"""Pairwise squared distances (counterpart of toothgroupnetwork_tpu/ops/distance.py).

The expansion ``|s|^2 - 2 s.d + |d|^2`` is evaluated channel by channel in a
FIXED left-to-right order with separate multiplies and adds, never as a
matmul: the kNN kernel (csrc/knn.cu) computes the same expression with
round-to-nearest intrinsics, so the plain twin and the kernel produce
bit-identical distances and select the same neighbours on near-ties.
"""

from __future__ import annotations

import torch


def _dot_fixed(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis of ``a * b`` as ((a0*b0 + a1*b1) + a2*b2) + ..."""
    acc = a[..., 0] * b[..., 0]
    for i in range(1, a.shape[-1]):
        acc = acc + a[..., i] * b[..., i]
    return acc


def square_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """``[..., M, C] x [..., N, C] -> [..., M, N]`` squared distances, >= 0."""
    s2 = _dot_fixed(src, src)
    d2 = _dot_fixed(dst, dst)
    cross = _dot_fixed(src.unsqueeze(-2), dst.unsqueeze(-3))
    return torch.clamp_min((s2.unsqueeze(-1) - 2.0 * cross) + d2.unsqueeze(-2), 0.0)


def pairwise_sqdist(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Alias of :func:`square_distance` (the JAX package's name at its call
    sites)."""
    return square_distance(src, dst)
