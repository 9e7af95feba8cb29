"""Row gathers (counterpart of toothgroupnetwork_tpu/ops/gather.py)."""

from __future__ import annotations

import os

import torch

from .kernels.gather import onehot_gather


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``points[..., idx, :]``: points ``[B, N, C]`` (or ``[N, C]``), integer
    idx ``[B, ...]`` (or ``[...]``) into the N axis -> ``idx.shape + (C,)``."""
    c = points.shape[-1]
    if points.dim() == 2:
        return points[idx.reshape(-1).long()].reshape(idx.shape + (c,))
    b, n = points.shape[0], points.shape[1]
    offs = (torch.arange(b, device=idx.device) * n).reshape(
        (b,) + (1,) * (idx.dim() - 1))
    flat = (idx.long() + offs).reshape(-1)
    return points.reshape(b * n, c)[flat].reshape(idx.shape + (c,))


def gather_neighbors(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Neighbourhood gather ``[B, N, C]`` + ``[B, M, K]`` -> ``[B, M, K, C]``.

    The JAX package's switch, under the same name: ``TGN_TPU_GATHER=mxu``
    takes the row-gather kernel K8 (``kernels/gather.py:onehot_gather``;
    on CPU tensors its plain twin), and ``auto``, the default, takes
    :func:`index_points`. Both give the same values; no model layer calls
    this function, in either package."""
    if os.environ.get("TGN_TPU_GATHER", "auto") == "mxu":
        return onehot_gather(points, idx)
    return index_points(points, idx)


def group_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Neighbourhood gather ``[B, N, C]`` + ``[B, S, K]`` -> ``[B, S, K, C]``
    (the pointops grouping contract)."""
    return index_points(points, idx)
