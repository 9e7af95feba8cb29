"""Farthest point sampling (counterpart of toothgroupnetwork_tpu/ops/fps.py).

Every call goes through K1 (``kernels/fps.py``): the kernel on a CUDA
tensor, its plain twin on a CPU tensor.
"""

from __future__ import annotations

import torch

from .kernels.fps import fps as fps_kernel


def farthest_point_sample(xyz: torch.Tensor, n_samples: int,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """xyz ``[N, 3]`` or ``[B, N, 3]``, optional bool mask ``[N]`` / ``[B, N]``
    -> int32 ``[n_samples]`` / ``[B, n_samples]``. Seeds at the first valid
    point; invalid points are never picked; once the valid points are
    exhausted the indices repeat valid points."""
    if xyz.dim() == 2:
        return farthest_point_sample(
            xyz[None], n_samples, None if mask is None else mask[None])[0]
    valid = None if mask is None else mask.to(torch.bool).contiguous()
    return fps_kernel(xyz.to(torch.float32).contiguous(), n_samples, valid)


def fps(xyz: torch.Tensor, n_samples: int,
        mask: torch.Tensor | None = None) -> torch.Tensor:
    """Alias of :func:`farthest_point_sample` (the JAX package's name)."""
    return farthest_point_sample(xyz, n_samples, mask)
