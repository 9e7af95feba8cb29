"""Row gathers (counterpart of toothgroupnetwork_tpu/ops/gather.py)."""

from __future__ import annotations

import torch


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
