"""FPS + grouping composites of the PointNet++ set-abstraction layers
(counterpart of toothgroupnetwork_tpu/ops/sampling.py)."""

from __future__ import annotations

import torch

from .ball_query import ball_query
from .fps import farthest_point_sample
from .gather import index_points


def sample_and_group(npoint: int, radius: float, nsample: int, xyz: torch.Tensor,
                     points: torch.Tensor | None = None,
                     mask: torch.Tensor | None = None):
    """FPS down to ``npoint`` centres (K1), ball-group ``nsample`` points
    around each, recentre. xyz ``[B, N, 3]``, points ``[B, N, D]`` or None.
    Returns ``(new_xyz [B, npoint, 3], new_points [B, npoint, nsample,
    3(+D)], fps_idx [B, npoint], group_idx [B, npoint, nsample])``."""
    fps_idx = farthest_point_sample(xyz, npoint, mask)
    new_xyz = index_points(xyz, fps_idx)
    idx = ball_query(radius, nsample, xyz, new_xyz, mask)
    new_points = index_points(xyz, idx) - new_xyz[..., None, :]
    if points is not None:
        new_points = torch.cat([new_points, index_points(points, idx)], dim=-1)
    return new_xyz, new_points, fps_idx, idx


def sample_and_group_all(xyz: torch.Tensor, points: torch.Tensor | None = None,
                         mask: torch.Tensor | None = None):
    """One global group: ``(new_xyz [B, 1, 3] zeros, new_points [B, 1, N,
    3(+D)])``; with a mask, padded points' features are zeroed."""
    b = xyz.shape[0]
    new_xyz = torch.zeros((b, 1, 3), dtype=xyz.dtype, device=xyz.device)
    grouped = xyz[:, None]
    if points is not None:
        grouped = torch.cat([grouped, points[:, None]], dim=-1)
    if mask is not None:
        grouped = torch.where(mask.to(torch.bool)[:, None, :, None], grouped, 0.0)
    return new_xyz, grouped
