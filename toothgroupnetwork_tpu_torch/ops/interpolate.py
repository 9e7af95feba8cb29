"""3-NN inverse-distance upsampling (counterpart of
toothgroupnetwork_tpu/ops/interpolate.py)."""

from __future__ import annotations

import torch

from .gather import index_points
from .knn import knn_points


def knn_interpolate(target_xyz: torch.Tensor, source_xyz: torch.Tensor,
                    source_feat: torch.Tensor, k: int = 3,
                    t_mask: torch.Tensor | None = None,
                    s_mask: torch.Tensor | None = None) -> torch.Tensor:
    """``[..., M, 3]``, ``[..., N, 3]``, ``[..., N, C]`` -> ``[..., M, C]`` with
    weights ``recip / sum(recip)``, ``recip = 1 / (dist + 1e-8)`` over the
    exact k nearest (re-scored) source points."""
    idx, dist = knn_points(target_xyz, source_xyz, k, t_mask, s_mask)
    recip = 1.0 / (dist + 1e-8)
    weight = recip / recip.sum(dim=-1, keepdim=True)
    neigh = index_points(source_feat, idx)
    return (neigh * weight[..., None]).sum(dim=-2)


def three_nn_interpolate(target_xyz, source_xyz, source_feat, t_mask=None,
                         s_mask=None):
    """The PointNet++ three-NN upsampling: :func:`knn_interpolate` at k = 3."""
    return knn_interpolate(target_xyz, source_xyz, source_feat, 3, t_mask, s_mask)
