"""PointNet++ set-abstraction and feature-propagation layers (counterpart of
toothgroupnetwork_tpu/nn/set_abstraction.py), channel-last. A grouped MLP
is Dense over ``[B, S, K, C]`` rows; its BatchNorm normalises over all of
(B, S, K). Submodules carry the flax names (``mlp``, ``scale_i``,
``dense_i``, ``bn_i``), so the weight bridge maps them mechanically.

Input widths are explicit here (flax infers them at init): ``din`` is the
per-point feature width D of ``points`` (0 for none); a grouped row is
``3 + D`` wide."""

from __future__ import annotations

from collections.abc import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from ..ops import (ball_query, farthest_point_sample, index_points,
                   knn_interpolate, sample_and_group_all)
from .layers import Dense, MaskedBatchNorm


class GroupMLP(nn.Module):
    """Dense + BN + ReLU stack over grouped ``[..., C]`` rows."""

    def __init__(self, din: int, features: Sequence[int], *, device):
        super().__init__()
        self.n = len(features)
        for i, f in enumerate(features):
            self.add_module(f"dense_{i}", Dense(din, f, device=device))
            self.add_module(f"bn_{i}", MaskedBatchNorm(f, device=device))
            din = f

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        shape = x.shape
        x = x.reshape(-1, shape[-1])
        flat_mask = None
        if mask is not None:
            flat_mask = torch.broadcast_to(mask, shape[:-1]).reshape(-1)
        for i in range(self.n):
            x = getattr(self, f"dense_{i}")(x)
            x = F.relu(getattr(self, f"bn_{i}")(x, flat_mask))
        return x.reshape(shape[:-1] + (x.shape[-1],))


def _sampled_mask(mask, fps_idx):
    """The centres' validity: the mask gathered at the FPS indices."""
    if mask is None:
        return None
    return index_points(mask[..., None].to(torch.float32), fps_idx)[..., 0] > 0


class SetAbstraction(nn.Module):
    """Single-scale SA: FPS -> ball group -> shared MLP -> max over the
    neighbourhood; ``group_all`` collapses the cloud into one group, whose
    fully masked rows (padded crop slots) pool to 0."""

    def __init__(self, npoint: int, radius: float, nsample: int, din: int,
                 mlp: Sequence[int], group_all: bool = False, *, device):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.group_all = group_all
        self.mlp = GroupMLP(3 + din, mlp, device=device)

    def forward(self, xyz, points=None, mask=None):
        """Returns ``(new_xyz [B, S, 3], new_points [B, S, C'], new_mask)``."""
        if self.group_all:
            new_xyz, grouped = sample_and_group_all(xyz, points, mask)
            gmask = mask.to(torch.bool)[:, None, :] if mask is not None else None
            h = self.mlp(grouped, gmask)
            if mask is not None:
                h = torch.where(gmask[..., None], h, -1e30)
            pooled = h.amax(dim=2)
            if mask is not None:
                any_valid = mask.to(torch.bool).any(dim=-1)[:, None, None]
                pooled = torch.where(any_valid, pooled, 0.0)
            return new_xyz, pooled, None
        fps_idx = farthest_point_sample(xyz, self.npoint, mask)
        new_xyz = index_points(xyz, fps_idx)
        idx = ball_query(self.radius, self.nsample, xyz, new_xyz, mask)
        grouped = index_points(xyz, idx) - new_xyz[..., None, :]
        if points is not None:
            grouped = torch.cat([grouped, index_points(points, idx)], dim=-1)
        new_mask = _sampled_mask(mask, fps_idx)
        gmask = (None if new_mask is None
                 else new_mask[..., None].expand(grouped.shape[:3]))
        return new_xyz, self.mlp(grouped, gmask).amax(dim=2), new_mask


class SetAbstractionMsg(nn.Module):
    """Multi-scale grouping SA: one FPS, then per radius a ball group, an
    MLP (``scale_i``) and a max, concatenated over scales. Each group is
    ``[grouped_points, grouped_xyz]`` in that order."""

    def __init__(self, npoint: int, radius_list: Sequence[float],
                 nsample_list: Sequence[int], din: int,
                 mlp_list: Sequence[Sequence[int]], *, device):
        super().__init__()
        self.npoint = npoint
        self.radius_list, self.nsample_list = tuple(radius_list), tuple(nsample_list)
        for i, mlp in enumerate(mlp_list):
            self.add_module(f"scale_{i}", GroupMLP(din + 3, mlp, device=device))
        self.out_dim = sum(mlp[-1] for mlp in mlp_list)

    def forward(self, xyz, points=None, mask=None):
        fps_idx = farthest_point_sample(xyz, self.npoint, mask)
        new_xyz = index_points(xyz, fps_idx)
        new_mask = _sampled_mask(mask, fps_idx)
        outs = []
        for i, (radius, k) in enumerate(zip(self.radius_list, self.nsample_list)):
            idx = ball_query(radius, k, xyz, new_xyz, mask)
            grouped = index_points(xyz, idx) - new_xyz[..., None, :]
            if points is not None:
                grouped = torch.cat([index_points(points, idx), grouped], dim=-1)
            gmask = (None if new_mask is None
                     else new_mask[..., None].expand(grouped.shape[:3]))
            outs.append(getattr(self, f"scale_{i}")(grouped, gmask).amax(dim=2))
        return new_xyz, torch.cat(outs, dim=-1), new_mask


class FeaturePropagation(nn.Module):
    """FP upsampling: three-NN inverse-distance interpolation (a broadcast
    when the source has one point), the skip concat, Dense + BN + ReLU.
    ``din`` is the width of ``[points1, interpolated points2]``."""

    def __init__(self, din: int, mlp: Sequence[int], *, device):
        super().__init__()
        self.n = len(mlp)
        for i, f in enumerate(mlp):
            self.add_module(f"dense_{i}", Dense(din, f, device=device))
            self.add_module(f"bn_{i}", MaskedBatchNorm(f, device=device))
            din = f

    def forward(self, xyz1, xyz2, points1, points2, mask1=None, mask2=None):
        """xyz1 ``[B, N, 3]`` targets; xyz2 ``[B, S, 3]`` sources carrying
        points2 ``[B, S, D]``."""
        if xyz2.shape[1] == 1:
            interp = points2.expand(points2.shape[0], xyz1.shape[1], points2.shape[-1])
        else:
            interp = knn_interpolate(xyz1, xyz2, points2, 3, mask1, mask2)
        x = interp if points1 is None else torch.cat([points1, interp], dim=-1)
        for i in range(self.n):
            x = getattr(self, f"dense_{i}")(x)
            x = F.relu(getattr(self, f"bn_{i}")(x, mask1))
        return x
