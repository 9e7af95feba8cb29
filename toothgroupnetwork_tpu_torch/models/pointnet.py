"""PointNet semantic segmentation (counterpart of
toothgroupnetwork_tpu/models/pointnet.py): the PointNet encoder with input
and feature spatial transformers and a 4-layer head at scale 2, 17 logits.

The attribute names are the flax names, the auto-named children included
(``PointMLP_0``, ``Dense_0..2``, ``LayerNorm_0..1`` in each transformer), so
the weight bridge maps a JAX checkpoint mechanically."""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ..nn.layers import Dense, LayerNorm, PointMLP, masked_max


class SpatialTransformer(nn.Module):
    """Per-point MLP -> masked global max -> FC head with LayerNorms ->
    a ``k x k`` transform ``I + delta`` (the delta layer zero-initialised,
    so a new transformer is the identity)."""

    def __init__(self, din: int, k: int, *, device):
        super().__init__()
        self.k = k
        self.PointMLP_0 = PointMLP(din, [64, 128, 1024], device=device)
        self.Dense_0 = Dense(1024, 512, device=device)
        self.LayerNorm_0 = LayerNorm(512, device=device)
        self.Dense_1 = Dense(512, 256, device=device)
        self.LayerNorm_1 = LayerNorm(256, device=device)
        self.Dense_2 = Dense(256, k * k, device=device, zero_init=True)

    def forward(self, x, mask=None):
        g = masked_max(self.PointMLP_0(x, mask), mask, dim=1)
        g = F.relu(self.LayerNorm_0(self.Dense_0(g)))
        g = F.relu(self.LayerNorm_1(self.Dense_1(g)))
        delta = self.Dense_2(g)
        iden = torch.eye(self.k, dtype=delta.dtype, device=delta.device)
        return (delta + iden.reshape(1, -1)).reshape(-1, self.k, self.k)


class PointNetEncoder(nn.Module):
    """Transformer on xyz, shared MLPs, optional feature transformer, global
    max; with ``global_feat=False`` the broadcast global feature is
    concatenated before the per-point features."""

    def __init__(self, c: int = 6, global_feat: bool = True,
                 feature_transform: bool = False, scale: int = 1, *, device):
        super().__init__()
        s = scale
        self.global_feat, self.feature_transform = global_feat, feature_transform
        self.stn = SpatialTransformer(c, 3, device=device)
        self.mlp1 = PointMLP(c, [64 * s], device=device)
        if feature_transform:
            self.fstn = SpatialTransformer(64 * s, 64 * s, device=device)
        self.mlp2 = PointMLP(64 * s, [128 * s], device=device)
        self.mlp3 = PointMLP(128 * s, [1024 * s], last_activation=False,
                             device=device)

    def forward(self, x, mask=None):
        trans = self.stn(x, mask)
        xyz = torch.bmm(x[..., :3], trans)
        x = torch.cat([xyz, x[..., 3:]], dim=-1) if x.shape[-1] > 3 else xyz
        x = self.mlp1(x, mask)
        trans_feat = None
        if self.feature_transform:
            trans_feat = self.fstn(x, mask)
            x = torch.bmm(x, trans_feat)
        point_feat = x
        x = self.mlp3(self.mlp2(x, mask), mask)
        g = masked_max(x, mask, dim=1)
        if self.global_feat:
            return g, trans, trans_feat
        g_b = g[:, None, :].expand(g.shape[0], point_feat.shape[1], g.shape[-1])
        return torch.cat([g_b, point_feat], dim=-1), trans, trans_feat


class PointNetSeg(nn.Module):
    """17-way semantic segmentation. ``forward(feat [B, N, 6])`` returns
    ``cls_pred`` logits ``[B, N, num_classes]`` and ``trans_feat``."""

    def __init__(self, num_classes: int = 17, scale: int = 2, c: int = 6, *,
                 device):
        super().__init__()
        s = scale
        self.feat = PointNetEncoder(c, global_feat=False, feature_transform=True,
                                    scale=s, device=device)
        self.head = PointMLP(1024 * s + 64 * s, [512 * s, 256 * s, 128 * s],
                             device=device)
        self.cls = Dense(128 * s, num_classes, device=device)
        self.eval()

    def forward(self, feat, mask=None):
        x, _, trans_feat = self.feat(feat, mask)
        return {"cls_pred": self.cls(self.head(x, mask)), "trans_feat": trans_feat}
