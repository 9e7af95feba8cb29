"""PointNet++ MSG semantic segmentation (counterpart of
toothgroupnetwork_tpu/models/pointnetpp.py): three multi-scale SA stages
(1024 / 512 / 256 centres, radii 0.025-0.2) at scale 4, three FP stages, and
the cls (17), offset (3) and dist (1) heads."""

from __future__ import annotations

from torch import nn
from torch.nn import functional as F

from ..nn.layers import Dense, MaskedBatchNorm
from ..nn.set_abstraction import FeaturePropagation, SetAbstractionMsg


class PointNetPPSeg(nn.Module):
    def __init__(self, num_classes: int = 17, scale: int = 4, c: int = 6, *,
                 device):
        super().__init__()
        s = scale
        kw = dict(device=device)
        self.sa1 = SetAbstractionMsg(1024, [0.025, 0.05], [32, 64], c,
                                     [[32 * s, 32 * s], [32 * s, 32 * s]], **kw)
        self.sa2 = SetAbstractionMsg(512, [0.05, 0.1], [32, 64], self.sa1.out_dim,
                                     [[64 * s, 128 * s], [64 * s, 128 * s]], **kw)
        self.sa3 = SetAbstractionMsg(256, [0.1, 0.2], [32, 64], self.sa2.out_dim,
                                     [[196 * s, 256 * s], [196 * s, 256 * s]], **kw)
        self.fp3 = FeaturePropagation(self.sa2.out_dim + self.sa3.out_dim,
                                      [256 * s, 256 * s], **kw)
        self.fp2 = FeaturePropagation(self.sa1.out_dim + 256 * s,
                                      [128 * s, 128 * s], **kw)
        self.fp1 = FeaturePropagation(c + 128 * s, [64 * s, 32 * s], **kw)
        d = 32 * s
        self.offset_1 = Dense(d, 16, **kw)
        self.offset_bn = MaskedBatchNorm(16, **kw)
        self.offset_2 = Dense(16, 3, zero_init=True, **kw)
        self.dist_1 = Dense(d, 16, **kw)
        self.dist_bn = MaskedBatchNorm(16, **kw)
        self.dist_2 = Dense(16, 1, zero_init=True, **kw)
        self.cls_1 = Dense(d, num_classes, **kw)
        self.cls_bn = MaskedBatchNorm(num_classes, **kw)
        self.cls_2 = Dense(num_classes, num_classes, **kw)
        self.eval()

    def forward(self, feat, mask=None):
        """feat ``[B, N, 6]`` xyz + normals. Returns ``cls_pred`` logits,
        ``offset``, ``dist`` and the l0/l3 features."""
        l0_xyz = feat[..., :3]
        l1_xyz, l1_points, m1 = self.sa1(l0_xyz, feat, mask)
        l2_xyz, l2_points, m2 = self.sa2(l1_xyz, l1_points, m1)
        l3_xyz, l3_points, m3 = self.sa3(l2_xyz, l2_points, m2)
        l2_points = self.fp3(l2_xyz, l3_xyz, l2_points, l3_points, m2, m3)
        l1_points = self.fp2(l1_xyz, l2_xyz, l1_points, l2_points, m1, m2)
        l0_points = self.fp1(l0_xyz, l1_xyz, feat, l1_points, mask, m1)
        offset = self.offset_2(F.relu(self.offset_bn(self.offset_1(l0_points), mask)))
        dist = self.dist_2(F.relu(self.dist_bn(self.dist_1(l0_points), mask)))
        cls = self.cls_2(F.relu(self.cls_bn(self.cls_1(l0_points), mask)))
        return {"cls_pred": cls, "offset": offset, "dist": dist,
                "l0_points": l0_points, "l3_points": l3_points, "l3_xyz": l3_xyz,
                "l3_mask": m3}
