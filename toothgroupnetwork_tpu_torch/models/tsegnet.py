"""TSegNet (counterpart of toothgroupnetwork_tpu/models/tsegnet.py):

  * centroid module: a PointNet++ MSG backbone (1024 / 512 / 256 centres,
    radii 0.025-0.2) with offset and distance heads on the 256-point level,
    fed ``[l3_points, l3_xyz]`` (515 channels),
  * crops: the ``crop_size`` nearest points of the whole cloud around each
    proposed centroid, with the distance density field ``exp(-4 |x - c|)``;
    crop features ``[xyz, l0 features (32), ddf]`` = 36 channels,
  * seg module: two PointNet++ towers; tower 1 -> pd_1 (2-class softmax) and
    the confidence weight_1, tower 2 (38 channels: + pd_1) -> pd_2 (a binary
    logit) and, through a group-all SA, the 17-way id head.

The crop proposals (DBSCAN over the centroid module's own predictions) come
from the host: the inference pipeline's 16 slots (``pipelines/tsegnet.py``),
the training task's host stage's ``N_CROPS_TRAIN`` (``models/tasks.py``).
In train mode the gradients flow through the crops' l0 features into the
centroid backbone, as in the JAX module. The crops select with the plain
``ops.smallest_k`` (k = 3072 is far above K2's 64) over the port's
fixed-order distances (``ops/distance.py``), where the JAX package takes its
matmul expansion: the two may order exact near-ties at a crop's rim
differently.

In the point-sharded step (``parallel/points.py``) the centroid module
runs on this rank's rows of the point axis; the crop selection and the
crops' coordinates come from the all-gathered cloud, the crops' l0
features over the ring (``sharded_ops.crop_rows_gather``, their gradient
returned to the owners), and the seg module runs on this rank's rows of
the ``B·K`` crops (the crop outputs hold those rows, ``nn_crop_indexes``
as ``[rows, S]``)."""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..nn.layers import Dense, LayerNorm, MaskedBatchNorm
from ..nn.set_abstraction import (FeaturePropagation, SetAbstraction,
                                  SetAbstractionMsg)
from ..ops import index_points, smallest_k, square_distance
from ..parallel import points as point_shards
from ..postprocess.clustering import dbscan

# crop slots a train batch carries (JAX tsegnet.py:N_CROPS_TRAIN)
N_CROPS_TRAIN = 8

# (npoint, radii, nsamples, mlps) of the three SA levels and the FP widths;
# ``tiny`` is the JAX package's structurally identical minimal arch
_FULL_SA = ((1024, (0.025, 0.05), (32, 64), ((32, 32), (32, 32))),
            (512, (0.05, 0.1), (32, 64), ((64, 128), (64, 128))),
            (256, (0.1, 0.2), (32, 64), ((196, 256), (196, 256))))
_FULL_FP = ((256, 256), (128, 128), (64, 32))
_TINY_SA = ((32, (0.05, 0.1), (4, 8), ((8, 8), (8, 8))),
            (16, (0.1, 0.2), (4, 8), ((8, 16), (8, 16))),
            (8, (0.2, 0.4), (4, 8), ((16, 16), (16, 16))))
_TINY_FP = ((16, 16), (16, 16), (16, 8))


class PointNetPPBackbone(nn.Module):
    """The MSG backbone (scale 1) and FP decoder of both tsegnet modules."""

    def __init__(self, c: int, tiny: bool = False, *, device):
        super().__init__()
        sa, fp = (_TINY_SA, _TINY_FP) if tiny else (_FULL_SA, _FULL_FP)
        din = c
        for i, (npoint, radii, nsamples, mlps) in enumerate(sa):
            m = SetAbstractionMsg(npoint, radii, nsamples, din, mlps, device=device)
            self.add_module(f"sa{i + 1}", m)
            din = m.out_dim
        d1, d2, d3 = self.sa1.out_dim, self.sa2.out_dim, self.sa3.out_dim
        self.fp3 = FeaturePropagation(d2 + d3, fp[0], device=device)
        self.fp2 = FeaturePropagation(d1 + fp[0][-1], fp[1], device=device)
        self.fp1 = FeaturePropagation(c + fp[1][-1], fp[2], device=device)
        self.l0_dim, self.l3_dim = fp[2][-1], d3

    def forward(self, feat, mask=None):
        l0_xyz = feat[..., :3]
        l1_xyz, l1_points, m1 = self.sa1(l0_xyz, feat, mask)
        l2_xyz, l2_points, m2 = self.sa2(l1_xyz, l1_points, m1)
        l3_xyz, l3_points, m3 = self.sa3(l2_xyz, l2_points, m2)
        l2_up = self.fp3(l2_xyz, l3_xyz, l2_points, l3_points, m2, m3)
        l1_up = self.fp2(l1_xyz, l2_xyz, l1_points, l2_up, m1, m2)
        l0_up = self.fp1(l0_xyz, l1_xyz, feat, l1_up, mask, m1)
        return {"l0_points": l0_up, "l3_points": l3_points, "l3_xyz": l3_xyz,
                "l3_mask": m3}


class TsgCentroidModule(nn.Module):
    def __init__(self, tiny: bool = False, *, device):
        super().__init__()
        kw = dict(device=device)
        self.backbone = PointNetPPBackbone(6, tiny, **kw)
        d = self.backbone.l3_dim + 3
        self.offset_1 = Dense(d, 256, **kw)
        self.offset_bn = MaskedBatchNorm(256, **kw)
        self.offset_2 = Dense(256, 3, zero_init=True, **kw)
        self.dist_1 = Dense(d, 256, **kw)
        self.dist_bn = MaskedBatchNorm(256, **kw)
        self.dist_2 = Dense(256, 1, zero_init=True, **kw)

    def forward(self, feat, mask=None):
        bb = self.backbone(feat, mask)
        h = torch.cat([bb["l3_points"], bb["l3_xyz"]], dim=-1)
        m3 = bb["l3_mask"]
        off = self.offset_2(F.relu(self.offset_bn(self.offset_1(h), m3)))
        dist = self.dist_2(F.relu(self.dist_bn(self.dist_1(h), m3)))
        return {**bb, "offset_result": off, "dist_result": dist}


class TsgSegModule(nn.Module):
    """Crop segmentation over ``[K, S, c]`` crop features (c = 36: xyz, the
    centroid backbone's 32 l0 features, ddf; 12 with the tiny backbone)."""

    def __init__(self, tiny: bool = False, c: int = 36, *, device):
        super().__init__()
        kw = dict(device=device)
        self.tower1 = PointNetPPBackbone(c, tiny, **kw)
        l0 = self.tower1.l0_dim
        self.pd_mask_1 = Dense(l0, 2, **kw)
        self.wt_mask_1 = Dense(l0, 1, **kw)
        self.tower2 = PointNetPPBackbone(c + 2, tiny, **kw)
        self.pd_mask_2 = Dense(l0, 1, **kw)
        self.flatten_sa = SetAbstraction(0, 0.0, 0, self.tower2.l3_dim, [256, 512],
                                         group_all=True, **kw)
        self.fc1 = Dense(512, 256, **kw)
        self.id_ln = LayerNorm(256, **kw)
        self.fc2 = Dense(256, 17, zero_init=True, **kw)

    def forward(self, crop_feat, crop_mask=None):
        t1 = self.tower1(crop_feat, crop_mask)
        pd_1 = torch.softmax(self.pd_mask_1(t1["l0_points"]), dim=-1)
        weight_1 = self.wt_mask_1(t1["l0_points"])
        t2 = self.tower2(torch.cat([crop_feat, pd_1], dim=-1), crop_mask)
        pd_2 = self.pd_mask_2(t2["l0_points"])
        _, g, _ = self.flatten_sa(t2["l3_xyz"], t2["l3_points"], t2["l3_mask"])
        idh = F.relu(self.id_ln(self.fc1(g[:, 0, :])))
        return pd_1, weight_1, pd_2, self.fc2(idh)


def cluster_centres(l3_xyz: np.ndarray, offset: np.ndarray,
                    dist: np.ndarray) -> np.ndarray:
    """Crop centres from one cloud's centroid predictions (host): DBSCAN
    (eps 0.05, min 3) over the moved l3 points ``l3_xyz + offset`` whose
    predicted distance is < 0.3, one centre (the mean) per cluster in label
    order, noise dropped. Returns ``[n, 3]``."""
    moved = (l3_xyz + offset)[dist < 0.3]
    if moved.shape[0] < 3:
        return moved[:0]
    labels, _ = dbscan(moved, 0.05, 3)
    return np.array([moved[labels == lab].mean(axis=0)
                     for lab in np.unique(labels) if lab != -1]).reshape(-1, 3)


def compute_ddf(crop_xyz: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """``exp(-4 |x - c|)``: crop_xyz ``[K, S, 3]``, centers ``[K, 3]`` ->
    ``[K, S, 1]``."""
    d = torch.linalg.vector_norm(crop_xyz - centers[:, None, :], dim=-1)
    return torch.exp(-4.0 * d)[..., None]


def tsegnet_crops(feat: torch.Tensor, l0_points: torch.Tensor,
                  centers: torch.Tensor, valid: torch.Tensor, crop_size: int,
                  mask: torch.Tensor | None = None):
    """The seg module's inputs: the ``crop_size`` nearest points of ``feat``
    ``[B, N, 6]`` around each centre ``[B, K, 3]`` (raw xyz, not
    recentred), their l0 features and ddf. Returns (crop_feat ``[B*K, S,
    36]``, crop_mask ``[B*K, S]``, crop_idx ``[B, K, S]``)."""
    b, k = centers.shape[:2]
    mesh = point_shards.active()
    # in the point-sharded step: the selection over the whole cloud,
    # gathered once, and this rank's rows of the crop axis
    lo, hi = point_shards.crop_rows(b * k)
    feat, whole_mask = point_shards.whole(feat), point_shards.whole(mask)
    with point_shards.dense():
        d2 = square_distance(centers.to(torch.float32), feat[..., :3].to(torch.float32))
        if whole_mask is not None:
            d2 = d2 + torch.where(whole_mask.to(torch.bool), 0.0, 1e10)[:, None, :]
        crop_idx, _ = smallest_k(d2, crop_size)
        crop_xyz = index_points(feat[..., :3], crop_idx).reshape(b * k, crop_size, 3)
    if mesh is None:
        crop_l0 = index_points(l0_points, crop_idx).reshape(b * k, crop_size, -1)
    else:
        from ..parallel.sharded_ops import crop_rows_gather

        crop_l0 = crop_rows_gather(l0_points, crop_idx, lo, hi, mesh,
                                   point_shards.global_size(l0_points.shape[1]))
        crop_idx = crop_idx.reshape(b * k, crop_size)[lo:hi]
    crop_xyz = crop_xyz[lo:hi]
    ddf = compute_ddf(crop_xyz, centers.reshape(b * k, 3)[lo:hi])
    crop_feat = torch.cat([crop_xyz, crop_l0, ddf], dim=-1)
    crop_mask = valid.to(torch.bool)[..., None].expand(b, k, crop_size).reshape(
        b * k, crop_size)[lo:hi]
    return crop_feat, crop_mask, crop_idx


@contextlib.contextmanager
def _eval_mode(module: nn.Module):
    """``module`` in eval mode inside the block, its own mode restored after."""
    was = module.training
    module.eval()
    try:
        yield
    finally:
        module.train(was)


class TSegNetModule(nn.Module):
    """The whole tsegnet. ``forward(feat, mask, center_points,
    center_valid)`` runs the centroid module and, given proposals, the crops
    and the seg module, in the module's mode; ``centroid_forward`` and
    ``seg_forward`` run each half alone in eval mode (running statistics),
    whatever the module's mode, as the JAX methods pass ``train=False``
    (the inference pipeline's two device programs, and the training host
    stage's centroid forward)."""

    def __init__(self, crop_size: int = 3072, run_seg_module: bool = True,
                 tiny_backbone: bool = False, *, device):
        super().__init__()
        self.crop_size, self.run_seg_module = crop_size, run_seg_module
        self.cent_module = TsgCentroidModule(tiny_backbone, device=device)
        if run_seg_module:
            self.seg_module = TsgSegModule(
                tiny_backbone, self.cent_module.backbone.l0_dim + 4, device=device)
        self.eval()

    def forward(self, feat, mask=None, center_points=None, center_valid=None):
        out = dict(self.cent_module(feat, mask))
        if not self.run_seg_module or center_points is None:
            return out
        crop_feat, crop_mask, crop_idx = tsegnet_crops(
            feat, out["l0_points"], center_points, center_valid, self.crop_size,
            mask)
        with point_shards.dense():
            pd_1, weight_1, pd_2, id_pred = self.seg_module(crop_feat, crop_mask)
        out.update({"pd_1": pd_1, "weight_1": weight_1, "pd_2": pd_2,
                    "id_pred": id_pred, "center_points": center_points,
                    "center_valid": center_valid, "nn_crop_indexes": crop_idx,
                    "cropped_feature_ls": crop_feat, "crop_mask": crop_mask})
        return out

    def centroid_forward(self, feat, mask=None):
        with _eval_mode(self.cent_module):
            return self.cent_module(feat, mask)

    def seg_forward(self, crop_feat, crop_mask=None):
        with _eval_mode(self.seg_module):
            return self.seg_module(crop_feat, crop_mask)
