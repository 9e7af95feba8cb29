"""tgnet two-stage grouping network (counterpart of
toothgroupnetwork_tpu/models/tgnet.py): ``stage1`` over the full cloud,
``stage2`` over 16 fixed crop slots built by :func:`make_crops`, and the
train forward that crops around the ground-truth tooth centroids.

The 16 crop slots are fixed (one per tooth class); a missing tooth gets a far
sentinel centroid, and its crop is masked out of every loss and BatchNorm
statistic through ``crop_mask``.

In the point-sharded step (``parallel/points.py``) stage 1 runs on this
rank's rows of the point axis; the centroids and the crops come from the
all-gathered inputs, bit-equal to the dense step's, and stage 2 runs on
this rank's rows of the ``B·16`` crops (the crop outputs hold those rows,
``nn_crop_indexes`` as ``[rows, S]``)."""

from __future__ import annotations

import torch
from torch import nn

from ..ops import index_points, smallest_k, square_distance
from ..parallel import points as point_shards
from .point_transformer.backbone import PointTransformerSeg

N_TEETH = 16
_FAR = 1e3


def half_arch_labels(labels: torch.Tensor) -> torch.Tensor:
    """Merge the left and right arch classes: 9..15 -> 1..7 (-1 and 0..8 kept)."""
    return torch.where(labels >= 9, labels - 8, labels)


def binary_crop_labels(labels: torch.Tensor) -> torch.Tensor:
    """Clamp crop labels to {-1 gingiva, 0 any tooth}."""
    return torch.where(labels >= 0, torch.zeros_like(labels), labels)


def gt_tooth_centroids(xyz: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor | None = None):
    """Per-tooth-class centroids of the ground-truth labels: (centroids
    ``[B, 16, 3]``, valid ``[B, 16]``); a tooth with no point gets the far
    sentinel 1e3, so its crop gathers points that are then masked out."""
    classes = torch.arange(N_TEETH, device=labels.device)
    tooth = labels[:, None, :] == classes[None, :, None]           # [B,16,N]
    if mask is not None:
        tooth = tooth & mask.to(torch.bool)[:, None, :]
    tf = tooth.to(torch.float32)
    counts = tf.sum(dim=-1)
    cent = torch.einsum("btn,bnc->btc", tf, xyz.to(torch.float32))
    cent = cent / torch.clamp_min(counts, 1.0)[..., None]
    valid = counts > 0
    return torch.where(valid[..., None], cent, _FAR), valid


def make_crops(feat: torch.Tensor, centroids: torch.Tensor,
               crop_valid: torch.Tensor, crop_size: int,
               mask: torch.Tensor | None = None,
               extra: torch.Tensor | None = None):
    """Nearest-``crop_size`` crops around each centroid, xyz recentred per crop.

    feat ``[B, N, C]`` (xyz first), centroids ``[B, K, 3]``, crop_valid
    ``[B, K]``. Returns (crop_feat ``[B*K, S, C]``, crop_mask ``[B*K, S]``,
    crop_idx ``[B, K, S]``), and with ``extra`` (a per-point ``[B, N]``
    payload such as the labels) also its crops ``[B*K, S]``. The selection
    (k = crop_size, far above the kNN kernel's k <= 64) is a plain distance
    pass and a STABLE sort, as the JAX package computes it outside any
    Pallas kernel: crop order matters, since the crop's first FPS seeds from
    crop point 0.
    """
    b, n, c = feat.shape
    k = centroids.shape[1]
    d2 = square_distance(centroids.to(torch.float32), feat[..., :3].to(torch.float32))
    if mask is not None:
        d2 = d2 + torch.where(mask.to(torch.bool), 0.0, 1e10)[:, None, :]
    idx, _ = smallest_k(d2, crop_size)
    crop = index_points(feat, idx)
    xyz = crop[..., :3] - crop[..., :3].mean(dim=2, keepdim=True)
    crop = torch.cat([xyz, crop[..., 3:]], dim=-1).reshape(b * k, crop_size, c)
    crop_mask = crop_valid[..., None].expand(b, k, crop_size).reshape(b * k, crop_size)
    if extra is None:
        return crop, crop_mask, idx
    cropped = index_points(extra[..., None], idx)[..., 0].reshape(b * k, crop_size)
    return crop, crop_mask, idx, cropped


class TGNet(nn.Module):
    """Two cascaded backbones: ``first`` (k = 9 + 1 half-arch classes) and
    ``second`` (k = 2, FG/BG over the crops), both computing in ``dtype``
    (their logits and offsets are float32 either way)."""

    def __init__(self, crop_size: int = 3072, c: int = 6,
                 planes=(32, 64, 128, 256, 512), stride=(1, 4, 4, 4, 4),
                 nsample=(36, 24, 24, 24, 24), blocks=(2, 3, 4, 6, 3),
                 block_num: int = 5, cell_attention: bool = False, *, device,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.crop_size = crop_size
        # the crop half runs 16 crops at once (B != 1), where the cell path
        # turns itself off, so both halves may share the flag
        kw = dict(c=c, planes=planes, stride=stride, nsample=nsample,
                  blocks=blocks, block_num=block_num,
                  cell_attention=cell_attention, device=device, dtype=dtype)
        self.first = PointTransformerSeg(k=10, **kw)
        self.second = PointTransformerSeg(k=2, **kw)
        self.eval()    # built for serving; train() selects the train path

    def prepare_kernel_state(self) -> None:
        """Fold and lay out both backbones' attention parameters on the
        calling thread (``PointTransformerSeg.prepare_kernel_state``)."""
        self.first.prepare_kernel_state()
        self.second.prepare_kernel_state()

    def forward(self, feat, mask=None, labels=None):
        """The train-path forward of the JAX ``TGNet.__call__``: stage 1,
        crops around the ground-truth centroids of ``labels`` ``[B, N]``
        (-1..15), stage 2 over them. Returns its dict of outputs; in eval
        mode the same path runs with the eval kernels (the validation
        pass)."""
        out1 = self.first(feat, mask)
        # the inputs carry no gradient: in the point-sharded step the whole
        # cloud, gathered once, and this rank's rows of the crop axis
        lo, hi = point_shards.crop_rows(feat.shape[0] * N_TEETH)
        feat, labels, mask = (point_shards.whole(t) for t in (feat, labels, mask))
        with point_shards.dense():
            centroids, crop_valid = gt_tooth_centroids(feat[..., :3], labels, mask)
            crop_feat, crop_mask, crop_idx, crop_labels = make_crops(
                feat, centroids, crop_valid, self.crop_size, mask, extra=labels)
            if hi - lo < crop_feat.shape[0]:
                crop_feat, crop_mask, crop_labels = (
                    t[lo:hi] for t in (crop_feat, crop_mask, crop_labels))
                crop_idx = crop_idx.reshape(-1, self.crop_size)[lo:hi]
            out2 = self.second(crop_feat, crop_mask)
        return {
            "sem_1": out1["sem_1"],
            "offset_1": out1["offset_1"],
            "cbl_stages_1": out1["cbl_stages"],
            "first_features": out1["embed"],
            "sem_2": out2["sem_1"],
            "offset_2": out2["offset_1"],
            "cbl_stages_2": out2["cbl_stages"],
            "cluster_gt_seg_label": crop_labels,
            "crop_valid": crop_valid,
            "crop_mask": crop_mask,
            "nn_crop_indexes": crop_idx,
            "cropped_feature_ls": crop_feat,
            "cls_pred": out1["sem_1"],
        }

    def stage1(self, feat, mask=None):
        return self.first(feat, mask)

    def stage2(self, crop_feat, crop_mask=None):
        return self.second(crop_feat, crop_mask)
