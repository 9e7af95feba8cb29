"""tgnet two-stage grouping network, inference stages (counterpart of
toothgroupnetwork_tpu/models/tgnet.py): ``stage1`` over the full cloud,
``stage2`` over 16 fixed crop slots built by :func:`make_crops`."""

from __future__ import annotations

import torch
from torch import nn

from ..ops import index_points, smallest_k, square_distance
from .point_transformer.backbone import PointTransformerSeg

N_TEETH = 16


def make_crops(feat: torch.Tensor, centroids: torch.Tensor,
               crop_valid: torch.Tensor, crop_size: int,
               mask: torch.Tensor | None = None):
    """Nearest-``crop_size`` crops around each centroid, xyz recentred per crop.

    feat ``[B, N, C]`` (xyz first), centroids ``[B, K, 3]``, crop_valid
    ``[B, K]``. Returns (crop_feat ``[B*K, S, C]``, crop_mask ``[B*K, S]``,
    crop_idx ``[B, K, S]``). The selection (k = crop_size, far above the kNN
    kernel's k <= 64) is a plain distance pass and a STABLE sort, as the JAX
    package computes it outside any Pallas kernel: crop order matters, since
    the crop's first FPS seeds from crop point 0.
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
    return crop, crop_mask, idx


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

    def prepare_kernel_state(self) -> None:
        """Fold and lay out both backbones' attention parameters on the
        calling thread (``PointTransformerSeg.prepare_kernel_state``)."""
        self.first.prepare_kernel_state()
        self.second.prepare_kernel_state()

    def stage1(self, feat, mask=None):
        return self.first(feat, mask)

    def stage2(self, crop_feat, crop_mask=None):
        return self.second(crop_feat, crop_mask)
