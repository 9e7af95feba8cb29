"""tgnet offset and chamfer losses (counterpart of
toothgroupnetwork_tpu/losses/tgn_loss.py), in the JAX package's masked-dense
form: per-tooth masks ``[B, 16, N]`` from the labels, teeth with fewer than
5 points left out of the centroid term.

In the point-sharded step (``parallel/points.py``) the points are this
rank's rows of each cloud: the tooth centroids and counts come from the
all-gathered coordinates and labels (``points.whole``), bit-equal to the
dense step's, and each sum over the point axis is summed over the shards
(``points.psum``, the identity outside that step)."""

from __future__ import annotations

import torch

from ..parallel import data_parallel
from ..parallel import points as point_shards

_N_TEETH = 16
_BIG = 1e9


def _tooth_masks(gt_label: torch.Tensor, point_mask: torch.Tensor | None):
    """labels ``[B, N]`` -> (per-tooth masks ``[B, 16, N]`` float32, counts
    ``[B, 16]`` float32, centroid validity: count >= 5)."""
    classes = torch.arange(_N_TEETH, device=gt_label.device)
    tooth = gt_label[:, None, :] == classes[None, :, None]
    if point_mask is not None:
        tooth = tooth & point_mask.to(torch.bool)[:, None, :]
    counts = tooth.sum(dim=-1)
    return tooth.to(torch.float32), counts.to(torch.float32), counts >= 5


def _tooth_centroids(xyz, tooth_f, counts):
    sums = torch.einsum("btn,bnc->btc", tooth_f, xyz)
    return sums / torch.clamp_min(counts, 1.0)[..., None]


def _teeth(xyz, gt_label, point_mask):
    """(per-tooth masks of these points ``[B, 16, n]``, the counts ``[B,
    16]``, their validity, the centroids ``[B, 16, 3]``): the counts,
    validity and centroids those of the whole cloud (gathered in the
    point-sharded step)."""
    whole_f, counts, valid = _tooth_masks(point_shards.whole(gt_label),
                                          point_shards.whole(point_mask))
    cent = _tooth_centroids(point_shards.whole(xyz), whole_f, counts)
    if point_shards.active() is not None:
        whole_f = _tooth_masks(gt_label, point_mask)[0]
    return whole_f, counts, valid, cent


def batch_center_offset_loss(pred_offset: torch.Tensor, xyz: torch.Tensor,
                             gt_label: torch.Tensor,
                             point_mask: torch.Tensor | None = None):
    """(centroid_loss, dir_loss) for offsets and points ``[B, N, 3]`` and
    labels ``[B, N]`` in -1..15: the mean squared distance of each tooth's
    offset-moved points to its centroid (averaged per tooth, then over the
    valid teeth), and ``(<offset dir, dir to centroid> - 1)^2`` over the
    points whose offset is longer than 2e-4."""
    xyz = xyz.to(torch.float32)
    pred_offset = pred_offset.to(torch.float32)
    tooth_f, counts, valid, cent = _teeth(xyz, gt_label, point_mask)   # [B,16,3]

    moved = xyz + pred_offset
    d2 = ((moved[:, None, :, :] - cent[:, :, None, :]) ** 2).sum(dim=-1)  # [B,16,N]
    per_tooth = point_shards.psum((d2 * tooth_f).sum(dim=-1)) / torch.clamp_min(counts, 1.0)
    vf = valid.to(torch.float32)
    centroid_loss = data_parallel.ratio((per_tooth * vf).sum(), vf.sum(), 1.0)

    off_norm = torch.linalg.vector_norm(pred_offset, dim=-1)           # [B,N]
    off_dir = pred_offset / torch.clamp_min(off_norm, 1e-12)[..., None]
    to_cent = cent[:, :, None, :] - xyz[:, None, :, :]                 # [B,16,N,3]
    to_cent_dir = to_cent / torch.clamp_min(
        torch.linalg.vector_norm(to_cent, dim=-1, keepdim=True), 1e-12)
    dot = torch.einsum("bnc,btnc->btn", off_dir, to_cent_dir)
    sq = (dot - 1.0) ** 2
    moving = (off_norm > 2e-4)[:, None, :]
    sel = tooth_f * moving * vf[..., None]
    n_sel = point_shards.psum(sel.sum(dim=-1))
    per_tooth_dir = point_shards.psum((sq * sel).sum(dim=-1)) / torch.clamp_min(n_sel, 1.0)
    has_dir = (n_sel > 0).to(torch.float32)
    dir_loss = data_parallel.ratio((per_tooth_dir * has_dir).sum(), has_dir.sum(), 1.0)
    return centroid_loss, dir_loss


def batch_chamfer_distance_loss(pred_offset: torch.Tensor, xyz: torch.Tensor,
                                gt_label: torch.Tensor,
                                point_mask: torch.Tensor | None = None) -> torch.Tensor:
    """The ratio of each foreground point's squared distance (after its
    offset) to the nearest valid tooth centroid over that to the second
    nearest, averaged per cloud, then over the batch."""
    xyz = xyz.to(torch.float32)
    pred_offset = pred_offset.to(torch.float32)
    _, _, valid, cent = _teeth(xyz, gt_label, point_mask)

    moved = xyz + pred_offset
    d2 = ((moved[:, :, None, :] - cent[:, None, :, :]) ** 2).sum(dim=-1)  # [B,N,16]
    d2 = torch.where(valid[:, None, :], d2, _BIG)
    top2 = torch.topk(d2, 2, dim=-1, largest=False).values
    ratio = top2[..., 0] / torch.clamp_min(top2[..., 1], 1e-12)

    fg = gt_label != -1
    if point_mask is not None:
        fg = fg & point_mask.to(torch.bool)
    fgf = fg.to(torch.float32)
    per_cloud = (point_shards.psum((ratio * fgf).sum(dim=-1))
                 / torch.clamp_min(point_shards.psum(fgf.sum(dim=-1)), 1.0))
    # a mean of per-cloud values over this rank's equal slice of the batch:
    # the data-parallel step's mean over the ranks makes it the global mean,
    # value and gradient, so it needs no collective of its own; in the
    # point-sharded step each value is its whole cloud's (psummed), the
    # same on every rank, and that mean leaves it as it is
    return per_cloud.mean()
