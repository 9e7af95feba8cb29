"""TSegNet losses (counterpart of toothgroupnetwork_tpu/losses/tsg_loss.py):

  * ``distance_loss``: smooth-L1 between the predicted distance of each l3
    point and its true distance to the nearest ground-truth centroid;
  * ``centroid_dist_loss``: the moved points' squared distance to their
    nearest centroid where the predicted distance is <= 0.2, plus each
    centroid's squared distance to its nearest moved point where that is
    <= 0.2;
  * ``chamfer_distance_loss``: the nearest / second-nearest ratio where the
    nearest is <= 0.2;
  * ``first_seg_loss``: the reference's NLL on softmax PROBABILITIES (the
    per-point term is ``-p[gt]``), confidence-weighted as
    ``mean((-p w)^2 + (1 - w)^2)`` with ``w = sigmoid(weight_1)``, kept as
    the reference computes it;
  * ``second_seg_loss``: BCE with logits weighted by ``2 - w``;
  * ``id_loss``: 17-way CE of each crop's tooth id.

Ground-truth centroids come as fixed ``[B, 16, 3]`` rows and a validity
mask (invalid rows at distance 1e9); the crop terms are masked by crop
validity. In the point-sharded step the l3 points are this rank's rows:
the per-point terms' sums go through ``data_parallel.ratio``, and each
centroid's nearest moved point is the minimum over every rank's rows
(``points.pmax`` of the negation)."""

from __future__ import annotations

import torch
from torch.nn import functional as F

from ..parallel import data_parallel
from ..parallel import points as point_shards

_BIG = 1e9


def _masked_min_dists(points, centroids, cent_valid, k: int = 1):
    """Squared distances from each point to its ``k`` nearest valid
    centroids, ascending: ``[B, N, k]``."""
    d2 = ((points[:, :, None, :] - centroids[:, None, :, :]) ** 2).sum(-1)
    d2 = torch.where(cent_valid[:, None, :], d2, _BIG)
    return -torch.topk(-d2, k, dim=-1).values


def smooth_l1(pred, target):
    diff = (pred - target).abs()
    return torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)


def _masked_mean(x, mask):
    if mask is None:
        return data_parallel.mean(x)
    m = mask.to(x.dtype)
    return data_parallel.ratio((x * m).sum(), m.sum(), 1.0)


def distance_loss(pred_distance, sample_xyz, centroids, cent_valid, mask=None):
    """pred_distance ``[B, M, 1]``, sample_xyz ``[B, M, 3]`` (the l3
    points), centroids ``[B, 16, 3]``."""
    min_d = torch.sqrt(_masked_min_dists(sample_xyz, centroids, cent_valid)[..., 0])
    return _masked_mean(smooth_l1(pred_distance[..., 0], min_d), mask)


def centroid_dist_loss(pred_offset, sample_xyz, pred_distance, centroids,
                       cent_valid, mask=None):
    moved = sample_xyz + pred_offset
    min_d = _masked_min_dists(moved, centroids, cent_valid)[..., 0]      # [B,M]
    sel = pred_distance[..., 0] <= 0.2
    if mask is not None:
        sel = sel & mask.to(torch.bool)
    sf = sel.to(min_d.dtype)
    loss = data_parallel.ratio((min_d * sf).sum(), sf.sum(), 1.0)

    # each centroid to its nearest moved point (amin: ties share the
    # gradient, as jnp.min's does; over the shards, pmax's split)
    d2 = ((centroids[:, :, None, :] - moved[:, None, :, :]) ** 2).sum(-1)
    if mask is not None:
        d2 = torch.where(mask.to(torch.bool)[:, None, :], d2, _BIG)
    if point_shards.active() is None:
        min_c = d2.amin(dim=-1)                                          # [B,16]
    else:
        min_c = -point_shards.pmax(-d2.transpose(1, 2))
    cf = ((min_c <= 0.2) & cent_valid).to(min_c.dtype)
    return loss + data_parallel.ratio((min_c * cf).sum(), cf.sum(), 1.0)


def chamfer_distance_loss(pred_offset, sample_xyz, centroids, cent_valid,
                          mask=None):
    moved = sample_xyz + pred_offset
    d2 = _masked_min_dists(moved, centroids, cent_valid, k=2)            # [B,M,2]
    ratio = d2[..., 0] / torch.clamp_min(d2[..., 1], 1e-12)
    sel = d2[..., 0] <= 0.2
    if mask is not None:
        sel = sel & mask.to(torch.bool)
    sf = sel.to(ratio.dtype)
    return data_parallel.ratio((ratio * sf).sum(), sf.sum(), 1.0)


def centroid_loss(pred_offset, sample_xyz, pred_distance, centroids, cent_valid,
                  mask=None):
    """The (dist_loss, cent_loss, chamf_loss) triple."""
    return (
        distance_loss(pred_distance, sample_xyz, centroids, cent_valid, mask),
        centroid_dist_loss(pred_offset, sample_xyz, pred_distance, centroids,
                           cent_valid, mask),
        chamfer_distance_loss(pred_offset, sample_xyz, centroids, cent_valid,
                              mask),
    )


def first_seg_loss(pd_1, weight_1, gt_bin, crop_mask=None):
    """pd_1 ``[K, S, 2]`` softmax probabilities; weight_1 ``[K, S, 1]``;
    gt_bin ``[K, S]`` in {0, 1}."""
    # the label's entry as a one-hot product: exact, and its backward is
    # elementwise (no scatter)
    p = (pd_1 * F.one_hot(gt_bin.long(), pd_1.shape[-1]).to(pd_1.dtype)).sum(-1)
    nll = -p  # the reference's NLL applied to probabilities
    w = torch.sigmoid(weight_1[..., 0])
    return _masked_mean((nll * w) ** 2 + (1.0 - w) ** 2, crop_mask)


def second_seg_loss(pd_2, weight_1, gt_bin, crop_mask=None):
    """pd_2 ``[K, S, 1]`` logits."""
    z = pd_2[..., 0]
    y = gt_bin.to(z.dtype)
    bce = torch.clamp_min(z, 0) - z * y + torch.log1p(torch.exp(-z.abs()))
    w = torch.sigmoid(weight_1[..., 0])
    return _masked_mean((2.0 - w) * bce, crop_mask)


def id_loss(id_pred, gt_ids, crop_valid=None):
    """id_pred ``[K, 17]`` logits; gt_ids ``[K]`` in 0..16."""
    logp = F.log_softmax(id_pred, dim=-1)
    ce = -(logp * F.one_hot(gt_ids.long(), logp.shape[-1]).to(logp.dtype)).sum(-1)
    return _masked_mean(ce, crop_valid)
