"""Semantic segmentation losses (counterpart of
toothgroupnetwork_tpu/losses/seg_loss.py): the cross-entropy with the
reference's +1 label shift (gingiva -1 -> class 0), optionally
label-smoothed or class-weighted, averaged over the valid points only; and
the PointNet feature-transform regulariser."""

from __future__ import annotations

import torch
from torch.nn import functional as F

from ..parallel import data_parallel


def tooth_class_loss(logits: torch.Tensor, labels: torch.Tensor, num_classes: int,
                     mask: torch.Tensor | None = None,
                     weight: torch.Tensor | None = None,
                     label_smoothing: float | None = None) -> torch.Tensor:
    """Cross-entropy of ``logits`` ``[..., N, num_classes]`` against ``labels``
    ``[..., N]`` in -1..num_classes-2, shifted by +1 and clipped.

    ``weight``: per-class weights (weighted mean sum w_y ce / sum w_y).
    ``label_smoothing``: off-target mass smoothing / (num_classes - 1),
    on-target 1 - smoothing, a plain mean over the valid points (class
    weights do not apply). ``mask``: ``[..., N]`` validity."""
    labels = torch.clamp(labels.long() + 1, 0, num_classes - 1)
    logp = F.log_softmax(logits, dim=-1)
    onehot = F.one_hot(labels, num_classes).to(logp.dtype)
    if label_smoothing is not None:
        conf = 1.0 - label_smoothing
        off = label_smoothing / (num_classes - 1)
        ce = -(onehot * (conf - off) + off).mul(logp).sum(dim=-1)
        if mask is None:
            return data_parallel.mean(ce)
        m = mask.to(ce.dtype)
        return data_parallel.ratio((ce * m).sum(), m.sum(), 1.0)
    # the log-probability of the label as a one-hot product: exact, and its
    # backward is elementwise (no scatter)
    ce = -(onehot * logp).sum(dim=-1)
    w = (torch.ones_like(ce) if weight is None
         else torch.as_tensor(weight, dtype=ce.dtype, device=ce.device)[labels])
    if mask is not None:
        w = w * mask.to(ce.dtype)
    return data_parallel.ratio((ce * w).sum(), w.sum(), 1e-8)


def feature_transform_regularizer(trans: torch.Tensor) -> torch.Tensor:
    """``mean_b ||I - T T^T||_F`` over a batch of ``[B, d, d]`` transforms.

    A mean of per-cloud values over this rank's equal slice of the batch:
    the data-parallel step's mean over the ranks makes it the global mean,
    value and gradient (``parallel/data_parallel.py``), so it needs no
    collective of its own."""
    eye = torch.eye(trans.shape[-1], dtype=trans.dtype, device=trans.device)
    diff = trans @ trans.transpose(-1, -2) - eye
    return torch.sqrt((diff * diff).sum(dim=(-2, -1)) + 1e-12).mean()
