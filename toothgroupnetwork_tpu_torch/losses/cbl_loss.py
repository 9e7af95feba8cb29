"""Contrastive Boundary Learning loss (counterpart of
toothgroupnetwork_tpu/losses/cbl_loss.py), per up-stage of the backbone:

  * sub-scene labels: the mean one-hot full-resolution label over each stage
    point's ``kr``-NN in the full-resolution cloud, ``kr = prod(stride[:i])``
    (stage 0 takes its one-hot labels as they are);
  * neighbourhood: the stage's attention kNN without its first (self) entry;
  * positives: neighbours whose argmax label (the first maximum on a tie)
    equals the point's; rows kept only with both positives and negatives;
  * the softnn contrast ``-log(sum exp(-d) pos / sum exp(-d))`` over l2
    latent distances, the max subtracted, temperature 1;
  * the mean over the kept rows, times 0.1.

The ``kr``-NN selection takes no gradient and runs through the kNN kernel
K2 at any ``kr`` (beyond 64 its any-size kernel; the JAX package computes
this selection outside any Pallas kernel)."""

from __future__ import annotations

import math

import torch
from torch.nn import functional as F

from ..ops import index_points, knn_points
from ..parallel import data_parallel

_EPS = 1e-12


def _subscene_knn(query, points, k, p_mask):
    """Indices ``[B, M, k]`` of the exact k nearest ``points`` of each query
    (masked points biased by 1e10, ties to the lower index)."""
    return knn_points(query, points, k, None, p_mask, need_dist=False)[0]


def cbl_loss_per_stage(cbl_stages: list[dict], target: torch.Tensor,
                       num_classes: int, stride, temperature: float = 1.0,
                       weight: float = 0.1) -> list[torch.Tensor]:
    """One scalar loss per up-stage. ``cbl_stages``: the backbone's dicts
    {p ``[B, Ni, 3]``, latent ``[B, Ni, C]``, mask ``[B, Ni]``, knn_idx
    ``[B, Ni, K]``}, stage 0 at full resolution; ``target`` ``[B, N]`` in
    -1..num_classes-2 (shifted +1)."""
    p0, m0 = cbl_stages[0]["p"], cbl_stages[0]["mask"]
    onehot0 = F.one_hot(target.long() + 1, num_classes).to(torch.float32)

    losses = []
    for i, st in enumerate(cbl_stages):
        if i == 0:
            labels = onehot0
        else:
            kr = int(math.prod(stride[:i]))
            idx = _subscene_knn(st["p"], p0, kr, m0)
            labels = index_points(onehot0, idx).mean(dim=2)       # [B,Ni,ncls]

        nb_idx = st["knn_idx"][..., 1:]                           # without self
        center_lab = labels.argmax(dim=-1)
        nb_lab = index_points(labels, nb_idx).argmax(dim=-1)      # [B,Ni,K-1]
        posmask = center_lab[..., None] == nb_lab

        k1 = posmask.shape[-1]
        pos_cnt = posmask.sum(dim=-1)
        point_mask = (pos_cnt > 0) & (pos_cnt < k1)
        if st["mask"] is not None:
            point_mask = point_mask & st["mask"].to(torch.bool)

        feats = st["latent"]
        diff = feats[..., None, :] - index_points(feats, nb_idx)  # [B,Ni,K-1,C]
        dist = torch.sqrt((diff * diff).sum(dim=-1) + _EPS)

        logits = -dist
        logits = logits - logits.amax(dim=-1, keepdim=True)
        if temperature is not None:
            logits = logits / temperature
        ex = torch.exp(logits)
        pos = (ex * posmask).sum(dim=-1)
        row_loss = -torch.log(pos / ex.sum(dim=-1) + _EPS)

        pm = point_mask.to(row_loss.dtype)
        losses.append(data_parallel.ratio((row_loss * pm).sum(), pm.sum(), 1.0) * weight)
    return losses


def cbl_loss(cbl_stages, target, num_classes, stride, temperature=1.0,
             weight=0.1) -> torch.Tensor:
    """The CBL summed over the up-stages."""
    return sum(cbl_loss_per_stage(cbl_stages, target, num_classes, stride,
                                  temperature, weight))
