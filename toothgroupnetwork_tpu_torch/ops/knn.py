"""k-nearest neighbours (counterpart of toothgroupnetwork_tpu/ops/knn.py,
its exact route): the selection runs through K2 (``kernels/knn.py``); the
self-first dedup and the exact re-score are plain torch, as they are XLA
around the Pallas kernel in the JAX package. Inside the point-sharded
context (``parallel/points.py``) K2 selects for this rank's query rows
over the whole cloud, its coordinates (or DGCNN's features) and bias
all-gathered once (``parallel/ring.py:sharded_select``), on the route the
dense call takes, and the rest runs as here, with global indices."""

from __future__ import annotations

import torch

from ..parallel import points as point_shards
from .distance import _dot_fixed
from .gather import index_points
from .kernels.knn import knn_select, smallest_k

_BIG = 1e10

__all__ = ["knn", "knn_points", "knn_self", "smallest_k"]


def knn_points(query: torch.Tensor, points: torch.Tensor, k: int,
               q_mask: torch.Tensor | None = None,
               p_mask: torch.Tensor | None = None, *,
               include_self: bool = False, need_dist: bool = True):
    """Exact kNN from ``query`` ``[M, C]``/``[B, M, C]`` into ``points``
    (any C: xyz, or DGCNN's feature space).

    Masked points get d2 + 1e10 (a bias: they can still fill a row), ties go
    to the lower index, and for k > n the tail is index 0 at d2 = 1e10.
    ``q_mask`` is accepted for signature parity and not used (rows of invalid
    queries hold arbitrary in-range indices). ``include_self``: for
    self-queries, row i starts with i itself (distance 0) and its duplicate is
    dropped. ``need_dist``: re-score the selected neighbours by direct
    subtraction and re-sort; otherwise distances are the selection's.

    Returns ``(idx int32 [..., M, k], dist f32 [..., M, k])`` with Euclidean
    (sqrt) distances.
    """
    del q_mask
    squeeze = query.dim() == 2
    if squeeze:
        query, points = query[None], points[None]
        p_mask = None if p_mask is None else p_mask[None]
    query = query.to(torch.float32).contiguous()
    points = points.to(torch.float32).contiguous()
    b, m = query.shape[:2]
    n = points.shape[1]
    bias = None
    if p_mask is not None:
        bias = torch.where(p_mask.to(torch.bool), 0.0, _BIG).to(
            torch.float32).contiguous()
    mesh = point_shards.active()
    q_base = 0
    if mesh is None:
        idx, d2 = knn_select(query, points, k, bias)
    else:
        from ..parallel.ring import sharded_select

        n = point_shards.global_size(n)
        if include_self:
            q_base = point_shards.rows(point_shards.global_size(m), mesh)[0]
        idx, d2 = sharded_select(query, points, k, mesh, n, bias)
    keff = min(k, n)

    dup = None
    if include_self:
        qi = torch.clamp(torch.arange(q_base, q_base + m, device=idx.device), max=n - 1)
        self_col = qi.to(torch.int32)[None, :, None].expand(b, m, 1)
        dup = idx == self_col
        idx = torch.cat([self_col, idx], dim=-1)

    if need_dist:
        delta = query[:, :, None, :] - index_points(points, idx)
        d2s = _dot_fixed(delta, delta)
        if keff < k:
            # keep the k > n sentinel: a re-scored index 0 would sort forward
            pad = torch.arange(d2s.shape[-1], device=idx.device) >= (
                d2s.shape[-1] - (k - keff))
            d2s = torch.where(pad, _BIG, d2s)
        if include_self:
            d2s = torch.cat([d2s[..., :1],
                             torch.where(dup, _BIG, d2s[..., 1:])], dim=-1)
    else:
        d2s = torch.clamp_min(d2, 0.0)
        if include_self:
            d2s = torch.cat([torch.zeros_like(d2s[..., :1]),
                             torch.where(dup, _BIG, d2s)], dim=-1)

    if include_self and not need_dist:
        # [self] + the sorted candidates minus the first self duplicate (or
        # minus the last candidate when self is absent)
        any_dup = dup.any(dim=-1)
        dpos = torch.where(any_dup, dup.to(torch.uint8).argmax(dim=-1), k - 1)
        sel = torch.arange(k - 1, device=idx.device) >= dpos[..., None]
        cand_i = torch.where(sel, idx[..., 2:k + 1], idx[..., 1:k])
        cand_d = torch.where(sel, d2s[..., 2:k + 1], d2s[..., 1:k])
        idx = torch.cat([idx[..., :1], cand_i], dim=-1)
        d2o = torch.cat([d2s[..., :1], cand_d], dim=-1)
    elif include_self or need_dist:
        d2o, order = torch.sort(d2s, dim=-1, stable=True)
        d2o, order = torch.clamp_min(d2o[..., :k], 0.0), order[..., :k]
        idx = torch.gather(idx, -1, order)
    else:
        d2o = d2s
    pos = d2o > 0
    dist = torch.where(pos, torch.sqrt(torch.where(pos, d2o, 1.0)), 0.0)
    if squeeze:
        return idx[0], dist[0]
    return idx, dist


def knn_self(points: torch.Tensor, k: int, p_mask: torch.Tensor | None = None):
    """Per-stage self-kNN of the backbone: own index first, selection-precision
    distances (counterpart of the JAX package's flat ``knn_self``)."""
    return knn_points(points, points, k, p_mask, p_mask, include_self=True,
                      need_dist=False)


def knn(query: torch.Tensor, points: torch.Tensor, k: int,
        q_mask: torch.Tensor | None = None,
        p_mask: torch.Tensor | None = None, **kw):
    """Alias of :func:`knn_points` (the JAX package's name)."""
    return knn_points(query, points, k, q_mask, p_mask, **kw)
