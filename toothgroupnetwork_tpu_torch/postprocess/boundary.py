"""Boundary-aware resampling (counterpart of
toothgroupnetwork_tpu/postprocess/boundary.py:boundary_sampled_feats).

Given instance labels on the sampled cloud: label every full-resolution
vertex by its nearest sampled point, score each vertex's 40-NN label purity,
mark vertices below ``bdl_ratio`` (0.7) as boundary, and build a
boundary-focused cloud of ``num_bdl_points`` uniformly drawn boundary
vertices plus an FPS fill of the rest. With ``spatial_sort`` each of the two
blocks is spatially sorted on its own, for the cell-attention path.

Two routes, the same contract, the pipeline taking the device route on a
CUDA device and the host route on the CPU:

* the host route: the purity on a host KD-tree, the fill through K1 on the
  compacted non-boundary subset (the JAX package's CPU route);
* the device route: the purity through K2 on the device
  (:func:`boundary_purity_device`, the counterpart of ``_purity_device_fn``
  with exact selection) and the fill through one masked K1 launch over the
  whole cloud (the counterpart of ``_masked_fps``), which selects exactly
  the points FPS of the compacted subset selects: the same seed (the first
  valid point) and the same argmax, ties to the lower index. The boundary
  draw, the repeat branch and the sorts stay on the host with the same
  ``rng`` draws, so both routes build the same cloud from the same mask.

The routes agree up to distance near-ties: the KD-tree ranks in float64, K2
in float32, so a 1-NN may swap only between points at equal distance, a
40-set only at its 40th place, and so the mask only where the ratio lies
within 2.5/40 of ``bdl_ratio``.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.spatial import cKDTree

from ..ops import farthest_point_sample, knn_points
from ..ops.cells import spatial_sort_perm
from ..ops.distance import _dot_fixed
from ..pipelines.base import fps_sample_idx
from ..utils import profiling
from .clustering import first_label_ratio


def boundary_purity(org_xyz: np.ndarray, sampled_xyz: np.ndarray,
                    point_labels: np.ndarray, k: int, bdl_ratio: float):
    """Returns (boundary mask [N], 1-NN label [N], 1-NN index [N],
    1-NN squared distance [N] f32)."""
    dist, nn = cKDTree(np.asarray(sampled_xyz)[:, :3]).query(org_xyz, k=k,
                                                             workers=-1)
    nn = np.atleast_2d(nn)
    dist = np.atleast_2d(dist)
    return (first_label_ratio(point_labels[nn]) < bdl_ratio,
            point_labels[nn[:, 0]],
            nn[:, 0], (dist[:, 0] ** 2).astype(np.float32))


def nearest_rescored(query: torch.Tensor, points: torch.Tensor, k: int):
    """The k nearest ``points`` ``[M, 3]`` of each query ``[N, 3]`` through
    K2 (``knn_points``: the kernel's exact selection, re-scored by direct
    subtraction and re-sorted, ties to the earlier candidate). Returns
    (idx int64 ``[N, k]``, the first's squared distance f32 ``[N]``, by
    the same subtraction)."""
    idx = knn_points(query, points, k)[0].long()
    delta = query - points[idx[:, 0]]
    return idx, _dot_fixed(delta, delta)


def boundary_purity_device(org_xyz: torch.Tensor, sampled_xyz: torch.Tensor,
                           labels: torch.Tensor, k: int, bdl_ratio: float):
    """Device counterpart of :func:`boundary_purity`: org ``[N, 3]`` and
    sampled ``[M, 3]`` f32, ``labels`` ``[M]`` integers, all on one device
    -> (boundary mask [N] bool, 1-NN label [N], 1-NN index [N] int64, 1-NN
    squared distance [N] f32), all on that device. The 1-NN is the nearest
    of the k by the exact float32 d2; the ratio is the k labels' share of
    the 1-NN label, in float64 as the host's ``first_label_ratio``."""
    org = org_xyz.to(torch.float32).contiguous()
    smp = sampled_xyz.to(torch.float32).contiguous()
    idx, nn1_d2 = nearest_rescored(org, smp, k)
    lab = labels[idx]
    ratio = (lab == lab[:, :1]).sum(dim=1).to(torch.float64) / k
    return ratio < bdl_ratio, lab[:, 0], idx[:, 0], nn1_d2


def boundary_sampled_feats(point_labels: np.ndarray, org_feats: np.ndarray,
                           sampled_feats: np.ndarray, bdl_ratio: float = 0.7,
                           num_bdl_points: int = 20000,
                           num_all_points: int = 24000,
                           rng: np.random.Generator | None = None,
                           spatial_sort: bool = False,
                           org_dev: torch.Tensor | None = None,
                           sampled_dev: torch.Tensor | None = None, *, device):
    """Returns (feats [num_all_points, 6] f32, pseudo_labels [num_all_points],
    n_boundary, nn1_idx [N], nn1_d2 [N], rows [num_all_points] int64):
    boundary points first, then the FPS fill. ``nn1_idx``/``nn1_d2`` are
    each vertex's nearest sampled point and its squared distance, reused by
    the pipeline's final transfer: host arrays on the host route, tensors
    left on the device on the device route. ``rows`` is each output row's
    index into ``org_feats``. ``spatial_sort`` sorts within each block, so
    the boundary points stay first (the ``[:n_boundary]`` contract).

    ``org_dev`` ``[N, >=3]``, the org cloud already on the device, selects
    the device route (module docstring), beside ``sampled_dev`` ``[M,
    >=3]`` (uploaded here when None); without it the host route runs."""
    rng = rng or np.random.default_rng(0)
    k = min(40, sampled_feats.shape[0])
    on_device = org_dev is not None
    if on_device:
        if sampled_dev is None:
            sampled_dev = torch.from_numpy(np.ascontiguousarray(
                sampled_feats[:, :3], np.float32)).to(org_dev.device)
        bd_dev, lab_dev, nn1_idx, nn1_d2 = boundary_purity_device(
            org_dev[:, :3], sampled_dev[:, :3],
            torch.from_numpy(np.asarray(point_labels)).to(org_dev.device),
            k, bdl_ratio)
        bd_mask, ps_labels = (profiling.fetch(bd_dev).numpy(),
                              profiling.fetch(lab_dev).numpy())
    else:
        bd_mask, ps_labels, nn1_idx, nn1_d2 = boundary_purity(
            org_feats[:, :3].astype(np.float32), sampled_feats[:, :3],
            point_labels, k, bdl_ratio)

    # uniform resample of the boundary points (truncates when there are more)
    bd_rows = np.flatnonzero(bd_mask)
    bd_rows = bd_rows[rng.permutation(bd_rows.shape[0])[:num_bdl_points]]

    need = num_all_points - bd_rows.shape[0]
    non_bd = np.flatnonzero(~bd_mask)
    if non_bd.shape[0] <= need:
        # not enough non-boundary points: all of them, then uniform repeats
        reps = rng.integers(0, max(non_bd.shape[0], 1), need - non_bd.shape[0])
        nb_rows = non_bd[np.concatenate([np.arange(non_bd.shape[0]), reps])]
    elif not on_device:
        nb_rows = non_bd[fps_sample_idx(org_feats[non_bd, :3], need,
                                        device=device)]
    elif need:
        nb_rows = profiling.fetch(farthest_point_sample(
            org_dev[:, :3], need, ~bd_dev)).numpy().astype(np.int64)
    else:
        nb_rows = non_bd[:0]

    if spatial_sort:
        if bd_rows.shape[0]:
            bd_rows = bd_rows[spatial_sort_perm(org_feats[bd_rows, :3])]
        if nb_rows.shape[0]:
            nb_rows = nb_rows[spatial_sort_perm(org_feats[nb_rows, :3])]

    rows = np.concatenate([bd_rows, nb_rows])
    return (org_feats[rows].astype(np.float32), ps_labels[rows],
            bd_rows.shape[0], nn1_idx, nn1_d2, rows)
