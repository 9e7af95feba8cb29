"""Boundary-aware resampling (counterpart of
toothgroupnetwork_tpu/postprocess/boundary.py:boundary_sampled_feats on its
host-purity route).

Given instance labels on the sampled cloud: label every full-resolution
vertex by its nearest sampled point, score each vertex's 40-NN label purity
on a host KD-tree, mark vertices below ``bdl_ratio`` (0.7) as boundary, and
build a boundary-focused cloud of ``num_bdl_points`` uniformly drawn boundary
vertices plus an FPS fill of the rest (K1 on ``device``). With
``spatial_sort`` each of the two blocks is spatially sorted on its own, for
the cell-attention path.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree

from ..ops.cells import spatial_sort_perm
from ..pipelines.base import fps_sample_idx
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


def boundary_sampled_feats(point_labels: np.ndarray, org_feats: np.ndarray,
                           sampled_feats: np.ndarray, bdl_ratio: float = 0.7,
                           num_bdl_points: int = 20000,
                           num_all_points: int = 24000,
                           rng: np.random.Generator | None = None,
                           spatial_sort: bool = False, *, device):
    """Returns (feats [num_all_points, 6] f32, pseudo_labels [num_all_points],
    n_boundary, nn1_idx [N], nn1_d2 [N]): boundary points first, then the
    FPS fill. ``nn1_idx``/``nn1_d2`` are each vertex's nearest sampled point
    and its squared distance, reused by the pipeline's final transfer.
    ``spatial_sort`` sorts within each block, so the boundary points stay
    first (the ``[:n_boundary]`` contract)."""
    rng = rng or np.random.default_rng(0)
    k = min(40, sampled_feats.shape[0])
    bd_mask, ps_labels, nn1_idx, nn1_d2 = boundary_purity(
        org_feats[:, :3].astype(np.float32), sampled_feats[:, :3],
        point_labels, k, bdl_ratio)

    bd_feats = org_feats[bd_mask]
    bd_labels = ps_labels[bd_mask]
    # uniform resample of the boundary points (truncates when there are more)
    perm = rng.permutation(bd_feats.shape[0])[:num_bdl_points]
    bd_feats, bd_labels = bd_feats[perm], bd_labels[perm]

    need = num_all_points - bd_feats.shape[0]
    non_bd_feats = org_feats[~bd_mask]
    non_bd_labels = ps_labels[~bd_mask]
    if non_bd_feats.shape[0] > need:
        idx = fps_sample_idx(non_bd_feats[:, :3], need, device=device)
    else:
        # not enough non-boundary points: all of them, then uniform repeats
        reps = rng.integers(0, max(non_bd_feats.shape[0], 1),
                            need - non_bd_feats.shape[0])
        idx = np.concatenate([np.arange(non_bd_feats.shape[0]), reps])
    non_bd_feats, non_bd_labels = non_bd_feats[idx], non_bd_labels[idx]

    if spatial_sort:
        if bd_feats.shape[0]:
            o = spatial_sort_perm(bd_feats[:, :3])
            bd_feats, bd_labels = bd_feats[o], bd_labels[o]
        if non_bd_feats.shape[0]:
            o = spatial_sort_perm(non_bd_feats[:, :3])
            non_bd_feats, non_bd_labels = non_bd_feats[o], non_bd_labels[o]

    feats = np.concatenate([bd_feats, non_bd_feats], axis=0)
    labels = np.concatenate([bd_labels, non_bd_labels], axis=0)
    return (feats.astype(np.float32), labels, bd_feats.shape[0], nn1_idx,
            nn1_d2)
