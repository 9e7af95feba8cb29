"""Host scan prep of the tgn inference pipeline (counterpart of
toothgroupnetwork_tpu/data/scan_prep.py, same arithmetic): obj parse,
vertex dedup, per-scan y-extent normalisation, vertex normals, midpoint
subdivision of small meshes. The FPS sampling that follows runs on the
device (``pipelines/tgn.py``, K1).

The module's import closure is numpy only (no torch): ``run_many`` runs
the prep in spawned worker processes, which import this module and so never
touch the card.
"""

from __future__ import annotations

import numpy as np

from ..utils import profiling
from .mesh_io import compute_vertex_normals, parse_obj, subdivide_midpoint

# per-scan normalisation constants of the reference's tgn inference pipeline
SCALER = 1.8
SHIFTER = 0.8
N_SAMPLE = 24000


def warm_worker(_i: int = 0) -> bool:
    """Prep-pool warm-up target: a spawned worker pays its Python and numpy
    imports here, outside any batch's timing
    (``pipelines/tgn.py:TgnInferencePipeline._prep_pool``)."""
    return True


def normalize_scan_vertices(vertices: np.ndarray) -> np.ndarray:
    """Mean-centre, then scale every axis by this scan's y-extent:
    ``(v - min y) / (max y - min y) * 1.8 - 0.8``."""
    vertices = vertices - vertices.mean(axis=0)
    ymin, ymax = vertices[:, 1].min(), vertices[:, 1].max()
    return (vertices - ymin) / (ymax - ymin) * SCALER - SHIFTER


def dedup_vertices(vertices: np.ndarray, faces: np.ndarray):
    """Drop repeated vertex rows, keeping each first occurrence in its
    original order and remapping the faces (``np.unique(axis=0,
    return_index=True)`` semantics, -0.0 equal to 0.0).

    A mesh with no repeated rows is proven so by one row hash (distinct
    hashes imply distinct rows) and returned as it is; otherwise a stable
    3-key lexsort groups equal rows, the group head being the first
    occurrence."""
    n = vertices.shape[0]
    if n == 0:
        return vertices, faces
    canon = np.ascontiguousarray(vertices + 0.0)  # -0.0 -> +0.0
    bits = canon.view(np.uint64 if canon.itemsize == 8 else np.uint32)
    cols = [bits[:, c].astype(np.uint64) for c in range(3)]
    h = (cols[0] * np.uint64(0x9E3779B97F4A7C15)
         ^ cols[1] * np.uint64(0xC2B2AE3D27D4EB4F)
         ^ cols[2] * np.uint64(0x165667B19E3779F9))
    if len(np.unique(h)) == n:
        return vertices, faces
    order = np.lexsort((vertices[:, 2], vertices[:, 1], vertices[:, 0]))
    sv = vertices[order]
    is_head = np.empty(n, bool)
    is_head[0] = True
    np.any(sv[1:] != sv[:-1], axis=1, out=is_head[1:])
    group = np.cumsum(is_head) - 1               # group id per sorted row
    first_idx = order[is_head]                   # first occurrence per group
    out_order = np.argsort(first_idx)
    rank = np.empty_like(out_order)
    rank[out_order] = np.arange(len(out_order))
    inverse = np.empty(n, np.intp)               # original row -> group id
    inverse[order] = group
    new_faces = rank[inverse][faces] if faces.size else faces
    return vertices[np.sort(first_idx)], new_faces


def prep_scan_host_tgn(stl_path: str, n_sample: int = N_SAMPLE):
    """``(org_feats [N0, 6], bdl_feats [N1, 6])`` float32: the features of
    the deduplicated vertices (the targets of the final 1-NN transfer) and
    the source the device samples from, midpoint-subdivided once when the
    mesh has fewer than ``n_sample`` vertices. A ``scan_prep`` span on a
    thread that traces (``utils/profiling.py``)."""
    with profiling.span("scan_prep"):
        vertices, faces = parse_obj(stl_path)
        vertices, faces = dedup_vertices(vertices, faces)
        vertices = normalize_scan_vertices(vertices)
        normals = compute_vertex_normals(vertices, faces)
        org_feats = np.concatenate([vertices, normals], axis=1)
        if vertices.shape[0] < n_sample:
            sub_v, sub_f = subdivide_midpoint(vertices, faces, 1)
            bdl_feats = np.concatenate([sub_v, compute_vertex_normals(sub_v, sub_f)],
                                       axis=1)
        else:
            bdl_feats = org_feats.copy()
        return org_feats.astype(np.float32), bdl_feats.astype(np.float32)
