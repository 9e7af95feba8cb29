"""Shared inference-time mesh preparation (counterpart of
toothgroupnetwork_tpu/pipelines/base.py, its exact route).

The tgnet pipeline's host prep (obj parse, dedup, per-scan normalisation,
normals, subdivision) is ``data.scan_prep``; the other families' prep
(:func:`prep_mesh_feats`, no dedup, as in the JAX package) is here. The
farthest point sampling down to the model's point count runs through K1
(ops/kernels/fps.py) on ``device``; the final label transfer to every
original vertex is a host KD-tree 1-NN (:func:`nn_upsample`).
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.spatial import cKDTree

from ..data.mesh_io import compute_vertex_normals, parse_obj, subdivide_midpoint
from ..data.scan_prep import N_SAMPLE, normalize_scan_vertices
from ..ops import farthest_point_sample
from ..utils import profiling


def prep_mesh_feats(stl_path: str, n_sample: int = N_SAMPLE):
    """Host mesh prep without the FPS: ``(org_feats [N0, 6], feats [N, 6])``
    float32, the original vertices' xyz + normals (the 1-NN targets) and
    the FPS source, midpoint-subdivided once when the mesh has fewer than
    ``n_sample`` vertices."""
    vertices, faces = parse_obj(stl_path)
    vertices = normalize_scan_vertices(vertices)
    normals = compute_vertex_normals(vertices, faces)
    org_feats = np.concatenate([vertices, normals], axis=1)
    if vertices.shape[0] < n_sample:
        vertices, faces = subdivide_midpoint(vertices, faces, 1)
        normals = compute_vertex_normals(vertices, faces)
    feats = np.concatenate([vertices, normals], axis=1)
    return org_feats.astype(np.float32), feats.astype(np.float32)


def prep_mesh(stl_path: str, n_sample: int = N_SAMPLE, *, device):
    """``(org_feats [N0, 6], sampled [n_sample, 6])``: the 1-NN targets and
    the model input, FPS-sampled through K1 on ``device``."""
    org_feats, feats = prep_mesh_feats(stl_path, n_sample)
    return org_feats, fps_sample(feats, n_sample, device=device)


def sample_on_device(feats: np.ndarray, n: int, device):
    """``(feats_dev [n, 6] on device, sampled [n, 6] host)``: the FPS rows
    gathered on the card (K1 seeded at point 0; a cloud of at most ``n``
    rows is repeated instead), and their host copy from the fetched
    indices."""
    src = torch.from_numpy(np.ascontiguousarray(feats, np.float32)).to(device)
    n0 = feats.shape[0]
    if n0 <= n:
        idx = torch.arange(n0, device=src.device).repeat(-(-n // n0))[:n]
    else:
        idx = farthest_point_sample(src[:, :3], n).long()
    return src[idx], feats[profiling.fetch(idx).numpy()]


def nn_upsample(values: np.ndarray, source_xyz: np.ndarray,
                target_xyz: np.ndarray) -> np.ndarray:
    """1-NN label transfer from the sampled points to the original
    vertices (a host KD-tree)."""
    _, nearest = cKDTree(source_xyz).query(target_xyz, k=1, workers=-1)
    return np.asarray(values).reshape(-1)[nearest]


def fps_sample_idx(xyz: np.ndarray, n: int, *, device) -> np.ndarray:
    """Exact FPS indices (seeded at point 0) of a host cloud ``[N0, 3]``,
    ``n <= N0``, computed on ``device``."""
    if n == 0:
        return np.zeros(0, np.int64)
    pts = torch.from_numpy(np.ascontiguousarray(xyz[:, :3], np.float32)).to(device)
    return profiling.fetch(farthest_point_sample(pts, n)).numpy().astype(np.int64)


def fps_sample(feats: np.ndarray, n: int, *, device) -> np.ndarray:
    """FPS down to ``n`` rows; a cloud with fewer rows is repeated instead."""
    return sample_on_device(feats, n, device)[1]


def class_logits_to_fdi(cls_ids: np.ndarray) -> np.ndarray:
    """Class ids 0..16 -> FDI numbers without the jaw offset
    (``>= 9 -> +2`` then ``> 0 -> +10``)."""
    out = np.asarray(cls_ids).copy()
    out[out >= 9] += 2
    out[out > 0] += 10
    return out
