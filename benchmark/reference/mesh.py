"""Host mesh prep of the tgnet reference: a frozen copy of the served
program's stated scan prep (obj parse, vertex dedup, per-scan y-extent
normalisation, area-weighted vertex normals), numpy only. The parser reads
the ``v``/``f`` lines the benchmark writes; a mesh of fewer vertices than
the model samples would also be subdivided by the program, which the
benchmark's meshes never are (``prep_scan`` refuses them)."""

from __future__ import annotations

import numpy as np

SCALER = 1.8
SHIFTER = 0.8


def parse_obj(path: str):
    """``(vertices [N, 3] float64, faces [F, 3] int64, 0-based)`` of an .obj
    whose lines are ``v x y z`` and ``f a b c``."""
    with open(path) as f:
        tok = np.array(f.read().split()).reshape(-1, 4)
    is_v = tok[:, 0] == "v"
    vertices = tok[is_v, 1:].astype(np.float64)
    faces = tok[tok[:, 0] == "f", 1:].astype(np.int64) - 1
    return vertices, faces


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


def compute_vertex_normals(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted unit vertex normals, float64 ``[N, 3]`` (zero for
    vertices no face references)."""
    n = vertices.shape[0]
    normals = np.zeros((n, 3), dtype=np.float64)
    if faces.shape[0]:
        v0, v1, v2 = (vertices[faces[:, i]] for i in range(3))
        e1, e2 = v1 - v0, v2 - v0
        fn = np.stack([e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1],
                       e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2],
                       e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]], axis=1)
        # one bincount per (corner, component): the same additions, in the
        # same order, as the JAX package's scatter
        for corner in range(3):
            fc = faces[:, corner]
            for c in range(3):
                normals[:, c] += np.bincount(fc, weights=fn[:, c], minlength=n)
    norm = np.linalg.norm(normals, axis=1, keepdims=True)
    return np.divide(normals, norm, out=np.zeros_like(normals), where=norm > 0)


def prep_scan(path: str, n_sample: int):
    """``feats [N, 6]`` float32 of the deduplicated, normalised vertices with
    their normals: the final transfer's targets and the FPS source."""
    vertices, faces = parse_obj(path)
    vertices, faces = dedup_vertices(vertices, faces)
    if vertices.shape[0] < n_sample:
        raise ValueError(f"{path}: {vertices.shape[0]} vertices, fewer than "
                         f"the {n_sample} the model samples")
    vertices = normalize_scan_vertices(vertices)
    normals = compute_vertex_normals(vertices, faces)
    return np.concatenate([vertices, normals], axis=1).astype(np.float32)
