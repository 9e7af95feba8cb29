"""Mesh IO for the inference scan prep, the offline preprocessing and the
boundary engine: .obj parsing, area-weighted vertex normals, the
``[N, 6]`` feature array, midpoint subdivision (counterpart of
toothgroupnetwork_tpu/data/mesh_io.py, same arithmetic).

Vertex normals follow open3d's ``compute_vertex_normals``: unnormalised
(area-weighted) face normals, scatter-added to the three corners, then
L2-normalised per vertex.
"""

from __future__ import annotations

import numpy as np

from .fast_obj import parse_obj_fast


def parse_obj(path: str) -> tuple[np.ndarray, np.ndarray]:
    """``(vertices [N, 3] float64, faces [F, 3] int64, 0-based)`` of a
    Wavefront .obj: the native parser where ``native/libfast_obj.so`` loads,
    else :func:`parse_obj_numpy`."""
    fast = parse_obj_fast(path)
    if fast is not None:
        return fast
    return parse_obj_numpy(path)


def parse_obj_numpy(path: str) -> tuple[np.ndarray, np.ndarray]:
    """The Python parser: ``v x y z`` lines and ``f`` lines in the forms
    ``f a b c``, ``f a//n ...`` and ``f a/t/n ...`` (first three indices)."""
    verts, faces = [], []
    with open(path) as f:
        for raw in f:
            line = raw.split()
            if not line:
                continue
            if line[0] == "v":
                verts.append((float(line[1]), float(line[2]), float(line[3])))
            elif line[0] == "f":
                faces.append([int(tok.split("/")[0]) for tok in line[1:4]])
    vertices = np.asarray(verts, dtype=np.float64)
    faces_arr = (np.asarray(faces, dtype=np.int64) - 1 if faces
                 else np.zeros((0, 3), np.int64))
    return vertices, faces_arr


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


def load_mesh_arr(path: str, return_faces: bool = False):
    """``[N, 6]`` float64 xyz + unit vertex normals of an .obj (the
    preprocessing's and the boundary engine's feature layout), and with
    ``return_faces`` its faces beside them."""
    vertices, faces = parse_obj(path)
    arr = np.concatenate([vertices, compute_vertex_normals(vertices, faces)], axis=1)
    return (arr, faces) if return_faces else arr


def subdivide_midpoint(vertices: np.ndarray, faces: np.ndarray,
                       n_iter: int = 1):
    """Midpoint subdivision (open3d ``subdivide_midpoint``): each triangle
    splits into four at its edge midpoints, shared between faces; new
    vertices are numbered in order of first use."""
    for _ in range(n_iter):
        edges: dict[tuple[int, int], int] = {}
        n0 = len(vertices)

        def midpoint_id(a: int, b: int) -> int:
            key = (a, b) if a < b else (b, a)
            if key not in edges:
                edges[key] = n0 + len(edges)
            return edges[key]

        new_faces = np.empty((len(faces) * 4, 3), dtype=np.int64)
        for i, (a, b, c) in enumerate(faces):
            ab, bc, ca = midpoint_id(a, b), midpoint_id(b, c), midpoint_id(c, a)
            new_faces[4 * i:4 * i + 4] = ((a, ab, ca), (ab, b, bc),
                                          (bc, c, ca), (ab, bc, ca))
        mids = np.empty((len(edges), 3), dtype=vertices.dtype)
        for (a, b), mid in edges.items():
            mids[mid - n0] = (vertices[a] + vertices[b]) / 2.0
        vertices = np.concatenate([vertices, mids], axis=0)
        faces = new_faces
    return vertices, faces
