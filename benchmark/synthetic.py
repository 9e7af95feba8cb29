"""Seeded synthetic jaw arches: the benchmark's scans and training cases.

An arch is a sheet meshed on an ``ns x nu`` grid (along and across the
arch) that follows the centreline ``(s, 0.9 s^2)``, with a Gaussian bump at
each of ``n_teeth`` tooth stations, mirrored left and right; every vertex
near a station carries its tooth's class (right 1..7, left 9 and 8 + p),
the rest gingiva 0. The seed moves the stations and the surface noise; the
sizes come from the traffic file, so every seed serves the same set of
sizes.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def arch_mesh(rng: np.random.Generator, ns: int, nu: int, n_teeth: int,
              scale: float = 40.0):
    """``(verts [ns*nu, 3] float32 in mm, faces [F, 3] int64, cls [V])``."""
    per_side = n_teeth // 2
    s_right = 0.12 + (0.86 / per_side) * np.arange(per_side)
    s_pos = np.concatenate([s_right, -s_right]) + rng.normal(0, 0.008, 2 * per_side)
    classes = np.concatenate([np.arange(1, per_side + 1),
                              np.array([9] + [8 + p for p in range(2, per_side + 1)])])
    r_bump, r_label, h = 0.062, 0.075, 0.14
    S, U = np.meshgrid(np.linspace(-1, 1, ns), np.linspace(-0.12, 0.12, nu),
                       indexing="ij")
    a = 0.9
    tnorm = np.sqrt(1 + (2 * a * S) ** 2)
    X = S + U * (-2 * a * S / tnorm)
    Y = a * S ** 2 + U / tnorm
    d2 = (S[..., None] - s_pos) ** 2 + U[..., None] ** 2          # [ns, nu, T]
    Z = (h * np.exp(-d2 / r_bump ** 2)).sum(-1) + rng.normal(0, 0.002, S.shape)
    near = d2.argmin(-1)
    cls = np.where(d2.min(-1) < r_label ** 2, classes[near], 0).reshape(-1)
    verts = (np.stack([X, Y, 0.35 * Z], -1).reshape(-1, 3) * scale).astype(np.float32)
    i, j = np.meshgrid(np.arange(ns - 1), np.arange(nu - 1), indexing="ij")
    v0 = (i * nu + j).reshape(-1)
    faces = np.stack([np.stack([v0, v0 + 1, v0 + nu], -1),
                      np.stack([v0 + 1, v0 + nu + 1, v0 + nu], -1)], 1).reshape(-1, 3)
    return verts, faces.astype(np.int64), cls.astype(np.int64)


def write_obj(path: Path, verts: np.ndarray, faces: np.ndarray) -> None:
    """``v``/``f`` lines, 1-based faces."""
    with open(path, "w") as fh:
        fh.write("v %.6f %.6f %.6f\n" * len(verts) % tuple(verts.astype(float).ravel()))
        fh.write("f %d %d %d\n" * len(faces) % tuple((faces + 1).ravel().tolist()))


def vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    a, b, c = (verts[faces[:, i]].astype(np.float64) for i in range(3))
    fn = np.cross(b - a, c - a)
    nrm = np.zeros((len(verts), 3))
    for i in range(3):
        for ax in range(3):
            nrm[:, ax] += np.bincount(faces[:, i], fn[:, ax], minlength=len(verts))
    return nrm / np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-12)


def write_case(path: Path, rng: np.random.Generator, ns: int, nu: int,
               n_teeth: int, n_points: int) -> None:
    """A preprocessed training case ``[n_points, 7]`` float32: xyz
    normalised as the scan prep does (centred, y-extent to [-0.8, 1.0]),
    unit normals and the class 0..16, ``n_points`` vertices drawn without
    repeats."""
    verts, faces, cls = arch_mesh(rng, ns, nu, n_teeth)
    nrm = vertex_normals(verts, faces)
    xyz = verts.astype(np.float64) - verts.mean(axis=0)
    y = xyz[:, 1]
    xyz = (xyz - y.min()) / (y.max() - y.min()) * 1.8 - 0.8
    rows = np.sort(rng.choice(len(verts), n_points, replace=False))
    arr = np.concatenate([xyz[rows], nrm[rows], cls[rows, None]], axis=1)
    np.save(path, arr.astype(np.float32))
