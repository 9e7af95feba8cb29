"""Offline preprocessing: FDI label remap, normalization, FPS to 24k points
(counterpart of toothgroupnetwork_tpu/data/preprocess.py, held bit-equal to
it by the tests).

  * FDI remap: lower-jaw labels -20; decade-1 labels (11-18) -> 1-8 via %10;
    decade-2 labels (21-28) -> 9-16 via %10+8; negatives -> 0 (gingiva).
    Result: 0 = gingiva, 1..16 = teeth.
  * Normalization: center xyz by mean, then map all three axes through the
    FIXED global constants ``(x - Y_AXIS_MIN) / (Y_AXIS_MAX - Y_AXIS_MIN) * 2 - 1``.
  * FPS to exactly ``N_POINTS`` points when the scan is larger, through the
    port's ``farthest_point_sample`` on ``device`` (K1 on the card). Scans
    with no more vertices are PADDED to ``N_POINTS`` with a saved
    ``n_valid`` count.
  * Output: ``<base>_<jaw>_sampled_points.npy`` of shape (N_POINTS, 7)
    float32: xyz + normal + class label. ``base`` is the obj's name, which
    already holds the jaw; the boundary engine's case name (its first two
    ``_`` fields) depends on that name.

torch is imported only where the FPS runs, so the data package imports
without it.
"""

from __future__ import annotations

import json
import os

import numpy as np

from .mesh_io import load_mesh_arr

# Fixed global normalization constants.
Y_AXIS_MAX = 33.15232091532151
Y_AXIS_MIN = -36.9843781139949

N_POINTS = 24000


def fdi_to_class(labels: np.ndarray, jaw: str) -> np.ndarray:
    """FDI tooth numbers (11-48) -> class ids 0..16 (0 = gingiva)."""
    labels = np.asarray(labels).copy().astype(np.int64)
    if jaw == "lower":
        labels = labels - 20
    dec1 = labels // 10 == 1
    labels[dec1] = labels[dec1] % 10
    dec2 = labels // 10 == 2
    labels[dec2] = labels[dec2] % 10 + 8
    labels[labels < 0] = 0
    return labels


def class_to_fdi(labels: np.ndarray, jaw: str) -> np.ndarray:
    """Inverse remap: class ids 0..16 -> FDI numbers (0 stays 0 = gingiva):
    ``>= 9 -> +2``, then ``> 0 -> +10``, plus 20 on the lower jaw."""
    labels = np.asarray(labels).copy().astype(np.int64)
    labels[labels >= 9] += 2
    labels[labels > 0] += 10
    if jaw == "lower":
        labels[labels > 0] += 20
    return labels


def normalize_vertices(xyz: np.ndarray) -> np.ndarray:
    """Center by mean, scale by the fixed global constants to ~[-1, 1]."""
    xyz = np.asarray(xyz, dtype=np.float64)
    xyz = xyz - xyz.mean(axis=0)
    return (xyz - Y_AXIS_MIN) / (Y_AXIS_MAX - Y_AXIS_MIN) * 2.0 - 1.0


def fps_indices(xyz: np.ndarray, m: int, device) -> np.ndarray:
    """FPS of the float32 cast of ``xyz`` ``[N, 3]`` on ``device``:
    int32 ``[m]`` on the host."""
    import torch

    from ..ops import farthest_point_sample

    pts = torch.from_numpy(np.ascontiguousarray(xyz, dtype=np.float32))
    return farthest_point_sample(pts.to(device), m).cpu().numpy()


def resample_pcd(arr: np.ndarray, n: int, method: str = "fps",
                 rng: np.random.Generator | None = None,
                 device="cuda") -> np.ndarray:
    """Drop points so the cloud has exactly ``n``: a uniform permutation
    from ``rng``, or FPS on ``device``."""
    if method == "uniformly":
        rng = rng or np.random.default_rng()
        idx = rng.permutation(arr.shape[0])
    elif method == "fps":
        idx = fps_indices(arr[:, :3], n, device)
    else:
        raise ValueError(f"unknown resample method {method!r}")
    return arr[idx[:n]]


def preprocess_scan(obj_path: str, json_path: str | None = None, device="cuda"):
    """Full preprocessing of one scan: load mesh, remap labels, normalize,
    FPS to ``N_POINTS`` on ``device``.

    Returns ``(arr [N_POINTS, 7], n_valid, jaw)``; when ``json_path`` is None
    (an unlabeled scan) the label column is -1.
    """
    mesh_arr = load_mesh_arr(obj_path)  # (N, 6) xyz+normal
    n = mesh_arr.shape[0]

    jaw = None
    if json_path is not None:
        with open(json_path) as f:
            meta = json.load(f)
        jaw = meta["jaw"]
        labels = fdi_to_class(np.asarray(meta["labels"]), jaw).reshape(-1, 1)
        if labels.shape[0] != n:
            raise ValueError(
                f"label count {labels.shape[0]} != vertex count {n} in {obj_path}")
    else:
        labels = np.full((n, 1), -1, dtype=np.int64)

    mesh_arr = mesh_arr.copy()
    mesh_arr[:, :3] = normalize_vertices(mesh_arr[:, :3])
    arr = np.concatenate([mesh_arr, labels.astype(np.float64)], axis=1)

    if arr.shape[0] > N_POINTS:
        arr = resample_pcd(arr, N_POINTS, "fps", device=device)
        n_valid = N_POINTS
    else:
        n_valid = arr.shape[0]
        pad = np.zeros((N_POINTS - n_valid, arr.shape[1]))  # labels read as gingiva
        arr = np.concatenate([arr, pad], axis=0)
    return arr.astype(np.float32), n_valid, jaw


def preprocess_dir(source_obj_path: str, source_json_path: str, save_path: str,
                   verbose: bool = True, device="cuda") -> int:
    """Find the obj files in the subdirectories of ``source_obj_path``,
    match each json by basename, preprocess, save one npy each (and a
    ``.meta.json`` with ``n_valid`` for a padded scan). Returns the count."""
    os.makedirs(save_path, exist_ok=True)
    obj_paths = []
    for dirpath, _, files in os.walk(source_obj_path):
        if dirpath == source_obj_path:
            continue
        obj_paths += [os.path.join(dirpath, f) for f in sorted(files)
                      if f.endswith(".obj")]
    json_map = {}
    for dirpath, _, files in os.walk(source_json_path):
        if dirpath == source_json_path:
            continue
        for f in files:
            if f.endswith(".json"):
                json_map[f.split(".")[0]] = os.path.join(dirpath, f)

    count = 0
    for i, obj_path in enumerate(obj_paths):
        base = os.path.basename(obj_path).split(".")[0]
        arr, n_valid, jaw = preprocess_scan(obj_path, json_map[base], device)
        out = os.path.join(save_path, f"{base}_{jaw}_sampled_points.npy")
        np.save(out, arr)
        if n_valid < N_POINTS:
            with open(out[:-4] + ".meta.json", "w") as f:
                json.dump({"n_valid": int(n_valid)}, f)
        count += 1
        if verbose:
            print(f"[{i}] {base} ({jaw}, n_valid={n_valid}) -> {out}")
    return count
