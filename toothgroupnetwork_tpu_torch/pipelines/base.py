"""Shared inference-time mesh sampling (counterpart of
toothgroupnetwork_tpu/pipelines/base.py, its exact route).

The host mesh prep (obj parse, dedup, per-scan normalisation, normals,
subdivision) is the JAX package's JAX-free ``data.scan_prep``; this module
adds the farthest point sampling down to the model's point count, which runs
through K1 (ops/kernels/fps.py) on ``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import farthest_point_sample


def fps_sample_idx(xyz: np.ndarray, n: int, *, device) -> np.ndarray:
    """Exact FPS indices (seeded at point 0) of a host cloud ``[N0, 3]``,
    ``n <= N0``, computed on ``device``."""
    if n == 0:
        return np.zeros(0, np.int64)
    pts = torch.from_numpy(np.ascontiguousarray(xyz[:, :3], np.float32)).to(device)
    return farthest_point_sample(pts, n).cpu().numpy().astype(np.int64)


def fps_sample(feats: np.ndarray, n: int, *, device) -> np.ndarray:
    """FPS down to ``n`` rows; a cloud with fewer rows is repeated instead."""
    if feats.shape[0] <= n:
        reps = -(-n // feats.shape[0])
        return np.concatenate([feats] * reps, axis=0)[:n]
    return feats[fps_sample_idx(feats[:, :3], n, device=device)]


def class_logits_to_fdi(cls_ids: np.ndarray) -> np.ndarray:
    """Class ids 0..16 -> FDI numbers without the jaw offset
    (``>= 9 -> +2`` then ``> 0 -> +10``)."""
    out = np.asarray(cls_ids).copy()
    out[out >= 9] += 2
    out[out > 0] += 10
    return out
