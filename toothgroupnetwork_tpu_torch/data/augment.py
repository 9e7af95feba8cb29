"""Train-time augmentation on ``(N, 6)`` xyz+normal arrays (the transforms
and ``build_augmenter`` of toothgroupnetwork_tpu/data/augment.py, held
bit-equal to them by the tests).

Replaces the reference's ``augmentator.py`` (reference: augmentator.py:6-82) with the
same three composable transforms and semantics, but seeded ``np.random.Generator``
state instead of global numpy RNG, and data-driven construction instead of the
reference's ``eval()`` of a config string (train_config_maker.py:23, generator.py:32).

Semantics preserved:
  * Scaling: one uniform scalar from ``[lo, hi)`` multiplies xyz (augmentator.py:19-31).
  * Rotation: angle in DEGREES from ``[lo, hi)`` about a fixed z-axis, a random unit
    axis, or the cloud's PCA axes with random sign flips; normals rotate too
    (augmentator.py:33-68; axis-angle matrix per gen_utils.py:161-176). Applied as
    ``x' = (R @ x.T).T``.
  * Translation: per-axis uniform offset from ``[lo, hi)`` (augmentator.py:70-82).

``reload_vals`` draws fresh random parameters; ``run`` applies them. This split exists
because the BDL model re-applies the SAME augmentation to cached boundary-resampled
clouds (bdl_grouping_netowrk_model.py:185-188), so parameters must be reusable.
"""

from __future__ import annotations

import numpy as np


def axis_rotation_matrix(axis: np.ndarray, angle_deg: float) -> np.ndarray:
    """Rodrigues rotation matrix about ``axis`` by ``angle_deg`` degrees
    (gen_utils.py:161-176 contract)."""
    ang = np.radians(angle_deg)
    ux, uy, uz = axis
    c, s = np.cos(ang), np.sin(ang)
    return np.array([
        [c + ux * ux * (1 - c), ux * uy * (1 - c) - uz * s, ux * uz * (1 - c) + uy * s],
        [uy * ux * (1 - c) + uz * s, c + uy * uy * (1 - c), uy * uz * (1 - c) - ux * s],
        [uz * ux * (1 - c) - uy * s, uz * uy * (1 - c) + ux * s, c + uz * uz * (1 - c)],
    ])


class Scaling:
    def __init__(self, trans_range):
        self.trans_range = trans_range
        assert trans_range[1] > trans_range[0]
        self.trans_val = 1.0

    def reload_val(self, rng: np.random.Generator):
        lo, hi = self.trans_range
        self.trans_val = rng.random() * (hi - lo) + lo

    def augment(self, vert_arr: np.ndarray) -> np.ndarray:
        vert_arr[:, :3] = vert_arr[:, :3] * self.trans_val
        return vert_arr


class Rotation:
    def __init__(self, angle_range, angle_axis: str):
        self.angle_range = angle_range
        self.angle_axis = angle_axis
        assert angle_range[1] > angle_range[0]
        self.rot_val = 0.0
        self.angle_axis_val = np.array([0.0, 0.0, 1.0])
        self._flip = np.ones(3)

    def reload_val(self, rng: np.random.Generator):
        if self.angle_axis == "rand":
            v = rng.random(3)
            self.angle_axis_val = v / np.linalg.norm(v)
        elif self.angle_axis == "fixed":
            self.angle_axis_val = np.array([0.0, 0.0, 1.0])
        elif self.angle_axis == "pca":
            self._flip = (rng.random(3) > 0.5).astype(np.float64) * 2.0 - 1.0
        else:
            raise ValueError(f"rotation axis mode {self.angle_axis!r}")
        lo, hi = self.angle_range
        self.rot_val = rng.random() * (hi - lo) + lo

    def augment(self, vert_arr: np.ndarray) -> np.ndarray:
        if self.angle_axis == "pca":
            # PCA axes as the rotation matrix, each row sign-flipped at random
            # (augmentator.py:41-47).
            x = vert_arr[:, :3] - vert_arr[:, :3].mean(0)
            _, _, vt = np.linalg.svd(x, full_matrices=False)
            rot = vt * self._flip[:, None]
        else:
            rot = axis_rotation_matrix(self.angle_axis_val, self.rot_val)
        vert_arr[:, :3] = vert_arr[:, :3] @ rot.T
        if vert_arr.shape[1] >= 6:
            vert_arr[:, 3:6] = vert_arr[:, 3:6] @ rot.T
        return vert_arr


class Translation:
    def __init__(self, trans_range):
        self.trans_range = trans_range
        assert trans_range[1] > trans_range[0]
        self.trans_val = np.zeros((1, 3))

    def reload_val(self, rng: np.random.Generator):
        lo, hi = self.trans_range
        self.trans_val = rng.random((1, 3)) * (hi - lo) + lo

    def augment(self, vert_arr: np.ndarray) -> np.ndarray:
        vert_arr[:, :3] = vert_arr[:, :3] + self.trans_val
        return vert_arr


class Augmentator:
    """Composable augmentation pipeline (augmentator.py:6-17 contract)."""

    def __init__(self, augmentation_list):
        self.augmentation_list = list(augmentation_list)

    def reload_vals(self, rng: np.random.Generator):
        for a in self.augmentation_list:
            a.reload_val(rng)

    def run(self, mesh_arr: np.ndarray) -> np.ndarray:
        for a in self.augmentation_list:
            mesh_arr = a.augment(mesh_arr)
        return mesh_arr


def default_augmenter() -> Augmentator:
    """The reference's default train-time pipeline (train_config_maker.py:23):
    Scaling [0.85, 1.15], Rotation [-30, 30] deg about z, Translation [-0.2, 0.2]."""
    return Augmentator([
        Scaling([0.85, 1.15]),
        Rotation([-30, 30], "fixed"),
        Translation([-0.2, 0.2]),
    ])


_AUG_REGISTRY = {"scaling": Scaling, "rotation": Rotation, "translation": Translation}


def build_augmenter(specs) -> Augmentator | None:
    """Build from a data spec, e.g. ``[("scaling", [0.85, 1.15]),
    ("rotation", [-30, 30], "fixed"), ("translation", [-0.2, 0.2])]`` — the typed
    replacement for the reference's eval()-string configs."""
    if specs is None:
        return None
    augs = []
    for spec in specs:
        name, *args = spec
        augs.append(_AUG_REGISTRY[name.lower()](*args))
    return Augmentator(augs)
