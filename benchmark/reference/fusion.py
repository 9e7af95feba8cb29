"""Label fusion: half-arch → full-arch disambiguation + boundary-cluster merge
(a frozen copy of the port's ``postprocess/fusion.py`` for the benchmark's
plain tgnet reference, with the PCA of the arch plane in numpy):

  * stage 1 predicts 9+1 HALF-arch classes (left/right merged); the full 16-class
    labeling is recovered geometrically: PCA over the instance centroids gives the
    arch plane, its normal oriented from gingiva toward teeth; the central-incisor
    midpoint (sem classes 1/9) anchors a center line; the cross product gives the
    left/right test axis. Instances whose centroid falls on the negative side get
    ``label + 8`` (the left arch), except central incisors (classes 1/9),
  * each boundary-stage instance cluster is relabeled to the stage-1 instance its
    points are 1-NN-closest to, inheriting that instance's semantic label.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree

from .clustering import pca_components


def disambiguate_arch_labels(first_xyz: np.ndarray, first_ps_label: np.ndarray,
                             first_sem_label: np.ndarray) -> np.ndarray:
    """Returns per-point full-arch semantic labels (0..16) for the sampled cloud.

    Args:
      first_xyz: [N, 3]; first_ps_label: [N] instance ids (0 = bg);
      first_sem_label: [N] half-arch classes (0..9).
    May also zero out instances with no semantic majority (reference :97-101
    clears both labels); mutates ``first_ps_label`` in place accordingly.
    """
    ins_ids = np.unique(first_ps_label)
    ins_ids = ins_ids[ins_ids != 0]
    if ins_ids.size == 0:
        return np.zeros(len(first_ps_label), dtype=np.int64)
    centers = np.array([first_xyz[first_ps_label == i].mean(axis=0)
                        for i in ins_ids])

    if ins_ids.size < 3 or (first_ps_label == 0).sum() == 0:
        # degenerate scan: too few instances for a PCA arch plane — keep the
        # per-instance majority half labels without left/right correction
        new_sem = np.zeros(len(first_ps_label), dtype=np.int64)
        for ins_id in ins_ids:
            m = first_ps_label == ins_id
            sem_in = first_sem_label[m]
            sem_in = sem_in[sem_in != 0]
            if sem_in.shape[0] == 0:
                first_ps_label[m] = 0
                continue
            new_sem[m] = int(np.argmax(np.bincount(sem_in.astype(int))))
        return new_sem

    gin_mean = first_xyz[first_ps_label == 0].mean(axis=0)
    teeth_mean = first_xyz[first_ps_label != 0].mean(axis=0)
    pca_axis = pca_components(centers)
    if np.dot(teeth_mean - gin_mean, pca_axis[2]) <= 0:
        pca_axis[2] = -pca_axis[2]

    # central-incisor anchor (classes 1 and 9 = FDI 11/21-ish midpoint, :78-86)
    n_incisor = (first_sem_label == 1).sum() + (first_sem_label == 9).sum()
    cp_11_12 = None
    if n_incisor > 20:
        cp_11_12 = np.mean([first_xyz[first_sem_label == 1].mean(axis=0),
                            first_xyz[first_sem_label == 9].mean(axis=0)], axis=0)
    else:
        for i in range(2, 9):
            if (first_sem_label == i).sum() > 20:
                cp_11_12 = np.mean([first_xyz[first_sem_label == i].mean(axis=0),
                                    centers.mean(axis=0)], axis=0)
                break
    if cp_11_12 is None:
        cp_11_12 = centers.mean(axis=0)

    center_line = cp_11_12 - centers.mean(axis=0)
    checking_axis = np.cross(pca_axis[2], center_line)

    new_sem = np.zeros(len(first_ps_label), dtype=np.int64)
    for ins_id in ins_ids:
        m = first_ps_label == ins_id
        sem_in = first_sem_label[m]
        sem_in = sem_in[sem_in != 0]
        if sem_in.shape[0] == 0:
            new_sem[m] = 0
            first_ps_label[m] = 0
            continue
        lab = int(np.argmax(np.bincount(sem_in.astype(int))))
        if lab not in (1, 9):
            ins_center = first_xyz[m].mean(axis=0)
            if np.dot(ins_center - cp_11_12, checking_axis) < 0:
                lab += 8
        new_sem[m] = lab
    return new_sem


def merge_boundary_clusters(first_xyz: np.ndarray, first_ps_label: np.ndarray,
                            new_sem_labels: np.ndarray, bdl_xyz: np.ndarray,
                            bdl_ps_label: np.ndarray):
    """Relabel each boundary instance cluster by the 1-NN-majority stage-1 instance
    (reference :107-126). Returns (mod_bdl_ps, mod_bdl_sem)."""
    tree = cKDTree(first_xyz)
    mod_ps = np.zeros(len(bdl_ps_label), dtype=np.int64)
    mod_sem = np.zeros(len(bdl_ps_label), dtype=np.int64)
    for lab in np.unique(bdl_ps_label):
        if lab == 0:
            continue
        m = bdl_ps_label == lab
        _, nn = tree.query(bdl_xyz[m], k=1)
        first_ids = first_ps_label[nn.reshape(-1)]
        maj = int(np.argmax(np.bincount(first_ids.astype(int))))
        ins_mask = first_ps_label == maj
        sems = np.unique(new_sem_labels[ins_mask])
        assert sems.shape[0] <= 1 or maj == 0, "sem label error"
        sem = int(sems[0]) if sems.size else 0
        mod_ps[m] = maj
        mod_sem[m] = sem
    return mod_ps, mod_sem
