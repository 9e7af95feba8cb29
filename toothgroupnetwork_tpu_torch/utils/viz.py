"""Visualization exports (the port's copy of
toothgroupnetwork_tpu/utils/viz.py, numpy only, held byte-equal to it by the
tests).

The reference visualizes with open3d windows (gen_utils.py:79-147 ``print_3d`` /
``np_to_pcd_with_label`` / ``get_colored_mesh``); the equivalents write
standard ASCII PLY files viewable in any mesh tool. The label palette gives
each tooth class its own hue.
"""

from __future__ import annotations

import colorsys

import numpy as np


def label_palette(n: int = 33) -> np.ndarray:
    """Distinct RGB colors for labels 0..n−1 (0 = gingiva = light gray)."""
    colors = [(0.75, 0.75, 0.75)]
    for i in range(1, n):
        h = (i * 0.61803398875) % 1.0  # golden-ratio hue walk
        colors.append(colorsys.hsv_to_rgb(h, 0.75, 0.95))
    return (np.array(colors) * 255).astype(np.uint8)


def labels_to_colors(labels: np.ndarray) -> np.ndarray:
    pal = label_palette(int(np.max(labels)) + 1 if labels.size else 1)
    return pal[np.asarray(labels).astype(int)]


def write_ply(path: str, vertices: np.ndarray, colors: np.ndarray | None = None,
              faces: np.ndarray | None = None):
    """Write a (colored) point cloud or triangle mesh as ASCII PLY."""
    vertices = np.asarray(vertices, dtype=np.float32)
    n = len(vertices)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        if faces is not None:
            f.write(f"element face {len(faces)}\n"
                    "property list uchar int vertex_indices\n")
        f.write("end_header\n")
        if colors is not None:
            colors = np.asarray(colors, dtype=np.uint8)
            for v, c in zip(vertices, colors):
                f.write(f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f} "
                        f"{c[0]} {c[1]} {c[2]}\n")
        else:
            for v in vertices:
                f.write(f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        if faces is not None:
            for face in np.asarray(faces, dtype=np.int64):
                f.write(f"3 {face[0]} {face[1]} {face[2]}\n")


def export_labeled_points(path: str, points: np.ndarray, labels: np.ndarray):
    """The reference's ``np_to_pcd_with_label`` (gen_utils.py) as a PLY export."""
    write_ply(path, points[:, :3], labels_to_colors(labels))


def export_colored_mesh(path: str, vertices: np.ndarray, faces: np.ndarray,
                        labels: np.ndarray):
    """The reference's ``get_colored_mesh`` as a PLY export."""
    write_ply(path, vertices[:, :3], labels_to_colors(labels), faces)
