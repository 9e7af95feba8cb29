"""Host data layer of the port: .obj parsing, vertex normals, the tgn
inference scan prep, the offline preprocessing (``preprocess``, whose FPS
imports torch where it runs), and the training dataset, batching, case
split and augmentation (numpy; counterpart of toothgroupnetwork_tpu/data/,
with its re-exports)."""

from .augment import (Augmentator, Rotation, Scaling, Translation,
                      build_augmenter, default_augmenter)
from .dataset import BatchLoader, DentalScanDataset, collate_batch
from .mesh_io import (compute_vertex_normals, load_mesh_arr, parse_obj,
                      subdivide_midpoint)
from .preprocess import (Y_AXIS_MAX, Y_AXIS_MIN, class_to_fdi, fdi_to_class,
                         normalize_vertices, preprocess_scan)
from .scan_prep import N_SAMPLE, prep_scan_host_tgn

__all__ = ["Augmentator", "BatchLoader", "DentalScanDataset", "N_SAMPLE",
           "Rotation", "Scaling", "Translation", "Y_AXIS_MAX", "Y_AXIS_MIN",
           "build_augmenter", "class_to_fdi", "collate_batch",
           "compute_vertex_normals", "default_augmenter", "fdi_to_class",
           "load_mesh_arr", "normalize_vertices", "parse_obj",
           "prep_scan_host_tgn", "preprocess_scan", "subdivide_midpoint"]
