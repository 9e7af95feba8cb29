"""Host data layer of the port: .obj parsing, vertex normals, the tgn
inference scan prep, the offline preprocessing (``preprocess``, whose FPS
imports torch where it runs), and the training dataset, batching, case
split and augmentation (numpy; counterpart of toothgroupnetwork_tpu/data/)."""

from .augment import Augmentator, build_augmenter
from .dataset import BatchLoader, DentalScanDataset, collate_batch
from .mesh_io import compute_vertex_normals, parse_obj, subdivide_midpoint
from .scan_prep import N_SAMPLE, prep_scan_host_tgn

__all__ = ["Augmentator", "BatchLoader", "DentalScanDataset", "N_SAMPLE",
           "build_augmenter", "collate_batch", "compute_vertex_normals",
           "parse_obj", "prep_scan_host_tgn",
           "subdivide_midpoint"]
