"""Host data layer of the port: .obj parsing, vertex normals and the tgn
inference scan prep (numpy only; counterpart of the parts of
toothgroupnetwork_tpu/data/ that the inference pipeline uses)."""

from .mesh_io import compute_vertex_normals, parse_obj, subdivide_midpoint
from .scan_prep import N_SAMPLE, prep_scan_host_tgn

__all__ = ["N_SAMPLE", "compute_vertex_normals", "parse_obj",
           "prep_scan_host_tgn", "subdivide_midpoint"]
