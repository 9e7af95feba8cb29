"""Host postprocessing of the tgnet pipeline: clustering, fusion and the
boundary resampling (counterpart of toothgroupnetwork_tpu/postprocess)."""

from .clustering import clustering_points, first_label_ratio, get_clustering_labels

__all__ = ["clustering_points", "get_clustering_labels", "first_label_ratio"]
