"""Point-cloud ops on torch tensors; the selection kernels live in ``kernels/``."""

from .distance import square_distance
from .fps import farthest_point_sample
from .gather import index_points
from .interpolate import knn_interpolate
from .knn import knn_points, knn_self, smallest_k

__all__ = ["farthest_point_sample", "index_points", "knn_interpolate",
           "knn_points", "knn_self", "smallest_k", "square_distance"]
