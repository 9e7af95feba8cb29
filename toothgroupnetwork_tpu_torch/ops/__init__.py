"""Point-cloud ops on torch tensors (counterpart of
toothgroupnetwork_tpu/ops/__init__.py); the selection kernels live in
``kernels/``."""

from .ball_query import ball_query
from .distance import pairwise_sqdist, square_distance
from .fps import farthest_point_sample, fps
from .gather import group_points, index_points
from .interpolate import knn_interpolate, three_nn_interpolate
from .knn import knn, knn_points, knn_self, smallest_k
from .misc import aggregation, subtraction
from .sampling import sample_and_group, sample_and_group_all

__all__ = [
    "aggregation",
    "ball_query",
    "farthest_point_sample",
    "fps",
    "group_points",
    "index_points",
    "knn",
    "knn_interpolate",
    "knn_points",
    "knn_self",
    "pairwise_sqdist",
    "sample_and_group",
    "sample_and_group_all",
    "smallest_k",
    "square_distance",
    "subtraction",
    "three_nn_interpolate",
]
