"""Point-axis-sharded exact kNN (counterpart of
toothgroupnetwork_tpu/parallel/ring.py).

Rank r holds rows ``[r N // D, (r + 1) N // D)`` of the cloud
(``points.bounds``: equal shards where D divides N). The JAX version
passes the point shards round a ``ppermute`` ring because its local step
materialises the ``[Mq, N/D]`` distances. K2 (``ops/kernels/knn.py:
knn_select``) selects inside the kernel and never holds them, so a ring
would save only the coordinates, 12 bytes a point: here the shards'
coordinates and candidate bias are all-gathered once
(``sharded_ops.gather_axis``) and K2 runs this rank's query rows against
the whole cloud in one launch (:func:`sharded_select`, which the dense
``ops.knn_points`` also calls inside the point-sharded context, DGCNN's
feature-space kNN among its calls: its C = 64 rows are 256 bytes a point,
6.1 MB for a 24000-point cloud, still one gather and one launch on the
dense call's route). Its
indices are global and its lists those of the dense kNN: k may pass a
shard's size, and past the whole cloud's the tail is index 0 at d² 1e10.

K2 computes d² by direct subtraction, where the JAX local step expands the
square through a matmul (ring.py:54-57): candidates within the expansion's
rounding of the k-th may swap (the near-tie rule of the kNN tests).
"""

from __future__ import annotations

import torch

from ..ops.kernels.knn import knn_select
from .mesh import Mesh
from .sharded_ops import gather_axis

_BIG = 1e10


def sharded_select(query: torch.Tensor, points: torch.Tensor, k: int, mesh: Mesh,
                   n: int, bias: torch.Tensor | None = None):
    """``knn_select`` of this rank's query rows ``[B, Mq, C]`` (any C) over
    the ``n``-point cloud whose rows ``points`` ``[B, n_r, C]`` (and candidate
    ``bias`` ``[B, n_r]``, added to their d²) this rank holds: (int32
    global indices, f32 d²) ``[B, Mq, k]``, the dense kNN's lists."""
    cloud = gather_axis(points.to(torch.float32), mesh, n).contiguous()
    if bias is not None:
        bias = gather_axis(bias.to(torch.float32), mesh, n).contiguous()
    return knn_select(query.to(torch.float32).contiguous(), cloud, k, bias)


def ring_knn(query: torch.Tensor, points: torch.Tensor, k: int, mesh: Mesh,
             mask: torch.Tensor | None = None,
             n: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN of this rank's ``query`` rows ``[Mq, C]`` over the cloud
    of ``n`` points whose rows ``points`` ``[n_r, C]`` this rank holds
    (``n`` by default ``n_r`` times D: equal shards). ``mask`` ``[n_r]``
    marks the valid candidates; an invalid one takes d² + 1e10, as in
    ``knn_points``.

    Returns ``(idx int32, dist f32)`` ``[Mq, k]``: global point indices
    ascending by (d², index), and the exact Euclidean distances (sqrt of
    the selection's d²), as the JAX ``ring_knn`` returns them."""
    n = points.shape[0] * mesh.size if n is None else n
    bias = None if mask is None else torch.where(mask.to(torch.bool), 0.0, _BIG)[None]
    idx, d2 = sharded_select(query[None], points[None], k, mesh, n, bias)
    d2o = torch.clamp_min(d2[0], 0.0)
    pos = d2o > 0
    dist = torch.where(pos, torch.sqrt(torch.where(pos, d2o, 1.0)), 0.0)
    return idx[0], dist
