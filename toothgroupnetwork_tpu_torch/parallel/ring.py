"""Ring-pass point-axis sharding: exact kNN with the query and point axes
sharded over the ranks (counterpart of toothgroupnetwork_tpu/parallel/ring.py).

Each rank holds ``N/D`` points. The point shards travel around the ring
(:func:`~.mesh.ring_pass`: to rank + 1, from rank - 1, as ``ppermute``), so
each rank's query rows meet every shard while it holds one shard at a time.
The local step is K2 (``ops/kernels/knn.py:knn_select``) on the resident
shard; its list is merged with the running one by the key (d², global
index). The keys are unique, so the merge is exact in any order of the
shards.

K2 computes d² by direct subtraction, where the JAX local step expands the
square through a matmul (ring.py:54-57): candidates within the expansion's
rounding of the k-th may swap (the near-tie rule of the kNN tests).
"""

from __future__ import annotations

import torch

from ..ops.kernels.knn import knn_select
from .mesh import Mesh, ring_pass


def merge_lists(best_d, best_i, new_d, new_i, k: int):
    """The ``k`` smallest keys (d², global index) of two ``[M, k]`` lists,
    ascending."""
    cat_d = torch.cat([best_d, new_d], dim=-1)
    cat_i = torch.cat([best_i, new_i], dim=-1)
    order = torch.argsort(cat_i, dim=-1, stable=True)
    cat_d, cat_i = cat_d.gather(-1, order), cat_i.gather(-1, order)
    order = torch.argsort(cat_d, dim=-1, stable=True)[:, :k]
    return cat_d.gather(-1, order), cat_i.gather(-1, order)


def ring_knn(query: torch.Tensor, points: torch.Tensor, k: int,
             mesh: Mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN of this rank's ``query`` rows ``[Mq, C]`` over the cloud
    whose shard ``points`` ``[N/D, C]`` this rank holds (every rank's shard
    the same size, rank r's rows ``r N/D ...``).

    Returns ``(idx int32, dist f32)`` ``[Mq, k]``: global point indices
    ascending by (d², index), and the exact Euclidean distances (sqrt of
    the selection's d²), as the JAX ``ring_knn`` returns them. ``k`` must
    not pass ``N/D``, so that every shard fills a list."""
    shard_n = points.shape[0]
    if k > shard_n:
        raise ValueError(f"ring_knn needs k <= N/devices ({k} > {shard_n})")
    q = query.to(torch.float32).contiguous()[None]
    blk = points.to(torch.float32).contiguous()
    best_d = best_i = None
    for step in range(mesh.size):
        owner = (mesh.rank - step) % mesh.size      # whose shard is resident
        idx, d2 = knn_select(q, blk[None], k)
        gi = idx[0].to(torch.int64) + owner * shard_n
        if best_d is None:
            best_d, best_i = d2[0], gi
        else:
            best_d, best_i = merge_lists(best_d, best_i, d2[0], gi, k)
        if step + 1 < mesh.size:
            blk = ring_pass(blk, mesh)
    d2o = torch.clamp_min(best_d, 0.0)
    pos = d2o > 0
    dist = torch.where(pos, torch.sqrt(torch.where(pos, d2o, 1.0)), 0.0)
    return best_i.to(torch.int32), dist
