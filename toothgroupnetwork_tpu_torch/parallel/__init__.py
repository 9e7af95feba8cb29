"""Multi-rank parallelism over ``torch.distributed`` (counterpart of
toothgroupnetwork_tpu/parallel/): the process group and rank pool
(``distributed.py``), the rank mesh, sharding helpers and collectives
(``mesh.py``), data-parallel training with global statistics
(``data_parallel.py``, read by the ``Trainer``, the BatchNorm, Dropout and
the losses), the point-sharded eval path: kNN through K2 over the
gathered coordinates (``ring.py``), sharded FPS and the ring gather
(``sharded_ops.py``) and the point-sharded backbone forward with K6
(``sharded_backbone.py``), and the
point-sharded train step (``sharded_train.py``) on the context that routes
the dense point-axis ops over the shards (``points.py``).

The package re-exports the process-group and mesh layer only. The
point-sharded functions are imported from their own modules
(``parallel.points``, ``parallel.ring``, ``parallel.sharded_ops``,
``parallel.sharded_backbone``, ``parallel.sharded_train``): they import the
model code, which imports ``parallel.data_parallel`` and ``parallel.points``.
"""

from .distributed import (RankPool, backend_for, init_rank, local_batch_slice,
                          maybe_initialize, rank_device)
from .mesh import (Mesh, make_data_mesh, replicate, shard_batch, shard_rows,
                   sharded_square_distance)

__all__ = ["Mesh", "RankPool", "backend_for", "init_rank", "local_batch_slice",
           "make_data_mesh", "maybe_initialize", "rank_device", "replicate",
           "shard_batch", "shard_rows", "sharded_square_distance"]
