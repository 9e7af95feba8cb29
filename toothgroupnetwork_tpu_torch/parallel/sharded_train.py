"""Point-sharded training (counterpart of
toothgroupnetwork_tpu/parallel/sharded_train.py).

The JAX module jits the dense train step with the batch's point axis
sharded over a mesh and lets GSPMD insert the collectives, so the
BatchNorm's global moments, the losses, the gradients and the update equal
the dense step's by construction. torch has no GSPMD. Here each rank runs
the same dense step (``train/trainer.py:train_step``) on its rows of the
point axis (:func:`shard_batch_points`), inside the point-sharded context
(``parallel/points.py``), where the point-axis ops write out what XLA
inserts: FPS (K1) and kNN (K2, in xyz and in DGCNN's feature space) on
the all-gathered cloud, the ball query against the all-gathered
coordinates, row gathers over the ring with their gradients returned to
the owners, the bottleneck mean's sum and the global max (PointNet's and
DGCNN's) over the shards, and dropout's draw over the whole point axis.
The BatchNorm sums and the loss normalisers reduce over the shards
through the step's ``data_parallel`` context (``data_parallel.psum`` /
``ratio``), as in a data-parallel step; the rows after a global max are
replicated, and every rank runs their ops whole, outside those sums.

The gradient. Every rank computes the whole loss L from the psummed sums,
and the backward of each exchange is its adjoint (the psum's sums the
upstream gradient over the ranks; the ring gather's returns each gathered
row's gradient to its owner). So the ranks' backward passes together are
the backward of the sum of the D ranks' copies of L, D·L: rank r's
``.grad`` is its share of d(D·L)/dθ, the ops it ran on its rows and its
copies of the replicated ones. ``train_step``'s one all-reduce of the
flattened gradients sums the shares and divides by D
(``data_parallel.all_reduce_grads``): dL/dθ on every rank, by the same
argument, and with the same factor, as the data-parallel step's. The
parameters, the optimizer state and the BatchNorm statistics (updated from
psummed moments) stay equal on every rank.
"""

from __future__ import annotations

import numpy as np
import torch

from ..train.trainer import train_step
from . import points
from .data_parallel import exchange
from .mesh import Mesh

# the mesh axis name of the JAX module (its ``NamedSharding`` spec)
POINT_AXIS = "points"

# the tasks whose forward reaches only point-axis ops the context routes;
# the others raise (ROADMAP.md Queue 1 names what each still needs)
SUPPORTED_TASKS = ("pointtransformer", "pointnet", "dgcnn", "pointnetpp")


def shard_batch_points(batch: dict, mesh: Mesh) -> dict:
    """This rank's rows of every array leaf with a point axis (axis 1 of
    ``[B, N, ...]``: ``feat``, ``gt_seg_label``, ``mask``), rows
    ``[r N // D, (r + 1) N // D)``; every other array whole. Arrays go onto
    the rank's device (``mesh.device``) as tensors; other fields pass
    through."""
    n = np.shape(batch["feat"])[1]
    lo, hi = points.rows(n, mesh)
    out = {}
    for key, v in batch.items():
        if not isinstance(v, (np.ndarray, torch.Tensor)):
            out[key] = v
            continue
        t = torch.as_tensor(v)
        if t.dim() >= 2 and t.shape[1] == n:
            t = t[:, lo:hi]
        out[key] = t.contiguous().to(mesh.device)
    return out


def make_point_sharded_train_step(task, config, mesh: Mesh):
    """The dense train step for point-sharded batches on ``mesh``.

    Returns ``step(model, optimizer, batch, generator=None) -> values``:
    ``batch`` from :func:`shard_batch_points`, ``model`` and ``optimizer``
    replicated (equal on every rank, as ``mesh.replicate`` leaves them),
    ``generator`` the dropout generator of the step (``train_step``'s; in
    the same state on every rank, so that every rank draws the dense
    step's mask and keeps its rows); the values are the global losses, the
    same on every rank. Raises
    ``NotImplementedError`` for a task whose forward reaches a point-axis
    op the context does not route."""
    if task.name not in SUPPORTED_TASKS:
        raise NotImplementedError(
            f"the point-sharded train step of {task.name!r} needs point-axis ops "
            f"without a sharded route (see {points.ROADMAP_ITEM}); "
            f"supported: {SUPPORTED_TASKS}")

    def step(model, optimizer, batch: dict,
             generator: torch.Generator | None = None) -> dict:
        n = sum(exchange(int(batch["feat"].shape[1]), mesh))
        with points.context(mesh, n):
            return train_step(model, optimizer, task, config, batch,
                              generator=generator, mesh=mesh)

    return step
