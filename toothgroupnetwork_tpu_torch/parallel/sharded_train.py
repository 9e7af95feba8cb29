"""Point-sharded training (counterpart of
toothgroupnetwork_tpu/parallel/sharded_train.py), for every task name.

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

The crop models. tgnet (``tgnet_fps``, ``tgnet_bdl``) and tsegnet cut
their crops from the whole cloud: every rank all-gathers the inputs
(``points.whole``: coordinates, labels, mask; no gradient), computes the
ground-truth centroids and the crop selection as the dense step does,
bit-equal to it, and keeps its rows of the crop axis (``points.crop_rows``:
``B·K`` crops, the floor rule of the point axis). The crop stage (tgnet's
stage 2, tsegnet's seg module) and its loss terms run under
``points.dense()``: the point-axis hooks off, the ``data_parallel``
context on, so it is a data-parallel run over crop rows, each crop
counted once in the BatchNorm sums (and in the running variance's
``n / (n - 1)``) and in the loss normalisers. tsegnet's crop features
carry a gradient into the sharded backbone: its rows come over
``sharded_ops.ring_gather`` at this rank's crop rows' global indices. The
losses sum their per-tooth and per-cloud sums over the shards
(``points.psum``) and take tsegnet's per-centroid minimum over the sharded
l3 points as ``points.pmax`` of the negation.

Host stages (tgnet_bdl's boundary resample, tsegnet's proposals) run
outside the step, as the JAX module leaves them to its caller:
:func:`host_batch_points` runs the task's stage on the whole batch on rank
0 and shards the result on every rank.

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

from ..train.trainer import apply_host_stage, train_step
from . import data_parallel, points
from .data_parallel import exchange
from .mesh import Mesh

# the mesh axis name of the JAX module (its ``NamedSharding`` spec)
POINT_AXIS = "points"


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


def host_batch_points(task, model, batch: dict, config, step: int, mesh: Mesh) -> dict:
    """This rank's rows (:func:`shard_batch_points`) of the whole ``batch``
    after the task's host stage (``train/trainer.py:apply_host_stage``,
    the ``Trainer``'s rules), for tasks that have one (tgnet_bdl,
    tsegnet); the batch's rows as they are for the others.

    Rank 0 alone runs the stage, on the whole batch, outside both the
    point-sharded and the data-parallel contexts, and sends the arrays it
    returns to the other ranks through ``data_parallel.exchange``. So the
    stage sees the batch a one-process step sees: its draws
    (tsegnet's ``default_rng(step)`` permutations, the boundary engine's
    generator) are the one-process draws, with no replay of other ranks'
    clouds (``data_parallel.around`` finds no mesh), and one process writes
    the boundary engine's ``.npy`` cache. ``model`` is the replicated model
    (equal on every rank). A failure of the stage on rank 0 raises
    ``data_parallel.RankFailure`` on every rank."""
    if task.host_stage is not None:
        out = None
        if mesh.rank == 0:
            try:
                with data_parallel.context(None), points.context(None, 0):
                    out = apply_host_stage(task, model, batch, config, step)
            except Exception as e:
                data_parallel.fail(e, mesh)
        out = exchange(out, mesh)[0]
        batch = {**batch, **out}
    return shard_batch_points(batch, mesh)


def make_point_sharded_train_step(task, config, mesh: Mesh):
    """The dense train step for point-sharded batches on ``mesh``, for any
    task.

    Returns ``step(model, optimizer, batch, generator=None) -> values``:
    ``batch`` from :func:`shard_batch_points` (or, for a task with a host
    stage, :func:`host_batch_points`), ``model`` and ``optimizer``
    replicated (equal on every rank, as ``mesh.replicate`` leaves them),
    ``generator`` the dropout generator of the step (``train_step``'s; in
    the same state on every rank, so that every rank draws the dense
    step's mask and keeps its rows); the values are the global losses, the
    same on every rank."""
    def step(model, optimizer, batch: dict,
             generator: torch.Generator | None = None) -> dict:
        n = sum(exchange(int(batch["feat"].shape[1]), mesh))
        with points.context(mesh, n):
            return train_step(model, optimizer, task, config, batch,
                              generator=generator, mesh=mesh)

    return step
