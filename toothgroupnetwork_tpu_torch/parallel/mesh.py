"""The rank mesh, sharding helpers and the collectives the parallel layer
uses (counterpart of toothgroupnetwork_tpu/parallel/mesh.py).

JAX lays a batch or a point axis over a ``jax.sharding.Mesh`` and XLA
inserts the collectives. The port runs one process per rank and writes
them out: a :class:`Mesh` holds the group, this rank, the size, the rank's
device and the axis name, and the functions below take it.

Data parallelism shards the batch's leading axis (:func:`shard_batch`) and
keeps the parameters equal on every rank (:func:`replicate`). Point-axis
sharding gives each rank ``N/D`` rows of a cloud (:func:`shard_rows`); the
point-sharded primitives (``ring.py``, ``sharded_ops.py``) all-gather
coordinates (:func:`all_gather`) and pass feature shards around the ring
(:func:`ring_pass`).

gloo takes CUDA tensors for ``all_reduce`` and ``broadcast`` only, so those
are called on the tensors as they are. Under gloo with ranks on a card,
:func:`all_gather` and :func:`ring_pass` copy through host buffers;
:func:`_staged` is that staging, the one place it is written, and
:meth:`Mesh.describe` names it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..ops.distance import square_distance


@dataclass(frozen=True)
class Mesh:
    """One axis of ranks: the process ``group``, this ``rank`` in it, its
    ``size``, the rank's ``device``, the ``axis`` name and the group's
    ``backend``."""

    group: object
    rank: int
    size: int
    device: torch.device
    axis: str
    backend: str

    @property
    def staged(self) -> bool:
        """Whether all-gathers and ring passes copy through the host (gloo
        with tensors on a card)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def describe(self) -> str:
        how = ("all_gather and ring passes staged through host memory"
               if self.staged else "collectives on the tensors' device")
        return (f"mesh axis {self.axis!r}: rank {self.rank}/{self.size} on "
                f"{self.device}, {self.backend} ({how})")


def make_data_mesh(n: int | None = None, axis: str = "data",
                   device: str | torch.device = "cuda") -> Mesh | None:
    """The mesh of the group's first ``n`` ranks (every rank by default),
    this rank's tensors on ``device`` (the card unless the caller names the
    CPU). Every rank of the group calls it; a
    rank outside the first ``n`` gets None. Needs a started process group
    (``distributed.init_rank`` or ``maybe_initialize``)."""
    if not dist.is_initialized():
        raise RuntimeError("make_data_mesh needs a torch.distributed process group")
    world = dist.get_world_size()
    n = n or world
    if not 1 <= n <= world:
        raise ValueError(f"mesh of {n} ranks in a group of {world}")
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    rank = dist.get_rank()
    if rank >= n:
        return None
    return Mesh(group, rank, n, torch.device(device), axis,
                str(dist.get_backend(group)))


def _staged(t: torch.Tensor, mesh: Mesh, op) -> torch.Tensor:
    """``op(t_on_comm_device) -> tensor``, with ``t`` copied to the host and
    the result back to ``t``'s device where the mesh is staged."""
    if not mesh.staged:
        return op(t.contiguous())
    return op(t.detach().cpu().contiguous()).to(t.device)


def all_gather(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``t`` (one shape on all ranks), stacked in rank order:
    ``[D, *t.shape]``."""
    def op(x):
        parts = [torch.empty_like(x) for _ in range(mesh.size)]
        dist.all_gather(parts, x, group=mesh.group)
        return torch.stack(parts)
    return _staged(t, mesh, op)


def ring_pass(t: torch.Tensor, mesh: Mesh, shift: int = 1) -> torch.Tensor:
    """One ring step: ``t`` goes to rank + ``shift``, and rank - ``shift``'s
    ``t`` (same shape and dtype) comes back, as ``lax.ppermute`` with
    ``i -> i + 1`` (``shift`` -1: the ring run backwards)."""
    if mesh.size == 1:
        return t

    def op(x):
        got = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, _global(mesh, (mesh.rank + shift) % mesh.size),
                          mesh.group),
               dist.P2POp(dist.irecv, got, _global(mesh, (mesh.rank - shift) % mesh.size),
                          mesh.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return got
    return _staged(t, mesh, op)


def shard_rows(x, mesh: Mesh):
    """This rank's rows of ``x``'s leading axis (an array, tensor or list),
    which must divide by the mesh size, as a ``NamedSharding`` over it
    requires."""
    n = len(x)
    if n % mesh.size:
        raise ValueError(f"leading axis {n} does not divide over {mesh.size} ranks")
    per = n // mesh.size
    return x[mesh.rank * per:(mesh.rank + 1) * per]


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's rows of every array, tensor and list of ``batch``; other
    fields as they are."""
    return {k: (shard_rows(v, mesh) if isinstance(v, (np.ndarray, torch.Tensor, list))
                else v) for k, v in batch.items()}


def replicate(obj, mesh: Mesh):
    """Rank 0's values on every rank, in place: a module's parameters and
    buffers (in their fixed order), a tensor, or a dict / list of them.
    Returns ``obj``."""
    if isinstance(obj, torch.nn.Module):
        replicate([*obj.parameters(), *obj.buffers()], mesh)
    elif isinstance(obj, torch.Tensor):
        with torch.no_grad():
            # NCCL takes tensors on the card only (an optimizer's step
            # counts may lie on the host)
            t = (obj.data.to(mesh.device) if mesh.backend == "nccl"
                 and obj.device != mesh.device else obj.data)
            dist.broadcast(t, src=_global(mesh, 0), group=mesh.group)
            if t is not obj.data:
                obj.data.copy_(t)
    elif isinstance(obj, dict):
        replicate(list(obj.values()), mesh)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            if isinstance(v, (torch.Tensor, torch.nn.Module, dict, list, tuple)):
                replicate(v, mesh)
    return obj


def _global(mesh: Mesh, r: int) -> int:
    return r if mesh.group is dist.group.WORLD else dist.get_global_rank(mesh.group, r)


def sharded_square_distance(src: torch.Tensor, dst: torch.Tensor,
                            mesh: Mesh) -> torch.Tensor:
    """Squared distances from this rank's slab of ``src`` ``[M, C]`` (the
    query axis sharded, M divisible by the mesh size) to the whole ``dst``
    ``[N, C]``: this rank's ``[M/D, N]`` rows of the ``[M, N]`` matrix."""
    return square_distance(shard_rows(src, mesh), dst)
