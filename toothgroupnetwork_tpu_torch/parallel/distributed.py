"""Process-group start-up (counterpart of
toothgroupnetwork_tpu/parallel/distributed.py).

The JAX package connects hosts with ``jax.distributed.initialize`` and then
lays one program over every device. The port runs one process per rank over
``torch.distributed``: :func:`maybe_initialize` starts the group from
``TrainConfig.distributed`` (``coordinator_address`` -> the TCP init address,
``num_processes`` -> the world size, ``process_id`` -> the rank; left out,
each is read from the environment through ``env://``), and :class:`RankPool`
spawns the ranks of one machine and runs functions on all of them.

Backend rule (:func:`backend_for`), chosen from the devices when the group
is made: NCCL when every rank has a card of its own, gloo for CPU ranks and
for ranks that share one card (NCCL refuses two ranks on one device).
"""

from __future__ import annotations

import os
import queue
import shutil
import tempfile
import traceback

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

# seconds RankPool.run waits for a job's results before it ends the pool
_RESULT_TIMEOUT_S = 3600.0


def maybe_initialize(config, device: str | torch.device = "cuda") -> bool:
    """Start the process group once, iff ``config.distributed.enabled``,
    with the backend :func:`backend_for` picks for ``device`` (this rank's
    device: the card unless the caller names the CPU). Returns True when a group of more than one rank is running
    after the call. A no-op when distributed is off or the group exists."""
    d = getattr(config, "distributed", None)
    if d is not None and d.enabled and not dist.is_initialized():
        world = d.num_processes or int(os.environ.get("WORLD_SIZE", "1"))
        kwargs = {}
        if d.num_processes:
            kwargs["world_size"] = d.num_processes
        if d.process_id is not None:
            kwargs["rank"] = d.process_id
        init = f"tcp://{d.coordinator_address}" if d.coordinator_address else "env://"
        dist.init_process_group(backend_for(torch.device(device), world),
                                init_method=init, **kwargs)
    return dist.is_initialized() and dist.get_world_size() > 1


def local_batch_slice(global_batch: int) -> tuple[int, int]:
    """(start, size) of this rank's rows of a global batch laid out
    contiguously by rank; the whole batch without a group."""
    rank, world = ((dist.get_rank(), dist.get_world_size())
                   if dist.is_initialized() else (0, 1))
    per = global_batch // world
    return rank * per, per


def rank_device(rank: int, world: int, kind: str) -> torch.device:
    """Rank ``rank``'s device: the CPU for ``kind`` "cpu"; for "cuda",
    ``cuda:rank`` where the machine has a card for every rank, else
    ``cuda:0`` (the ranks share it)."""
    if kind == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", rank if torch.cuda.device_count() >= world else 0)


def backend_for(device: torch.device, world: int) -> str:
    """NCCL where each of ``world`` CUDA ranks has its own card, else gloo."""
    if device.type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def init_rank(rank: int, world: int, init_method: str, kind: str = "cuda"):
    """Join the ``world``-rank group as ``rank`` on :func:`rank_device`'s
    device; returns the data :class:`~.mesh.Mesh` over every rank."""
    from .mesh import make_data_mesh

    device = rank_device(rank, world, kind)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend_for(device, world), init_method=init_method,
                            world_size=world, rank=rank)
    return make_data_mesh(world, device=device)


def _rank_loop(rank, world, init_method, kind, jobs, results):
    """A spawned rank: join the group, then run ``fn(mesh, *args)`` for every
    job until the ``None`` job; each outcome goes to ``results`` as
    ``(rank, ok, value or traceback)``."""
    try:
        mesh = init_rank(rank, world, init_method, kind)
    except Exception:   # reported to the caller, which ends the pool
        results.put((rank, False, traceback.format_exc()))
        return
    while True:
        job = jobs.get()
        if job is None:
            break
        fn, args = job
        try:
            results.put((rank, True, fn(mesh, *args)))
        except Exception:   # reported to the caller, which ends the pool
            results.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class RankPool:
    """``world`` spawned rank processes of one machine in one group (a
    ``file://`` store in a fresh temporary directory), each on
    :func:`rank_device`'s device for ``kind`` (the card unless the caller
    names the CPU). :meth:`run` calls a
    module-level function ``fn(mesh, *args)`` on every rank and returns the
    ranks' results in rank order; a rank that raises ends the pool (its
    peers may be waiting in a collective) and :meth:`run` raises with its
    traceback. Use as a context manager, or call :meth:`close`."""

    def __init__(self, world: int, kind: str = "cuda"):
        import torch.multiprocessing as mp

        resolve_device(kind)   # raises for "cuda" without a card, before any spawn
        ctx = mp.get_context("spawn")
        self.world = world
        self._dir = tempfile.mkdtemp(prefix="tgn_ranks_")
        init = "file://" + os.path.join(self._dir, "store")
        # queues with a feeder thread: a job larger than a pipe's buffer
        # never blocks the caller, even on a rank that has died
        self._jobs = [ctx.Queue() for _ in range(world)]
        self._results = ctx.Queue()
        self._procs = [ctx.Process(target=_rank_loop, daemon=True,
                                   args=(r, world, init, kind, self._jobs[r],
                                         self._results))
                       for r in range(world)]
        for p in self._procs:
            p.start()

    def run(self, fn, *args) -> list:
        if not self._procs:
            raise RuntimeError("the rank pool is closed")
        for q in self._jobs:
            q.put((fn, args))
        out, waited = [None] * self.world, 0.0
        pending = set(range(self.world))
        while pending:
            try:
                rank, ok, value = self._results.get(timeout=1.0)
            except queue.Empty:
                waited += 1.0
                dead = [r for r in pending if not self._procs[r].is_alive()]
                if dead or waited > _RESULT_TIMEOUT_S:
                    self.close(force=True)
                    raise RuntimeError(f"ranks {sorted(pending)} gave no result "
                                       f"(dead: {dead}, {waited:.0f} s)")
                continue
            if not ok:
                self.close(force=True)
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
            pending.discard(rank)
        return out

    def close(self, force: bool = False) -> None:
        """Stop every rank: the ``None`` job, or at once with ``force``;
        a rank still alive after a minute is terminated."""
        if not self._procs:
            return
        if not force:
            for q in self._jobs:
                q.put(None)
        for p in self._procs:
            p.join(timeout=0.1 if force else 60.0)
            if p.is_alive():
                p.terminate()
                p.join()
        self._procs = []
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(force=exc[0] is not None)
