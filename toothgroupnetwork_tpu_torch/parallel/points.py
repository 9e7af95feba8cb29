"""The point-sharded context: what makes the dense forward run with its
point axis split over the ranks of a mesh (what GSPMD does for
toothgroupnetwork_tpu/parallel/sharded_train.py, written out by hand).

Inside :func:`context` every tensor with a point axis (axis 1 of
``[B, N, ...]``) holds this rank's rows of it, rank r rows
``[r N // D, (r + 1) N // D)`` (:func:`bounds`), at every stage; point
indices are global. The dense point-axis ops consult :func:`active` and
route themselves:

  * ``ops.farthest_point_sample`` -> K1 on the whole cloud, all-gathered
    once (``sharded_ops.gather_axis``), this rank's rows of the sample;
  * ``ops.knn_points`` / ``knn_self`` -> K2 for this rank's query rows
    against the whole cloud, all-gathered once, before their dense
    post-processing (``ring.sharded_select``), in xyz and in a feature
    space alike (DGCNN's C = 6 and 64);
  * ``ops.ball_query`` -> the dense body for this rank's query rows
    against the whole cloud's coordinates and mask, all-gathered once;
  * ``ops.index_points`` on a point-sharded source ->
    ``sharded_ops.ring_gather``, whose backward returns the rows' gradients
    to their owners;
  * ``nn.layers.masked_mean`` over the point axis -> :func:`psum` of the
    masked sum and count;
  * ``nn.layers.masked_max`` over the point axis -> :func:`pmax`;
  * ``nn.layers.Dropout`` on point rows -> the whole axis's draw, this
    rank's rows of it (:func:`global_rows`).

The rows after a global max (``[B, C]``) are replicated: every rank runs
the ops on them whole, outside every collective. An op that the context
does not route raises :func:`unsupported`, so no rank computes a
per-shard answer in silence. Outside the context every hook is the
identity.

The crop models (tgnet, tsegnet) and their losses call three more helpers:

  * :func:`whole` all-gathers an input that carries no gradient (the
    coordinates, labels and mask), so that the ground-truth centroids and
    the crop selection (``square_distance`` and ``smallest_k``, which are
    not routed) run as the dense code on the whole cloud, bit-equal to the
    dense step;
  * :func:`crop_rows` names this rank's rows of the crop axis (``B·K``
    crops, the same floor rule as :func:`bounds`);
  * :func:`dense` turns the hooks off inside (``active()`` is None) while
    the step's ``data_parallel`` context stays on: the crop stage runs
    there on this rank's crop rows, a data-parallel run over crops.
    tsegnet's crop features carry a gradient into the sharded backbone and
    come over the ring before it (``sharded_ops.crop_rows_gather``).

The losses sum their per-tooth and per-cloud sums over the shards with
:func:`psum`, and tsegnet's per-centroid minimum over the sharded l3
points is :func:`pmax` of the negation.

A shard knows its own row count only; the global count of each point axis
is resolved from the sizes this step has met (:func:`register`: the batch's
N, then each FPS sample's M), which every rank registers in the same order.
"""

from __future__ import annotations

import contextlib
from typing import TYPE_CHECKING

import torch
import torch.distributed as dist

if TYPE_CHECKING:
    from .mesh import Mesh

# where a point-axis op without a route is to be recorded (ROADMAP.md's
# Queue 3, the port's faults against the reference)
ROADMAP_ITEM = "ROADMAP.md Queue 3: a point-axis op of the dense step without a route"


class _Shards:
    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.sizes: list[int] = []


_ACTIVE: _Shards | None = None


def bounds(n: int, d: int) -> list[int]:
    """Rank r's rows of an ``n``-row point axis over ``d`` ranks are
    ``[bounds[r], bounds[r + 1])``."""
    return [r * n // d for r in range(d + 1)]


def rows(n: int, mesh: Mesh) -> tuple[int, int]:
    """(start, stop) of this rank's rows of an ``n``-row point axis."""
    b = bounds(n, mesh.size)
    return b[mesh.rank], b[mesh.rank + 1]


@contextlib.contextmanager
def context(mesh: Mesh, n_points: int):
    """Run the code inside with the point axis of an ``n_points`` cloud
    split over ``mesh`` (None: no split)."""
    global _ACTIVE
    before = _ACTIVE
    _ACTIVE = None if mesh is None else _Shards(mesh)
    try:
        if mesh is not None:
            register(n_points)
        yield mesh
    finally:
        _ACTIVE = before


def active() -> Mesh | None:
    """The mesh the point axis is split over, or None."""
    return None if _ACTIVE is None else _ACTIVE.mesh


def register(n: int) -> None:
    """Record ``n`` as a global point count of this step. Every rank
    registers the same counts in the same order, and each must tell every
    count apart by its own row count (raises otherwise, on every rank)."""
    shards = _ACTIVE
    d = shards.mesh.size
    if n < d:
        raise ValueError(f"a point axis of {n} rows over {d} ranks leaves a rank none")
    if n in shards.sizes:
        return
    for other in shards.sizes:
        for r in range(d):
            if bounds(n, d)[r + 1] - bounds(n, d)[r] == (
                    bounds(other, d)[r + 1] - bounds(other, d)[r]):
                raise ValueError(f"point axes of {n} and {other} rows give rank {r} "
                                 "the same row count; it cannot tell them apart")
    shards.sizes.append(n)


def global_size(n_local: int) -> int:
    """The global row count of a point axis of which this rank holds
    ``n_local`` rows (``n_local`` itself outside the context)."""
    if _ACTIVE is None:
        return n_local
    mesh = _ACTIVE.mesh
    for n in _ACTIVE.sizes:
        lo, hi = rows(n, mesh)
        if hi - lo == n_local:
            return n
    raise ValueError(f"no point axis of this step gives rank {mesh.rank} "
                     f"{n_local} rows (registered: {_ACTIVE.sizes})")


def psum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the point shards, differentiably (the identity
    outside the context)."""
    if _ACTIVE is None:
        return t
    from .data_parallel import _Psum

    return _Psum.apply(t, _ACTIVE.mesh.group)


def pmax(x: torch.Tensor) -> torch.Tensor:
    """The max over the point axis of the cloud whose rows ``x`` ``[B, n_r,
    C]`` this rank holds: ``[B, C]`` on every rank, bit-equal to
    ``amax(dim=1)`` of the whole cloud, and with its gradient, which
    ``amax`` splits evenly over the tied rows, split evenly over the tied
    rows of every rank. The max ``g`` is a MAX all-reduce of the shards'
    maxima (no gradient); the result is ``g + psum(sum((x - g) * tied)) /
    psum(count(tied))``: ``x - g`` is exactly 0 at a tie, so the value is
    ``g``, and the gradient ``tied / count``. A shard whose rows all lie
    below ``g`` (only padding, say) has no tie and no gradient."""
    mesh = _ACTIVE.mesh
    g = x.detach().amax(dim=1)
    dist.all_reduce(g, op=dist.ReduceOp.MAX, group=mesh.group)
    g = g[:, None]
    tied = x.detach() == g
    c = x.shape[-1]
    s = psum(torch.cat([((x - g) * tied).sum(dim=1), tied.sum(dim=1).to(x.dtype)],
                       dim=-1))
    return g[:, 0] + s[..., :c] / s[..., c:]


def global_rows(shape: tuple, draw) -> torch.Tensor:
    """``draw(shape)`` for a tensor ``[B, n_r, ...]`` of this rank's rows
    of a point axis: ``draw`` of the whole axis's shape, and this rank's
    rows of it, so the ranks' rows together are the dense draw."""
    n = global_size(shape[1])
    lo, hi = rows(n, _ACTIVE.mesh)
    return draw((shape[0], n) + tuple(shape[2:]))[:, lo:hi]


@contextlib.contextmanager
def dense():
    """The dense point-axis ops inside, on the rows they are given:
    ``active()`` is None and every hook the identity; the data-parallel
    context, if any, stays on. The point-sharded step runs its crop stage
    here, on this rank's rows of the crop axis (:func:`crop_rows`)."""
    global _ACTIVE
    before, _ACTIVE = _ACTIVE, None
    try:
        yield
    finally:
        _ACTIVE = before


def whole(x: torch.Tensor | None) -> torch.Tensor | None:
    """The whole point axis of which this rank holds ``x`` ``[B, n_r,
    ...]``: every rank's rows, in one all-gather, without a gradient (for
    inputs: coordinates, labels, masks). ``x`` itself outside the context,
    None as None."""
    if _ACTIVE is None or x is None:
        return x
    from .sharded_ops import gather_axis

    return gather_axis(x, _ACTIVE.mesh, global_size(x.shape[1]))


def crop_rows(n: int) -> tuple[int, int]:
    """(start, stop) of this rank's rows of an ``n``-row crop axis whose
    rows every rank could compute whole: :func:`rows` inside the context,
    ``(0, n)`` outside it."""
    if _ACTIVE is None:
        return 0, n
    if n < _ACTIVE.mesh.size:
        raise ValueError(f"{n} crops over {_ACTIVE.mesh.size} ranks leave a rank none")
    return rows(n, _ACTIVE.mesh)


def unsupported(op: str) -> None:
    """Raise inside the context: ``op`` has no point-sharded route yet."""
    if _ACTIVE is not None:
        raise NotImplementedError(
            f"{op} has no point-sharded route (see {ROADMAP_ITEM})")
