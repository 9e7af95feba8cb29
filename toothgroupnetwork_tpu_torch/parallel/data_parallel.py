"""Data-parallel training over a rank mesh: what makes a step over D ranks
equal the one-process step over the same global batch (the JAX
``Trainer``'s data mesh, train/trainer.py:92-103, gets this from running
one program over the mesh).

Inside :func:`context` (the ``Trainer`` holds it around each train step
and host stage):
  * ``MaskedBatchNorm`` in train mode takes its masked sums and counts,
    then the squared deviations from the global mean, over every rank
    (:func:`psum`, differentiable);
  * each loss that divides a sum over the batch by a count over the batch
    divides the global sum by the global count (:func:`ratio`);
  * ``Dropout`` draws the mask of the whole global batch from the shared
    generator and keeps this rank's rows (:func:`global_rows`);
  * a host stage that draws from one generator cloud by cloud replays the
    other ranks' draws (:func:`around`).
Outside it every helper is the identity, so a one-process step is
unchanged.

The backward of a differentiable ``all_reduce`` sums the upstream gradient
over the ranks, and every rank holds the whole loss: autograd gives each
rank its share of the gradient of D times the loss. :func:`all_reduce_grads`
sums the shares in one all-reduce of the flattened gradients, in parameter
order, and divides by D once.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from .mesh import Mesh

_ACTIVE: Mesh | None = None


@contextlib.contextmanager
def context(mesh: Mesh | None):
    """Make ``mesh`` the data-parallel mesh of the code inside (None: none)."""
    global _ACTIVE
    before, _ACTIVE = _ACTIVE, mesh
    try:
        yield mesh
    finally:
        _ACTIVE = before


def active() -> Mesh | None:
    """The data-parallel mesh of the running step, or None."""
    return _ACTIVE


class _Psum(torch.autograd.Function):
    """Sum over the ranks; its backward sums the upstream gradient over the
    ranks too (the adjoint of a sum whose result every rank holds)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _Psum.apply(grad, ctx.group), None


def psum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks of the active mesh, differentiably (the
    identity without one)."""
    if _ACTIVE is None:
        return t
    return _Psum.apply(t, _ACTIVE.group)


def ratio(num: torch.Tensor, den: torch.Tensor, floor: float) -> torch.Tensor:
    """``num / max(den, floor)`` of scalars over the global batch: the
    numerator and the denominator summed over the ranks in one all-reduce
    (:func:`psum`, the identity without a mesh)."""
    both = psum(torch.stack([num, den.to(num.dtype)]))
    return both[0] / torch.clamp_min(both[1], floor)


def mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the global batch: :func:`ratio` of its sum
    and its element count."""
    return ratio(x.sum(), x.new_tensor(float(x.numel())), 1.0)


def global_rows(shape: tuple, draw) -> torch.Tensor:
    """``draw(shape)`` for a tensor whose leading axis is this rank's rows
    of the batch: under a mesh, ``draw`` of the global batch's shape, and
    this rank's rows of it, so every rank reads one global draw."""
    if _ACTIVE is None:
        return draw(shape)
    full = draw((shape[0] * _ACTIVE.size,) + tuple(shape[1:]))
    return full[_ACTIVE.rank * shape[0]:(_ACTIVE.rank + 1) * shape[0]]


class RankFailure(RuntimeError):
    """A failure every rank of the mesh learned of in the same
    :func:`exchange`, so that all of them stand at the same collective and
    may restore together (the ``Trainer``'s elastic retry)."""


_FAILED = "<rank failed>"


def exchange(obj, mesh: Mesh | None = None) -> list:
    """Every rank's ``obj`` (picklable) in rank order, over ``mesh`` (by
    default the active one): ``[obj]`` without one. Raises
    :class:`RankFailure` on every rank when a rank sent :func:`fail`."""
    mesh = mesh or _ACTIVE
    if mesh is None:
        return [obj]
    parts = [None] * mesh.size
    dist.all_gather_object(parts, obj, group=mesh.group)
    failed = [r for r, p in enumerate(parts) if isinstance(p, str) and p == _FAILED]
    if failed:
        raise RankFailure(f"rank(s) {failed} of {mesh.size} failed")
    return parts


def fail(error: BaseException, mesh: Mesh):
    """A rank's side of a failure outside the step's collectives: the
    :func:`exchange` its peers wait in (the next one of their host stage,
    or the one that closes it), where every rank raises
    :class:`RankFailure`."""
    try:
        exchange(_FAILED, mesh)
    except RankFailure as agreed:
        raise agreed from error


def around(items: list) -> tuple[list, list]:
    """The items of the ranks before this one and of those after it, each
    flattened in rank order, given this rank's (a host stage's per-cloud
    draw specs: the earlier ranks' rows of the batch precede this rank's);
    ``([], [])`` without a mesh."""
    if _ACTIVE is None:
        return [], []
    parts = exchange(list(items))
    r = _ACTIVE.rank
    return ([x for p in parts[:r] for x in p], [x for p in parts[r + 1:] for x in p])


def all_reduce_grads(params, mesh: Mesh) -> None:
    """The gradient of the global loss on every rank: each rank's gradients
    (of D times the loss, from autograd through the collectives) flattened
    in parameter order, summed in one all-reduce, divided by D."""
    params = [p for p in params if p.grad is not None]
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    dist.all_reduce(flat, group=mesh.group)
    flat.div_(mesh.size)
    offset = 0
    for p in params:
        n = p.grad.numel()
        p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
        offset += n


def mean_values(values: dict, mesh: Mesh) -> dict:
    """Each loss value averaged over the ranks in one all-reduce: a loss
    held equal on every rank stays itself; a mean of per-cloud values over
    this rank's equal slice becomes the global mean."""
    keys = sorted(values)
    flat = torch.stack([values[k].detach().float() for k in keys])
    dist.all_reduce(flat, group=mesh.group)
    flat.div_(mesh.size)
    return {k: flat[i] for i, k in enumerate(keys)}


def merge_meters(sums: dict, weight: float, mesh: Mesh) -> tuple[dict, float]:
    """An item-weighted loss meter's sums and weight, summed over the ranks
    (a rank that saw no item has none)."""
    total, w = {}, 0.0
    for s, wt in exchange((sums, weight), mesh):
        for k, v in s.items():
            total[k] = total.get(k, 0.0) + v
        w += wt
    return total, w
