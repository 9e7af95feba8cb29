"""Point-axis-sharded FPS and neighbour gather (counterpart of
toothgroupnetwork_tpu/parallel/sharded_ops.py).

Rank r holds rows ``[r N // D, (r + 1) N // D)`` of a point axis
(``points.bounds``: equal shards where D divides N).

  * :func:`sharded_fps` (the point-sharded eval forward, equal shards)
    never holds the whole cloud. FPS is sequential over its samples. A
    step updates the shard's distances elementwise in the order of K1's
    plain version (``ops/kernels/fps.py:fps_reference``), takes the shard's
    (max, lowest index) and that point's coordinates, and all-gathers the D
    rows: the winner is the largest value, ties to the lower global index,
    and its coordinates come from its owner's row. It is a loop in torch,
    as the JAX version is a ``fori_loop``; no Pallas kernel backs it.
  * :func:`gather_axis` all-gathers a whole point axis once (no gradient):
    the point-sharded train step's FPS (K1) and kNN (K2) run on the whole
    cloud's coordinates, 12 bytes a point, as GSPMD runs the dense step's
    kernels on the gathered cloud.
  * :func:`ring_gather` rotates the source shard around the ring, padded to
    ``ceil(N / D)`` rows in transit; each of the D steps serves the indices
    that fall in the resident shard. Its backward runs the ring the other
    way: an accumulator of each owner's row gradients travels to rank - 1,
    every rank adding its gathered rows' gradients for that owner in one
    ``index_put_(accumulate=True)`` (deterministic under
    ``torch.use_deterministic_algorithms``: a sorted segment sum on the
    card, in order on the CPU; never float atomics), until it reaches its
    owner.
  * :func:`crop_rows_gather` is the ring gather of a crop model's crop
    rows (tsegnet's l0 features): this rank's rows of the crop axis, whose
    indices every rank holds whole.
"""

from __future__ import annotations

import torch

from .mesh import Mesh, all_gather, ring_pass
from .points import bounds


def sharded_fps(xyz: torch.Tensor, n_samples: int, mesh: Mesh,
                mask: torch.Tensor | None = None) -> torch.Tensor:
    """Exact farthest point sampling of the cloud whose shard ``xyz``
    ``[N/D, 3]`` this rank holds (``mask`` ``[N/D]``: validity, valid points
    first over the whole cloud).

    Returns int64 ``[n_samples]`` global indices, the same on every rank and
    equal to ``ops.farthest_point_sample`` on the whole cloud: seeded at
    the first valid point, ties to the lower global index, invalid points
    never picked while a valid one is left."""
    xyz = xyz.to(torch.float32)
    n_loc = xyz.shape[0]
    base = mesh.rank * n_loc
    n = n_loc * mesh.size
    valid = (torch.ones(n_loc, dtype=torch.bool, device=xyz.device) if mask is None
             else mask.to(torch.bool))
    inf = torch.tensor(float("inf"), device=xyz.device)
    dist = torch.where(valid, inf, -inf)
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]

    # seed: the first valid point of the whole cloud (index 0 if none)
    first = torch.where(valid.any(), base + valid.to(torch.uint8).argmax(), n)
    start = int(all_gather(first.reshape(1), mesh).min())
    start = 0 if start == n else start
    owner, local = divmod(start, n_loc)
    row = xyz[local].double() if owner == mesh.rank else torch.zeros(
        3, dtype=torch.float64, device=xyz.device)
    last = all_gather(row, mesh)[owner].float()

    out = [start]
    for _ in range(1, n_samples):
        dx, dy, dz = x - last[0], y - last[1], z - last[2]
        d = (dx * dx + dy * dy) + dz * dz
        dist = torch.minimum(dist, torch.where(valid, d, -inf))
        li = dist.argmax()                      # first max: lowest index
        mine = torch.cat([dist[li].double().reshape(1),
                          (li + base).double().reshape(1), xyz[li].double()])
        rows = all_gather(mine, mesh)           # [D, 5], in rank order
        host = rows[:, :2].tolist()
        win = max(range(mesh.size), key=lambda r: (host[r][0], -r))
        out.append(int(host[win][1]))
        last = rows[win, 2:].float()            # the winner's, from its owner
    return torch.tensor(out, dtype=torch.int64, device=xyz.device)


def gather_axis(x: torch.Tensor, mesh: Mesh, n: int) -> torch.Tensor:
    """The whole ``n``-row point axis of which this rank holds ``x``
    ``[B, n_r, ...]``: ``[B, n, ...]``, every rank's rows in rank order, in
    one all-gather of ``ceil(n / D)``-row payloads. No gradient."""
    b = bounds(n, mesh.size)
    parts = all_gather(pad_rows(x.detach(), -(-n // mesh.size)), mesh)
    out = torch.cat([parts[r, :, :b[r + 1] - b[r]] for r in range(mesh.size)], dim=1)
    return out.to(x.dtype)


def pad_rows(x: torch.Tensor, pad: int) -> torch.Tensor:
    """``x`` ``[B, n_r, C]`` padded to ``pad`` rows, a ring payload (bool as
    uint8: the collectives take no bool)."""
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    if x.shape[1] == pad:
        return x.contiguous()
    out = x.new_zeros((x.shape[0], pad) + tuple(x.shape[2:]))
    out[:, :x.shape[1]] = x
    return out


def _owners(idx: torch.Tensor, b: list[int]) -> torch.Tensor:
    """The rank owning each global index (``b``: the shard bounds)."""
    edges = torch.tensor(b[1:-1], dtype=torch.int64, device=idx.device)
    return torch.bucketize(idx, edges, right=True)


class _RingGather(torch.autograd.Function):
    """Rows ``x`` ``[B, n_r, C]`` of an ``n``-point cloud at global indices
    ``idx`` ``[B, ...]``; backward: the rows' gradients back to their
    owners (module docstring)."""

    @staticmethod
    def forward(ctx, x, idx, mesh, n):
        b = bounds(n, mesh.size)
        pad = -(-n // mesh.size)        # the largest shard's rows
        bsz = idx.shape[0]
        flat = idx.reshape(bsz, -1).to(torch.int64)
        owner = _owners(flat, b)
        clouds = torch.arange(bsz, device=idx.device)[:, None].expand_as(flat)
        blk = pad_rows(x, pad)
        out = blk.new_zeros(flat.shape + tuple(x.shape[2:]))
        for step in range(mesh.size):
            o = (mesh.rank - step) % mesh.size
            here = owner == o
            li = torch.clamp(flat - b[o], 0, pad - 1)
            out = torch.where(here.reshape(here.shape + (1,) * (out.dim() - 2)),
                              blk[clouds, li], out)
            if step + 1 < mesh.size:
                blk = ring_pass(blk, mesh)
        ctx.mesh, ctx.bounds, ctx.pad, ctx.n_own = mesh, b, pad, x.shape[1]
        ctx.save_for_backward(flat, owner)
        out = out.reshape(idx.shape + tuple(x.shape[2:]))
        return out.to(torch.bool) if x.dtype == torch.bool else out

    @staticmethod
    def backward(ctx, grad):
        flat, owner = ctx.saved_tensors
        mesh, b, pad = ctx.mesh, ctx.bounds, ctx.pad
        bsz = flat.shape[0]
        g = grad.reshape(bsz, flat.shape[1], -1)
        clouds = torch.arange(bsz, device=flat.device)[:, None].expand_as(flat)
        acc = None
        # backwards round the ring: at step t this rank adds to the
        # accumulator of owner rank - t, then hands it to rank - 1
        for t in range(mesh.size - 1, -1, -1):
            o = (mesh.rank - t) % mesh.size
            here = owner == o
            part = g.new_zeros((bsz, pad, g.shape[-1])) if acc is None else acc
            part = part.index_put_((clouds[here], (flat - b[o])[here]), g[here],
                                   accumulate=True)
            acc = ring_pass(part, mesh, shift=-1) if t else part
        return acc[:, :ctx.n_own], None, None, None


def ring_gather(x: torch.Tensor, idx: torch.Tensor, mesh: Mesh,
                n: int | None = None) -> torch.Tensor:
    """Rows of the cloud of ``n`` points (by default ``n_r`` times D) whose
    rows ``x`` ``[n_r, C]`` (or ``[B, n_r, C]``) this rank holds, at this
    rank's global indices ``idx`` ``[M, K]`` (``[B, ...]``):
    ``idx.shape + (C,)``, bit-equal to the dense row gather. The shard makes
    D - 1 ring passes; so does its gradient, the other way."""
    if x.dim() == 2:
        return ring_gather(x[None], idx[None], mesh, n)[0]
    n = x.shape[1] * mesh.size if n is None else n
    return _RingGather.apply(x, idx, mesh, n)


def crop_rows_gather(x: torch.Tensor, idx: torch.Tensor, lo: int, hi: int, mesh: Mesh,
                     n: int) -> torch.Tensor:
    """Rows of the ``n``-point clouds whose shards ``x`` ``[B, n_r, C]`` this
    rank holds, at crops ``[lo, hi)`` of ``idx`` ``[B, K, S]`` (global point
    indices; the crop axis is ``B·K`` crops, cloud-major): ``[hi - lo, S,
    C]``, bit-equal to the dense ``index_points`` of those crops, with its
    gradient returned to the owners (:func:`ring_gather`). A crop's row of
    indices goes to its cloud's slot of a ``[B, hi - lo, S]`` index, the
    other clouds' slots index row 0, and each crop takes its cloud's
    slot."""
    b, k, s = idx.shape
    r = torch.arange(lo, hi, device=idx.device)
    cloud, slot = r // k, r - lo
    per_cloud = idx.new_zeros((b, hi - lo, s))
    per_cloud[cloud, slot] = idx.reshape(b * k, s)[r]
    return ring_gather(x, per_cloud, mesh, n)[cloud, slot]
