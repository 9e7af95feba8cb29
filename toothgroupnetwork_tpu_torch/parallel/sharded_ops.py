"""Point-axis-sharded FPS and neighbour gather (counterpart of
toothgroupnetwork_tpu/parallel/sharded_ops.py).

With the point axis sharded (each rank ``N/D`` rows, rank r's rows
``r N/D ...``), FPS and the neighbourhood gather run without a rank ever
holding the whole cloud:

  * FPS is sequential over its samples. A step updates the shard's
    distances elementwise in the order of K1's plain version
    (``ops/kernels/fps.py:fps_reference``), takes the shard's (max, lowest
    index) and that point's coordinates, and all-gathers the D rows: the
    winner is the largest value, ties to the lower global index, and its
    coordinates come from its owner's row. It is a loop in torch, as the
    JAX version is a ``fori_loop``; no Pallas kernel backs it.
  * the gather rotates the source shard around the ring; each of the D
    steps serves the indices that fall in the resident shard.
"""

from __future__ import annotations

import torch

from .mesh import Mesh, all_gather, ring_pass


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


def ring_gather(x: torch.Tensor, idx: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Rows of the cloud whose shard ``x`` ``[N/D, C]`` this rank holds, at
    this rank's global indices ``idx`` ``[M, K]``: ``[M, K, C]``, bit-equal
    to the dense row gather. The shard makes D - 1 ring passes."""
    shard_n = x.shape[0]
    idx = idx.to(torch.int64)
    out = torch.zeros(idx.shape + x.shape[1:], dtype=x.dtype, device=x.device)
    xs = x
    for step in range(mesh.size):
        owner = (mesh.rank - step) % mesh.size
        here = (idx // shard_n) == owner
        li = torch.clamp(idx - owner * shard_n, 0, shard_n - 1)
        out = torch.where(here[..., None], xs[li], out)
        if step + 1 < mesh.size:
            xs = ring_pass(xs, mesh)
    return out
