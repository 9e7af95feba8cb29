"""K9 / K10 — the tgnet instancing's DBSCAN and MeanShift climbs on the card
(csrc/cluster.cu) and their plain twins.

They replace no TPU kernel: the JAX package clusters on the host with
scikit-learn, and the port's host copy (``postprocess/clustering.py``:
``dbscan``, ``mean_shift``) stays for every other caller. Both kernels are
exact: their labels, numbering and modes equal the host functions' (the
source note in csrc/cluster.cu gives the arithmetic), and so do the twins'
below, which repeat that arithmetic op by op.
"""

from __future__ import annotations

import numpy as np
import torch

from . import build
from ._launch import count_launch, on_cpu, require, stream_of


def dbscan(xyz: torch.Tensor, eps: float, min_samples: int) -> torch.Tensor:
    """K9: ``xyz [n, 3]`` f32 -> int64 ``[2, n]``: DBSCAN's labels (-1 =
    noise, clusters numbered by their lowest core index) and 1 for a core
    point, as ``postprocess/clustering.py:dbscan`` gives them. CPU tensors
    take :func:`dbscan_reference`."""
    if on_cpu(xyz):
        return dbscan_reference(xyz, eps, min_samples)
    dev = xyz.device
    require(xyz, "xyz", torch.float32, 2, dev)
    n = xyz.shape[0]
    if xyz.shape[1] != 3:
        raise ValueError(f"dbscan: xyz {tuple(xyz.shape)}")
    out = torch.empty((2, n), dtype=torch.int64, device=dev)
    if n == 0:
        return out
    with torch.cuda.device(dev):
        lib = build.library()
        scratch = torch.empty(3 * n, dtype=torch.int32, device=dev)
        status = lib.tgn_dbscan(xyz.data_ptr(), n, float(eps) * float(eps),
                                int(min_samples), scratch.data_ptr(), out.data_ptr(),
                                stream_of(dev))
        build.check(status, "tgn_dbscan")
    count_launch(dbscan)
    return out


dbscan.launches = 0


def stop_threshold(bandwidth: float) -> float:
    """The MeanShift stop ``1e-3 * bandwidth`` as numpy compares a float32
    norm with it: rounded to float32 where numpy compares in float32 (its
    promotion rules since 2.0), else the float64 value."""
    stop = 1e-3 * bandwidth
    return float(np.asarray(stop, (np.float32(0) + stop).dtype))


def mean_shift(points: torch.Tensor, offsets: torch.Tensor, seeds: torch.Tensor,
               seed_cluster: torch.Tensor, bandwidth: float,
               max_iter: int = 300) -> tuple[torch.Tensor, torch.Tensor]:
    """K10: the flat-kernel climbs of ``seeds [S, 3]`` f32, seed s over the
    points of cluster ``seed_cluster[s]`` (int32), rows ``offsets[c]`` to
    ``offsets[c + 1]`` (int32 ``[C + 1]``) of ``points [P, 3]`` f32 ->
    (means f32 ``[S, 3]``, counts int32 ``[S]``): each climb's last mean
    and the size of its last ball (0: the ball was empty and the seed is
    dropped), as ``postprocess/clustering.py:mean_shift`` climbs. CPU
    tensors take :func:`mean_shift_reference`."""
    if on_cpu(points):
        return mean_shift_reference(points, offsets, seeds, seed_cluster, bandwidth,
                                    max_iter)
    dev = points.device
    require(points, "points", torch.float32, 2, dev)
    require(offsets, "offsets", torch.int32, 1, dev)
    require(seeds, "seeds", torch.float32, 2, dev)
    require(seed_cluster, "seed_cluster", torch.int32, 1, dev)
    s = seeds.shape[0]
    if points.shape[1] != 3 or seeds.shape[1] != 3 or seed_cluster.shape[0] != s:
        raise ValueError(f"mean_shift: points {tuple(points.shape)} seeds "
                         f"{tuple(seeds.shape)} seed_cluster {tuple(seed_cluster.shape)}")
    means = torch.empty((s, 3), dtype=torch.float32, device=dev)
    counts = torch.empty((s,), dtype=torch.int32, device=dev)
    if s == 0:
        return means, counts
    with torch.cuda.device(dev):
        lib = build.library()
        status = lib.tgn_mean_shift(points.data_ptr(), offsets.data_ptr(),
                                    seeds.data_ptr(), seed_cluster.data_ptr(), s,
                                    float(bandwidth) * float(bandwidth),
                                    stop_threshold(bandwidth), int(max_iter),
                                    means.data_ptr(), counts.data_ptr(), stream_of(dev))
        build.check(status, "tgn_mean_shift")
    count_launch(mean_shift)
    return means, counts


mean_shift.launches = 0


def _d2_exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared distances ``[..., 3]`` float64, op by op as the kernels
    compute them: (dx*dx + dy*dy) + dz*dz."""
    d = a - b
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]


def numpy_norm(diff: torch.Tensor) -> torch.Tensor:
    """``np.linalg.norm`` of each float32 3-vector of ``diff [..., 3]`` as
    numpy computes it through OpenBLAS's ``sdot``, and as K10 does: the
    float32 squares summed in float64 in the order x, y, z, rounded to
    float32, the root correctly rounded to float32 (taken in float64 here:
    torch's float32 root on the CPU may miss by an ulp). The host climbs'
    stop test takes this norm; ``tests/test_torch_port_clustering_device.py``
    holds it to the host's numpy."""
    sq = diff * diff
    total = ((sq[..., 0].double() + sq[..., 1].double()) + sq[..., 2].double()).float()
    return torch.sqrt(total.double()).float()


def dbscan_reference(xyz: torch.Tensor, eps: float, min_samples: int) -> torch.Tensor:
    """Plain twin of K9: the pairs by row blocks, the components by
    min-index propagation over the core-core edges."""
    x = xyz.to(torch.float64)
    n = x.shape[0]
    eps2 = float(eps) * float(eps)
    block = max(1, (1 << 22) // max(n, 1))
    counts = torch.zeros(n, dtype=torch.int64)
    src, dst = [], []
    for i0 in range(0, n, block):
        near = _d2_exact(x[i0:i0 + block, None, :], x[None, :, :]) <= eps2
        counts[i0:i0 + block] = near.sum(dim=1)
        i, j = near.nonzero(as_tuple=True)
        src.append(i + i0)
        dst.append(j)
    src = torch.cat(src) if src else torch.zeros(0, dtype=torch.int64)
    dst = torch.cat(dst) if dst else torch.zeros(0, dtype=torch.int64)
    core = counts >= min_samples
    labels = torch.full((n,), -1, dtype=torch.int64)
    # each core point's component's lowest index
    cc = core[src] & core[dst]
    a, b = src[cc], dst[cc]
    rep = torch.arange(n)
    while True:
        new = rep.scatter_reduce(0, a, rep[b], "amin")
        new = new[new]
        if torch.equal(new, rep):
            break
        rep = new
    root = core & (rep == torch.arange(n))
    rank = torch.cumsum(root.to(torch.int64), 0) - 1
    labels[core] = rank[rep[core]]
    # border points: the smallest number among their core neighbours
    big = torch.iinfo(torch.int64).max
    sel = ~core[src] & core[dst]
    border = torch.full((n,), big, dtype=torch.int64).scatter_reduce(
        0, src[sel], labels[dst[sel]], "amin")
    has = ~core & (border != big)
    labels[has] = border[has]
    return torch.stack([labels, core.to(torch.int64)])


def mean_shift_reference(points: torch.Tensor, offsets: torch.Tensor,
                         seeds: torch.Tensor, seed_cluster: torch.Tensor,
                         bandwidth: float, max_iter: int = 300):
    """Plain twin of K10: every seed climbs at once, one step of all
    unfinished seeds a round; each step's sum runs over the points in
    ascending order, one float32 add a point (a vectorised sum adds in
    another order)."""
    pts = points.to(torch.float32)
    pts64 = pts.to(torch.float64)
    s = seeds.shape[0]
    bw2 = float(bandwidth) * float(bandwidth)
    stop = stop_threshold(bandwidth)
    off = offsets.to(torch.int64)
    idx = torch.arange(pts.shape[0])
    clus = seed_cluster.to(torch.int64)
    own = (idx[None, :] >= off[clus][:, None]) & (idx[None, :] < off[clus + 1][:, None])
    means = seeds.to(torch.float32).clone()
    counts = torch.zeros(s, dtype=torch.int32)
    live = torch.ones(s, dtype=torch.bool)
    it = 0
    while live.any():
        rows = live.nonzero(as_tuple=True)[0]
        inside = own[rows] & (_d2_exact(pts64[None, :, :],
                                        means[rows].to(torch.float64)[:, None, :]) <= bw2)
        total = torch.full((len(rows), 3), -0.0, dtype=torch.float32)
        for j in inside.any(dim=0).nonzero(as_tuple=True)[0].tolist():
            total = total + torch.where(inside[:, j, None], pts[j], -0.0)
        cnt = inside.sum(dim=1).to(torch.int32)
        counts[rows] = cnt
        empty = cnt == 0
        new = total / cnt.to(torch.float32)[:, None]
        norm = numpy_norm(new - means[rows])
        moved = rows[~empty]
        means[moved] = new[~empty]
        done = empty | (norm.double() <= stop) | (it == max_iter)
        live[rows[done]] = False
        it += 1
    return means, counts
