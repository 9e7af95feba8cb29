"""K2 — exact k-nearest-neighbour selection (csrc/knn.cu) and its plain twin.

Replaces toothgroupnetwork_tpu/ops/pallas/knn_kernel.py:knn_pallas_select
(``_knn_kernel``). The contract is that of ``knn_points`` on CPU in the JAX
package: sorted ascending by (d2, index), masked points biased by 1e10, and
for k > n a tail of index 0 at d2 = 1e10. What bounds it on the H100 is the
M x N distance stream and the selection's latency. At C = 3 the kernel runs
one warp per query over shared-memory tiles of candidates, a ballot against
the k-th (d2, index) key filtering them into a warp-resident sorted list,
and seeds each query's list from the candidates around its own index, so
its time no longer follows the cloud's order (csrc/knn.cu gives the
design). The self-first dedup and the exact re-score stay in plain torch
(ops/knn.py), as they stay in XLA around the Pallas kernel.

Any channel count C is taken, as ``knn_pallas_select`` takes one: C = 3 (xyz)
runs ``tgn_knn`` (float4 candidate tiles, the seed window), any other C up
to :data:`MAX_C` ``tgn_knn_c``, as DGCNN selects in feature space at C = 6
and 64; beyond the warp list's k (:data:`MAX_K`) or C > :data:`MAX_C`,
``tgn_knn_any``. The route follows from the shape alone (:func:`knn_route`);
no preset reaches the third (DGCNN's k = 20, ``nsample`` <= 36, the CBL
loss's k <= 64).

The two feature-space routes share one register-tiled distance stage
(csrc/knn.cu): a block of 64 queries walks its candidates in tiles of 128,
each thread summing a 4 x 8 tile of pairs channel by channel in the plain
twin's order, so the FP32 pipe sets the pace; products and sums are issued
apart (no FMA), so the exact form runs at half the card's FP32 operation
rate. The stage computes every pair, though a self-query's cross term is
symmetric and needs only n (n + 1) / 2 of them: that caps DGCNN's
self-kNN near a quarter of its bound (a tile computed once for both
triangles would lift it to a half). |q|^2 and |p|^2 come from a pre-pass
into scratch.
``tgn_knn_c`` then selects with a warp list a row (two register banks, one
when k <= 32), each split's first tile filled by a bitonic sort;
``tgn_knn_any`` queues each row's keys below its bar and merges a full queue
by rank into a sorted list of any k in global memory. Keys (d2, index) are
unique, so neither the order of the candidates nor a bar that lags changes
the k smallest; that is what lets the candidates be split across blocks,
when the queries' tiles alone leave block slots idle, and the partial
lists be merged by rank (one split writes the output directly).
"""

from __future__ import annotations

import ctypes

import torch

from ..distance import square_distance
from . import build
from ._launch import count_launch, on_cpu, require, stream_of

MAX_K = 64
MAX_C = 256


def knn_route(c: int, k: int) -> str:
    """The kernel :func:`knn_select` launches on a CUDA tensor for C
    channels and k neighbours: ``"tgn_knn"`` (C = 3), ``"tgn_knn_c"`` (any
    other C up to :data:`MAX_C`), each for k up to :data:`MAX_K`, else
    ``"tgn_knn_any"``."""
    if k > MAX_K or c > MAX_C:
        return "tgn_knn_any"
    return "tgn_knn" if c == 3 else "tgn_knn_c"


def knn_select(query: torch.Tensor, points: torch.Tensor, k: int,
               bias: torch.Tensor | None = None):
    """query ``[B, M, C]``, points ``[B, N, C]`` f32 contiguous, bias ``[B, N]``
    f32 or None -> (idx int32 ``[B, M, k]``, d2 f32 ``[B, M, k]``).
    CPU tensors take :func:`knn_select_reference`. Each launch also counts
    under its C in ``knn_select.launches_by_shape``."""
    if on_cpu(query):
        return knn_select_reference(query, points, k, bias)
    dev = query.device
    require(query, "query", torch.float32, 3, dev)
    require(points, "points", torch.float32, 3, dev)
    b, m, c = query.shape
    n = points.shape[1]
    if points.shape[2] != c or points.shape[0] != b or c < 1:
        raise ValueError(f"knn: query {tuple(query.shape)} points "
                         f"{tuple(points.shape)} (C >= 1)")
    if k < 1:
        raise ValueError(f"knn takes k >= 1, got {k}")
    if bias is not None:
        require(bias, "bias", torch.float32, 2, dev)
        if tuple(bias.shape) != (b, n):
            raise ValueError(f"bias {tuple(bias.shape)} != {(b, n)}")
    route = knn_route(c, k)
    with torch.cuda.device(dev):
        lib = build.library()
        idx = torch.empty((b, m, k), dtype=torch.int32, device=dev)
        d2 = torch.empty((b, m, k), dtype=torch.float32, device=dev)
        bias_ptr = None if bias is None else bias.data_ptr()
        if route == "tgn_knn":
            status = lib.tgn_knn(query.data_ptr(), points.data_ptr(), bias_ptr,
                                 b, m, n, k, idx.data_ptr(), d2.data_ptr(),
                                 stream_of(dev))
        else:
            status = launch_feature_knn(lib, route, query, points, bias, k, idx, d2,
                                        stream_of(dev))
        build.check(status, route)
    count_launch(knn_select, c)
    return idx, d2


knn_select.launches = 0
knn_select.launches_by_shape = {}


def launch_feature_knn(lib, route: str, query: torch.Tensor, points: torch.Tensor,
                       bias: torch.Tensor | None, k: int, idx: torch.Tensor,
                       d2: torch.Tensor, stream: int) -> int:
    """Launch ``tgn_knn_c`` or ``tgn_knn_any`` of ``lib`` into ``idx``/``d2``
    on ``stream``, with one scratch buffer of the bytes the library asks for
    at this shape (``tgn_knn_scratch``; its layout stays in csrc/knn.cu).
    Returns the C entry's status."""
    b, m, c = query.shape
    n = points.shape[1]
    nbytes = ctypes.c_size_t(0)
    splits = lib.tgn_knn_scratch(int(route == "tgn_knn_any"), b, m, n, k,
                                 ctypes.byref(nbytes))
    if splits < 1:
        return -splits
    scratch = torch.empty(nbytes.value, dtype=torch.uint8, device=query.device)
    return getattr(lib, route)(
        query.data_ptr(), points.data_ptr(),
        None if bias is None else bias.data_ptr(), b, m, n, c, k, scratch.data_ptr(),
        idx.data_ptr(), d2.data_ptr(), stream)


def smallest_k(d2: torch.Tensor, k: int):
    """The ``k`` smallest entries of the last axis, ascending, ties to the lower
    index (a stable sort); for k > n the tail is index 0 at 1e10.
    Returns (idx int32, values)."""
    n = d2.shape[-1]
    vals, idx = torch.sort(d2, dim=-1, stable=True)
    vals, idx = vals[..., :k], idx[..., :k].to(torch.int32)
    if k > n:
        tail = d2.shape[:-1] + (k - n,)
        idx = torch.cat([idx, idx.new_zeros(tail)], dim=-1)
        vals = torch.cat([vals, vals.new_full(tail, 1e10)], dim=-1)
    return idx, vals


def knn_select_reference(query: torch.Tensor, points: torch.Tensor, k: int,
                         bias: torch.Tensor | None = None,
                         chunk: int = 1024):
    """Plain twin of :func:`knn_select`, query rows in chunks so [M, N] is
    never whole; distances in the kernel's order (ops/distance.py)."""
    idx, d2 = [], []
    for s in range(0, query.shape[1], chunk):
        d = square_distance(query[:, s:s + chunk], points)
        d = d + (0.0 if bias is None else bias[:, None, :])
        i, v = smallest_k(d, k)
        idx.append(i)
        d2.append(v)
    return torch.cat(idx, dim=1), torch.cat(d2, dim=1)
