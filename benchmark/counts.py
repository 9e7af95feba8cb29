"""The benchmark's yardstick of work: the card's published peaks, the bounds
of the kernels the per-layer metrics hold to their roofline, and the model
FLOPs by shape. A trained model's step, its FLOPs and its kernels' bounds,
is counted in its reference module (``reference/<task>.py``) from these
primitives.

Peaks are NVIDIA's H100 SXM data sheet (dense, no sparsity): float32
outside the tensor cores and HBM bandwidth. The configurations state float32
with TF32 off, so every FLOP is held to the float32 peak.

A model's FLOPs are its matrix products, ``2 * rows * din * dout`` for every
Dense, at the rows the inputs need: the attention's q/k/v projections once
a point, its position and weight MLPs once a neighbour row, a scan's crop
stage over the crops it has and not over the padded slots. Distances,
selections, norms and activations are not counted. The test holds these
functions equal to ``torch.utils.flop_counter.FlopCounterMode`` over the
plain references.
"""

from __future__ import annotations

F32_FLOPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
SHARE_PLANES = 8
BASE_FDIM = 32


def bound_s(ops: float, nbytes: float) -> float:
    """The least time of a call: the larger of its operations over the
    float32 peak and its bytes over the HBM bandwidth."""
    return max(ops / F32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S)


def knn_ops(c: int, b: int, m: int, n: int, self_query: bool) -> float:
    """K2's operations: each (query, point) pair C mul and C - 1 add for the
    cross term, then the doubling, a sub and an add of |p|^2 and a compare.
    A self-query's cross term is symmetric, so it needs n (n + 1) / 2
    pairs."""
    pairs = n * (n + 1) / 2 if self_query else m * n
    return float(b) * ((2.0 * c - 1.0) * pairs + 4.0 * m * n)


def knn_bound_s(c: int, b: int, m: int, n: int, k: int, self_query: bool) -> float:
    """K2's bound: the operations above, the bytes its inputs (queries and
    points, float32) and its outputs (k int32 indices and float32 squared
    distances a query) move once."""
    nbytes = 4.0 * b * (m * c + (0 if self_query else n * c) + 2 * m * k)
    return bound_s(knn_ops(c, b, m, n, self_query), nbytes)


def fps_bound_s(b: int, n: int, samples: int) -> float:
    """K1's bound: each step updates each point's distance to the chosen
    set (3 sub, 3 mul, 2 add, min and the argmax compare: 10 operations);
    the points are read and the indices written once."""
    return bound_s(10.0 * b * samples * n, 4.0 * b * (3 * n + samples))


def dense_flops(rows: float, din: int, dout: int) -> float:
    return 2.0 * rows * din * dout


def backbone_flops(arch: dict, k: int, b: int, n: int, c: int = 6) -> float:
    """One point-transformer segmentation forward of ``b`` clouds of ``n``
    points with ``c`` input channels and ``k`` classes, at ``arch``'s
    planes, strides, neighbours and blocks."""
    planes, stride = arch["planes"], arch["stride"]
    nsample, blocks, depth = arch["nsample"], arch["blocks"], arch["block_num"]
    sizes, total, din = [], 0.0, c
    rows = n
    for i in range(depth):
        if stride[i] == 1:
            total += dense_flops(b * rows, din, planes[i])
        else:
            rows //= stride[i]
            total += dense_flops(b * rows * nsample[i], 3 + din, planes[i])
        sizes.append(rows)
        total += (blocks[i] - 1) * block_flops(b * rows, nsample[i], planes[i])
        din = planes[i]
    top = depth - 1
    total += dense_flops(b, planes[top], planes[top])                 # head mean
    total += dense_flops(b * sizes[top], 2 * planes[top], planes[top])
    total += block_flops(b * sizes[top], nsample[top], planes[top])
    for i in range(depth - 2, -1, -1):
        total += dense_flops(b * sizes[i], planes[i], planes[i])
        total += dense_flops(b * sizes[i + 1], planes[i + 1], planes[i])
        total += block_flops(b * sizes[i], nsample[i], planes[i])
    for out in (k, 3):                                               # the heads
        total += sum(dense_flops(b * sizes[i], planes[i], BASE_FDIM)
                     for i in range(depth))
        total += dense_flops(b * n, BASE_FDIM * depth, out)
    return total


def block_flops(rows: float, nsample: int, planes: int) -> float:
    """A point-transformer block on ``rows`` points: two Dense around the
    attention, whose q/k/v are projected once a point and whose position
    and weight MLPs run once a neighbour row."""
    cs = planes // SHARE_PLANES
    pair = rows * nsample
    return (dense_flops(rows, planes, planes) * 5
            + dense_flops(pair, 3, 3) + dense_flops(pair, 3, planes)
            + dense_flops(pair, planes, cs) + dense_flops(pair, cs, cs))


def tgnet_scan_flops(config: dict, fps_crops: int, bdl_crops: int) -> float:
    """One scan: both models' stage 1 over the sample and stage 2 over the
    crops the scan has (``fps_crops`` and ``bdl_crops`` valid slots)."""
    n, s = config["n_sample"], config["crop_sample_size"]
    fa, ba = config["model_parameter"], config["bdl_arch"]
    return (backbone_flops(fa, 10, 1, n) + backbone_flops(fa, 2, fps_crops, s)
            + backbone_flops(ba, 10, 1, n) + backbone_flops(ba, 2, bdl_crops, s))
