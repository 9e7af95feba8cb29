"""Plain point operations of the reference: exact farthest point sampling,
exact kNN by a stable sort of the squared distances, row gathers, the 3-NN
interpolation and the dense layers, in plain torch on any device.

The squared distances follow the fixed-order expansion
``|s|^2 - 2 s.d + |d|^2``, channel by channel with separate multiplies and
adds, and FPS sums ``(dx dx + dy dy) + dz dz``: that is the arithmetic the
served program states for its selections, so exact selections agree up to
the order of equal keys, which both break towards the lower index.

``Precision`` carries the one switch of the reference: ``tf32`` rounds both
operands of every matrix product to TF32 (10 mantissa bits, to nearest),
the control one step below the float32 the configurations state.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

BIG = 1e10
# rows of a distance matrix sorted at once: bounds the memory of a block
# at ROW_BLOCK x N floats
ROW_BLOCK = 1024


@dataclass(frozen=True)
class Precision:
    tf32: bool = False


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` float32 rounded to TF32's 10-bit mantissa, to nearest even
    (inf and nan pass through)."""
    bits = x.float().contiguous().view(torch.int32)
    low = bits & 0x1FFF
    up = (low > 0x1000) | ((low == 0x1000) & ((bits & 0x2000) != 0))
    rounded = (bits & ~0x1FFF) + torch.where(up, 0x2000, 0).to(torch.int32)
    finite = torch.isfinite(x.float())
    return torch.where(finite, rounded.view(torch.float32), x.float())


class _LinearTF32(torch.autograd.Function):
    """``x @ w.T`` with both operands of every product rounded to TF32, in
    the backward's products too, as TF32 matrix products run."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return round_tf32(x) @ round_tf32(w).T

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = round_tf32(g)
        gx = (g @ round_tf32(w)).reshape(x.shape)
        gw = g.reshape(-1, g.shape[-1]).T @ round_tf32(x).reshape(-1, x.shape[-1])
        return gx, gw


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
           prec: Precision) -> torch.Tensor:
    """``x @ w.T + b`` in float32 (``w`` ``[out, in]``), or on TF32 operands."""
    if not prec.tf32:
        return torch.nn.functional.linear(x.float(), w.float(), b)
    y = _LinearTF32.apply(x.float(), w.float())
    return y if b is None else y + b


def dot_fixed(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    acc = a[..., 0] * b[..., 0]
    for i in range(1, a.shape[-1]):
        acc = acc + a[..., i] * b[..., i]
    return acc


def square_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """``[B, M, C] x [B, N, C] -> [B, M, N]``, clamped at 0."""
    s2 = dot_fixed(src, src)
    d2 = dot_fixed(dst, dst)
    cross = dot_fixed(src.unsqueeze(-2), dst.unsqueeze(-3))
    return torch.clamp_min((s2.unsqueeze(-1) - 2.0 * cross) + d2.unsqueeze(-2), 0.0)


def index_points(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x`` ``[B, N, C]`` rows at ``idx`` ``[B, ...]`` -> ``[B, ..., C]``."""
    b = x.shape[0]
    flat = idx.reshape(b, -1).long()
    out = torch.gather(x, 1, flat[..., None].expand(-1, -1, x.shape[-1]))
    return out.reshape(*idx.shape, x.shape[-1])


def fps(xyz: torch.Tensor, n: int, valid: torch.Tensor | None = None) -> torch.Tensor:
    """Exact FPS of ``xyz`` ``[B, N, 3]``: seeded at the first valid point,
    each step the valid point farthest from the chosen set (the lowest index
    among equals); ``[B, n]`` int64."""
    b, npts, _ = xyz.shape
    if valid is None:
        valid = torch.ones((b, npts), dtype=torch.bool, device=xyz.device)
    inf = torch.tensor(float("inf"), device=xyz.device)
    dist = torch.where(valid, inf, -inf)
    rows = torch.arange(b, device=xyz.device)
    last = valid.to(torch.uint8).argmax(dim=1)
    out = torch.empty((b, n), dtype=torch.int64, device=xyz.device)
    out[:, 0] = last
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    for i in range(1, n):
        lc = xyz[rows, last]
        dx, dy, dz = x - lc[:, 0:1], y - lc[:, 1:2], z - lc[:, 2:3]
        d = (dx * dx + dy * dy) + dz * dz
        dist = torch.minimum(dist, torch.where(valid, d, -inf))
        last = dist.argmax(dim=1)
        out[:, i] = last
    return out


def smallest_k(d2: torch.Tensor, k: int):
    """The ``k`` smallest of each row of ``d2`` ``[B, M, N]`` by (value,
    index), ascending, sorted in blocks of rows; for k > N the tail is index
    0 at BIG. Returns (idx int64, d2)."""
    b, m, n = d2.shape
    keff = min(k, n)
    vals = torch.empty((b, m, keff), dtype=d2.dtype, device=d2.device)
    idx = torch.empty((b, m, keff), dtype=torch.int64, device=d2.device)
    for lo in range(0, m, ROW_BLOCK):
        v, i = torch.sort(d2[:, lo:lo + ROW_BLOCK], dim=-1, stable=True)
        vals[:, lo:lo + ROW_BLOCK], idx[:, lo:lo + ROW_BLOCK] = v[..., :keff], i[..., :keff]
    if keff < k:
        pad = k - keff
        idx = torch.cat([idx, idx.new_zeros((b, m, pad))], dim=-1)
        vals = torch.cat([vals, vals.new_full((b, m, pad), BIG)], dim=-1)
    return idx, vals


def select(query: torch.Tensor, points: torch.Tensor, k: int,
           p_mask: torch.Tensor | None = None):
    """Exact k smallest squared distances by the expansion, masked points
    biased by BIG, in blocks of query rows. Returns (idx, d2)."""
    outs = []
    for lo in range(0, query.shape[1], ROW_BLOCK):
        d2 = square_distance(query[:, lo:lo + ROW_BLOCK], points)
        if p_mask is not None:
            d2 = d2 + torch.where(p_mask, 0.0, BIG)[:, None, :]
        outs.append(smallest_k(d2, k))
    return (torch.cat([o[0] for o in outs], dim=1),
            torch.cat([o[1] for o in outs], dim=1))


def knn_points(query, points, k, p_mask=None, *, include_self=False,
               need_dist=True):
    """Exact kNN with the served program's stated contract: ``include_self``
    puts each row's own index first and drops its first duplicate among the
    selected (or the last selected when it is absent); ``need_dist``
    re-scores the selected by direct subtraction and re-sorts them (ties to
    the earlier). Returns (idx int64 ``[B, M, k]``, Euclidean distance)."""
    query, points = query.float(), points.float()
    b, m = query.shape[:2]
    n = points.shape[1]
    idx, d2 = select(query, points, k, p_mask)
    keff = min(k, n)
    dup = None
    if include_self:
        qi = torch.clamp(torch.arange(m, device=idx.device), max=n - 1)
        self_col = qi[None, :, None].expand(b, m, 1)
        dup = idx == self_col
        idx = torch.cat([self_col, idx], dim=-1)
    if need_dist:
        delta = query[:, :, None, :] - index_points(points, idx)
        d2s = dot_fixed(delta, delta)
        if keff < k:
            pad = torch.arange(d2s.shape[-1], device=idx.device) >= (
                d2s.shape[-1] - (k - keff))
            d2s = torch.where(pad, BIG, d2s)
        if include_self:
            d2s = torch.cat([d2s[..., :1], torch.where(dup, BIG, d2s[..., 1:])], dim=-1)
    else:
        d2s = torch.clamp_min(d2, 0.0)
        if include_self:
            d2s = torch.cat([torch.zeros_like(d2s[..., :1]),
                             torch.where(dup, BIG, d2s)], dim=-1)
    if include_self and not need_dist:
        any_dup = dup.any(dim=-1)
        dpos = torch.where(any_dup, dup.to(torch.uint8).argmax(dim=-1), k - 1)
        sel = torch.arange(k - 1, device=idx.device) >= dpos[..., None]
        idx = torch.cat([idx[..., :1], torch.where(sel, idx[..., 2:k + 1],
                                                   idx[..., 1:k])], dim=-1)
        d2o = torch.cat([d2s[..., :1], torch.where(sel, d2s[..., 2:k + 1],
                                                   d2s[..., 1:k])], dim=-1)
    elif include_self or need_dist:
        d2o, order = torch.sort(d2s, dim=-1, stable=True)
        d2o, order = torch.clamp_min(d2o[..., :k], 0.0), order[..., :k]
        idx = torch.gather(idx, -1, order)
    else:
        d2o = d2s
    pos = d2o > 0
    return idx, torch.where(pos, torch.sqrt(torch.where(pos, d2o, 1.0)), 0.0)


def nearest_rescored(query: torch.Tensor, points: torch.Tensor, k: int):
    """``[N, 3]`` queries' k nearest of ``points`` ``[M, 3]`` by the
    expansion, re-scored by direct subtraction and re-sorted. Returns (idx
    ``[N, k]``, the first's exact squared distance ``[N]``)."""
    idx = knn_points(query[None], points[None], k)[0][0]
    delta = query - points[idx[:, 0]]
    return idx, dot_fixed(delta, delta)


def interpolate3(target, source, feat, t_mask=None, s_mask=None):
    """Inverse-distance weights over the exact 3 nearest (re-scored)."""
    idx, dist = knn_points(target, source, 3, s_mask)
    recip = 1.0 / (dist + 1e-8)
    weight = recip / recip.sum(dim=-1, keepdim=True)
    return (index_points(feat, idx) * weight[..., None]).sum(dim=-2)


def masked_mean(x, mask, dim):
    if mask is None:
        return x.mean(dim=dim)
    w = mask[..., None].to(x.dtype)
    return (x * w).sum(dim=dim) / torch.clamp_min(w.sum(dim=dim), 1.0)


def batchnorm_eval(x, p: dict, name: str, eps: float = 1e-5):
    inv = torch.reciprocal(torch.sqrt(p[name + ".var"] + eps))
    return (x.float() - p[name + ".mean"]) * inv * p[name + ".scale"] + p[name + ".bias"]
