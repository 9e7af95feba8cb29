"""Mask-aware building blocks (counterpart of
toothgroupnetwork_tpu/nn/layers.py). Channel-last ``[..., C]`` throughout.

``dtype`` is the compute dtype, as flax's ``dtype=``: parameters and
statistics are held in float32 and rounded at use."""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ..parallel import data_parallel
from ..parallel import points as point_shards


def masked_max(x: torch.Tensor, mask: torch.Tensor | None, dim: int) -> torch.Tensor:
    """Max over ``dim`` with invalid positions held at -1e30 (so a fully
    masked row gives -1e30, as in the JAX package); ``mask`` has ``x``'s
    shape without the channel axis. Inside the point-sharded context
    (``dim`` 1, the point axis) the max of the whole cloud, its gradient
    split over the tied rows of every rank (``points.pmax``)."""
    if mask is not None:
        x = torch.where(mask.to(torch.bool)[..., None], x,
                        torch.tensor(-1e30, dtype=x.dtype, device=x.device))
    if point_shards.active() is not None:
        if dim != 1:
            point_shards.unsupported(f"masked_max over axis {dim}")
        return point_shards.pmax(x)
    return x.amax(dim=dim)


def masked_mean(x: torch.Tensor, mask: torch.Tensor | None, dim: int) -> torch.Tensor:
    """Mean over ``dim`` with invalid positions excluded; ``mask`` has ``x``'s
    shape without the channel axis. Inside the point-sharded context
    (``dim`` 1, the point axis) the masked sum and count are summed over
    the shards in one differentiable all-reduce."""
    if point_shards.active() is not None:
        if dim != 1:
            point_shards.unsupported(f"masked_mean over axis {dim}")
        w = (torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device) if mask is None
             else mask.to(x.dtype))[..., None]
        s = point_shards.psum(torch.cat([(x * w).sum(dim=1), w.sum(dim=1)], dim=-1))
        return s[..., :-1] / torch.clamp_min(s[..., -1:], 1.0)
    if mask is None:
        return x.mean(dim=dim)
    w = mask[..., None].to(x.dtype)
    return (x * w).sum(dim=dim) / torch.clamp_min(w.sum(dim=dim), 1.0)


class Dense(nn.Linear):
    """``nn.Linear`` that computes in ``dtype``: input, weight and bias are
    cast to it, as flax's ``Dense(dtype=...)`` promotes them. Below float32
    the product is rounded to ``dtype`` before the bias is added, as flax
    adds it; in float32 the bias is fused into the product.

    ``zero_init`` marks a layer whose flax counterpart takes
    ``kernel_init=zeros`` (its bias is zero anyway):
    ``utils.weights.init_like_flax_`` reads it."""

    def __init__(self, din: int, dout: int, bias: bool = True, *, device,
                 dtype: torch.dtype = torch.float32, zero_init: bool = False):
        super().__init__(din, dout, bias=bias, device=device)
        self.compute_dtype = dtype
        self.zero_init = zero_init

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt == torch.float32 or self.bias is None:
            return F.linear(x.to(dt), self.weight.to(dt), self.bias)
        return F.linear(x.to(dt), self.weight.to(dt)) + self.bias.to(dt)


class MaskedBatchNorm(nn.Module):
    """BatchNorm over every leading axis with the flax parameter names:
    ``scale``/``bias`` parameters and ``mean``/``var`` running statistics,
    ``y = (x - mean) * rsqrt(var + eps) * scale + bias`` (eps 1e-5),
    computed in float32 from a float32 copy of ``x`` and cast to ``dtype``.

    In eval mode ``mean``/``var`` are the running statistics and the mask is
    not read. In train mode they are the batch's over the points ``mask``
    keeps (all points without a mask): the mean and the biased variance,
    in float32; the running statistics take the unbiased variance with
    flax's momentum 0.9 (torch's 0.1). An empty mask normalises with mean 0
    and variance 1 and keeps the running statistics, as the JAX module does
    (a variance of 0 would scale a deep stack to inf). Inside a
    data-parallel step the batch is the global one, summed over the ranks
    (``data_parallel.psum``), and the empty-mask rule reads its count.
    Built in eval mode; ``train()`` selects the batch statistics."""

    momentum = 0.9

    def __init__(self, channels: int, *, device, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.scale = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("mean", torch.zeros(channels, device=device))
        self.register_buffer("var", torch.ones(channels, device=device))
        self.eval()    # built for serving, as the port's models are

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        if not self.training:
            inv = torch.reciprocal(torch.sqrt(self.var + self.eps))
            y = (x.float() - self.mean) * inv * self.scale + self.bias
            return y.to(self.dtype)
        xf = x.float()
        red = tuple(range(x.dim() - 1))
        # one path for one process and a data-parallel step: the masked sums
        # and the count, then the squared deviations from their mean (the
        # two-pass form), each summed over the ranks (the identity without
        # a mesh; differentiable under one)
        w = None if mask is None else mask[..., None].float()
        if w is None:
            s1, cnt = xf.sum(dim=red), xf.new_full((1,), x.numel() // x.shape[-1])
        else:
            s1, cnt = (xf * w).sum(dim=red), w.sum().reshape(1)
        s = data_parallel.psum(torch.cat([s1, cnt]))
        n_raw = s[-1]
        n = torch.clamp_min(n_raw, 1.0)
        denom = torch.clamp_min(n - 1.0, 1.0)
        mean = s[:-1] / n
        dev = (xf - mean) ** 2
        var = data_parallel.psum((dev if w is None else dev * w).sum(dim=red)) / n
        empty = n_raw < 0.5
        var = torch.where(empty, 1.0, var)
        with torch.no_grad():
            unbiased = var * n / denom
            new_mean = self.momentum * self.mean + (1 - self.momentum) * mean
            new_var = self.momentum * self.var + (1 - self.momentum) * unbiased
            new_mean = torch.where(empty, self.mean, new_mean)
            new_var = torch.where(empty, self.var, new_var)
            self.mean.copy_(new_mean)
            self.var.copy_(new_var)
        inv = torch.reciprocal(torch.sqrt(var + self.eps))
        y = (xf - mean) * inv * self.scale + self.bias
        return y.to(self.dtype)


class LayerNorm(nn.Module):
    """flax's ``nn.LayerNorm`` over the last axis: parameters ``scale`` and
    ``bias`` (flax's names; the weight bridge maps only ``kernel``), epsilon
    1e-6, the variance as ``E[x^2] - E[x]^2`` clipped at 0 (flax's fast
    variance), ``y = (x - mean) * (rsqrt(var + eps) * scale) + bias``."""

    def __init__(self, channels: int, *, device, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp_min((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, 0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale
        return ((xf - mean) * mul + self.bias).to(x.dtype)


class Dropout(nn.Module):
    """flax's ``nn.Dropout``: in train mode each element is kept with
    probability ``1 - p`` and scaled by ``1 / (1 - p)``, the mask drawn
    from ``generator`` on the input's device (``train_step`` sets it for
    its step and clears it after; the Trainer seeds it each step); the
    identity in eval mode and at p = 0. Inside the point-sharded context
    ``x`` is ``[B, n_r, C]``, this rank's rows of the point axis, and the
    mask this rank's rows of the whole axis's draw.
    Train mode at p > 0 without a generator raises, as flax does without a
    dropout key."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.generator: torch.Generator | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if self.p >= 1.0:
            return torch.zeros_like(x)
        if self.generator is None:
            raise ValueError("Dropout in train mode needs a generator "
                             "(train_step(..., generator=...))")

        def draw(shape):
            return torch.rand(shape, generator=self.generator, device=x.device)

        # this rank's rows of the global draw: of the batch under a
        # data-parallel step, of the point axis under a point-sharded one
        if point_shards.active() is not None:
            if x.dim() != 3:
                point_shards.unsupported(f"Dropout on a {x.dim()}-d tensor")
            keep = point_shards.global_rows(x.shape, draw) < 1.0 - self.p
        else:
            keep = data_parallel.global_rows(x.shape, draw) < 1.0 - self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros_like(x))


class PointMLP(nn.Module):
    """Per-point Dense -> MaskedBatchNorm -> ReLU stack (``dense_i``/``bn_i``,
    the flax names). ``last_activation=False`` leaves the last layer Dense +
    BN (PointNetEncoder's mlp3)."""

    def __init__(self, din: int, features, last_activation: bool = True, *,
                 device):
        super().__init__()
        self.n = len(features)
        self.last_activation = last_activation
        for i, f in enumerate(features):
            self.add_module(f"dense_{i}", Dense(din, f, device=device))
            self.add_module(f"bn_{i}", MaskedBatchNorm(f, device=device))
            din = f

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"bn_{i}")(getattr(self, f"dense_{i}")(x), mask)
            if i < self.n - 1 or self.last_activation:
                x = F.relu(x)
        return x
