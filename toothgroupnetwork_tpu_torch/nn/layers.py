"""Mask-aware building blocks, eval mode (counterpart of
toothgroupnetwork_tpu/nn/layers.py). Channel-last ``[..., C]`` throughout.

``dtype`` is the compute dtype, as flax's ``dtype=``: parameters and
statistics are held in float32 and rounded at use."""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F


def masked_mean(x: torch.Tensor, mask: torch.Tensor | None, dim: int) -> torch.Tensor:
    """Mean over ``dim`` with invalid positions excluded; ``mask`` has ``x``'s
    shape without the channel axis."""
    if mask is None:
        return x.mean(dim=dim)
    w = mask[..., None].to(x.dtype)
    return (x * w).sum(dim=dim) / torch.clamp_min(w.sum(dim=dim), 1.0)


class Dense(nn.Linear):
    """``nn.Linear`` that computes in ``dtype``: input, weight and bias are
    cast to it, as flax's ``Dense(dtype=...)`` promotes them. Below float32
    the product is rounded to ``dtype`` before the bias is added, as flax
    adds it; in float32 the bias is fused into the product."""

    def __init__(self, din: int, dout: int, bias: bool = True, *, device,
                 dtype: torch.dtype = torch.float32):
        super().__init__(din, dout, bias=bias, device=device)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt == torch.float32 or self.bias is None:
            return F.linear(x.to(dt), self.weight.to(dt), self.bias)
        return F.linear(x.to(dt), self.weight.to(dt)) + self.bias.to(dt)


class MaskedBatchNorm(nn.Module):
    """Eval-mode BatchNorm over the channel axis with the flax parameter names:
    ``scale``/``bias`` parameters and ``mean``/``var`` running statistics,
    ``y = (x - mean) * rsqrt(var + eps) * scale + bias`` (eps 1e-5),
    computed in float32 from a float32 copy of ``x`` and cast to ``dtype``.
    Masks only matter to training statistics, so the eval forward takes
    none."""

    def __init__(self, channels: int, *, device, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.scale = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("mean", torch.zeros(channels, device=device))
        self.register_buffer("var", torch.ones(channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.reciprocal(torch.sqrt(self.var + self.eps))
        y = (x.float() - self.mean) * inv * self.scale + self.bias
        return y.to(self.dtype)
