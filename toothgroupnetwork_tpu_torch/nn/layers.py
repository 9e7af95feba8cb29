"""Mask-aware building blocks, eval mode (counterpart of
toothgroupnetwork_tpu/nn/layers.py). Channel-last ``[..., C]`` throughout."""

from __future__ import annotations

import torch
from torch import nn


def masked_mean(x: torch.Tensor, mask: torch.Tensor | None, dim: int) -> torch.Tensor:
    """Mean over ``dim`` with invalid positions excluded; ``mask`` has ``x``'s
    shape without the channel axis."""
    if mask is None:
        return x.mean(dim=dim)
    w = mask[..., None].to(x.dtype)
    return (x * w).sum(dim=dim) / torch.clamp_min(w.sum(dim=dim), 1.0)


class MaskedBatchNorm(nn.Module):
    """Eval-mode BatchNorm over the channel axis with the flax parameter names:
    ``scale``/``bias`` parameters and ``mean``/``var`` running statistics,
    ``y = (x - mean) * rsqrt(var + eps) * scale + bias`` (eps 1e-5). Masks
    only matter to training statistics, so the eval forward takes none."""

    def __init__(self, channels: int, *, device, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("mean", torch.zeros(channels, device=device))
        self.register_buffer("var", torch.ones(channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.reciprocal(torch.sqrt(self.var + self.eps))
        return (x - self.mean) * inv * self.scale + self.bias
