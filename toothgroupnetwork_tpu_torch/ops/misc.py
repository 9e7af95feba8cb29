"""The pointops ``subtraction`` and ``aggregation`` primitives (counterpart
of toothgroupnetwork_tpu/ops/misc.py); no model layer calls them, in either
package."""

from __future__ import annotations

import torch

from .gather import index_points


def subtraction(input1: torch.Tensor, input2: torch.Tensor,
                idx: torch.Tensor) -> torch.Tensor:
    """``out[..., n, k, c] = input1[..., n, c] - input2[..., idx[n, k], c]``."""
    return input1[..., :, None, :] - index_points(input2, idx)


def aggregation(input: torch.Tensor, position: torch.Tensor, weight: torch.Tensor,
                idx: torch.Tensor) -> torch.Tensor:
    """``out[..., n, c] = sum_k (input[..., idx[n, k], c] + position[..., n, k, c])
    * weight[..., n, k, c % w_c]`` (channel-shared weights)."""
    gathered = index_points(input, idx)
    reps = gathered.shape[-1] // weight.shape[-1]
    w_full = weight.repeat((1,) * (weight.dim() - 1) + (reps,))
    return ((gathered + position) * w_full).sum(dim=-2)
