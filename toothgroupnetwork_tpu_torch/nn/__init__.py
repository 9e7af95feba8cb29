"""Eval-mode building blocks (counterpart of toothgroupnetwork_tpu/nn)."""

from .layers import MaskedBatchNorm, masked_mean

__all__ = ["MaskedBatchNorm", "masked_mean"]
