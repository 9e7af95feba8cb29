"""Building blocks (counterpart of toothgroupnetwork_tpu/nn)."""

from .layers import (Dense, Dropout, LayerNorm, MaskedBatchNorm, PointMLP,
                     masked_max, masked_mean)

__all__ = ["Dense", "Dropout", "LayerNorm", "MaskedBatchNorm", "PointMLP", "masked_max",
           "masked_mean"]
