"""Building blocks (counterpart of toothgroupnetwork_tpu/nn)."""

from .layers import (Dense, LayerNorm, MaskedBatchNorm, PointMLP, masked_max,
                     masked_mean)

__all__ = ["Dense", "LayerNorm", "MaskedBatchNorm", "PointMLP", "masked_max",
           "masked_mean"]
