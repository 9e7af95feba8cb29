"""Losses of the tgnet training path (counterpart of
toothgroupnetwork_tpu/losses/: seg_loss, tgn_loss and cbl_loss)."""

from .cbl_loss import cbl_loss, cbl_loss_per_stage
from .seg_loss import feature_transform_regularizer, tooth_class_loss
from .tgn_loss import batch_center_offset_loss, batch_chamfer_distance_loss

__all__ = ["batch_center_offset_loss", "batch_chamfer_distance_loss", "cbl_loss",
           "cbl_loss_per_stage", "feature_transform_regularizer",
           "tooth_class_loss"]
