"""Training losses (counterpart of toothgroupnetwork_tpu/losses/: seg_loss,
tgn_loss, cbl_loss and tsg_loss)."""

from .cbl_loss import cbl_loss, cbl_loss_per_stage
from .seg_loss import feature_transform_regularizer, tooth_class_loss
from .tgn_loss import batch_center_offset_loss, batch_chamfer_distance_loss
from .tsg_loss import centroid_loss, first_seg_loss, id_loss, second_seg_loss

__all__ = ["batch_center_offset_loss", "batch_chamfer_distance_loss", "cbl_loss",
           "cbl_loss_per_stage", "centroid_loss", "feature_transform_regularizer",
           "first_seg_loss", "id_loss", "second_seg_loss", "tooth_class_loss"]
