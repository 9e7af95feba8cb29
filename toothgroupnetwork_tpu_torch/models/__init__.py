"""Model families of the port and the task registry the trainer reads
(``get_task("tgnet_fps")``)."""

from . import tasks  # noqa: F401  (registers the tasks)
from .dgcnn import DGCNNSeg
from .pointnet import PointNetSeg
from .pointnetpp import PointNetPPSeg
from .registry import ModelTask, available_models, get_task
from .tgnet import TGNet, make_crops
from .tsegnet import TSegNetModule

__all__ = ["DGCNNSeg", "ModelTask", "PointNetPPSeg", "PointNetSeg", "TGNet",
           "TSegNetModule", "available_models", "get_task", "make_crops"]
