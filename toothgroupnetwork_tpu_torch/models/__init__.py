"""Model families of the port (tgnet only in this slice) and the task
registry the trainer reads (``get_task("tgnet_fps")``)."""

from . import tasks  # noqa: F401  (registers the tasks)
from .registry import ModelTask, available_models, get_task
from .tgnet import TGNet, make_crops

__all__ = ["ModelTask", "TGNet", "available_models", "get_task", "make_crops"]
