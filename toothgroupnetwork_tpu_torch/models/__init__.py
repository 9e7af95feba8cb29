"""Model families of the port (tgnet only in this slice)."""

from .tgnet import TGNet, make_crops

__all__ = ["TGNet", "make_crops"]
