from .backbone import PointTransformerSeg

__all__ = ["PointTransformerSeg"]
