"""Inference pipelines: mesh -> per-vertex FDI labels -> challenge JSON."""

from .maker import make_inference_pipeline
from .predict import ScanSegmentation
from .tgn import TgnInferencePipeline

__all__ = ["make_inference_pipeline", "ScanSegmentation", "TgnInferencePipeline"]
