"""Inference pipelines: mesh -> per-vertex FDI labels -> challenge JSON."""

from .maker import make_inference_pipeline
from .predict import ScanSegmentation
from .sem import SemInferencePipeline
from .tgn import TgnInferencePipeline
from .tsegnet import TsegnetInferencePipeline

__all__ = ["make_inference_pipeline", "ScanSegmentation", "SemInferencePipeline",
           "TgnInferencePipeline", "TsegnetInferencePipeline"]
