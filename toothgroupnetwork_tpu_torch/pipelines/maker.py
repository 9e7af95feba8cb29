"""Inference pipeline factory (counterpart of
toothgroupnetwork_tpu/pipelines/maker.py): the six model names the JAX
``make_inference_pipeline`` serves. Each pipeline rebuilds its model from
the task preset, or from ``config["model_parameter"]`` when given, and reads
a JAX-package ``.npz``."""

from __future__ import annotations

import torch

from ..models.tasks import SEM_MODELS, build_sem_model
from ..utils.weights import load_npz
from .sem import SemInferencePipeline
from .tgn import TgnInferencePipeline, use_full_fp32


def make_inference_pipeline(model_name: str, ckpt_paths: list[str],
                            config: dict | None = None, *, device):
    """name -> pipeline on ``device``. tgnet takes two checkpoints (fps +
    bdl); the others take one."""
    if model_name in SEM_MODELS:
        from ..models import get_task

        mp = (config["model_parameter"] if config
              else get_task(model_name).default_config().model_parameter)
        use_full_fp32()
        device = torch.device(device)
        model = load_npz(ckpt_paths[0], build_sem_model(model_name, mp,
                                                        device=device)).eval()
        return SemInferencePipeline(model, device=device)
    if model_name == "tgnet":
        if len(ckpt_paths) != 2:
            raise ValueError("tgnet needs the fps and the bdl checkpoint")
        return TgnInferencePipeline(ckpt_paths[0], ckpt_paths[1], config,
                                    device=device)
    if model_name == "tsegnet":
        from .tsegnet import TsegnetInferencePipeline

        return TsegnetInferencePipeline(ckpt_paths[0], config, device=device)
    raise ValueError(f"unknown model {model_name!r}")
