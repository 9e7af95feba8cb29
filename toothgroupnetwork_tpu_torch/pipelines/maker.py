"""Inference pipeline factory (counterpart of
toothgroupnetwork_tpu/pipelines/maker.py; the tgnet pipeline only)."""

from __future__ import annotations

from .tgn import TgnInferencePipeline


def make_inference_pipeline(model_name: str, ckpt_paths: list[str],
                            config: dict | None = None, *, device):
    """name -> pipeline. tgnet takes two checkpoints (fps + bdl)."""
    if model_name == "tgnet":
        if len(ckpt_paths) != 2:
            raise ValueError("tgnet needs the fps and the bdl checkpoint")
        return TgnInferencePipeline(ckpt_paths[0], ckpt_paths[1], config,
                                    device=device)
    raise ValueError(f"model {model_name!r} is not ported (tgnet only)")
