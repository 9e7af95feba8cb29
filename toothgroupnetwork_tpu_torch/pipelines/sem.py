"""Semantic-segmentation inference pipeline of pointnet, pointnetpp, dgcnn
and pointtransformer (counterpart of toothgroupnetwork_tpu/pipelines/sem.py):
host mesh prep -> FPS to ``n_sample`` points on the device (K1) -> one
forward on the device -> argmax on the device -> one fetch of the class ids
-> FDI remap -> host 1-NN to every original vertex. ``sem`` and ``ins`` are
the same array, as in the JAX package."""

from __future__ import annotations

import time
from collections import defaultdict

import torch

from ..utils import profiling
from .base import (N_SAMPLE, class_logits_to_fdi, nn_upsample, prep_mesh_feats,
                   sample_on_device)


class SemInferencePipeline:
    """``model(feats [1, n, 6], mask) -> {"cls_pred": [1, n, 17], ...}``,
    a module on ``device`` in eval mode."""

    def __init__(self, model, n_sample: int = N_SAMPLE, *, device):
        self.model = model
        self.n_sample = n_sample
        self.device = torch.device(device)
        # per-phase wall seconds of the last call
        self.timings: dict[str, float] = defaultdict(float)

    def __call__(self, stl_path: str) -> dict:
        """One scan; a ``scan`` span cut into its phases' spans under a
        recording torch profiler (``utils/profiling.py``)."""
        with profiling.tracing(), profiling.span("scan", phases=True):
            return self._scan(stl_path)

    @torch.inference_mode()
    def _scan(self, stl_path: str) -> dict:
        timings: dict[str, float] = defaultdict(float)
        t0 = time.perf_counter()
        org_feats, feats = prep_mesh_feats(stl_path, self.n_sample)
        feats_dev, sampled = sample_on_device(feats, self.n_sample, self.device)
        t0 = profiling.phase(timings, "mesh_prep", t0)
        ids = torch.argmax(self.model(feats_dev[None], None)["cls_pred"][0], dim=-1)
        ids = profiling.fetch(ids).numpy()
        t0 = profiling.phase(timings, "forward_device", t0)
        full = nn_upsample(class_logits_to_fdi(ids), sampled[:, :3],
                           org_feats[:, :3])
        profiling.phase(timings, "host_1nn_transfer", t0)
        self.timings = timings
        return {"sem": full.reshape(-1), "ins": full.reshape(-1)}
