"""tsegnet inference pipeline (counterpart of
toothgroupnetwork_tpu/pipelines/tsegnet.py): host mesh prep and FPS (K1) ->
the centroid module on the device -> one fetch -> host DBSCAN(eps=.05,
min_samples=3) over the offset-moved l3 points with ``dist < 0.3`` -> 16
padded crop slots with masks -> the seg module on the device, with the
sigmoid and the argmax there -> per crop, points with ``sigmoid(pd_2) >
0.5`` take the crop's id (later crops overwrite earlier ones) -> FDI remap
-> host 1-NN to every original vertex."""

from __future__ import annotations

import copy
import time
from collections import defaultdict

import numpy as np
import torch

from ..models.tasks import _tsegnet_preset, build_tsegnet
from ..models.tsegnet import cluster_centres, tsegnet_crops
from ..utils import profiling
from ..utils.weights import load_npz
from .base import N_SAMPLE, nn_upsample, prep_mesh_feats, sample_on_device
from .tgn import use_full_fp32

K_MAX = 16


class TsegnetInferencePipeline:
    def __init__(self, ckpt_path: str | None, config: dict | None = None,
                 n_sample: int = N_SAMPLE, module=None, *, device):
        """``config``: a dict with a ``model_parameter`` (the preset's by
        default). ``module`` replaces the built model, and no checkpoint is
        read."""
        use_full_fp32()
        self.device = torch.device(device)
        cfg = (copy.deepcopy(config) if config
               else {"model_parameter": _tsegnet_preset().model_parameter})
        self.n_sample = n_sample
        self.crop_size = cfg["model_parameter"].get("crop_sample_size", 3072)
        self.module = module if module is not None else load_npz(
            ckpt_path, build_tsegnet(cfg, device=self.device)).eval()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        # per-phase wall seconds and the proposal counts of the last call
        self.timings: dict[str, float] = defaultdict(float)
        self.last_stats: dict = {}

    def proposals(self, l3_xyz: np.ndarray, offset: np.ndarray, dist: np.ndarray):
        """Crop centres: DBSCAN over the moved l3 points with ``dist <
        0.3``, one centre (the mean) per cluster, noise dropped. Returns
        ``(centers [1, K_MAX, 3] with the 1e3 sentinel, valid [1, K_MAX])``."""
        cents = cluster_centres(l3_xyz, offset, dist)[:K_MAX]
        centers = np.full((1, K_MAX, 3), 1e3, np.float32)
        valid = np.zeros((1, K_MAX), bool)
        centers[0, :len(cents)] = cents
        valid[0, :len(cents)] = True
        return centers, valid

    def __call__(self, stl_path: str) -> dict:
        """One scan; a ``scan`` span cut into its phases' spans under a
        recording torch profiler (``utils/profiling.py``)."""
        with profiling.tracing(), profiling.span("scan", phases=True):
            return self._scan(stl_path)

    @torch.inference_mode()
    def _scan(self, stl_path: str) -> dict:
        timings: dict[str, float] = defaultdict(float)
        dev = self.device
        t0 = time.perf_counter()
        org_feats, feats = prep_mesh_feats(stl_path, self.n_sample)
        feats_dev, sampled = sample_on_device(feats, self.n_sample, dev)
        feats_dev = feats_dev[None]
        t0 = profiling.phase(timings, "mesh_prep", t0)

        cent = self.module.centroid_forward(feats_dev)
        l3_xyz, offset, dist = (profiling.fetch(t).numpy() for t in (
            cent["l3_xyz"][0], cent["offset_result"][0], cent["dist_result"][0, :, 0]))
        t0 = profiling.phase(timings, "centroid_device", t0)
        centers, valid = self.proposals(l3_xyz, offset, dist)
        t0 = profiling.phase(timings, "host_dbscan", t0)

        pred_labels = np.zeros(self.n_sample)
        painted = 0
        if valid.any():
            crop_feat, crop_mask, crop_idx = tsegnet_crops(
                feats_dev, cent["l0_points"], torch.from_numpy(centers).to(dev),
                torch.from_numpy(valid).to(dev), self.crop_size)
            _, _, pd_2, id_pred = self.module.seg_forward(crop_feat, crop_mask)
            pd_2, ids, crop_idx = (profiling.fetch(t).numpy() for t in (
                torch.sigmoid(pd_2[..., 0]), torch.argmax(id_pred, dim=-1),
                crop_idx[0]))
            for k in np.flatnonzero(valid[0]):
                sel = crop_idx[k][pd_2[k] > 0.5]
                pred_labels[sel] = ids[k]
                painted += int(sel.size > 0)
        t0 = profiling.phase(timings, "seg_device", t0)

        pred_labels[pred_labels >= 9] += 2
        pred_labels[pred_labels > 0] += 10
        full = nn_upsample(pred_labels, sampled[:, :3], org_feats[:, :3])
        profiling.phase(timings, "host_1nn_transfer", t0)
        self.timings = timings
        self.last_stats = {"clusters": int(valid.sum()), "painted_crops": painted}
        return {"sem": full.reshape(-1).astype(np.int64),
                "ins": full.reshape(-1).astype(np.int64)}
