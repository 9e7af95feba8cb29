"""Boundary-aware resampling data engine for tgnet_bdl training (counterpart
of toothgroupnetwork_tpu/train/bdl_engine.py, the same steps in the same
order).

A FROZEN pretrained tgnet_fps model labels each training scan's cloud
(crop-vote FG mask + KMeans with k = #GT teeth on offset-moved points); the
ORIGINAL full-resolution mesh is relabeled by 40-NN purity against those
labels; vertices under the ``bdl_ratio`` purity threshold are boundary; the
training cloud becomes up to ``num_of_bdl_points`` uniformly sampled
boundary points + FPS (K1 on the card) of the rest, cached per case
(unaugmented) and re-augmented on every later epoch.

Runs as the ``tgnet_bdl`` task's host stage: it replaces the batch's
feat/labels/mask before the train step. When the original obj/json paths
are not configured, the preprocessed cloud itself serves as the full-res
source.

The frozen model runs on the engine's device, in eval mode (K1, K2 and K3
on the card); it is built and loaded outside ``torch.inference_mode``, so
that its attention layers fold and lay out their parameters once
(``PointTransformerLayer.kernel_params``), and runs under ``no_grad``.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from glob import glob

import numpy as np
import torch
from scipy.spatial import cKDTree

from ..data.mesh_io import load_mesh_arr
from ..data.preprocess import Y_AXIS_MAX, Y_AXIS_MIN, fdi_to_class, fps_indices
from ..parallel import data_parallel
from ..postprocess.clustering import clustering_points, first_label_ratio


class BdlDataEngine:
    def __init__(self, device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        # (feat [1, N, 6], labels [1, N]) numpy -> (sem_2, nn_crop_indexes,
        # crop_valid, offset_1) numpy; built from the config on first use
        self._frozen = None
        self.frozen_model = None
        self._stl_map = None
        self._json_map = None
        self.rng = np.random.default_rng(0)
        # host seconds by part, summed over the calls: load_original,
        # frozen_forward, kmeans, knn40 (the purity), fps
        self.seconds = defaultdict(float)

    @contextlib.contextmanager
    def _timed(self, part: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[part] += time.perf_counter() - t0

    # ------------------------------------------------------------------
    def _ensure_frozen(self, config):
        if self._frozen is not None:
            return self._frozen
        from ..models import get_task
        from ..utils.weights import init_like_flax_, load_npz

        task = get_task("tgnet_fps")
        fps_info = config.model_parameter.get("fps_model_info", {})
        fps_cfg = task.default_config()
        if fps_info.get("model_parameter"):
            fps_cfg.model_parameter.update(fps_info["model_parameter"])
        model = task.build_module(fps_cfg, device=self.device)
        ckpt = fps_info.get("load_ckpt_path")
        if ckpt:
            load_npz(ckpt, model)
        else:
            init_like_flax_(model, torch.Generator().manual_seed(0))
        model.eval()

        def forward(feat, labels):
            with torch.no_grad():
                out = model(torch.from_numpy(feat).to(self.device), None,
                            labels=torch.from_numpy(labels).to(self.device))
            return tuple(out[k].cpu().numpy() for k in (
                "sem_2", "nn_crop_indexes", "crop_valid", "offset_1"))

        self._frozen, self.frozen_model = forward, model
        return forward

    def _ensure_paths(self, config):
        if self._stl_map is not None:
            return
        self._stl_map, self._json_map = {}, {}
        info = config.model_parameter.get("boundary_sampling_info", {})
        obj_root = info.get("orginal_data_obj_path")
        json_root = info.get("orginal_data_json_path")
        if obj_root and os.path.isdir(obj_root):
            for dirpath, _, _ in list(os.walk(obj_root))[1:]:
                for p in glob(os.path.join(dirpath, "*.obj")):
                    self._stl_map[os.path.basename(p).split(".")[0]] = p
        if json_root and os.path.isdir(json_root):
            for dirpath, _, _ in list(os.walk(json_root))[1:]:
                for p in glob(os.path.join(dirpath, "*.json")):
                    self._json_map[os.path.basename(p).split(".")[0]] = p

    def _load_original(self, base_name: str):
        """Original full-res mesh, fixed-constant normalization, class labels -1."""
        with open(self._json_map[base_name]) as f:
            meta = json.load(f)
        labels = fdi_to_class(np.asarray(meta["labels"]), meta["jaw"]) - 1
        vertices = load_mesh_arr(self._stl_map[base_name])
        vertices[:, :3] -= vertices[:, :3].mean(axis=0)
        vertices[:, :3] = ((vertices[:, :3] - Y_AXIS_MIN)
                           / (Y_AXIS_MAX - Y_AXIS_MIN)) * 2 - 1
        return vertices.astype(np.float32), labels.astype(np.int32)

    # ------------------------------------------------------------------
    def _stage_labels(self, config, feat: np.ndarray, labels: np.ndarray):
        """Frozen-model pseudo instance labels for one scan: [N], -1 = bg.
        The crop votes add on the host, crop by crop in crop order."""
        forward = self._ensure_frozen(config)
        with self._timed("frozen_forward"):
            sem_2, crop_idx, crop_valid, offset_1 = forward(feat[None], labels[None])
        sem_2 = np.asarray(sem_2)          # [K, S, 2]
        crop_idx = np.asarray(crop_idx[0])  # [K, S]
        crop_valid = np.asarray(crop_valid[0])
        offset_1 = np.asarray(offset_1[0])

        votes = np.zeros((feat.shape[0], 2), np.float32)
        for k in range(sem_2.shape[0]):
            if crop_valid[k]:
                np.add.at(votes, crop_idx[k], sem_2[k])
        whole_mask = np.argmax(votes, axis=1)

        moved = feat[:, :3] + offset_1
        fg = whole_mask == 1
        ins = np.full(feat.shape[0], -1.0)
        n_teeth = len(np.unique(labels)) - 1
        if fg.any() and n_teeth >= 1:
            with self._timed("kmeans"):
                _, _, lab_ls = clustering_points([moved[fg]], "kmeans", [n_teeth])
            ins[fg] = lab_ls[0]
        return ins

    # ------------------------------------------------------------------
    def __call__(self, model, batch, config) -> dict:
        """``model`` is the model in training (unused: the frozen model
        labels the scans); ``batch`` the loader's numpy batch. Returns host
        numpy ``feat`` / ``gt_seg_label`` / ``mask``."""
        info = config.model_parameter.get("boundary_sampling_info", {})
        bdl_ratio = info.get("bdl_ratio", 0.7)
        n_bdl = info.get("num_of_bdl_points", 20000)
        n_all = info.get("num_of_all_points", 24000)
        cache_dir = info.get("bdl_cache_path")
        self._ensure_paths(config)

        feats = np.asarray(batch["feat"])
        labels = np.asarray(batch["gt_seg_label"])
        mesh_paths = batch.get("mesh_path") or [None] * feats.shape[0]
        augmenters = batch.get("augmenter") or [None] * feats.shape[0]

        items = [self._prepare(config, feats[i], labels[i], mesh_paths[i],
                               augmenters[i], bdl_ratio, n_bdl, n_all, cache_dir)
                 for i in range(feats.shape[0])]
        # the resample draws from one generator, cloud by cloud: in a
        # data-parallel step each rank replays the draws of the earlier
        # ranks' clouds before its own and of the later ranks' after them,
        # so that every rank's stream is the one-process stream
        before, after = data_parallel.around([it["draws"] for it in items
                                              if "draws" in it])
        for spec in before:
            self._draw(spec)
        out_feat = np.empty((feats.shape[0], n_all, feats.shape[2]), np.float32)
        out_label = np.empty((feats.shape[0], n_all), np.int32)
        for i, it in enumerate(items):
            out_feat[i], out_label[i] = self._finish(it, n_bdl, n_all)
        for spec in after:
            self._draw(spec)
        return {"feat": out_feat, "gt_seg_label": out_label,
                "mask": np.ones(out_label.shape, bool)}

    def _prepare(self, config, feat, labels, mesh_path, augmenter, bdl_ratio,
                 n_bdl, n_all, cache_dir) -> dict:
        """One case up to its random draws: ``{"out": (feat, labels)}`` when
        it needs none (cached, or smaller than ``n_all``), else the case's
        arrays, its boundary mask and ``draws``, the spec of its draws
        (:meth:`_draw`)."""
        base_name = None
        if mesh_path:
            parts = os.path.basename(mesh_path).split("_")
            base_name = "_".join(parts[:2])
        cache_path = (os.path.join(cache_dir, f"{base_name}.npy")
                      if cache_dir and base_name else None)

        if cache_path and os.path.exists(cache_path):
            arr = np.load(cache_path)
            sampled_feat, sampled_label = arr[:, :6], arr[:, 6].astype(np.int32)
            if augmenter is not None:
                sampled_feat = augmenter.run(sampled_feat.copy())
            return {"out": (sampled_feat.astype(np.float32), sampled_label)}

        # original full-res source (fallback: the preprocessed cloud itself)
        if base_name and base_name in self._stl_map and base_name in self._json_map:
            with self._timed("load_original"):
                org_feat, org_label = self._load_original(base_name)
        else:
            org_feat, org_label = feat.copy(), labels.copy()
        if org_feat.shape[0] < n_all:
            return {"out": (feat[:n_all], labels[:n_all])}

        ins = self._stage_labels(config, feat, labels)

        auged = augmenter.run(org_feat.copy()) if augmenter is not None \
            else org_feat.copy()
        with self._timed("knn40"):
            tree = cKDTree(feat[:, :3])
            k = min(40, feat.shape[0])
            _, nn40 = tree.query(auged[:, :3], k=k, workers=-1)
            ratio = first_label_ratio(ins[np.atleast_2d(nn40)])
        bd = ratio < bdl_ratio
        n_bd = int(bd.sum())
        kept = min(n_bd, n_bdl)
        total = kept + min(org_feat.shape[0] - n_bd, n_all - kept)
        return {"org": (org_feat, auged, org_label), "bd": bd,
                "cache_path": cache_path, "draws": (n_bd, total, n_all)}

    def _draw(self, spec):
        """A case's draws, in order: the permutation of its ``n_bd``
        boundary points, then, when its ``total`` sampled points fall short
        of ``n_all``, the indices of the repeats that pad it."""
        n_bd, total, n_all = spec
        perm = self.rng.permutation(n_bd)
        reps = self.rng.integers(0, total, n_all - total) if total < n_all else None
        return perm, reps

    def _finish(self, item: dict, n_bdl, n_all):
        """A prepared case resampled: up to ``n_bdl`` boundary points drawn
        uniformly, FPS of the rest, repeats to pad; cached unaugmented."""
        if "out" in item:
            return item["out"]
        org_feat, auged, org_label = item["org"]
        bd, cache_path = item["bd"], item["cache_path"]
        perm, reps = self._draw(item["draws"])

        def resample(sel_feat, sel_auged, sel_label, n, method):
            if method == "uniformly":
                idx = perm[:n]
            elif sel_feat.shape[0] <= n:
                idx = np.arange(sel_feat.shape[0])
            else:
                with self._timed("fps"):
                    idx = fps_indices(sel_auged[:, :3], n, self.device)
            return sel_feat[idx], sel_auged[idx], sel_label[idx]

        bd_f, bd_a, bd_l = resample(org_feat[bd], auged[bd], org_label[bd],
                                    n_bdl, "uniformly")
        need = n_all - bd_f.shape[0]
        nb_f, nb_a, nb_l = resample(org_feat[~bd], auged[~bd], org_label[~bd],
                                    need, "fps")
        # pad if still short (degenerate tiny meshes)
        total = bd_f.shape[0] + nb_f.shape[0]
        if total < n_all:
            all_f = np.concatenate([bd_f, nb_f])[list(range(total)) + list(reps)]
            all_a = np.concatenate([bd_a, nb_a])[list(range(total)) + list(reps)]
            all_l = np.concatenate([bd_l, nb_l])[list(range(total)) + list(reps)]
        else:
            all_f = np.concatenate([bd_f, nb_f])
            all_a = np.concatenate([bd_a, nb_a])
            all_l = np.concatenate([bd_l, nb_l])

        if cache_path:
            os.makedirs(os.path.dirname(cache_path), exist_ok=True)
            np.save(cache_path,
                    np.concatenate([all_f, all_l[:, None]], axis=1))
        return all_a.astype(np.float32), all_l.astype(np.int32)
