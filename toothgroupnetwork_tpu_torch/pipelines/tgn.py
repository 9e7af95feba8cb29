"""tgnet two-stage inference pipeline (counterpart of
toothgroupnetwork_tpu/pipelines/tgn.py:TgnInferencePipeline on its exact,
non-TPU route):

  1. host mesh prep (dedup, normalise, normals, subdivide if small), then FPS
     to ``n_sample`` points on the device (K1); with ``cell_attention`` the
     sample is then spatially sorted (``ops/cells.py:spatial_sort_perm``),
  2. fps model stage 1: 10-class half-arch semantics + offsets,
  3. host: DBSCAN/PCA/MeanShift instancing of the offset-moved points -> crop
     centroids,
  4. fps model stage 2 over 16 crop slots -> per-point FG/BG votes,
  5. host: refined instancing from the vote mask,
  6. boundary-purity resampling: the 40-NN purity and the FPS fill
     (postprocess/boundary.py),
  7. bdl model stage 1 + 2 on the boundary cloud, host KMeans instancing,
  8. host: arch disambiguation (9 -> 16 classes) + boundary-cluster fusion,
  9. 1-NN transfer to every original vertex + FDI remap.

The model forwards run on ``device``; the fps model computes in
``model_parameter["dtype"]`` (float32 by default, or bfloat16, the JAX
package's serving dtype), the bdl model in float32, and logits, offsets and
votes reach the host in float32. Everything between them is host numpy,
except two stages on a CUDA device. The instancing (steps 3 and 5) runs
its DBSCAN and MeanShift climbs on the card (K9 / K10) on the moved points
and masks left there, with the host's labels
(postprocess/clustering.py). The boundary stage takes the device route as
the JAX package takes its own on its accelerator: the purity runs through
K2 and the fill through one masked K1 launch (step 6), and the
boundary-half 1-NN (K2, k = 4, re-scored) and the final transfer run on the
device too, which sends back two label planes (step 9). On the CPU both
keep the host route; the boundary stage's KD-trees are the JAX package's
CPU route, and its two routes agree up to distance near-ties
(postprocess/boundary.py).

``run_many`` serves several scans at once: each scan in flight runs on a
thread of its own and, on a CUDA device, on a CUDA stream of its own, and
the host mesh prep can run ahead in spawned worker processes.
"""

from __future__ import annotations

import copy
import multiprocessing as mp
import os
import queue
import time
from collections import defaultdict
from concurrent.futures import Future, ProcessPoolExecutor, ThreadPoolExecutor
from contextlib import nullcontext

import numpy as np
import torch
from scipy.spatial import cKDTree

from ..data import scan_prep
from ..data.scan_prep import N_SAMPLE, prep_scan_host_tgn
from ..models.tasks import (TGNET_BDL_ARCH, build_tgnet_bdl, build_tgnet_fps,
                            tgnet_fps_config)
from ..models.tgnet import make_crops
from ..ops import farthest_point_sample
from ..ops.cells import spatial_sort_perm
from ..ops.kernels.knn import knn_route
from ..postprocess.boundary import boundary_sampled_feats, nearest_rescored
from ..postprocess.clustering import clustering_points, get_clustering_labels
from ..postprocess.fusion import disambiguate_arch_labels, merge_boundary_clusters
from ..utils import profiling
from ..utils.weights import load_npz
from .base import class_logits_to_fdi, fps_sample

K_MAX = 16  # crop slots; challenge jaws have <= 16 teeth


def use_full_fp32() -> None:
    """Keep every float32 matrix product in full float32 on the card (no
    TF32), as the JAX package selects ``Precision.HIGHEST``, and the sums of
    bfloat16 products in float32 (no bf16 split-K reductions)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def _pad_centroids(centroids, device):
    """Host centroid list -> fixed ``[1, K_MAX, 3]`` slots (sentinel 1e3 for
    empty ones; beyond K_MAX centroids the first K_MAX are kept, as in the
    JAX package) + validity ``[1, K_MAX]``."""
    cents = np.full((1, K_MAX, 3), 1e3, np.float32)
    valid = np.zeros((1, K_MAX), bool)
    for i, c in enumerate(centroids[:K_MAX]):
        cents[0, i] = c
        valid[0, i] = True
    return (torch.from_numpy(cents).to(device), torch.from_numpy(valid).to(device),
            valid)


def _device_votes(sem2: torch.Tensor, crop_idx: torch.Tensor, valid: np.ndarray,
                  n_points: int) -> torch.Tensor:
    """Sum each valid crop's FG/BG logits onto its source points, argmax ->
    uint8 ``[N]``. The crops are added one at a time: a crop's indices are
    distinct, so no two additions race and the result is the same on every
    run (a float atomic scatter of all crops at once is not)."""
    votes = torch.zeros((n_points, 2), dtype=torch.float32, device=sem2.device)
    for c in np.flatnonzero(valid):
        votes.index_add_(0, crop_idx[c].long(), sem2[c].float())
    return torch.argmax(votes, dim=1).to(torch.uint8)


def _moved_f16(feats_xyz: torch.Tensor, offset: torch.Tensor):
    """xyz + offset rounded through float16, as the JAX package hands the
    moved points to the host clustering: (the device tensor, its host
    copy)."""
    moved = (feats_xyz + offset).to(torch.float16).float()
    return moved, profiling.fetch(moved).numpy()


def prep_mesh_tgn(stl_path: str, n_sample: int = N_SAMPLE, *, device):
    """``(org_feats, bdl_feats, sampled_feats)`` float32: the deduplicated
    vertices' features (the final transfer's targets), the boundary
    resampling's source (subdivided when the mesh is small) and its FPS
    sample of ``n_sample`` rows through K1 on ``device`` (counterpart of
    toothgroupnetwork_tpu/pipelines/tgn.py:prep_mesh_tgn)."""
    org_feats, bdl_feats = prep_scan_host_tgn(stl_path, n_sample)
    return org_feats, bdl_feats, fps_sample(bdl_feats, n_sample, device=device)


# K2's candidates for the boundary-half 1-NN: its selection ranks by the
# distance expansion, whose float32 rounding may misorder points nearer
# than that rounding; the exact re-score of the leading few (as the JAX
# function re-scores its top 4) returns the exact nearest
NN1_CANDIDATES = 4


def boundary_nn1(query: torch.Tensor, bdl_xyz: torch.Tensor):
    """The boundary half of the final 1-NN (counterpart of
    toothgroupnetwork_tpu/pipelines/tgn.py:_bdl_nn1_fn): each query ``[N,
    3]``'s nearest boundary point ``[P, 3]``: K2 selects
    :data:`NN1_CANDIDATES`, the nearest of them by the squared distance
    re-scored by direct subtraction. Returns (idx int64 ``[N]``, d2 f32
    ``[N]``) on the device."""
    idx, d2 = nearest_rescored(query.contiguous(), bdl_xyz.contiguous(),
                               min(NN1_CANDIDATES, bdl_xyz.shape[0]))
    return idx[:, 0], d2


def final_transfer(nn1: torch.Tensor, nn1_d2: torch.Tensor, nn_b, d_b2,
                   labels: np.ndarray, n_sampled: int):
    """Device final transfer (counterpart of
    toothgroupnetwork_tpu/pipelines/tgn.py:_final_transfer_fns): each
    vertex takes its nearest sampled point ``nn1`` or, where strictly
    nearer, its nearest boundary point ``n_sampled + nn_b`` (ties go to the
    sampled side), and gathers the rows of ``labels`` ``[L, n_sampled +
    n_bd]`` there; ``nn_b``/``d_b2`` None when there is no boundary point.
    Returns the ``[L, N]`` label planes on the host."""
    nn = nn1 if nn_b is None else torch.where(d_b2 < nn1_d2, n_sampled + nn_b, nn1)
    planes = torch.from_numpy(np.ascontiguousarray(labels, np.int32)).to(nn.device)
    return profiling.fetch(planes[:, nn]).numpy().astype(np.int64)


class TgnInferencePipeline:
    """``inject_modules=(fps_module, bdl_module)`` replaces the two built
    models, and no checkpoint is read: any two objects with the stage
    interface of ``models/tgnet.py:TGNet`` (``stage1(feats) -> {"sem_1",
    "offset_1"}``, ``stage2(crops, mask) -> {"sem_1"}``), as the
    whole-pipeline parity tests inject structured stand-in predictors. The
    JAX package's tuple has four entries, each module beside its variables,
    because a flax module holds no weights; a torch module carries its own,
    so two entries say the same."""

    def __init__(self, fps_ckpt: str | None, bdl_ckpt: str | None,
                 config: dict | None = None, bdl_arch: dict | None = None,
                 n_sample: int = N_SAMPLE, boundary_info: dict | None = None,
                 inject_modules: tuple | None = None, *, device):
        use_full_fp32()
        self.device = torch.device(device)
        cfg = copy.deepcopy(config) if config else tgnet_fps_config()
        # the boundary stage's route follows the device (module docstring)
        self._boundary_on_device = self.device.type == "cuda"
        # super-row candidate attention (ops/cells.py), off by default as in
        # the JAX package; it needs spatially sorted clouds, so the flag also
        # turns on the sorts of the sample and of the boundary cloud
        self._spatial_sort = bool(cfg["model_parameter"].get("cell_attention",
                                                             False))
        bdl_arch = dict(bdl_arch or TGNET_BDL_ARCH)
        bdl_arch.setdefault("cell_attention", self._spatial_sort)
        self.crop_size = cfg["model_parameter"].get("crop_sample_size", 3072)
        self.n_sample = n_sample
        # boundary_sampling_info defaults (train_configs/tgnet_bdl.py)
        self.boundary_info = boundary_info or {
            "bdl_ratio": 0.7, "num_of_bdl_points": 20000,
            "num_of_all_points": n_sample}
        if (self.boundary_info["num_of_bdl_points"]
                > self.boundary_info["num_of_all_points"]):
            raise ValueError("boundary_info: num_of_bdl_points must be <= "
                             f"num_of_all_points (got {self.boundary_info})")
        if inject_modules is not None:
            self.fps_module, self.bdl_module = inject_modules
        else:
            self.fps_module = load_npz(fps_ckpt, build_tgnet_fps(
                cfg, device=self.device)).eval()
            self.bdl_module = load_npz(bdl_ckpt, build_tgnet_bdl(
                self.crop_size, bdl_arch, device=self.device)).eval()
        # the weights were copied on the legacy default stream; run_many's
        # streams do not wait for it
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        # per-phase wall seconds of the last completed call (each call fills
        # its own dict and publishes it here when it ends)
        self.timings: dict[str, float] = defaultdict(float)
        self._pool: ProcessPoolExecutor | None = None
        self._pool_size = 0

    # ends a phase of __call__: ``_t(timings, name, t0) -> now`` (seconds
    # on time.perf_counter), and its span while the scan is traced
    _t = staticmethod(profiling.phase)

    def variants(self) -> dict:
        """The route each part of a scan takes on this pipeline, at the
        flagship shapes (counterpart of the JAX pipeline's ``variants()``,
        which reports its TPU switches; the port has none of them): the
        attention entry of each model's first stage over the whole cloud
        and over the crops (``K3``, ``K6`` on the cell path, ``unfused`` in
        train mode), the boundary route and, on the device route, the K2
        route of the purity 40-NN and of the boundary 1-NN, the dtypes.
        On the CPU every kernel takes its plain version."""
        n_all = self.boundary_info["num_of_all_points"]

        def attention(module, half, b, n):
            backbone = getattr(module, half, None)
            entry = getattr(backbone, "attention_entry", None)
            return "injected" if entry is None else entry(b, n)

        def knn(k):
            if not self._boundary_on_device:
                return "host KD-tree"
            return knn_route(3, k) if self.device.type == "cuda" else "plain"

        def dtype(module):
            return str(getattr(getattr(module, "first", None), "dtype", "injected"))

        return {
            "device": str(self.device),
            "attn_fps_stage0": attention(self.fps_module, "first", 1, self.n_sample),
            "attn_fps_crops": attention(self.fps_module, "second", K_MAX,
                                        self.crop_size),
            "attn_bdl_stage0": attention(self.bdl_module, "first", 1, n_all),
            "attn_bdl_crops": attention(self.bdl_module, "second", K_MAX,
                                        self.crop_size),
            "boundary_route": "device" if self._boundary_on_device else "host",
            "purity_knn": knn(min(40, self.n_sample)),
            "bdl_nn1_knn": knn(NN1_CANDIDATES),
            "fps_dtype": dtype(self.fps_module),
            "bdl_dtype": dtype(self.bdl_module),
        }

    def _stage2_votes(self, module, feats: torch.Tensor, centroids):
        """Crops around ``centroids`` + stage 2 + vote aggregation -> the
        per-point FG mask (uint8 ``[N]``): (on the device, on the host)."""
        cents, valid, valid_np = _pad_centroids(centroids, self.device)
        crops, crop_mask, crop_idx = make_crops(feats, cents, valid, self.crop_size)
        out = module.stage2(crops, crop_mask)
        votes = _device_votes(out["sem_1"], crop_idx[0], valid_np[0], feats.shape[1])
        return votes, profiling.fetch(votes).numpy()

    def run_many(self, stl_paths, workers: int = 3,
                 prep_workers: int | None = None) -> list[dict]:
        """Overlapped multi-scan inference: ``workers`` scans in flight, so
        one scan's host phases (clustering, boundary resampling, fusion) run
        while another's device stages occupy the card. On a CUDA device each
        scan in flight runs on a CUDA stream of its own: on one shared
        stream each scan's host fetch would wait for every other scan's
        queued kernels. The mesh prep (obj parse, dedup, normals) can also
        run ahead in ``prep_workers`` spawned worker processes, which import
        only the numpy ``data.scan_prep`` and never touch the card.
        ``prep_workers`` defaults to ``min(2, cpu_count - 1)``; 0 means
        threads only. The pool persists across calls (``close()`` reaps
        it). Returns the results in input order, each identical to a serial
        call's; ``self.timings`` holds the last completed scan's. A scan
        that raises makes this call raise. Under a recording torch profiler
        the call is a ``run_many`` span and each scan a ``scan`` span under
        it, group ``(call, index)`` (``utils/profiling.py``)."""
        if prep_workers is None:
            prep_workers = max(0, min(2, (os.cpu_count() or 1) - 1))
        workers = max(1, workers)
        call_id = profiling.new_call()
        with profiling.tracing(), profiling.span("run_many", (call_id, None)) as call:
            # folds and kernel layouts are shared by every scan: made here,
            # on this thread, and finished on the card before any worker
            # reads them
            for module in (self.fps_module, self.bdl_module):
                prepare = getattr(module, "prepare_kernel_state", None)
                if prepare is not None:
                    with torch.inference_mode():
                        prepare()
            streams: queue.SimpleQueue = queue.SimpleQueue()
            for _ in range(workers):
                streams.put(torch.cuda.Stream(self.device)
                            if self.device.type == "cuda" else None)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

            def one(index, path, prep=None):
                stream = streams.get()
                try:
                    with (torch.cuda.stream(stream) if stream is not None
                          else nullcontext()), profiling.joined(call, (call_id, index)):
                        return self(path, _prep=prep)
                finally:
                    streams.put(stream)

            preps = [None] * len(stl_paths)
            if prep_workers > 0:
                pool = self._prep_pool(prep_workers)
                preps = [pool.submit(prep_scan_host_tgn, p, self.n_sample)
                         for p in stl_paths]
            with ThreadPoolExecutor(max_workers=workers) as ex:
                return list(ex.map(one, range(len(stl_paths)), stl_paths, preps))

    def _prep_pool(self, prep_workers: int) -> ProcessPoolExecutor:
        """The persistent spawn-context prep pool, warmed on first use (the
        workers' imports happen then, not under a batch's timing) and kept
        while its size holds."""
        if self._pool is not None and self._pool_size == prep_workers:
            return self._pool
        self.close()
        # spawn, not fork: a forked child would inherit the parent's CUDA
        # state, which it cannot use
        pool = ProcessPoolExecutor(prep_workers, mp_context=mp.get_context("spawn"))
        list(pool.map(scan_prep.warm_worker, range(prep_workers)))
        self._pool, self._pool_size = pool, prep_workers
        return pool

    def close(self) -> None:
        """Reap the prep pool, if there is one."""
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool, self._pool_size = None, 0

    def __call__(self, stl_path: str, _prep=None) -> dict:
        """One scan; ``_prep``: its ``(org_feats, bdl_feats)`` from
        ``prep_scan_host_tgn``, or the future of them from ``run_many``'s
        prep workers (the FPS sample on the device still runs here). Under
        a recording torch profiler, or inside a traced ``run_many``, the
        scan is a ``scan`` span cut into its phases' spans."""
        with profiling.tracing(), profiling.span("scan", phases=True):
            return self._scan(stl_path, _prep)

    @torch.inference_mode()
    def _scan(self, stl_path: str, _prep) -> dict:
        timings: dict[str, float] = defaultdict(float)
        dev = self.device
        t0 = time.perf_counter()
        if isinstance(_prep, Future):
            with profiling.span("scan_prep.wait"):
                _prep = _prep.result()
        org_feats, bdl_feats = (prep_scan_host_tgn(stl_path, self.n_sample)
                                if _prep is None else _prep)
        n_vertices = org_feats.shape[0]
        src = torch.from_numpy(bdl_feats).to(dev)
        if bdl_feats.shape[0] <= self.n_sample:
            reps = -(-self.n_sample // bdl_feats.shape[0])
            sample_idx = torch.arange(bdl_feats.shape[0], device=dev).repeat(
                reps)[:self.n_sample]
        else:
            sample_idx = farthest_point_sample(src[:, :3], self.n_sample).long()
        # the host copy of the indices waits for the FPS, so its time is
        # counted here and not in the next phase
        sample_np = profiling.fetch(sample_idx).numpy()
        if self._spatial_sort:
            perm = spatial_sort_perm(bdl_feats[sample_np, :3])
            sample_np = sample_np[perm]
            sample_idx = sample_idx[torch.from_numpy(perm).to(dev)]
        feats_dev = src[sample_idx][None]
        sampled = bdl_feats[sample_np]
        t0 = self._t(timings, "mesh_prep", t0)

        # ---------------- stage 1 (fps model) ----------------
        out = self.fps_module.stage1(feats_dev)
        cls_dev = torch.argmax(out["sem_1"][0], dim=-1)
        cls_1 = profiling.fetch(cls_dev).numpy().astype(np.int32)
        moved_dev, moved = _moved_f16(feats_dev[0, :, :3], out["offset_1"][0])
        t0 = self._t(timings, "fps:stage1_device", t0)

        fg_labels = get_clustering_labels(moved, cls_1, (moved_dev, cls_dev))
        fg_moved = moved[cls_1 != 0]
        centroids = [fg_moved[fg_labels == i].mean(axis=0)
                     for i in np.unique(fg_labels)]
        t0 = self._t(timings, "fps:host_centroids", t0)
        mask_dev, whole_mask = self._stage2_votes(self.fps_module, feats_dev, centroids)
        t0 = self._t(timings, "fps:stage2_device", t0)

        # refined instancing from the vote-aggregated FG mask
        ins_labels = np.full(len(sampled), -1.0)
        if whole_mask.any():
            ins_labels[whole_mask != 0] = get_clustering_labels(
                moved, whole_mask, (moved_dev, mask_dev))
        ins_labels = (ins_labels + 1).astype(np.int64)  # 0 = bg
        t0 = self._t(timings, "host_instancing", t0)

        # ---------------- boundary stage (bdl model) ----------------
        on_device = self._boundary_on_device
        bdl_sampled, pseudo_labels, n_bd, nn1_idx, nn1_d2, rows = \
            boundary_sampled_feats(
                ins_labels, bdl_feats, sampled,
                bdl_ratio=self.boundary_info["bdl_ratio"],
                num_bdl_points=self.boundary_info["num_of_bdl_points"],
                num_all_points=self.boundary_info["num_of_all_points"],
                spatial_sort=self._spatial_sort,
                org_dev=src if on_device else None, sampled_dev=feats_dev[0],
                device=dev)
        pseudo_in = pseudo_labels.astype(np.int64) - 1  # -1 = bg
        # the boundary cloud gathered from the resident source cloud: one
        # index upload instead of the rows
        rows_dev = torch.from_numpy(rows).to(dev)
        t0 = self._t(timings, "host_boundary_resample", t0)

        # the bdl crop centroids come from the pseudo labels, known before
        # the forward
        xyz_b = bdl_sampled[:, :3]
        bdl_cents = [xyz_b[pseudo_in == i].mean(axis=0)
                     for i in np.unique(pseudo_in) if i != -1]
        feats_b = src[rows_dev][None]
        out_b = self.bdl_module.stage1(feats_b)
        _, moved_b = _moved_f16(feats_b[0, :, :3], out_b["offset_1"][0])
        _, whole_mask_b = self._stage2_votes(self.bdl_module, feats_b, bdl_cents)
        t0 = self._t(timings, "bdl:fused_device", t0)

        n_clusters = len(np.unique(pseudo_in)) - 1
        bdl_ins = np.zeros(len(bdl_sampled)) - 1
        fg_b = whole_mask_b != 0
        if fg_b.any() and n_clusters >= 1:
            _, _, labels_ls = clustering_points([moved_b[fg_b]], "kmeans",
                                                [n_clusters])
            bdl_ins[fg_b] = labels_ls[0]
        bdl_ins = (bdl_ins + 1).astype(np.int64)
        t0 = self._t(timings, "host_bdl_kmeans", t0)

        # ---------------- fusion ----------------
        first_xyz = sampled[:, :3]
        new_sem = disambiguate_arch_labels(first_xyz, ins_labels, cls_1)
        bdl_xyz = bdl_sampled[:n_bd, :3]
        mod_ps, mod_sem = merge_boundary_clusters(
            first_xyz, ins_labels, new_sem, bdl_xyz, bdl_ins[:n_bd])
        final_ins = np.concatenate([ins_labels, mod_ps], axis=0)
        final_sem = np.concatenate([new_sem, mod_sem], axis=0)
        t0 = self._t(timings, "host_fusion", t0)

        # ---------------- 1-NN transfer + FDI remap ----------------
        # nearest of the sampled cloud (the purity query's byproduct) or of
        # the boundary cloud, ties to the sampled side
        if on_device:
            # the original vertices are the first rows of the resident
            # cloud, and so are the boundary rows' sources
            nn_b = d_b2 = None
            if n_bd:
                nn_b, d_b2 = boundary_nn1(src[:n_vertices, :3],
                                          src[rows_dev[:n_bd], :3])
            result_ins, result_sem = final_transfer(
                nn1_idx[:n_vertices], nn1_d2[:n_vertices], nn_b, d_b2,
                np.stack([final_ins, final_sem]), len(first_xyz))
        else:
            nn = nn1_idx[:n_vertices].astype(np.int64)
            if n_bd:
                d_b, nn_b = cKDTree(bdl_xyz).query(org_feats[:, :3], k=1,
                                                   workers=-1)
                use_b = (d_b ** 2) < nn1_d2[:n_vertices]
                nn = np.where(use_b, len(first_xyz) + nn_b, nn)
            result_ins = final_ins[nn]
            result_sem = final_sem[nn]
        result_sem = class_logits_to_fdi(result_sem)
        self._t(timings, "host_1nn_transfer", t0)
        self.timings = timings
        return {"sem": result_sem.reshape(-1), "ins": result_ins.reshape(-1)}
