"""Smoke run of the PyTorch + CUDA port (toothgroupnetwork_tpu_torch) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --parallel    # phases 1-3 and 14-16 only

Run from the root of a checkout on a machine with an NVIDIA Hopper card and
the CUDA toolkit. It exits non-zero, before printing any result, when there
is no CUDA device or when the port is not beside it. Phases, one line each
(any failure raises and ends the run with a non-zero code):

  1. environment: the card's name and power limit (nvidia-smi), versions;
  2. build: nvcc compiles csrc/*.cu into build/kernels/ (keyed by a hash);
  3. each hand-written kernel against its plain PyTorch version on the card,
     at the shapes the inference path gives it, with CUDA-event times (the
     attention kernels also with the device time of CUDA-graph replays),
     the least time the card could take for the same work (the larger of
     the bytes over 3.35 TB/s and the operations over 67 TFLOP/s float32,
     with bf16 rows' matrix products over 989 TFLOP/s, the bf16 tensor-core
     peak) and, where one PyTorch call computes the same function, that
     call's time (``torch.addmm`` beside K3's k/v projection ``project_kv``;
     K3 at every shape one scan gives it, each with its launches a scan;
     device times of CUDA-graph replays for K3-K8, ``project_kv``,
     ``torch.addmm`` and ``torch.index_select``)
     (K1 with its cluster size and microseconds a step, beside its chain
     floor: the per-step exchange alone over 24000 steps on 16 CTAs, K1's
     and the cluster-barrier design's; K2 also on the first cloud spatially
     sorted; K2's general-C route at DGCNN's self-kNN shapes, C = 6 and
     64, identical to its plain version, beside the two-call yardstick
     ``torch.topk(torch.cdist(x, x), k, largest=False)`` (timed only), with
     the register-tiled design's geometry (queries a block, candidates a
     tile, a thread's register tile, registers, local memory, shared memory,
     resident blocks an SM, the compiler's spills) and the candidate splits
     of each launch; K1 at the PointNet++ SA shapes;
     the cell-attention kernels K4/K5/K6 on a spatially sorted
     24000-point sheet; K7 and K8 at the crop and full-cloud shapes; the
     bfloat16 variants of K3, K4 and K6 against their bfloat16 twins);
  4. full-width fps model, stage 1 over a 24000-point cloud: the kernels on
     the card against the same port on the CPU (plain versions), on the
     default path, with ``cell_attention`` on the sorted cloud, and in
     bfloat16 (and bfloat16 against float32 on the card);
  5. the slice: random full-width fps + bdl weights (``save_npz``), three
     synthetic ~100k-vertex scans through ``cli.infer.main`` on the card,
     challenge JSON checked, a repeated scan identical, every kernel of the
     path launched (and none of the cell path; K10 counted, launched only
     where the instancing re-splits a cluster); one more call under
     torch.profiler gives the device's busy share;
 5b. the instancing kernels: K9 (``tgn_dbscan``) and K10
     (``tgn_mean_shift``) on the instancing inputs the slice's scans give
     the default pipeline (its ``get_clustering_labels`` calls, recorded)
     and on a synthetic foreground at the serving cell's size (10100
     points, two re-splits): the card route's labels identical to the
     host route's, K9 identical to its plain twin and the host ``dbscan``,
     K10's climbs to its twin and the host's climbs, CUDA-event times
     beside the twins' and the bounds (K9: n(n-1)/2 pairs x 8 float64
     operations over the float64 peak; K10: each climb step's ball tests
     x 8);
  6. the cell-attention configuration: one more scan through ``cli.infer.main
     --config_path`` with ``"cell_attention": true``, the same checks, K4, K5
     and K6 launched;
  7. the bfloat16 configuration: one more scan through ``cli.infer.main
     --config_path`` with ``"dtype": "bfloat16"``, the same checks, K1, K2
     and K3 launched and none of K4-K6; then steady calls of the three
     configurations in turns;
 7b. the device boundary route, which every pipeline on the card takes:
     on each configuration's scan the purity, the masked fill, the
     boundary 1-NN and the final labels bit-identical to the route on K1's
     and K2's plain versions on the card; against the host route (a
     pipeline around the same models set to the CPU's KD-tree route, for
     the comparison only) on the same stage-1 labels, the 1-NN d2 within
     rtol 1e-4, a 1-NN index swapped only at equal d2, the mask equal
     outside 2.5/40 of ``bdl_ratio`` and on 0.99 of the vertices, and given
     the host's mask the same fill; a repeated scan and ``run_many``
     identical; K2 two launches more a scan than the host route, K1 as
     many; both routes' phase seconds; K2 at the purity and boundary 1-NN
     shapes and K1's masked fill timed against their plain versions and
     bounds; K2's any-size kernel (k = 65, C = 300) equal to its plain
     version, one launch a call, timed;
  8. the two entries no model layer calls (as in the JAX package): the
     row gather K8 through ``ops.gather.gather_neighbors`` under
     ``TGN_TPU_GATHER=mxu`` and the pre-projected attention K7 through its
     wrapper, each launched and checked;
  9. serve many: six more synthetic scans (seeds 0-5) served serially and
     then through ``TgnInferencePipeline.run_many`` (three scans in flight,
     each on its own CUDA stream, two spawned prep processes), three of them
     in the cell and bfloat16 configurations: outputs identical to serial,
     launch counts equal, serial and overlapped scans per second, the
     phases' seconds a scan both ways, the busy share of one profiled batch,
     the kernel library loaded once, no prep worker with CUDA initialised;
 10. training: tgnet_fps at full width and batch 1 on labelled synthetic
     24000-point arch cases: step 1's seven losses on the card against the
     CPU port's (on 6000 of the points), two seeded runs bit-identical, the loss falling over 8
     steps on one batch, the step's median seconds with and without
     deterministic algorithms, its peak memory and one profiled step; one
     epoch through ``cli.train.main`` (K1 and K2 launched in the train
     steps, K3 in the val pass), the checkpoint resumed and the exported
     ``.npz`` serving one scan; three steps with ``"dtype": "bfloat16"``
     (finite losses, K1 and K2 launched, seconds beside float32's);
 11. the workflow: three labelled synthetic 100489-vertex cases through
     ``cli.preprocess`` (K1 once a scan, the arrays identical to K1's plain
     version's), ``cli.split`` and ``cli.train --model_name tgnet_bdl``
     (the boundary engine's frozen fps model launching K1, K2 and K3, its
     resample K1; the bdl step K2; the val pass K3; a cached epoch without
     the frozen model), the host stage's launches and seconds by part a
     case, the engine identical with K1's plain version, the frozen stage 1
     and the bdl step on the card against the CPU port's (on 6000 points)
     and the step repeated bit for bit, then the
     exported weights serving one case through ``cli.infer`` and
     ``cli.evaluate`` printing what ``cal_metric`` gives;
 12. the families: pointnet, pointnetpp, dgcnn, pointtransformer and
     tsegnet, each at its preset's full width with random weights (the
     classifier centred on the scan; tsegnet's centroid heads fitted so that
     DBSCAN finds clusters and its paint logit centred), one synthetic
     100489-vertex scan through ``cli.infer --model_name`` (each family's
     kernels launched, none of K4-K8; DGCNN's K2 at C = 6 once and C = 64
     twice), the challenge JSON checked, a repeated scan identical, steady
     seconds a scan by phase, peak memory, one profiled call's busy share,
     and the forward on the card against the CPU port (DGCNN at 6000
     points);
 13. the families trained: pointnet, pointnetpp, dgcnn, pointtransformer
     and tsegnet at each preset's full width, batch 1, on phase 10's first
     24000-point case: the launches of one step exactly (none of K3-K8;
     K3 in a pointtransformer val scan), tsegnet's host stage apart
     (launches, proposals card vs CPU, seconds), step 1 against the CPU
     port (DGCNN at 6000 points and dropout 0), two seeded runs
     bit-identical, the loss falling, the step's seconds with and without
     deterministic algorithms, its peak memory and one profiled step; then
     ``cli.train --model_name dgcnn`` and ``tsegnet`` for one epoch, the
     exported weights served through ``cli.infer --model_name``;
 14. data-parallel training (``parallel/``, ``train_step(mesh=)``):
     tgnet_fps at full width, global batch 2, on two spawned ranks sharing
     the card over gloo (``parallel.RankPool``), two steps against the
     one-process batch-2 step on the card and against the control, one
     process with its matrix products run one cloud at a time
     (tolerances derived beside ``DP_LOSS_RTOL``), the ranks
     bit-identical, each rank's K1 and K2
     launches a step equal to one cloud's one-process step, seconds a step
     each way; one step on a world-size-1 NCCL group;
 15. the point-sharded forward: the fps model's full-width stage-1
     backbone over a 24576-point arch on the two ranks
     (``parallel.sharded_backbone_forward``: sharded FPS, K2 over the
     gathered coordinates, ring gathers, K6) against the dense port model's eval forward on the card:
     FPS indices equal, kNN lists by the near-tie rule, outputs within 1e-4
     of the largest, K2 and K6 launches a rank, seconds and the sharded
     FPS's share;
 16. the point-sharded training step (``parallel/sharded_train.py``):
     the pointtransformer, pointnet, dgcnn, pointnetpp, tgnet_fps,
     tgnet_bdl and tsegnet presets at full width, batch 1 on phase 10's
     first 24000-point case (tgnet_bdl on one labelled 100489-vertex case
     through its host stage with a frozen random-weight fps model; tsegnet
     on proposals from a calibrated centroid module, as in phase 13), each
     with its point axis split over the two ranks, against the dense
     one-process step on the card (losses, statistics, parameters;
     tolerances derived beside ``PS_LOSS_RTOL``) and beside the control,
     the dense step on the cloud twice (batch 2; for the crop models with
     its products one cloud at a time, ``products_per_cloud``), and the
     dense step's own update; the crops (each rank's rows of the crop
     axis) and the host stage's arrays identical to the dense step's, two
     sharded steps from one state bit-identical, the ranks' digests equal,
     K1 and K2 launched a rank as often as in the dense step (each on the
     gathered coordinates, DGCNN's K2 on the gathered features, the crop
     stage's on the rank's crops), seconds a step, the FPS's share and
     peak memory a rank.

Every log line carries the card's nvidia-smi name and power limit. Then
one JSON line of the kernels, phase 16's summaries again (one a task, then
the seven tasks' seconds a step and peak GiB a rank on one line), the
nvidia-smi line again, and last the line ``{"ok": true, "device":
{...}}``. With ``--parallel`` the run builds the kernels, holds them to
their plain versions (phase 3) and runs phases 14-16 on the data phase 10
writes; it ends with phase 16's summaries and the nvidia-smi line, and
prints no kernels line and no ``ok`` line.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
FDI = {0} | {10 * q + t for q in (1, 2, 3, 4) for t in range(1, 9)}
# class-0 shift of each model's classifier bias: random weights otherwise
# call every point background, and the host clustering, the crops and the
# boundary stage would run on nothing
BG_SHIFT = {"first": -3.0, "second": -2.0}
# phase-3 shapes, the ones the inference path gives each kernel
FPS_SHAPES = ((1, 24000, 6000, None),           # B, N, samples, valid points
              (16, 3072, 768, None),
              (1, 106496, 24000, 100489),       # mesh prep, padded to 8192s
              (1, 100489, 24000, None),         # mesh prep as the port runs it
              (1, 84000, 8000, None),           # a boundary fill
              # the PointNet++ SA stages of pointnetpp and tsegnet's
              # centroid module, then tsegnet's 16 crops of 3072
              (1, 24000, 1024, None), (1, 1024, 512, None), (1, 512, 256, None),
              (16, 3072, 1024, None), (16, 1024, 512, None), (16, 512, 256, None))
KNN_SHAPES = ((1, 24000, 24000, 36, True, False),   # B, M, N, k, self-query,
              (16, 3072, 3072, 36, True, False),    # spatially sorted
              (1, 6000, 24000, 24, False, False),
              (1, 24000, 24000, 36, True, True),    # the first cloud, sorted
              # training's CBL sub-scene labels: kr = 16 and 64 into the
              # full-resolution cloud, and into the crops
              (1, 375, 24000, 16, False, False),
              (1, 93, 24000, 64, False, False),
              (16, 48, 3072, 64, False, False))
# K2's general-C route: DGCNN's EdgeConv self-kNN in feature space
# (B, N, k, C): the xyz + normals input, then the 64-channel features
KNN_C_SHAPES = ((1, 24000, 20, 6), (1, 24000, 20, 64))
FPS_CHAIN = (24000, 16)   # K1's chain floor: steps, cluster size
# K3: every (B, N, K, C) one scan gives it: the fps model's stage 1 and
# its deeper stages (24000 -> 6000 -> 1500 -> 375 -> 93 points), its 16 crops
# of 3072 (-> 768 -> 192 -> 48 -> 12, the last with a k > n tail), then the
# bdl model's two stride-1 stages on the 24000-point boundary cloud and its
# 16 crops
ATTENTION_SHAPES = ((1, 24000, 36, 32),         # B, N, K, C
                    (16, 3072, 36, 32),
                    (1, 93, 24, 512),
                    (1, 6000, 24, 64), (1, 1500, 24, 128), (1, 375, 24, 256),
                    (16, 768, 24, 64), (16, 192, 24, 128), (16, 48, 24, 256),
                    (16, 12, 24, 512),
                    (1, 24000, 36, 16), (1, 24000, 24, 32),
                    (16, 3072, 36, 16), (16, 3072, 24, 32))
# the cell-attention kernels: (K, C) of each attention layer on a 24000-point
# stride-1 stage (fps stage 1; bdl stages 1 and 2), 32 candidate slots (L8=256)
CELL_SHAPES = ((36, 32), (36, 16), (24, 32))
CELL_SLOTS = 32
# the row gather and the pre-projected attention: the crop stage and the
# full cloud (B, N, K, C)
ENTRY_SHAPES = ((16, 3072, 36, 32), (1, 24000, 36, 32))
N_POINTS = 24000          # the fps model's input cloud
N_SIDE = 317              # synthetic scans of 317^2 = 100489 vertices
CARD = {"card": None}     # the nvidia-smi line, beside every number logged
# published H100 SXM peaks (NVIDIA's H100 datasheet): float32 outside the
# tensor cores, dense bf16 on the tensor cores (the matrix products of bf16
# rows may run there), float64 outside the tensor cores and HBM bandwidth
F32_OPS_PER_S = 67e12
BF16_TC_OPS_PER_S = 989e12
F64_OPS_PER_S = 34e12     # float64 outside the tensor cores (K9, K10)
HBM_BYTES_PER_S = 3.35e12
# K3's launches a scan by shape in each configuration's main-path run
# (phase_slice), from its wrapper's count
SCAN_K3_SHAPES: dict = {}
# the serve-many phase: six synthetic scans (seeds 0-5) through run_many with
# three scans in flight and two prep processes; the cell and bf16
# configurations serve the first three
SERVE_SEEDS = range(6)
SERVE_SCANS = {"default": 6, "cell": 3, "bf16": 3}
SERVE_WORKERS, SERVE_PREP = 3, 2
# scans in flight swept on the default configuration's batch
SERVE_SWEEP = (1, 2, 4)
# the training phase: labelled 24000-point synthetic arch cases (two train,
# one val) at full width and batch 1; a fixed batch's steps (the loss must
# fall over them), the steps two seeded runs must repeat bit for bit, the
# steps timed each way for the cost of deterministic algorithms
TRAIN_CASES = (("TR00", "lower", 14), ("TR01", "upper", 12), ("TR02", "lower", 13))
TRAIN_FALL_STEPS = 8
TRAIN_REPEAT_STEPS = 3
TRAIN_TIMED_STEPS = 4
TRAIN_BF16_STEPS = 3
# phases 10-11 hold the card to the CPU port on this many points of a
# 24000-point cloud (a full-width tgnet step on the CPU takes 45-75 s of a
# call; DGCNN's phase-13 reference is cut the same way)
CPU_REFERENCE_POINTS = 6000
# the workflow phase: three labelled synthetic 100489-vertex cases (both
# jaws), preprocessed, split, and the bdl model trained on them
WORKFLOW_CASES = (("WF00", "lower"), ("WF01", "upper"), ("WF02", "lower"))


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps({**fields, **CARD}, default=float),
          flush=True)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def card() -> torch.device:
    return torch.device("cuda", 0)


def cuda_ms(fn, reps: int, warm: int = 1) -> float:
    """Mean milliseconds of ``fn`` on the card: CUDA events around ``reps``
    back-to-back calls after ``warm`` (0 or 1) warm-up calls
    (``utils.profiling.chained_time``)."""
    from toothgroupnetwork_tpu_torch.utils.profiling import chained_time

    return chained_time(fn, iters=reps, warmup=warm > 0, device=card()) * 1e3


def graph_ms(fn, reps: int = 20) -> float:
    """Mean device milliseconds of ``fn``: ``reps`` calls captured in one
    CUDA graph, a replay timed with CUDA events
    (``utils.profiling.chained_time``). No host time falls between the
    launches, where ``cuda_ms`` counts it when a call's kernels are shorter
    than its launches."""
    from toothgroupnetwork_tpu_torch.utils.profiling import chained_time

    return chained_time(fn, iters=reps, graph=True, device=card()) * 1e3


def nbytes(*tensors) -> int:
    """Bytes of the tensors (dicts counted by their tensor values; the
    kernel layout a wrapper keeps in a parameter dict is not an input)."""
    total = 0
    for t in tensors:
        for v in (t.values() if isinstance(t, dict) else (t,)):
            if isinstance(v, torch.Tensor):
                total += v.numel() * v.element_size()
    return total


def referenced_bytes(src: torch.Tensor, rows: torch.Tensor) -> int:
    """Bytes of the rows of ``src`` (viewed as [R, ...]) that the flat row
    indices ``rows`` reference, each counted once: what a gather of this
    run's data must read."""
    return int(torch.unique(rows).numel()) * (src.numel() // src.shape[0]
                                              * src.element_size())


def cell_rows(pos: torch.Tensor, l8: int) -> torch.Tensor:
    """Flat candidate-block rows ``q // 8 * L8 + pos`` that K4/K5 read
    (positions outside [0, L8) read nothing)."""
    hit = (pos >= 0) & (pos < l8)
    q = torch.arange(pos.shape[0], device=pos.device)[:, None] // 8
    return (q * l8 + pos)[hit]


def attention_ops(rows: int, c: int, cs: int) -> int:
    """Float32 operations of the attention layer after the k/v projection,
    per neighbour row: pe (Dense 3x3 + relu, Dense 3xC) 21 + 7C, k - q + pe
    2C, BN0 + relu 3C, Dense Cxcs 2C cs + cs, BN1 + relu 3cs, Dense csxcs
    2cs^2 + cs, softmax 3cs, v + pe C, the weighted sum 2C."""
    return rows * (15 * c + 2 * c * cs + 2 * cs * cs + 8 * cs + 21)


class KernelRecord:
    """Per-kernel results over the phase-3 shapes: times, the bound from
    this run's inputs, and the one-call library time where there is one."""

    def __init__(self, name, source, replaces):
        self.entry = {"name": name, "route": "cuda", "source": source,
                      "replaces": replaces, "launches": 0, "max_abs_err": 0.0,
                      "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                      "bound_by": None, "library_ms": None, "shapes": []}
        self._top_bound = -1.0

    def add(self, shape: str, err: float, ms: float, plain_ms: float, *,
            ops: float, moved: float, library_ms: float | None = None,
            tensor_ops: float = 0.0, f64_ops: float = 0.0, **extra):
        """``ops`` operations and ``moved`` bytes (each input read once,
        each output written once) of this call; ``tensor_ops`` of the ops
        are matrix products of bf16 operands, held to the bf16 tensor-core
        peak, and ``f64_ops`` float64 operations, held to the float64 peak
        (the rest to the float32 peak). A row with tensor_ops also logs its
        all-float32 bound."""
        e = self.entry
        t_ops = ((ops - tensor_ops - f64_ops) / F32_OPS_PER_S
                 + tensor_ops / BF16_TC_OPS_PER_S + f64_ops / F64_OPS_PER_S) * 1e3
        t_bytes = moved / HBM_BYTES_PER_S * 1e3
        if tensor_ops:
            extra.update(held_to="bf16 tensor cores + float32",
                         bound_f32_ms=max(ops / F32_OPS_PER_S * 1e3, t_bytes))
        bound_ms = max(t_ops, t_bytes)
        bound_by = "operations" if t_ops >= t_bytes else "bytes"
        e["max_abs_err"] = max(e["max_abs_err"], float(err))
        e["ms"] += ms
        e["plain_ms"] += plain_ms
        e["bound_ms"] += bound_ms
        if bound_ms > self._top_bound:   # what binds the largest call
            self._top_bound, e["bound_by"] = bound_ms, bound_by
        if library_ms is not None:
            e["library_ms"] = (e["library_ms"] or 0.0) + library_ms
        e["shapes"].append({"shape": shape, "max_abs_err": float(err), "ms": ms,
                            "plain_ms": plain_ms, "bound_ms": bound_ms,
                            "bound_by": bound_by, "library_ms": library_ms,
                            "ops": ops, "bytes": moved, **extra})
        log("kernel", name=e["name"], shape=shape, max_abs_err=float(err),
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=library_ms, **extra)


def knn_ops(c: int, b: int, m: int, n: int, self_query: bool) -> float:
    """The operations K2's function needs: each (query, point) pair C mul
    and C - 1 add for the cross term, the doubling, a sub and an add of
    |p|^2, and 1 compare. A self-query's cross term is symmetric
    (cross(i, j) == cross(j, i) bit for bit: the same products, added in
    the same channel order), so it needs only n (n + 1) / 2 of its pairs."""
    pairs = n * (n + 1) / 2 if self_query else m * n
    return float(b) * ((2.0 * c - 1.0) * pairs + 4.0 * m * n)


def knn_splits(route: str, b: int, m: int, n: int, k: int) -> int:
    """The candidate splits K2's feature-space launch picks at this shape."""
    from toothgroupnetwork_tpu_torch.ops.kernels import build

    import ctypes

    return build.library().tgn_knn_scratch(int(route == "tgn_knn_any"), b, m, n, k,
                                           ctypes.byref(ctypes.c_size_t(0)))


def ptxas_report(log_text: str, needle: str) -> dict:
    """Registers, stack frame and spill bytes of the first kernel whose
    mangled name holds ``needle``, from the compiler's ``-Xptxas -v``
    report in the build log."""
    import re

    out = {}
    props = re.search(r"Function properties for \S*" + re.escape(needle)
                      + r"\S*\s+(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", log_text)
    if props:
        out.update(stack_bytes=int(props[1]), spill_store_bytes=int(props[2]),
                   spill_load_bytes=int(props[3]))
    used = re.search(r"Compiling entry function '\S*" + re.escape(needle)
                     + r"[^']*'.*?Used (\d+) registers", log_text, re.S)
    if used:
        out["ptxas_registers"] = int(used[1])
    return out


def knn_tiled_geometry() -> dict:
    """The register-tiled design of K2's feature-space routes
    (``tgn_knn_geometry``: queries a block, candidates a tile, a thread's
    register tile, channels a chunk, threads, registers a thread, local
    memory, shared memory a block, resident blocks an SM) with the
    compiler's registers and spills for each route's kernel."""
    import ctypes

    from toothgroupnetwork_tpu_torch.ops.kernels import build

    lib = build.library()
    log_path = Path(build.build_info.get("log", ""))
    log_text = log_path.read_text() if log_path.is_file() else ""
    out = {}
    for flag, route in ((0, "tgn_knn_c"), (1, "tgn_knn_any")):
        vals = (ctypes.c_int * 10)()
        build.check(lib.tgn_knn_geometry(flag, vals), "tgn_knn_geometry")
        q, p, r, s, ch, threads, regs, local, smem, per_sm = list(vals)
        out[route] = {"queries_a_block": q, "candidates_a_tile": p,
                      "thread_tile": f"{r}x{s}", "channels_a_chunk": ch,
                      "threads_a_block": threads, "registers": regs,
                      "local_bytes": local, "shared_bytes": smem,
                      "blocks_per_sm": per_sm,
                      **ptxas_report(log_text, f"knn_tile_kernelILb{flag}E")}
    log("knn_tiled_geometry", **out)
    return out


def bf16_ulps(got, ref, atol: float = 1e-4):
    """(ok, share of elements more than one bf16 ulp apart): ok when every
    |got - ref| <= one bf16 ulp (8 significant bits) at max(|got|, |ref|)
    + atol. Two float32 results within atol round to bf16 values at most
    that far apart; near zero, where a sum cancels, atol is many ulps."""
    got, ref = got.float(), ref.float()
    mag = torch.maximum(got.abs(), ref.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    diff = (got - ref).abs()
    return bool((diff <= ulp + atol).all()), float((diff > ulp).float().mean())


def phase_kernels(dev, gen):
    from toothgroupnetwork_tpu_torch.models.point_transformer.backbone import (
        PointTransformerLayer)
    from toothgroupnetwork_tpu_torch.ops import knn_self
    from toothgroupnetwork_tpu_torch.ops.kernels import attention, fps, knn
    from toothgroupnetwork_tpu_torch.utils.weights import randomize_

    def cloud(*shape, scale=1.0):
        return torch.from_numpy((gen.standard_normal(shape) * scale)
                                .astype(np.float32)).to(dev)

    rec_fps = KernelRecord("fps", "toothgroupnetwork_tpu_torch/csrc/fps.cu",
                           "toothgroupnetwork_tpu/ops/pallas/fps_kernel.py:245")
    rec_knn = KernelRecord("knn", "toothgroupnetwork_tpu_torch/csrc/knn.cu",
                           "toothgroupnetwork_tpu/ops/pallas/knn_kernel.py:81")
    rec_att = KernelRecord(
        "attention", "toothgroupnetwork_tpu_torch/csrc/attention.cu",
        "toothgroupnetwork_tpu/ops/pallas/attention_kernel.py:346")
    rec_kv = KernelRecord(
        "project_kv", "toothgroupnetwork_tpu_torch/csrc/attention.cu",
        "toothgroupnetwork_tpu/ops/pallas/attention_kernel.py:346")

    # K1's chain floor: the per-step exchange alone at the mesh-prep step
    # count and cluster size, K1's (push) and the cluster-barrier design's
    # (pull), beside the mesh-prep shape's FLOP bound
    steps, c = FPS_CHAIN
    floor = {f"{way}_ms": cuda_ms(lambda: fps.chain_floor(steps, c, dev,
                                                          pull=way == "pull"), 3)
             for way in ("push", "pull")}
    rec_fps.entry["chain_floor"] = {"steps": steps, "cluster": c, **floor}
    log("fps_chain_floor", steps=steps, cluster=c, **floor,
        us_per_step={k: v * 1e3 / steps for k, v in floor.items()},
        flop_bound_ms=10.0 * steps * 100489 / F32_OPS_PER_S * 1e3)

    # K1: identical indices on tie-free (continuous random) inputs. Each of
    # the m steps updates the running minimum of every valid point: 3 sub,
    # 3 mul, 2 add, 1 min and 1 compare
    for b, n, m, n_valid in FPS_SHAPES:
        xyz = cloud(b, n, 3)
        valid = None
        if n_valid is not None:
            valid = torch.zeros((b, n), dtype=torch.bool, device=dev)
            valid[:, :n_valid] = True
        got = fps.fps(xyz, m, valid)
        ref = fps.fps_reference(xyz, m, valid)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            bad = int((got != ref).any(dim=1).sum())
            raise AssertionError(f"K1 fps [{b},{n}]->{m}: {bad} clouds differ")
        err = float((got.long() - ref.long()).abs().max())
        ms = cuda_ms(lambda: fps.fps(xyz, m, valid), 3)
        rec_fps.add(f"[{b},{n}]->{m}" + (f" valid {n_valid}" if n_valid else ""),
                    err, ms, cuda_ms(lambda: fps.fps_reference(xyz, m, valid), 1),
                    ops=10.0 * b * m * (n_valid or n),
                    moved=nbytes(xyz, got) + (0 if valid is None else nbytes(valid)),
                    cluster=fps.cluster_size(n), us_per_step=ms * 1e3 / m)

    # K2: identical except rows with a near-tie at the k-th place; the
    # operations as knn_ops counts them at C = 3
    from toothgroupnetwork_tpu_torch.ops.cells import spatial_sort_perm

    clouds = {}
    for b, m, n, k, self_q, sort in KNN_SHAPES:
        if sort:    # the same points as the shape's first cloud, sorted
            pts = clouds[(b, n)]
            pts = pts[:, torch.from_numpy(spatial_sort_perm(pts[0].cpu().numpy()))
                      .to(dev)].contiguous()
        else:
            pts = clouds.setdefault((b, n), cloud(b, n, 3))
        qry = pts if self_q else cloud(b, m, 3)
        gi, gd = knn.knn_select(qry, pts, k)
        ri, rd = knn.knn_select_reference(qry, pts, k + 1)
        torch.cuda.synchronize()
        row_bad = (gi != ri[..., :k]).any(dim=-1)
        kth, nxt = rd[..., k - 1], rd[..., k]
        near_tie = (nxt - kth).abs() <= 1e-6 * kth.abs().clamp_min(1e-30)
        if bool((row_bad & ~near_tie).any()):
            raise AssertionError(f"K2 knn [{b},{m}]x[{b},{n}] k={k}: "
                                 f"{int((row_bad & ~near_tie).sum())} rows differ")
        ok = ~row_bad
        err = float((gd - rd[..., :k]).abs()[ok].max())
        rec_knn.add(f"[{b},{m}]x[{b},{n}] k={k}" + (" sorted" if sort else ""), err,
                    cuda_ms(lambda: knn.knn_select(qry, pts, k), 3),
                    cuda_ms(lambda: knn.knn_select_reference(qry, pts, k), 1),
                    ops=knn_ops(3, b, m, n, self_q),
                    moved=nbytes(pts, gi, gd) + (0 if self_q else nbytes(qry)),
                    rows_differ=int(row_bad.sum()),
                    near_tie_rows=int(near_tie.sum()))

    # K2's general-C route: identical indices and d2 (the kernel sums the
    # channels in the plain version's order); the operations as knn_ops
    # counts them for a self-query. Beside it, the two-call yardstick
    # topk(cdist) (timed only: its matmul expansion rounds otherwise; the
    # port never calls it), and the candidate splits the launch picked
    rec_knn.entry["tiled_geometry"] = knn_tiled_geometry()
    for b, n, k, c in KNN_C_SHAPES:
        x = cloud(b, n, c)
        gi, gd = knn.knn_select(x, x, k)
        ri, rd = knn.knn_select_reference(x, x, k)
        torch.cuda.synchronize()
        if not (torch.equal(gi, ri) and torch.equal(gd, rd)):
            raise AssertionError(f"K2 knn C={c} [{b},{n}] k={k}: "
                                 f"{int((gi != ri).any(dim=-1).sum())} rows differ")
        rec_knn.add(f"[{b},{n}] C={c} k={k} self", 0.0,
                    cuda_ms(lambda: knn.knn_select(x, x, k), 3),
                    cuda_ms(lambda: knn.knn_select_reference(x, x, k), 1),
                    ops=knn_ops(c, b, n, n, True), moved=nbytes(x, gi, gd),
                    library_ms=cuda_ms(lambda: torch.topk(torch.cdist(x, x), k,
                                                          largest=False), 3),
                    library_call="torch.topk(torch.cdist(x, x), k, largest=False)",
                    device_ms=graph_ms(lambda: knn.knn_select(x, x, k), 3),
                    splits=knn_splits(knn.knn_route(c, k), b, n, n, k), identical=True)

    # K3: max |kernel - plain| <= 1e-4 in float32 (other summation order);
    # in bfloat16 (bf16 rows, q and out) within one bf16 ulp of the output.
    # The k/v projection commutes with the gather: counted once per point.
    # Its kernel alone (project_kv): within 1e-5 of its plain version, beside
    # torch.addmm (one call, float32 rows: the same function)
    for dtype in (torch.float32, torch.bfloat16):
        for b, n, kk, c in ATTENTION_SHAPES:
            layer = PointTransformerLayer(c, device=dev)
            randomize_(layer, torch.Generator().manual_seed(c))
            p = cloud(b, n, 3, scale=0.2)
            x = cloud(b, n, c, scale=0.5).to(dtype)
            idx, _ = knn_self(p, kk)
            with torch.no_grad():
                params = attention.fold_attention_params(layer, dtype)
                q = layer.linear_q(x.float()).reshape(b * n, c).to(dtype).contiguous()
                got = attention.fused_vector_attention_packed_x(x, p, idx, q, params)
                ref = attention.fused_vector_attention_packed_x_reference(
                    x, p, idx, q, params)
                torch.cuda.synchronize()
                err = float((got.float() - ref.float()).abs().max())
                extra = {}
                if dtype == torch.float32:
                    ok = err <= 1e-4
                else:
                    ok, extra["share_beyond_one_ulp"] = bf16_ulps(got, ref)
                if not ok:
                    raise AssertionError(f"K3 attention {dtype} B{b}/N{n}/K{kk}/C{c}: "
                                         f"max abs diff {err}")
                tag = " bf16" if dtype != torch.float32 else ""
                bf16 = dtype == torch.bfloat16
                cs, proj = c // 8, 4.0 * b * n * c * c
                rec_att.add(
                    f"B{b}/N{n}/K{kk}/C{c}{tag}", err,
                    cuda_ms(lambda: attention.fused_vector_attention_packed_x(
                        x, p, idx, q, params), 5),
                    cuda_ms(lambda: attention.fused_vector_attention_packed_x_reference(
                        x, p, idx, q, params), 3),
                    ops=attention_ops(b * n * kk, c, cs) + proj,
                    moved=nbytes(x, p, idx, q, got, params),
                    tensor_ops=(proj + b * n * kk * (2.0 * c * cs + 2.0 * cs * cs)
                                if bf16 else 0.0),
                    device_ms=graph_ms(lambda: attention.fused_vector_attention_packed_x(
                        x, p, idx, q, params)), **extra)

                x2 = x.reshape(b * n, c)
                kv = attention.project_kv(x2, params)
                kv_ref = attention.project_kv_reference(x2, params)
                torch.cuda.synchronize()
                err = float((kv - kv_ref).abs().max())
                if not err <= 1e-5:
                    raise AssertionError(f"project_kv {dtype} M{b * n}/C{c}: "
                                         f"max abs diff {err}")
                w = torch.cat([params["wk"], params["wv"]], dim=1)
                bias = torch.cat([params["bk"], params["bv"]])
                library_ms = None
                lib_extra = {}
                if not bf16:
                    library_ms = cuda_ms(lambda: torch.addmm(bias, x2, w), 5)
                    lib_extra["library_device_ms"] = graph_ms(
                        lambda: torch.addmm(bias, x2, w))
                rec_kv.add(f"M{b * n}/Cin{c}/C{c}{tag}", err,
                           cuda_ms(lambda: attention.project_kv(x2, params), 5),
                           cuda_ms(lambda: attention.project_kv_reference(x2, params),
                                   3),
                           ops=proj, moved=nbytes(x2, w.to(dtype), bias, kv),
                           tensor_ops=proj if bf16 else 0.0, library_ms=library_ms,
                           device_ms=graph_ms(lambda: attention.project_kv(x2, params)),
                           **lib_extra)
    return ([rec_fps, rec_knn, rec_att, rec_kv] + phase_cell_kernels(dev, gen, cloud)
            + phase_entry_kernels(dev, gen, cloud))


def sorted_sheet(gen, n: int) -> np.ndarray:
    """A curved sheet of n points in spatially sorted order (ops/cells.py)."""
    from toothgroupnetwork_tpu_torch.ops.cells import spatial_sort_perm

    u = gen.uniform(-1, 1, (n, 2))
    xyz = np.stack([u[:, 0], 0.3 * u[:, 0] ** 2 + 0.2 * u[:, 1] ** 2, u[:, 1]], 1)
    xyz = (xyz + gen.normal(0, 0.01, xyz.shape)).astype(np.float32)
    return xyz[spatial_sort_perm(xyz)]


def phase_cell_kernels(dev, gen, cloud):
    """K4/K5 bit-equal and K6 within 1e-4 of their plain versions, at the
    shapes of the cell path on a 24000-point stride-1 stage, in float32 and
    (K4, K6) on bfloat16 rows."""
    from toothgroupnetwork_tpu_torch.models.point_transformer.backbone import (
        PointTransformerLayer)
    from toothgroupnetwork_tpu_torch.ops import cells, knn_self
    from toothgroupnetwork_tpu_torch.ops.kernels import attention, cell_select
    from toothgroupnetwork_tpu_torch.utils.weights import randomize_

    src = "toothgroupnetwork_tpu_torch/csrc/"
    rec_x = KernelRecord("cell_select_x", src + "cell_select.cu",
                         "toothgroupnetwork_tpu/ops/pallas/cell_select_kernel.py:82")
    rec_p = KernelRecord("cell_select_p", src + "cell_select.cu",
                         "toothgroupnetwork_tpu/ops/pallas/cell_select_kernel.py:117")
    rec_g = KernelRecord("attention_gathered", src + "attention.cu",
                         "toothgroupnetwork_tpu/ops/pallas/attention_kernel.py:94")
    n, l8 = N_POINTS, CELL_SLOTS * 8
    p = torch.from_numpy(sorted_sheet(gen, n)).to(dev)
    idx36, _ = knn_self(p[None], 36)
    ctx = {}
    for kk in sorted({kk for kk, _ in CELL_SHAPES}, reverse=True):
        cand, pos, n_cells = cells.build_cell_candidates(
            idx36[0, :, :kk].contiguous(), CELL_SLOTS)
        ctx[kk] = (cand, cells.pos_with_self_fallback(pos, l8))
        log("cells", n=n, k=kk, slots=CELL_SLOTS,
            overflow_share=float((pos == l8).float().mean()),
            mean_cells=float(n_cells.float().mean()),
            max_cells=int(n_cells.max()))

    # K5 once per stage (k = 36); the k = 24 stage slices its rows
    cand, pos = ctx[36]
    blk_p = cells.gather_candidate_blocks(p, cand)
    got = cell_select.cell_select_p(blk_p, pos, p)
    ref = cell_select.cell_select_p_reference(blk_p, pos, p)
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        raise AssertionError("K5 cell_select_p differs from its plain version")
    rec_p.add(f"N{n}/K36/L8={l8}", 0.0,
              cuda_ms(lambda: cell_select.cell_select_p(blk_p, pos, p), 20),
              cuda_ms(lambda: cell_select.cell_select_p_reference(blk_p, pos, p), 5),
              ops=float(got.numel()),
              moved=referenced_bytes(blk_p.reshape(-1, 3), cell_rows(pos, l8))
              + nbytes(pos, p, got),
              device_ms=graph_ms(lambda: cell_select.cell_select_p(blk_p, pos, p)))
    p_r36 = got

    for dtype in (torch.float32, torch.bfloat16):
        tag = " bf16" if dtype != torch.float32 else ""
        for kk, c in CELL_SHAPES:
            cand, pos = ctx[kk]
            x = cloud(n, c, scale=0.5)
            blk_x = cells.gather_candidate_blocks(x.to(dtype), cand)
            got = cell_select.cell_select_x(blk_x, pos)
            ref = cell_select.cell_select_x_reference(blk_x, pos)
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                raise AssertionError(f"K4 cell_select_x K{kk}/C{c}{tag} differs")
            rec_x.add(f"N{n}/K{kk}/C{c}/L8={l8}{tag}", 0.0,
                      cuda_ms(lambda: cell_select.cell_select_x(blk_x, pos), 20),
                      cuda_ms(lambda: cell_select.cell_select_x_reference(blk_x,
                                                                          pos), 5),
                      ops=0.0, moved=referenced_bytes(blk_x.reshape(-1, c),
                                                      cell_rows(pos, l8))
                      + nbytes(pos, got),
                      blk_mb=nbytes(blk_x) / 1e6, x_g_mb=nbytes(got) / 1e6,
                      device_ms=graph_ms(lambda: cell_select.cell_select_x(blk_x, pos)))

            # K6: float32 q, weights and out; rows and p_r in the dtype
            layer = PointTransformerLayer(c, device=dev)
            randomize_(layer, torch.Generator().manual_seed(c))
            x_g = got.reshape(n * kk, c)
            p_r = p_r36[:, :kk].reshape(n * kk, 3).to(dtype).contiguous()
            with torch.no_grad():
                params = attention.fold_attention_params(layer, dtype)
                q = layer.linear_q(x).contiguous()
                out = attention.fused_vector_attention(q, x_g, p_r, params, k=kk)
                ref = attention.fused_vector_attention_reference(q, x_g, p_r, params,
                                                                 k=kk)
                torch.cuda.synchronize()
                err = float((out - ref).abs().max())
                if not err <= 1e-4:
                    raise AssertionError(f"K6 attention B1/N{n}/K{kk}/C{c}{tag}: "
                                         f"max abs diff {err}")
                rec_g.add(f"B1/N{n}/K{kk}/C{c}{tag}", err,
                          cuda_ms(lambda: attention.fused_vector_attention(
                              q, x_g, p_r, params, k=kk), 5),
                          cuda_ms(lambda: attention.fused_vector_attention_reference(
                              q, x_g, p_r, params, k=kk), 3),
                          ops=attention_ops(n * kk, c, c // 8) + 4.0 * n * kk * c * c,
                          moved=nbytes(x_g, p_r, q, out, params),
                          device_ms=graph_ms(lambda: attention.fused_vector_attention(
                              q, x_g, p_r, params, k=kk)))
    return [rec_x, rec_p, rec_g]


def phase_entry_kernels(dev, gen, cloud):
    """K7 (pre-projected attention) within 1e-4 and K8 (row gather, float32
    and bfloat16) identical to their plain versions at ENTRY_SHAPES; K8
    beside ``torch.index_select`` on the flat index, the one PyTorch call
    that computes the same function."""
    from toothgroupnetwork_tpu_torch.models.point_transformer.backbone import (
        PointTransformerLayer)
    from toothgroupnetwork_tpu_torch.ops.kernels import attention, gather
    from toothgroupnetwork_tpu_torch.utils.weights import randomize_

    src = "toothgroupnetwork_tpu_torch/csrc/"
    rec_k7 = KernelRecord("attention_projected", src + "attention.cu",
                          "toothgroupnetwork_tpu/ops/pallas/attention_kernel.py:302")
    rec_k8 = KernelRecord("gather", src + "gather.cu",
                          "toothgroupnetwork_tpu/ops/pallas/gather_kernel.py:64")
    for b, n, kk, c in ENTRY_SHAPES:
        layer = PointTransformerLayer(c, device=dev)
        randomize_(layer, torch.Generator().manual_seed(c))
        rows = b * n * kk
        k_g, v_g = cloud(rows, c, scale=0.5), cloud(rows, c, scale=0.5)
        p_r, q = cloud(rows, 3, scale=0.05), cloud(b * n, c, scale=0.5)
        with torch.no_grad():
            params = attention.fold_attention_params(layer)
            got = attention.fused_vector_attention_packed(q, k_g, v_g, p_r, params,
                                                          k=kk)
            ref = attention.fused_vector_attention_packed_reference(
                q, k_g, v_g, p_r, params, k=kk)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            if not err <= 1e-4:
                raise AssertionError(f"K7 attention B{b}/N{n}/K{kk}/C{c}: "
                                     f"max abs diff {err}")
            kv_free = {k: v for k, v in params.items() if k not in ("wk", "bk", "wv",
                                                                    "bv")}
            rec_k7.add(f"B{b}/N{n}/K{kk}/C{c}", err,
                       cuda_ms(lambda: attention.fused_vector_attention_packed(
                           q, k_g, v_g, p_r, params, k=kk), 5),
                       cuda_ms(lambda: attention
                               .fused_vector_attention_packed_reference(
                                   q, k_g, v_g, p_r, params, k=kk), 3),
                       ops=attention_ops(rows, c, c // 8),
                       moved=nbytes(q, k_g, v_g, p_r, got, kv_free),
                       device_ms=graph_ms(lambda: attention.fused_vector_attention_packed(
                           q, k_g, v_g, p_r, params, k=kk)))
        del k_g, v_g, p_r

        idx = torch.from_numpy(gen.integers(0, n, (b, n, kk)).astype(np.int32)).to(dev)
        flat = (idx.long() + torch.arange(b, device=dev)[:, None, None] * n).reshape(-1)
        for dtype in (torch.bfloat16, torch.float32):
            x = cloud(b, n, c).to(dtype)
            got = gather.onehot_gather_packed(x, idx)
            ref = gather.onehot_gather_packed_reference(x, idx)
            lib = torch.index_select(x.reshape(b * n, c), 0, flat)
            torch.cuda.synchronize()
            if not (torch.equal(got, ref) and torch.equal(got.reshape(-1, c), lib)):
                raise AssertionError(f"K8 gather {dtype} B{b}/N{n}/K{kk}/C{c} differs")
            tag = " bf16" if dtype == torch.bfloat16 else ""
            rec_k8.add(f"B{b}/N{n}/K{kk}/C{c}{tag}", 0.0,
                       cuda_ms(lambda: gather.onehot_gather_packed(x, idx), 20),
                       cuda_ms(lambda: gather.onehot_gather_packed_reference(x, idx),
                               5),
                       ops=0.0, moved=referenced_bytes(x.reshape(-1, c), flat)
                       + nbytes(idx, got),
                       library_ms=cuda_ms(lambda: torch.index_select(
                           x.reshape(b * n, c), 0, flat), 20),
                       device_ms=graph_ms(lambda: gather.onehot_gather_packed(x, idx)),
                       library_device_ms=graph_ms(lambda: torch.index_select(
                           x.reshape(b * n, c), 0, flat)))
    return [rec_k7, rec_k8]


def phase_entries(dev, feats: np.ndarray):
    """The two entries no model layer calls, each driven once with its
    counter set to 0 just before: ``gather_neighbors`` under
    ``TGN_TPU_GATHER=mxu`` (K8) on 16 crops of a scan (3072 points each,
    their 6 feature channels zero-padded to a C32 layer's width, bf16) and
    their 36-NN, and the pre-projected attention (K7) on the k/v rows that
    a bf16 layer projects from the gathered rows. Returns the launch
    counts."""
    from toothgroupnetwork_tpu_torch.models.point_transformer.backbone import (
        PointTransformerLayer)
    from toothgroupnetwork_tpu_torch.models.tgnet import make_crops
    from toothgroupnetwork_tpu_torch.ops import index_points, knn_self
    from toothgroupnetwork_tpu_torch.ops.gather import gather_neighbors
    from toothgroupnetwork_tpu_torch.ops.kernels import attention, gather
    from toothgroupnetwork_tpu_torch.utils.weights import randomize_

    b, n, kk, c = ENTRY_SHAPES[0]
    src = torch.from_numpy(feats).to(dev)[None]
    cents = src[:, torch.linspace(0, feats.shape[0] - 1, b).long(), :3]
    crops, _, _ = make_crops(src, cents, torch.ones((1, b), dtype=torch.bool,
                                                    device=dev), n)
    idx, _ = knn_self(crops[..., :3].contiguous(), kk)
    layer = PointTransformerLayer(c, device=dev, dtype=torch.bfloat16)
    randomize_(layer, torch.Generator().manual_seed(3))
    x = torch.nn.functional.pad(crops, (0, c - crops.shape[-1])).bfloat16()
    kernels = (gather.onehot_gather_packed, attention.fused_vector_attention_packed)
    for k in kernels:
        k.launches = 0
    os.environ["TGN_TPU_GATHER"] = "mxu"
    try:
        with torch.no_grad():
            x_g = gather_neighbors(x, idx)
            k_g = layer.linear_k(x_g).reshape(b * n * kk, c)
            v_g = layer.linear_v(x_g).reshape(b * n * kk, c)
            p_r = (index_points(crops[..., :3], idx) - crops[:, :, None, :3])
            p_r = p_r.reshape(-1, 3).bfloat16()
            q = layer.linear_q(x).reshape(b * n, c)
            params = attention.fold_attention_params(layer, torch.bfloat16)
            out = attention.fused_vector_attention_packed(q, k_g, v_g, p_r, params,
                                                          k=kk)
    finally:
        del os.environ["TGN_TPU_GATHER"]
    launches = {k.__name__: k.launches for k in kernels}
    torch.cuda.synchronize()
    same = torch.equal(x_g, index_points(x, idx))
    with torch.no_grad():
        ref = attention.fused_vector_attention_packed_reference(q, k_g, v_g, p_r,
                                                                params, k=kk)
    err = float((out - ref).abs().max())
    log("entries", crops=b, points=n, k=kk, c=c, dtype="bfloat16",
        gather_identical=same, attention_max_abs_err=err, launches=launches)
    if not same or not err <= 1e-4 or not all(launches.values()):
        raise AssertionError(f"entries: gather identical {same}, attention err "
                             f"{err}, launches {launches}")
    return launches


def make_weights(work: Path):
    """Full-width fps and bdl models, random weights from a seeded generator,
    written in the JAX package's .npz layout."""
    from toothgroupnetwork_tpu_torch.models.tasks import (build_tgnet_bdl,
                                                          build_tgnet_fps,
                                                          tgnet_fps_config)
    from toothgroupnetwork_tpu_torch.utils.weights import randomize_, save_npz

    gen = torch.Generator().manual_seed(0)
    cfg = tgnet_fps_config()
    crop = cfg["model_parameter"]["crop_sample_size"]
    paths = {}
    for name, model in (("fps", build_tgnet_fps(cfg, device="cpu")),
                        ("bdl", build_tgnet_bdl(crop, device="cpu"))):
        randomize_(model, gen)
        with torch.no_grad():
            for half, shift in BG_SHIFT.items():
                getattr(model, half).cls_head.cls.bias[0] += shift
        paths[name] = work / f"{name}.npz"
        save_npz(str(paths[name]), model)
    return paths


def vertex_feats(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """[V, 6] xyz (centred, unit radius) + unit vertex normals of a mesh."""
    xyz = verts - verts.mean(axis=0)
    xyz /= np.linalg.norm(xyz, axis=1).max()
    a, b, c = (xyz[faces[:, i]] for i in range(3))
    nrm = np.zeros_like(xyz)
    fn = np.cross(b - a, c - a)
    for i in range(3):
        np.add.at(nrm, faces[:, i], fn)
    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-12)
    return np.concatenate([xyz, nrm], axis=1).astype(np.float32)


def phase_model(dev, ckpt: Path, feats: np.ndarray, cell: bool = False,
                dtype: str = "float32"):
    """Stage 1 of the full-width fps model on the card (kernels) against the
    CPU (plain versions), on N_POINTS FPS points of a scan's vertices; with
    ``cell`` the points are spatially sorted and the model runs the
    cell-attention path (K4/K5/K6 must launch on the card); ``dtype`` is
    the model's compute dtype. Argmax agreement must reach 0.999 in float32
    and 0.97 in bfloat16 (the two devices round bf16 sums taken in other
    orders). Returns the card's outputs."""
    from toothgroupnetwork_tpu_torch.models.tasks import (build_tgnet_fps,
                                                          tgnet_fps_config)
    from toothgroupnetwork_tpu_torch.ops import farthest_point_sample
    from toothgroupnetwork_tpu_torch.ops.cells import spatial_sort_perm
    from toothgroupnetwork_tpu_torch.ops.kernels import attention, cell_select
    from toothgroupnetwork_tpu_torch.utils.weights import load_npz

    src = torch.from_numpy(feats).to(dev)
    idx = farthest_point_sample(src[:, :3], N_POINTS).long()
    if cell:
        perm = spatial_sort_perm(feats[idx.cpu().numpy(), :3])
        idx = idx[torch.from_numpy(perm).to(dev)]
    feat = src[idx][None]
    cfg = tgnet_fps_config()
    cfg["model_parameter"].update(cell_attention=cell, dtype=dtype)
    cell_kernels = (cell_select.cell_select_x, cell_select.cell_select_p,
                    attention.fused_vector_attention)
    outs = {}
    for name, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        model = load_npz(str(ckpt), build_tgnet_fps(cfg, device=d)).eval()
        for k in cell_kernels:
            k.launches = 0
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = model.stage1(feat.to(d))
        if d.type == "cuda":
            torch.cuda.synchronize()
        outs[name] = ({k: out[k].float().cpu() for k in ("sem_1", "offset_1")},
                      time.perf_counter() - t0)
        if name == "cuda":
            launched = {k.__name__: k.launches for k in cell_kernels}
    (gpu, t_gpu), (cpu, t_cpu) = outs["cuda"], outs["cpu"]
    if not (all(launched.values()) if cell else not any(launched.values())):
        raise AssertionError(f"stage1 cell={cell}: cell kernels launched "
                             f"{launched}")
    for key, val in gpu.items():
        if not torch.isfinite(val).all():
            raise AssertionError(f"stage1 {key}: non-finite values on the card")
    agree = float((gpu["sem_1"].argmax(-1) == cpu["sem_1"].argmax(-1))
                  .float().mean())
    d_off = float((gpu["offset_1"] - cpu["offset_1"]).abs().max())
    d_sem = float((gpu["sem_1"] - cpu["sem_1"]).abs().max())
    log("model", what=f"fps stage1 {N_POINTS} pts, card vs CPU port",
        cell_attention=cell, dtype=dtype, argmax_agreement=agree,
        max_abs_doffset=d_off, max_abs_dlogit=d_sem, first_call_s_cuda=t_gpu,
        s_cpu=t_cpu, cell_launches=launched)
    floor = 0.999 if dtype == "float32" else 0.97
    if agree < floor:
        raise AssertionError(f"stage1 {dtype} argmax agreement {agree} < {floor}")
    return gpu


def phase_slice(dev, ckpts, scans, out_dir: Path, kernels, unused=(),
                config: Path | None = None, what: str = "slice", counted=()):
    """The CLI over the scans on the card; every kernel of ``kernels`` must
    launch and none of ``unused``; those of ``counted`` are counted only.
    Returns the launch counts and the pipeline."""
    from toothgroupnetwork_tpu_torch.cli import infer
    from toothgroupnetwork_tpu_torch.ops.kernels.attention import (
        fused_vector_attention_packed_x as k3)
    from toothgroupnetwork_tpu_torch.pipelines import ScanSegmentation

    argv = ["--input_dir_path", str(scans[0].parent), "--save_path", str(out_dir),
            "--model_name", "tgnet", "--checkpoint_path", str(ckpts["fps"]),
            "--checkpoint_path_bdl", str(ckpts["bdl"]), "--device", str(dev)]
    if config is not None:
        argv += ["--config_path", str(config)]
    for k in (*kernels, *unused, *counted):
        k.launches = 0
    k3.launches_by_shape.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipeline = infer.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in (*kernels, *unused, *counted)}
    # K3's launches by shape, counted by its wrapper in the same run
    SCAN_K3_SHAPES[what] = {
        f"B{b}/N{n}/K{kk}/C{c}" + (" bf16" if dtype == torch.bfloat16 else ""):
        count / len(scans) for (b, n, kk, c, dtype), count in k3.launches_by_shape.items()}
    log(what, scans=len(scans), wall_s=wall, scans_per_s=len(scans) / wall,
        launches=launches, last_scan_timings_s=dict(pipeline.timings))
    if sum(k3.launches_by_shape.values()) != launches[k3.__name__]:
        raise AssertionError(f"K3 by shape {k3.launches_by_shape} does not sum to "
                             f"its count {launches[k3.__name__]} ({what})")
    log("k3_shapes", what=what, launches_per_scan=SCAN_K3_SHAPES[what],
        not_in_phase3=sorted(set(SCAN_K3_SHAPES[what]) - {
            f"B{b}/N{n}/K{k}/C{c}{t}" for b, n, k, c in ATTENTION_SHAPES
            for t in ("", " bf16")}))
    for k in kernels:
        if launches[k.__name__] <= 0:
            raise AssertionError(f"kernel {k.__name__} was not launched ({what})")
    for k in unused:
        if launches[k.__name__] != 0:
            raise AssertionError(f"kernel {k.__name__} launched off its path "
                                 f"({what})")

    for scan in scans:
        res = json.loads((out_dir / (scan.stem + ".json")).read_text())
        n_vert = sum(1 for line in scan.open() if line.startswith("v "))
        labels, ins = res["labels"], res["instances"]
        if not (len(labels) == len(ins) == n_vert):
            raise AssertionError(f"{scan.name}: {len(labels)} labels, {len(ins)} "
                                 f"instances for {n_vert} vertices")
        if not set(labels) <= FDI or min(ins) < 0:
            raise AssertionError(f"{scan.name}: labels outside the FDI set")
        log("scan", what=what, name=scan.name, vertices=n_vert,
            labels=sorted(set(labels)), instances=len(set(ins)))

    # a repeated scan gives the same output, timed alone as a steady call
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    labels, ins, _ = ScanSegmentation(pipeline).predict([str(scans[0])])
    torch.cuda.synchronize()
    again_s = time.perf_counter() - t0
    first = json.loads((out_dir / (scans[0].stem + ".json")).read_text())
    if labels != first["labels"] or ins != first["instances"]:
        raise AssertionError("repeated scan: output differs from the first run")
    log("repeat", what=what, scan=scans[0].name, identical=True, wall_s=again_s,
        timings_s=dict(pipeline.timings))
    profile_call(lambda: pipeline(str(scans[0])), what)
    return launches, pipeline


# the instancing's DBSCAN eps and min_samples and MeanShift bandwidth
INSTANCING = (0.03, 30, 0.07)


def synthetic_foreground(seed: int) -> np.ndarray:
    """A foreground at the serving cell's size, as the instancing gets it
    (float16-valued float32): 14 teeth of 700 points along an arch, the
    4th, 5th and 11th moved to 0.05 from the tooth before, and 300
    scattered points. At seed 0 DBSCAN finds 9 clusters and the instancing
    re-splits two (53 seeds over 3492 points), near the serving cell's
    re-splits (49-132 seeds over 1.5k-2.6k points)."""
    rng = np.random.default_rng(seed)
    t = np.linspace(-0.8, 0.8, 14)
    cents = np.stack([t, 0.5 * t ** 2, np.zeros_like(t)], -1)
    for m in (3, 4, 10):
        step = cents[m] - cents[m - 1]
        cents[m] = cents[m - 1] + step / np.linalg.norm(step) * 0.05
    x = np.concatenate([rng.normal(c, 0.02, (700, 3)) for c in cents]
                       + [rng.uniform(-1, 1, (300, 3))])
    return x[rng.permutation(len(x))].astype(np.float16).astype(np.float32)


def climb_steps(x: np.ndarray, seeds: np.ndarray, bandwidth: float,
                max_iter: int = 300) -> int:
    """The steps of the host's climbs of ``seeds`` over ``x``
    (``postprocess/clustering.py:_climbs``), the last, empty ball's
    included: each is a ball test of every point of ``x``."""
    from scipy.spatial import cKDTree

    tree, stop, steps = cKDTree(x), 1e-3 * bandwidth, 0
    for seed in seeds:
        mean, it = seed, 0
        while True:
            nb = np.sort(np.asarray(tree.query_ball_point(mean, bandwidth), np.int64))
            steps += 1
            if nb.size == 0:
                break
            old, mean = mean, x[nb].mean(axis=0)
            if np.linalg.norm(mean - old) <= stop or it == max_iter:
                break
            it += 1
    return steps


def phase_instancing(dev, pipe, scans) -> list:
    """K9 and K10 on the instancing inputs the scans give ``pipe`` (the
    default pipeline's ``get_clustering_labels`` calls, recorded) and on
    :func:`synthetic_foreground`: each recorded call's labels identical to
    the host route's on the same inputs; K9 identical to its plain twin and
    to the host ``dbscan``; K10, on the clusters the instancing re-splits,
    identical to its twin and each climb to the host's; CUDA-event times
    beside the twins' (on the CPU) and the bounds. Returns K9's and K10's
    records."""
    from toothgroupnetwork_tpu_torch.ops.kernels import cluster
    from toothgroupnetwork_tpu_torch.pipelines import tgn
    from toothgroupnetwork_tpu_torch.postprocess import clustering

    eps, min_samples, bandwidth = INSTANCING
    source = "toothgroupnetwork_tpu_torch/csrc/cluster.cu"
    replaces = "none: the JAX package clusters on the host (scikit-learn)"
    rec_db = KernelRecord("dbscan", source, replaces)
    rec_ms = KernelRecord("mean_shift", source, replaces)
    with Recorded(tgn, "get_clustering_labels") as calls:
        for scan in scans:
            pipe(str(scan))
        torch.cuda.synchronize()
    inputs = []
    for i, ((moved, labels, (moved_dev, labels_dev)), _, got) in enumerate(calls):
        if not moved_dev.is_cuda:
            raise AssertionError("instancing: the pipeline handed no CUDA copy")
        want = clustering.get_clustering_labels(moved, labels)
        if not same(got, want):
            raise AssertionError(f"instancing call {i}: the card route's labels "
                                 "differ from the host route's")
        inputs.append((f"scan_call{i}", moved[labels != 0], moved_dev[labels_dev != 0]))
    fg = synthetic_foreground(0)
    inputs.append(("synthetic", fg, torch.from_numpy(fg).to(dev)))
    log("instancing", calls=len(calls), identical_to_host_route=True,
        foreground_points=[len(x) for _, x, _ in inputs])

    for what, fg, fg_dev in inputs:
        n = len(fg)
        if n == 0:
            continue
        db = cluster.dbscan(fg_dev, eps, min_samples).cpu().numpy()
        t0 = time.perf_counter()
        twin = cluster.dbscan_reference(fg_dev.cpu(), eps, min_samples).numpy()
        plain_ms = (time.perf_counter() - t0) * 1e3
        host_labels, core_idx = clustering.dbscan(fg, eps, min_samples)
        core = np.zeros(n, np.int64)
        core[core_idx] = 1
        if not (same(db, twin) and same(db, np.stack([host_labels, core]))):
            raise AssertionError(f"K9 ({what}, n {n}) differs from its twin or the host")
        pairs = n * (n - 1) / 2
        rec_db.add(f"{what}/n{n}", 0.0,
                   cuda_ms(lambda: cluster.dbscan(fg_dev, eps, min_samples), 20),
                   plain_ms, ops=8.0 * pairs, f64_ops=8.0 * pairs,
                   moved=12.0 * n + 16.0 * n, clusters=int(db[0].max() + 1),
                   core_points=int(db[1].sum()))

        merged = clustering._merged_clusters(fg, db[0], db[1].astype(bool))
        if not merged:
            log("instancing", what=what, n=n, resplits=0)
            continue
        args, owner, clouds = clustering._climb_inputs(fg, fg_dev, db[0], merged,
                                                       bandwidth)
        means, counts = (t.cpu().numpy() for t in cluster.mean_shift(*args, bandwidth))
        t0 = time.perf_counter()
        twin_means, twin_counts = cluster.mean_shift_reference(
            *(a.cpu() for a in args), bandwidth)
        plain_ms = (time.perf_counter() - t0) * 1e3
        if not (same(means, twin_means) and same(counts, twin_counts)):
            raise AssertionError(f"K10 ({what}) differs from its twin")
        seeds = args[2].cpu().numpy()
        tests = 0
        for c, x in enumerate(clouds):
            mine = owner == c
            if clustering._intensity(means[mine], counts[mine]) != clustering._climbs(
                    x, bandwidth, seeds[mine], 300):
                raise AssertionError(f"K10 ({what}, cluster {c}) climbs differ from "
                                     "the host's")
            tests += climb_steps(x, seeds[mine], bandwidth) * len(x)
        s, p = len(owner), len(args[0])
        rec_ms.add(f"{what}/seeds{s}/points{p}", 0.0,
                   cuda_ms(lambda: cluster.mean_shift(*args, bandwidth), 20),
                   plain_ms, ops=8.0 * tests, f64_ops=8.0 * tests,
                   moved=12.0 * p + 12.0 * s + 4.0 * s + 16.0 * s,
                   resplits=len(merged), ball_tests=tests)
    if not rec_ms.entry["shapes"]:
        raise AssertionError("instancing: K10 never ran (no input re-split a cluster)")
    return [rec_db, rec_ms]


def phase_ab(pipes: dict, scan: Path, rounds: int = 2) -> None:
    """Steady calls of the configurations' pipelines on one scan, in turns
    (in order, then in reverse, per round: default, cell, bf16, bf16, cell,
    default): wall and per-phase seconds of each call, so the
    configurations are compared on one card within one run."""
    samples = {name: [] for name in pipes}
    for name in (list(pipes) + list(pipes)[::-1]) * rounds:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipes[name](str(scan))
        torch.cuda.synchronize()
        samples[name].append({"wall_s": time.perf_counter() - t0,
                              **pipes[name].timings})
    for name, calls in samples.items():
        keys = calls[0].keys()
        log("ab", config=name, calls=len(calls),
            median_s={k: float(np.median([c[k] for c in calls])) for k in keys},
            wall_s=[c["wall_s"] for c in calls])


# the device boundary phase: steady calls of each route in turns, and the
# gates' tolerances: the 1-NN d2 of the routes within rtol 1e-4, a 1-NN
# index only swapped between points whose d2 agree within float32 rounding
# (rtol 1e-6), the mask equal outside 2.5/40 of bdl_ratio and on 0.99 of
# the vertices (tests/test_tgn_pipeline.py:86-141: the KD-tree ranks in
# float64, K2 in float32, so a 40-set may differ at its 40th place)
BOUNDARY_ROUNDS = 3
BOUNDARY_KNN_K = 40
# K2's any-size kernel (k > 64 or C > 256): (B, M, N, C, k)
KNN_SIZE_SHAPES = ((1, 3000, 3000, 3, 65), (1, 3000, 3000, 300, 20),
                   (2, 700, 3000, 300, 65))


class Recorded:
    """Inside the block, each call of ``module.<name>`` is kept as (args,
    kwargs, result)."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, []

    def __enter__(self):
        self.orig = fn = getattr(self.module, self.name)

        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            self.calls.append((args, kw, out))
            return out

        setattr(self.module, self.name, wrapped)
        return self.calls

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


class PlainVersions:
    """Inside the block the port's K1 and K2 entries take their plain
    versions on the card: the device boundary route's comparison, never a
    path of the program."""

    def __enter__(self):
        import importlib

        from toothgroupnetwork_tpu_torch.ops.kernels import fps, knn

        fps_mod = importlib.import_module("toothgroupnetwork_tpu_torch.ops.fps")
        knn_mod = importlib.import_module("toothgroupnetwork_tpu_torch.ops.knn")
        self.saved = [(fps_mod, "fps_kernel", fps_mod.fps_kernel),
                      (knn_mod, "knn_select", knn_mod.knn_select)]
        fps_mod.fps_kernel, knn_mod.knn_select = (fps.fps_reference,
                                                  knn.knn_select_reference)

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def same(a, b) -> bool:
    """Bit-identical tensors, arrays or numbers (a tensor held against its
    host copy)."""
    a, b = (np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x) for x in (a, b))
    return a.shape == b.shape and a.dtype == b.dtype and bool(np.array_equal(a, b))


def phase_device_boundary(dev, pipes: dict, configs: dict, scans,
                          records, kernels) -> dict:
    """The device boundary route, which every pipeline on the card takes
    (phases 5-7 built them through ``cli.infer``), on each configuration's
    scan: the stage outputs bit-identical to the route on K1's and K2's
    plain versions (mask, 1-NN index, d2 and label, the fill, the boundary
    1-NN, the final labels), held to the host route on the same stage-1
    labels (the gates above; given the host's mask, the fill identical), a
    repeated scan and ``run_many`` identical, the launches a scan (K2 two
    more than the host route, K1 as many), the phases' seconds each way.
    The host route, for the comparison only, is a pipeline around the same
    models with the CPU's route set. The default configuration's K2 and K1
    shapes timed; K2's any-size kernel (k = 65, C = 300) equal to its plain
    version. Returns each configuration's launches a device-route scan."""
    from scipy.spatial import cKDTree

    from toothgroupnetwork_tpu_torch.ops import farthest_point_sample
    from toothgroupnetwork_tpu_torch.ops.kernels import knn
    from toothgroupnetwork_tpu_torch.pipelines import tgn
    from toothgroupnetwork_tpu_torch.pipelines.base import fps_sample_idx
    from toothgroupnetwork_tpu_torch.postprocess import boundary
    from toothgroupnetwork_tpu_torch.postprocess.clustering import first_label_ratio

    t_phase = time.perf_counter()
    scan = str(scans[0])
    per_scan = {}
    for name, dpipe in pipes.items():
        if dpipe.variants()["boundary_route"] != "device":
            raise AssertionError(f"device boundary ({name}): the pipeline on "
                                 "the card does not take the device route")
        hpipe = tgn.TgnInferencePipeline(
            None, None, configs[name],
            inject_modules=(dpipe.fps_module, dpipe.bdl_module), device=dev)
        hpipe._boundary_on_device = False   # the comparison's host route
        # one scan each way: the launches, the device scan's stage inputs
        counts, out = {}, {}
        for route, p in (("host", hpipe), ("device", dpipe)):
            for k in kernels:
                k.launches = 0
            with Recorded(tgn, "boundary_sampled_feats") as clouds, \
                    Recorded(tgn, "boundary_nn1") as nn1s, \
                    Recorded(tgn, "final_transfer") as transfers:
                out[route] = p(scan)
                torch.cuda.synchronize()
            counts[route] = {k.__name__: k.launches for k in kernels}
        per_scan[name] = counts["device"]
        (args, kw, dev_out), = clouds
        n_bd = dev_out[2]
        d_knn = counts["device"]["knn_select"] - counts["host"]["knn_select"]
        d_fps = counts["device"]["fps"] - counts["host"]["fps"]
        if (d_knn, d_fps) != ((2 if n_bd else 1), 0):
            raise AssertionError(f"device boundary ({name}): K2 {d_knn:+d} and "
                                 f"K1 {d_fps:+d} launches beside the host route")
        again = dpipe(scan)
        if not all(same(again[k], out["device"][k]) for k in ("sem", "ins")):
            raise AssertionError(f"device boundary ({name}): a repeated scan differs")

        # the stage outputs, kernels against their plain versions on the card
        labels, org_np, smp_np = args[0], args[1], args[2]
        org_dev, smp_dev = kw["org_dev"], kw["sampled_dev"]
        info = dpipe.boundary_info
        k = min(BOUNDARY_KNN_K, smp_np.shape[0])
        lab_dev = torch.from_numpy(labels).to(dev)
        purity = boundary.boundary_purity_device(org_dev[:, :3], smp_dev[:, :3],
                                                 lab_dev, k, info["bdl_ratio"])
        with PlainVersions():
            purity_plain = boundary.boundary_purity_device(
                org_dev[:, :3], smp_dev[:, :3], lab_dev, k, info["bdl_ratio"])
            cloud_plain = boundary.boundary_sampled_feats(*args, **kw)
            nn1_plain = (tgn.boundary_nn1(*nn1s[0][0]) if n_bd else None)
        stage_same = {
            "mask": same(purity[0], purity_plain[0]),
            "nn1_label": same(purity[1], purity_plain[1]),
            "nn1_idx": same(purity[2], purity_plain[2]),
            "nn1_d2": same(purity[3], purity_plain[3]),
            "fill_rows": all(same(a, b) for a, b in zip(dev_out, cloud_plain)),
            "boundary_nn1": (not n_bd or all(
                same(a, b) for a, b in zip(nn1s[0][2], nn1_plain)))}
        targs = transfers[0][0]
        plain_labels = tgn.final_transfer(
            targs[0], targs[1], *(nn1_plain or (None, None)), *targs[4:])
        stage_same["final_labels"] = same(plain_labels, transfers[0][2])
        if not all(stage_same.values()):
            raise AssertionError(f"device boundary ({name}): kernels differ from "
                                 f"their plain versions: {stage_same}")

        # the host route on the same stage-1 labels
        host_out = boundary.boundary_sampled_feats(*args, **dict(kw, org_dev=None))
        bd_h, _, nn1_h, d2_h = boundary.boundary_purity(
            org_np[:, :3].astype(np.float32), smp_np[:, :3], labels, k,
            info["bdl_ratio"])
        _, nn40 = cKDTree(smp_np[:, :3]).query(org_np[:, :3].astype(np.float32),
                                               k=k, workers=-1)
        ratio_h = first_label_ratio(labels[nn40])
        bd_d = purity[0].cpu().numpy()
        nn1_d, d2_d = purity[2].cpu().numpy(), purity[3].cpu().numpy()
        near = np.abs(ratio_h - info["bdl_ratio"]) <= 2.5 / k
        agree = bd_d == bd_h
        swap = nn1_d != nn1_h
        d2_ok = np.abs(d2_d - d2_h) <= 1e-4 * np.abs(d2_h) + 1e-9
        swap_ok = np.abs(d2_d - d2_h)[swap] <= 1e-6 * np.abs(d2_h)[swap] + 1e-12
        # given the host's mask, the masked fill and the host's fill
        need = info["num_of_all_points"] - min(int(bd_h.sum()),
                                               info["num_of_bdl_points"])
        non_bd = np.flatnonzero(~bd_h)
        fill_same = None
        if non_bd.shape[0] > need > 0:
            fill_same = same(
                farthest_point_sample(org_dev[:, :3], need,
                                      torch.from_numpy(~bd_h).to(dev)).long(),
                non_bd[fps_sample_idx(org_np[non_bd, :3], need, device=dev)])
        versus_host = {
            "nn1_d2_within_1e-4": bool(d2_ok.all()),
            "nn1_swaps": int(swap.sum()),
            "nn1_swaps_at_equal_d2": bool(swap_ok.all()),
            "mask_agree": float(agree.mean()),
            "mask_agree_outside_band": bool(agree[~near].all()),
            "fill_given_host_mask_identical": fill_same,
            "cloud_identical": all(same(a, b) for a, b in
                                   zip(dev_out[:3] + dev_out[5:],
                                       host_out[:3] + host_out[5:])),
            "final_labels_agree": float(np.mean(
                (out["device"]["sem"] == out["host"]["sem"])
                & (out["device"]["ins"] == out["host"]["ins"])))}
        if not (versus_host["nn1_d2_within_1e-4"]
                and versus_host["nn1_swaps_at_equal_d2"]
                and versus_host["mask_agree_outside_band"]
                and versus_host["mask_agree"] >= 0.99 and fill_same is not False):
            raise AssertionError(f"device boundary ({name}) against the host "
                                 f"route: {versus_host}")

        # run_many on the device route against serial calls
        paths = [str(p) for p in scans]
        serial = [out["device"]] + [dpipe(p) for p in paths[1:]]
        many = dpipe.run_many(paths, workers=3, prep_workers=0)
        if not all(same(g[key], w[key]) for g, w in zip(many, serial)
                   for key in ("sem", "ins")):
            raise AssertionError(f"device boundary ({name}): run_many differs "
                                 "from serial calls")

        # steady calls of the two routes in turns
        samples = {"host": [], "device": []}
        for _ in range(BOUNDARY_ROUNDS):
            for route, p in (("host", hpipe), ("device", dpipe)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                p(scan)
                torch.cuda.synchronize()
                samples[route].append({"wall_s": time.perf_counter() - t0,
                                       **p.timings})
        median = {route: {key: float(np.median([c[key] for c in calls]))
                          for key in calls[0]}
                  for route, calls in samples.items()}
        log("device_boundary", config=name, n_boundary=n_bd,
            fill_points=info["num_of_all_points"] - n_bd,
            launches_host=counts["host"], launches_device=counts["device"],
            stage_outputs_identical_to_plain=stage_same, versus_host=versus_host,
            repeat_identical=True, run_many_identical=True,
            median_s=median, variants=dpipe.variants())

        if name == "default":
            time_boundary_kernels(dev, records, org_dev, smp_dev, bd_d, need,
                                  nn1s[0][0] if n_bd else None)

    # K2's any-size kernel (k > 64 or C > 256): equal to its plain version on
    # the same inputs on the card, one launch a call, timed beside it; the
    # operations as knn_ops counts them (M != N: every pair)
    rec_knn = records[1]
    launches = knn.knn_select.launches
    gen = np.random.default_rng(7)
    for b, m, n, c, k in KNN_SIZE_SHAPES:
        q = torch.from_numpy(gen.standard_normal((b, m, c)).astype(np.float32)).to(dev)
        pts = torch.from_numpy(gen.standard_normal((b, n, c)).astype(np.float32)).to(dev)
        gi, gd = knn.knn_select(q, pts, k)
        ri, rd = knn.knn_select_reference(q, pts, k)
        if not (same(gi, ri) and same(gd, rd)):
            raise AssertionError(f"K2 any-size [{b},{m}]x[{b},{n}] C={c} k={k} "
                                 "differs from its plain version")
        if knn.knn_select.launches != launches + 1:
            raise AssertionError("K2's any-size call did not count one launch")
        rec_knn.add(f"any-size [{b},{m}]x[{b},{n}] C={c} k={k}", 0.0,
                    cuda_ms(lambda: knn.knn_select(q, pts, k), 3),
                    cuda_ms(lambda: knn.knn_select_reference(q, pts, k), 1),
                    ops=knn_ops(c, b, m, n, False), moved=nbytes(q, pts, gi, gd),
                    device_ms=graph_ms(lambda: knn.knn_select(q, pts, k), 3),
                    route=knn.knn_route(c, k),
                    splits=knn_splits(knn.knn_route(c, k), b, m, n, k), identical=True)
        launches = knn.knn_select.launches
    log("device_boundary", seconds=time.perf_counter() - t_phase,
        launches_per_scan=per_scan)
    return per_scan


def time_boundary_kernels(dev, records, org_dev, smp_dev, bd_mask, need,
                          nn1_args) -> None:
    """K2 at the purity shape (every vertex's 40 nearest of the sample) and
    at the boundary 1-NN's (its 4 nearest boundary points), K1's masked
    fill, each against its plain version and its bound, into the kernels
    line."""
    from toothgroupnetwork_tpu_torch.ops.kernels import fps, knn
    from toothgroupnetwork_tpu_torch.pipelines.tgn import NN1_CANDIDATES

    rec_fps, rec_knn = records[0], records[1]
    q = org_dev[None, :, :3].contiguous()
    shapes = [(q, smp_dev[None, :, :3].contiguous(), BOUNDARY_KNN_K, "purity")]
    if nn1_args is not None:
        shapes.append((nn1_args[0][None].contiguous(),
                       nn1_args[1][None].contiguous(), NN1_CANDIDATES, "boundary 1-NN"))
    for qry, pts, k, what in shapes:
        gi, gd = knn.knn_select(qry, pts, k)
        plain = []
        plain_ms = cuda_ms(lambda: plain.append(
            knn.knn_select_reference(qry, pts, k)), 1, warm=0)
        if not (same(gi, plain[0][0]) and same(gd, plain[0][1])):
            raise AssertionError(f"K2 at the {what} shape differs from its plain "
                                 "version")
        rec_knn.add(f"{what} [1,{qry.shape[1]}]x[1,{pts.shape[1]}] k={k}", 0.0,
                    cuda_ms(lambda: knn.knn_select(qry, pts, k), 3), plain_ms,
                    ops=knn_ops(3, 1, qry.shape[1], pts.shape[1], False),
                    moved=nbytes(qry, pts, gi, gd),
                    device_ms=graph_ms(lambda: knn.knn_select(qry, pts, k), 3),
                    device_boundary=True, identical=True)
    if need > 0:
        valid = torch.from_numpy(~bd_mask).to(dev)[None]
        got = fps.fps(q, need, valid)
        plain = []
        plain_ms = cuda_ms(lambda: plain.append(fps.fps_reference(q, need, valid)),
                           1, warm=0)
        if not same(got, plain[0]):
            raise AssertionError("K1's masked fill differs from its plain version")
        n_valid = int(valid.sum())
        ms = cuda_ms(lambda: fps.fps(q, need, valid), 3)
        rec_fps.add(f"masked fill [1,{q.shape[1]}] valid {n_valid}->{need}", 0.0,
                    ms, plain_ms, ops=10.0 * need * n_valid, moved=nbytes(q, valid, got),
                    cluster=fps.cluster_size(q.shape[1]), us_per_step=ms * 1e3 / need,
                    device_boundary=True, identical=True)


def profile_call(call, what: str) -> float:
    """``call()`` once more under torch.profiler: the device's busy share
    (kernel intervals of every stream merged, over the call's wall time) and
    device time by kernel. Returns the busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            t, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + (e.time_range.end - e.time_range.start) / 1e6,
                               n + 1)
    busy, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    busy /= 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    log("profile", what=what, wall_s=wall, device_busy_s=busy,
        busy_share=busy / wall,
        device_s_by_kernel={short(name): t for name, (t, _) in top},
        launches_by_kernel={short(name): n for name, (_, n) in top})
    return busy / wall


def worker_cuda_state() -> dict:
    """Run in a prep worker of ``run_many``: whether the process imported
    torch (this script's top level, which a spawned worker imports again as
    ``__mp_main__``) and whether it initialised CUDA, which it must not."""
    torch_mod = sys.modules.get("torch")
    return {"pid": os.getpid(), "torch_imported": torch_mod is not None,
            "cuda_initialized": bool(torch_mod and torch_mod.cuda.is_initialized())}


class PhaseSeconds:
    """Inside the block, every phase time a pipeline records
    (``TgnInferencePipeline._t``) is also summed here by phase, over all
    scans and threads: the host phases' cost under overlap, beside serial."""

    def __enter__(self):
        from toothgroupnetwork_tpu_torch.pipelines.tgn import TgnInferencePipeline

        self.totals, lock = defaultdict(float), threading.Lock()
        self._cls, self._orig = TgnInferencePipeline, TgnInferencePipeline.__dict__["_t"]
        record = self._orig.__func__

        def _t(timings, name, t0):
            now = record(timings, name, t0)
            with lock:
                self.totals[name] += now - t0
            return now

        TgnInferencePipeline._t = staticmethod(_t)
        return self

    def __exit__(self, *exc):
        self._cls._t = self._orig


def phase_serve_many(pipes: dict, work: Path, kernels) -> None:
    """Each configuration's pipeline serves its scans serially, then (after
    one warm batch) through ``run_many``: every scan's labels and instances
    identical to its serial output, each kernel's launches over the batch
    equal to the serial count, K3's by-shape counts summing to its count,
    the kernel library loaded once, no prep worker with CUDA initialised.
    Logs scans per second both ways, the phases' seconds a scan both ways,
    and (default) the device's busy share over one more batch and scans per
    second with 1, 2 and 4 scans in flight (``SERVE_SWEEP``)."""
    from synthetic import write_synthetic_obj

    from toothgroupnetwork_tpu_torch.ops.kernels import build
    from toothgroupnetwork_tpu_torch.ops.kernels.attention import (
        fused_vector_attention_packed_x as k3)

    scan_dir = work / "serve"
    scan_dir.mkdir()
    scans = []
    for seed in SERVE_SEEDS:
        path = scan_dir / f"serve{seed}_{('lower', 'upper')[seed % 2]}.obj"
        write_synthetic_obj(str(path), n_side=N_SIDE, seed=seed)
        scans.append(str(path))

    def batch(pipe, paths, way):
        for k in kernels:
            k.launches = 0
        k3.launches_by_shape.clear()
        torch.cuda.synchronize()
        with PhaseSeconds() as phases:
            t0 = time.perf_counter()
            outs = ([pipe(p) for p in paths] if way == "serial" else
                    pipe.run_many(paths, workers=SERVE_WORKERS,
                                  prep_workers=SERVE_PREP))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        return {"outs": outs, "wall_s": wall,
                "launches": {k.__name__: k.launches for k in kernels},
                "k3_by_shape": sum(k3.launches_by_shape.values()),
                "phase_s_per_scan": {k: v / len(paths)
                                     for k, v in phases.totals.items()}}

    for name, n in SERVE_SCANS.items():
        pipe, paths = pipes[name], scans[:n]
        try:
            serial = batch(pipe, paths, "serial")
            pipe.run_many(paths, workers=SERVE_WORKERS, prep_workers=SERVE_PREP)
            over = batch(pipe, paths, "overlapped")
            same = [bool(np.array_equal(o["sem"], s["sem"])
                         and np.array_equal(o["ins"], s["ins"]))
                    for o, s in zip(over["outs"], serial["outs"])]
            log("serve_many", config=name, scans=n, workers=SERVE_WORKERS,
                prep_workers=SERVE_PREP, serial_s=serial["wall_s"],
                overlapped_s=over["wall_s"],
                serial_scans_per_s=n / serial["wall_s"],
                overlapped_scans_per_s=n / over["wall_s"],
                speedup=serial["wall_s"] / over["wall_s"], identical=same,
                launches_serial=serial["launches"],
                launches_overlapped=over["launches"],
                k3_by_shape_sum=over["k3_by_shape"],
                phase_s_per_scan={"serial": serial["phase_s_per_scan"],
                                  "overlapped": over["phase_s_per_scan"]})
            if not all(same):
                raise AssertionError(f"serve_many {name}: run_many outputs differ "
                                     f"from serial ones ({same})")
            if over["launches"] != serial["launches"]:
                raise AssertionError(f"serve_many {name}: launches {over['launches']}"
                                     f" under run_many, {serial['launches']} serial")
            if over["k3_by_shape"] != over["launches"][k3.__name__]:
                raise AssertionError(f"serve_many {name}: K3 by shape sums to "
                                     f"{over['k3_by_shape']}, its count is "
                                     f"{over['launches'][k3.__name__]}")
            if name == "default":
                profile_call(lambda: pipe.run_many(paths, workers=SERVE_WORKERS,
                                                   prep_workers=SERVE_PREP),
                             "serve_many default")
                pool = pipe._prep_pool(SERVE_PREP)
                states = [pool.submit(worker_cuda_state).result()
                          for _ in range(2 * SERVE_PREP)]
                log("prep_workers", states=states)
                if any(st["cuda_initialized"] for st in states):
                    raise AssertionError(f"a prep worker initialised CUDA: {states}")
                for w in SERVE_SWEEP:
                    pipe.run_many(paths, workers=w, prep_workers=SERVE_PREP)
                    torch.cuda.synchronize()
                    with PhaseSeconds() as phases:
                        t0 = time.perf_counter()
                        outs = pipe.run_many(paths, workers=w, prep_workers=SERVE_PREP)
                        torch.cuda.synchronize()
                        wall = time.perf_counter() - t0
                    same = all(np.array_equal(o["sem"], r["sem"])
                               and np.array_equal(o["ins"], r["ins"])
                               for o, r in zip(outs, serial["outs"]))
                    log("serve_many_sweep", config=name, workers=w, scans=n,
                        scans_per_s=n / wall, identical=same,
                        phase_s_per_scan={k: v / n for k, v in phases.totals.items()})
                    if not same:
                        raise AssertionError(f"serve_many {name}, {w} in flight: "
                                             "outputs differ from serial ones")
        finally:
            pipe.close()
    log("build", loads=build.build_info["loads"], built=build.build_info["built"])
    if build.build_info["loads"] != 1:
        raise AssertionError(f"kernel library loaded {build.build_info['loads']} times")


def cpu_reference_rows(n: int) -> np.ndarray:
    """The ``CPU_REFERENCE_POINTS`` rows of an ``n``-point cloud, in order,
    on which phases 10-11 compare the card with the CPU port."""
    return np.sort(np.random.default_rng(0).permutation(n)[:CPU_REFERENCE_POINTS])


def write_train_data(work: Path) -> None:
    """The labelled synthetic arch cases ``TRAIN_CASES`` under
    ``work/train_data`` and their split files."""
    from synthetic import write_processed_npy

    for i, (case, jaw, teeth) in enumerate(TRAIN_CASES):
        write_processed_npy(str(work / "train_data"), case, jaw, n_points=N_POINTS,
                            n_teeth=teeth, seed=20 + i)
    (work / "train.txt").write_text("TR00\nTR01\n")
    (work / "val.txt").write_text("TR02\n")


def phase_train(dev, work: Path, ckpts, scan: Path) -> dict:
    """tgnet_fps training at full width (planes 32..512, 24000 points, 16
    crops of 3072, batch 1, the SGD preset and its seven loss weights) on
    labelled synthetic arch cases (``TRAIN_CASES``):

      * step 1's seven losses on the card equal the CPU port's (the same
        flax-like initial weights from one seed, the same batch cut to
        ``CPU_REFERENCE_POINTS`` points) within 1e-3 relative, with the CPU
        step's seconds;
      * one epoch through ``cli.train.main`` (two train steps, one val
        pass), every count set to 0 just before: K1 and K2 launched; then
        another train epoch (K1 and K2 in its steps, K3 in none: training
        runs the unfused attention) and a val pass (K3 launched);
      * the checkpoint resumes (epoch and every tensor), the exported .npz
        serves one scan through ``TgnInferencePipeline``;
      * two seeded runs bit-identical after ``TRAIN_REPEAT_STEPS`` steps
        (losses, parameters, BatchNorm statistics), the loss falling over
        ``TRAIN_FALL_STEPS`` steps on one batch, every loss finite;
      * the median step seconds with and without deterministic algorithms,
        the peak memory of a step and one profiled step (busy share, top
        kernels).

    Returns K1-K3's launches per train step and per val scan."""
    from toothgroupnetwork_tpu_torch.cli import train as cli_train
    from toothgroupnetwork_tpu_torch.data import DentalScanDataset
    from toothgroupnetwork_tpu_torch.models import get_task
    from toothgroupnetwork_tpu_torch.ops.kernels import attention, fps, knn
    from toothgroupnetwork_tpu_torch.pipelines import (ScanSegmentation,
                                                       make_inference_pipeline)
    from toothgroupnetwork_tpu_torch.train import make_optimizer, train_step
    from toothgroupnetwork_tpu_torch.train.checkpoints import save_weights
    from toothgroupnetwork_tpu_torch.train.trainer import Trainer
    from toothgroupnetwork_tpu_torch.utils.weights import init_like_flax_

    write_train_data(work)
    data = work / "train_data"
    task = get_task("tgnet_fps")
    cfg = task.default_config()
    kernels = (fps.fps, knn.knn_select, attention.fused_vector_attention_packed_x,
               attention.project_kv)

    def counts():
        return {k.__name__: k.launches for k in kernels}

    def zero():
        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()

    def fresh(device):
        model = task.build_module(cfg, device=device)
        init_like_flax_(model, torch.Generator().manual_seed(cfg.seed))
        return model, make_optimizer(cfg.optimizer, model.parameters())

    item = DentalScanDataset(str(data))[0]
    batch = {k: torch.from_numpy(item[k][None]) for k in ("feat", "gt_seg_label", "mask")}
    on_card = {k: v.to(dev) for k, v in batch.items()}

    def run(steps, model=None, opt=None, deterministic=True):
        if model is None:
            model, opt = fresh(dev)
        losses, secs = [], []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            vals = train_step(model, opt, task, cfg, on_card, deterministic)
            losses.append({k: float(v) for k, v in vals.items()})
            secs.append(time.perf_counter() - t0)
        return model, opt, losses, secs

    # step 1 on the card against the CPU port, from the same weights, on
    # CPU_REFERENCE_POINTS points of the case
    model_a, opt_a, losses_a, secs_a = run(TRAIN_REPEAT_STEPS)
    rows = torch.from_numpy(cpu_reference_rows(N_POINTS))
    small = {k: v[:, rows] for k, v in batch.items()}
    step1, step1_s = {}, {}
    for device in (dev, torch.device("cpu")):
        model_c, opt_c = fresh(device)
        t0 = time.perf_counter()
        step1[device.type] = {k: float(v) for k, v in train_step(
            model_c, opt_c, task, cfg, {k: v.to(device) for k, v in small.items()}).items()}
        step1_s[device.type] = time.perf_counter() - t0
        del model_c, opt_c
    (on_dev, cpu), cpu_s = (step1["cuda"], step1["cpu"]), step1_s["cpu"]
    rel = {k: abs(on_dev[k] - cpu[k]) / max(abs(cpu[k]), 1e-12) for k in cpu}
    log("train_step1", what=f"card vs CPU port, step 1, {CPU_REFERENCE_POINTS} points",
        card=on_dev, cpu=cpu, rel_diff=rel, cpu_step_s=cpu_s, card_step_s=secs_a[0])
    if len(cpu) != 7 or max(rel.values()) > 1e-3:
        raise AssertionError(f"train step 1: card vs CPU relative differences {rel}")

    # two seeded runs, bit for bit
    model_b, _, losses_b, _ = run(TRAIN_REPEAT_STEPS)
    same = losses_a == losses_b and all(
        torch.equal(a, b) for a, b in zip(model_a.state_dict().values(),
                                          model_b.state_dict().values()))
    log("train_repeat", steps=TRAIN_REPEAT_STEPS, identical=same)
    if not same:
        raise AssertionError("two seeded training runs differ")
    del model_b

    # the loss falls on one fixed batch; every loss finite
    _, _, more, secs_more = run(TRAIN_FALL_STEPS - TRAIN_REPEAT_STEPS, model_a, opt_a)
    totals = [sum(v * cfg.loss_weights[k] for k, v in ls.items())
              for ls in losses_a + more]
    log("train_fall", steps=len(totals), total_loss=totals)
    if not all(np.isfinite(list(ls.values())).all() for ls in losses_a + more):
        raise AssertionError(f"non-finite training losses: {losses_a + more}")
    if not totals[-1] < totals[0]:
        raise AssertionError(f"the loss did not fall over {len(totals)} steps: {totals}")

    # step seconds with and without deterministic algorithms, peak memory,
    # one profiled step
    timed = {}
    for det in (True, False, True):
        _, _, _, secs = run(TRAIN_TIMED_STEPS, model_a, opt_a, deterministic=det)
        timed.setdefault(det, []).extend(secs)
    torch.cuda.reset_peak_memory_stats(dev)
    run(1, model_a, opt_a)
    peak = torch.cuda.max_memory_allocated(dev)
    med = {det: float(np.median(v)) for det, v in timed.items()}
    log("train_time", deterministic_step_s=med[True], nondeterministic_step_s=med[False],
        determinism_cost=med[True] / med[False] - 1.0, steps_each=len(timed[True]),
        peak_memory_gib=peak / 2 ** 30, first_step_s=secs_a[0])
    log("train_phases", what="one step, each phase ended by a synchronise",
        phase_s=step_phases(model_a, opt_a, task, cfg, on_card))
    profile_call(lambda: run(1, model_a, opt_a), "train step")
    del model_a, opt_a

    # the main path: one epoch through the CLI
    ckpt = work / "train_ckpt" / "fps"
    argv = ["--model_name", "tgnet_fps", "--input_data_dir_path", str(data),
            "--train_data_split_txt_path", str(work / "train.txt"),
            "--val_data_split_txt_path", str(work / "val.txt"),
            "--checkpoint_path", str(ckpt), "--max_epochs", "1", "--device", str(dev)]
    zero()
    t0 = time.perf_counter()
    trainer = cli_train.main(argv)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    main_counts = counts()
    log("train_cli", epochs=trainer.epoch, steps=trainer.step, wall_s=main_s,
        best_val=trainer.best_val, launches=main_counts)
    if not (main_counts["fps"] and main_counts["knn_select"]
            and main_counts["fused_vector_attention_packed_x"]):
        raise AssertionError(f"cli.train: kernels not launched {main_counts}")
    if not np.isfinite(trainer.best_val):
        raise AssertionError(f"cli.train: val loss {trainer.best_val}")

    # the checkpoint resumes: epoch and every tensor
    resumed = Trainer(trainer.config, task, [], [], log_fn=lambda s: None, device=dev)
    epoch = resumed.resume()
    equal = all(torch.equal(a, b) for a, b in zip(
        resumed.model.state_dict().values(), trainer.model.state_dict().values()))
    log("train_resume", epoch=epoch, step=resumed.step, identical=equal)
    if epoch != 1 or resumed.step != trainer.step or not equal:
        raise AssertionError(f"resume: epoch {epoch}, step {resumed.step}, "
                             f"tensors equal {equal}")
    del resumed

    # launches a train step (no K3) and a val scan (K3)
    zero()
    step0 = trainer.step
    train_stats = trainer.train_epoch()
    per_step = {k: v / (trainer.step - step0) for k, v in counts().items()}
    zero()
    val_stats = trainer.eval_epoch()
    n_val = len(trainer.val_loader.dataset)
    per_val = {k: v / n_val for k, v in counts().items()}
    log("train_launches", per_train_step=per_step, per_val_scan=per_val,
        train=train_stats, val=val_stats)
    if not (per_step["fps"] and per_step["knn_select"]) \
            or per_step["fused_vector_attention_packed_x"]:
        raise AssertionError(f"train steps launched {per_step}")
    if not per_val["fused_vector_attention_packed_x"]:
        raise AssertionError(f"val pass launched {per_val}")

    # the exported weights serve a scan
    npz = work / "trained_fps.npz"
    save_weights(str(npz), trainer.model)
    pipe = make_inference_pipeline("tgnet", [str(npz), str(ckpts["bdl"])], None,
                                   device=dev)
    labels, ins, _ = ScanSegmentation(pipe).predict([str(scan)])
    n_vert = sum(1 for line in scan.open() if line.startswith("v "))
    log("train_serve", scan=scan.name, vertices=n_vert, labels=sorted(set(labels)),
        instances=len(set(ins)))
    if len(labels) != n_vert or not set(labels) <= FDI:
        raise AssertionError(f"trained weights: {len(labels)} labels for {n_vert} "
                             "vertices, or labels outside the FDI set")
    pipe.close()

    # bf16 training: the same batch at full width with "dtype": "bfloat16"
    cfg16 = task.default_config()
    cfg16.model_parameter["dtype"] = "bfloat16"
    model16 = task.build_module(cfg16, device=dev)
    init_like_flax_(model16, torch.Generator().manual_seed(cfg16.seed))
    opt16 = make_optimizer(cfg16.optimizer, model16.parameters())
    zero()
    losses16, secs16 = [], []
    for _ in range(TRAIN_BF16_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vals = train_step(model16, opt16, task, cfg16, on_card)
        losses16.append({k: float(v) for k, v in vals.items()})
        secs16.append(time.perf_counter() - t0)
    per_step16 = {k: v / TRAIN_BF16_STEPS for k, v in counts().items()}
    log("train_bf16", steps=TRAIN_BF16_STEPS, losses=losses16, step_s=secs16,
        median_step_s=float(np.median(secs16[1:])),
        float32_median_step_s=med[True], launches_per_step=per_step16)
    if not all(np.isfinite(list(ls.values())).all() for ls in losses16):
        raise AssertionError(f"bf16 training: non-finite losses {losses16}")
    if not (per_step16["fps"] and per_step16["knn_select"]):
        raise AssertionError(f"bf16 training: kernels not launched {per_step16}")
    if not all(t.dtype == torch.float32 for t in model16.state_dict().values()):
        raise AssertionError("bf16 training: a parameter or statistic is not float32")
    del model16, opt16
    return {"per_train_step": per_step, "per_val_scan": per_val}


def plain_fps_indices(xyz: np.ndarray, m: int, device) -> np.ndarray:
    """``data.preprocess.fps_indices`` through K1's plain version, on
    ``device``: the reference the workflow holds K1's samples to."""
    from toothgroupnetwork_tpu_torch.ops.kernels.fps import fps_reference

    pts = torch.from_numpy(np.ascontiguousarray(xyz, dtype=np.float32)).to(device)
    return fps_reference(pts[None], m)[0].cpu().numpy()


def phase_workflow(dev, work: Path, ckpts) -> dict:
    """The whole tgnet workflow through the port's entry points on labelled
    synthetic 100489-vertex cases (``WORKFLOW_CASES``):

      * ``cli.preprocess``: one 24000-point .npy a case, K1 once a scan,
        each array identical to the one K1's plain version samples on the
        card, seconds a scan;
      * ``cli.split``: each case in one fold; the train fold trains, the
        test fold validates (three cases give no val fold);
      * ``cli.train --model_name tgnet_bdl`` (the main path), one epoch, the
        frozen fps model from phase 5's random weights, the obj/json roots
        and a cache dir: K1, K2 and K3 launched; a second epoch on cache
        hits (the frozen model never runs): K2 and no K3 a bdl step, K3 in
        the val pass;
      * the host stage alone on each uncached case (a fresh engine): its
        launches and seconds by part, no refold and no new kernel layout on
        the second case, and the same clouds from an engine given the same
        frozen outputs with K1's plain version; the frozen stage 1's argmax
        on the card against the CPU port's >= 0.999 (on
        ``CPU_REFERENCE_POINTS`` points of the case);
      * the bdl step: step 1 within 1e-3 relative of the CPU port's (on
        ``CPU_REFERENCE_POINTS`` points of the resampled cloud), two
        seeded runs bit-identical, the loss falling over 8 steps, every loss
        finite, the median step, peak memory, one profiled step;
      * the exported fps and bdl .npz serve one case through ``cli.infer``,
        and ``cli.evaluate`` prints the four numbers ``cal_metric`` gives.

    Returns K1-K3's launches per bdl train step, per val scan and per
    host-stage case."""
    import contextlib
    import io
    import shutil

    from synthetic import write_synthetic_case

    from toothgroupnetwork_tpu_torch.cli import evaluate, infer, split
    from toothgroupnetwork_tpu_torch.cli import preprocess as cli_preprocess
    from toothgroupnetwork_tpu_torch.cli import train as cli_train
    from toothgroupnetwork_tpu_torch.data import DentalScanDataset, collate_batch
    from toothgroupnetwork_tpu_torch.data import preprocess
    from toothgroupnetwork_tpu_torch.eval.metrics import cal_metric
    from toothgroupnetwork_tpu_torch.models import get_task
    from toothgroupnetwork_tpu_torch.models.point_transformer.backbone import (
        PointTransformerLayer)
    from toothgroupnetwork_tpu_torch.models.tasks import bdl_engine, build_tgnet_fps
    from toothgroupnetwork_tpu_torch.ops.kernels import attention, fps, knn
    from toothgroupnetwork_tpu_torch.train import bdl_engine as engine_module
    from toothgroupnetwork_tpu_torch.train import make_optimizer, train_step
    from toothgroupnetwork_tpu_torch.train.checkpoints import save_weights
    from toothgroupnetwork_tpu_torch.utils.weights import init_like_flax_, load_npz

    src = work / "workflow"
    for i, (case, jaw) in enumerate(WORKFLOW_CASES):
        write_synthetic_case(str(src), case, jaw, n_side=N_SIDE, seed=30 + i)
    kernels = (fps.fps, knn.knn_select, attention.fused_vector_attention_packed_x,
               attention.project_kv)

    def counts():
        return {k.__name__: k.launches for k in kernels}

    def zero():
        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()

    # preprocess: the main path, then the plain version's samples
    processed = src / "processed"
    zero()
    t0 = time.perf_counter()
    cli_preprocess.main(["--source_obj_data_path", str(src / "objs"),
                         "--source_json_data_path", str(src / "jsons"),
                         "--save_data_path", str(processed), "--device", str(dev)])
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    pre_counts = counts()
    real = preprocess.fps_indices
    preprocess.fps_indices = plain_fps_indices
    try:
        same = []
        for case, jaw in WORKFLOW_CASES:
            arr, n_valid, _ = preprocess.preprocess_scan(
                str(src / "objs" / case / f"{case}_{jaw}.obj"),
                str(src / "jsons" / case / f"{case}_{jaw}.json"), dev)
            saved = np.load(processed / f"{case}_{jaw}_{jaw}_sampled_points.npy")
            same.append(n_valid == N_POINTS and np.array_equal(arr, saved))
    finally:
        preprocess.fps_indices = real
    log("workflow_preprocess", scans=len(WORKFLOW_CASES), wall_s=pre_s,
        s_per_scan=pre_s / len(WORKFLOW_CASES), launches=pre_counts,
        identical_to_plain=same)
    if pre_counts["fps"] != len(WORKFLOW_CASES) or not all(same):
        raise AssertionError(f"preprocess: K1 launches {pre_counts}, arrays equal "
                             f"to the plain version's {same}")

    # split
    splits = split.main(["--processed_data_path", str(processed),
                         "--out_dir", str(src / "splits")])
    folds = sorted(c for ids in splits.values() for c in ids)
    log("workflow_split", folds={k: len(v) for k, v in splits.items()})
    if folds != sorted(c for c, _ in WORKFLOW_CASES) or len(splits["train_fold.txt"]) != 2:
        raise AssertionError(f"split: {splits}")

    task = get_task("tgnet_bdl")
    cfg = task.default_config()
    cfg.model_parameter["boundary_sampling_info"].update(
        orginal_data_obj_path=str(src / "objs"), orginal_data_json_path=str(src / "jsons"),
        bdl_cache_path=str(src / "bdl_cache"))
    cfg.model_parameter["fps_model_info"]["load_ckpt_path"] = str(ckpts["fps"])
    cfg.save_json(str(src / "bdl_config.json"))

    # the main path: one epoch of tgnet_bdl through the CLI
    argv = ["--model_name", "tgnet_bdl", "--config_path", str(src / "bdl_config.json"),
            "--input_data_dir_path", str(processed),
            "--train_data_split_txt_path", str(src / "splits" / "train_fold.txt"),
            "--val_data_split_txt_path", str(src / "splits" / "test_fold.txt"),
            "--checkpoint_path", str(src / "ckpt" / "bdl"), "--max_epochs", "1",
            "--device", str(dev)]
    zero()
    t0 = time.perf_counter()
    trainer = cli_train.main(argv)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    main_counts = counts()
    engine = bdl_engine(trainer.config, dev)
    cached = sorted(os.listdir(src / "bdl_cache"))
    log("workflow_train_cli", epochs=trainer.epoch, steps=trainer.step, wall_s=epoch_s,
        best_val=trainer.best_val, launches=main_counts, cache=cached,
        host_stage_s=dict(engine.seconds))
    if not all(main_counts.values()) or not np.isfinite(trainer.best_val) \
            or len(cached) != len(WORKFLOW_CASES):
        raise AssertionError(f"cli.train tgnet_bdl: launches {main_counts}, val "
                             f"{trainer.best_val}, cache {cached}")

    # a second epoch on cache hits: launches a bdl step and a val scan
    frozen_calls = [0]
    frozen = engine._frozen

    def counted(*args):
        frozen_calls[0] += 1
        return frozen(*args)

    engine._frozen = counted
    zero()
    step0 = trainer.step
    t0 = time.perf_counter()
    train_stats = trainer.train_epoch()
    torch.cuda.synchronize()
    cached_epoch_s = time.perf_counter() - t0
    per_step = {k: v / (trainer.step - step0) for k, v in counts().items()}
    zero()
    val_stats = trainer.eval_epoch()
    n_val = len(trainer.val_loader.dataset)
    per_val = {k: v / n_val for k, v in counts().items()}
    engine._frozen = frozen
    log("workflow_bdl_launches", per_bdl_step=per_step, per_val_scan=per_val,
        frozen_calls=frozen_calls[0], cached_epoch_s=cached_epoch_s,
        train=train_stats, val=val_stats)
    if frozen_calls[0] or not per_step["knn_select"] \
            or per_step["fused_vector_attention_packed_x"]:
        raise AssertionError(f"cached epoch: frozen calls {frozen_calls[0]}, "
                             f"launches a step {per_step}")
    if not per_val["fused_vector_attention_packed_x"]:
        raise AssertionError(f"bdl val pass launched {per_val}")

    # the host stage alone on each uncached case, then the same frozen
    # outputs through an engine whose FPS is K1's plain version
    uncached = copy.deepcopy(trainer.config)
    uncached.model_parameter["boundary_sampling_info"]["bdl_cache_path"] = None
    fresh = engine_module.BdlDataEngine(dev)
    recorded, frozen_launches = {}, []
    forward = fresh._ensure_frozen(uncached)

    def record(feat, labels):
        before = counts()
        recorded[feat.tobytes()] = out = forward(feat, labels)
        frozen_launches.append({k: v - before[k] for k, v in counts().items()})
        return out

    fresh._frozen = record
    layers = [m for m in fresh.frozen_model.modules() if isinstance(m, PointTransformerLayer)]
    ds = DentalScanDataset(str(processed))
    batches = [collate_batch([ds[i]]) for i in range(len(ds))]
    per_case, outs, parts, kept = [], [], [], None
    for i, batch in enumerate(batches):
        before = dict(fresh.seconds)
        zero()
        t0 = time.perf_counter()
        outs.append(fresh(None, batch, uncached))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        per_case.append(counts())
        parts.append({k: v - before.get(k, 0.0) for k, v in fresh.seconds.items()}
                     | {"wall": wall})
        state = [(m._folded, tuple(lay for _, lay in
                                   m._folded.get(attention.LAYOUT_KEY, {}).values()))
                 for m in layers]
        if i == 0:
            kept = state
        refolded = sum(a[0] is not b[0] or any(x is not y for x, y in zip(a[1], b[1]))
                       for a, b in zip(state, kept))
        # (kernel layouts exist on the card only)
        if refolded or (dev.type == "cuda" and not all(lay for _, lay in state)):
            raise AssertionError(f"host stage case {i}: {refolded} attention layers "
                                 "folded or laid out again")
    t0 = time.perf_counter()
    cache_hit = engine(None, batches[0], trainer.config)  # the CLI run's cache
    hit_s = time.perf_counter() - t0
    plain = engine_module.BdlDataEngine(dev)
    plain._frozen = lambda feat, labels: recorded[feat.tobytes()]
    real = engine_module.fps_indices
    engine_module.fps_indices = plain_fps_indices
    try:
        same = []
        for batch, out in zip(batches, outs):
            got = plain(None, batch, uncached)
            same.append(all(np.array_equal(got[k], out[k]) for k in out))
    finally:
        engine_module.fps_indices = real
    resample = [c["fps"] - f["fps"] for c, f in zip(per_case, frozen_launches)]
    host_launches = {k: sum(c[k] for c in per_case) / len(per_case) for k in per_case[0]}
    log("workflow_host_stage", cases=len(batches), launches_per_case=per_case,
        frozen_launches_per_case=frozen_launches, resample_fps_launches=resample,
        seconds_by_part=parts, cache_hit_s=hit_s, identical_with_plain_fps=same,
        layers_folded_once=len(layers))
    if not all(same):
        raise AssertionError(f"host stage: clouds with K1's plain version differ {same}")
    if not all(all(f.values()) for f in frozen_launches) or not all(resample):
        raise AssertionError(f"host stage launches: frozen {frozen_launches}, "
                             f"resample K1 {resample}")
    if cache_hit["feat"].shape != outs[0]["feat"].shape:
        raise AssertionError("host stage: a cache hit of another shape")

    # the frozen model's stage 1, card vs CPU port, on CPU_REFERENCE_POINTS
    # points of the case
    feat = torch.from_numpy(batches[0]["feat"][:, cpu_reference_rows(
        batches[0]["feat"].shape[1])]).to(dev)
    fps_cfg = {"model_parameter": get_task("tgnet_fps").default_config().model_parameter}
    cpu_model = load_npz(str(ckpts["fps"]), build_tgnet_fps(fps_cfg, device="cpu")).eval()
    with torch.no_grad():
        on_card = fresh.frozen_model.stage1(feat)["sem_1"].float().cpu()
        t0 = time.perf_counter()
        on_cpu = cpu_model.stage1(feat.cpu())["sem_1"]
        cpu_s = time.perf_counter() - t0
    agree = float((on_card.argmax(-1) == on_cpu.argmax(-1)).float().mean())
    log("workflow_frozen_stage1", argmax_agreement=agree, cpu_s=cpu_s,
        max_abs_dlogit=float((on_card - on_cpu).abs().max()))
    if agree < 0.999:
        raise AssertionError(f"frozen stage 1 argmax agreement {agree} < 0.999")
    del cpu_model, fresh, plain

    # the bdl step on the first case's resampled cloud
    batch = {k: torch.from_numpy(outs[0][k]) for k in ("feat", "gt_seg_label", "mask")}
    on_dev = {k: v.to(dev) for k, v in batch.items()}

    def fresh_model(device):
        model = task.build_module(cfg, device=device)
        init_like_flax_(model, torch.Generator().manual_seed(cfg.seed))
        return model, make_optimizer(cfg.optimizer, model.parameters())

    def run(steps, model=None, opt=None):
        if model is None:
            model, opt = fresh_model(dev)
        losses, secs = [], []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            vals = train_step(model, opt, task, cfg, on_dev)
            losses.append({k: float(v) for k, v in vals.items()})
            secs.append(time.perf_counter() - t0)
        return model, opt, losses, secs

    model_a, opt_a, losses_a, secs_a = run(TRAIN_REPEAT_STEPS)
    rows = torch.from_numpy(cpu_reference_rows(batch["feat"].shape[1]))
    small = {k: v[:, rows] for k, v in batch.items()}
    step1, step1_s = {}, {}
    for device in (dev, torch.device("cpu")):
        model_c, opt_c = fresh_model(device)
        t0 = time.perf_counter()
        step1[device.type] = {k: float(v) for k, v in train_step(
            model_c, opt_c, task, cfg, {k: v.to(device) for k, v in small.items()}).items()}
        step1_s[device.type] = time.perf_counter() - t0
        del model_c, opt_c
    (got, cpu), cpu_step_s = (step1["cuda"], step1["cpu"]), step1_s["cpu"]
    rel = {k: abs(got[k] - cpu[k]) / max(abs(cpu[k]), 1e-12) for k in cpu}
    log("workflow_bdl_step1", points=CPU_REFERENCE_POINTS, card=got, cpu=cpu,
        rel_diff=rel, cpu_step_s=cpu_step_s)
    if len(cpu) != 7 or max(rel.values()) > 1e-3:
        raise AssertionError(f"bdl step 1: card vs CPU relative differences {rel}")
    model_b, _, losses_b, _ = run(TRAIN_REPEAT_STEPS)
    same = losses_a == losses_b and all(
        torch.equal(a, b) for a, b in zip(model_a.state_dict().values(),
                                          model_b.state_dict().values()))
    del model_b
    _, _, more, secs_more = run(TRAIN_FALL_STEPS - TRAIN_REPEAT_STEPS, model_a, opt_a)
    totals = [sum(v * cfg.loss_weights[k] for k, v in ls.items())
              for ls in losses_a + more]
    torch.cuda.reset_peak_memory_stats(dev)
    run(1, model_a, opt_a)
    peak = torch.cuda.max_memory_allocated(dev)
    steady = (secs_a + secs_more)[1:]
    log("workflow_bdl_train", repeat_identical=same, total_loss=totals,
        median_step_s=float(np.median(steady)), steps_timed=len(steady),
        first_step_s=secs_a[0], peak_memory_gib=peak / 2 ** 30,
        host_stage_uncached_s=[p["wall"] for p in parts], host_stage_cache_hit_s=hit_s)
    if not same:
        raise AssertionError("two seeded bdl runs differ")
    if not all(np.isfinite(list(ls.values())).all() for ls in losses_a + more):
        raise AssertionError(f"non-finite bdl losses: {losses_a + more}")
    if not totals[-1] < totals[0]:
        raise AssertionError(f"the bdl loss did not fall over {len(totals)} steps: {totals}")
    profile_call(lambda: run(1, model_a, opt_a), "bdl train step")
    del model_a, opt_a

    # serve one case with the exported weights, then evaluate it
    case, jaw = WORKFLOW_CASES[0]
    bdl_npz = work / "trained_bdl.npz"
    save_weights(str(bdl_npz), trainer.model)
    serve_dir = src / "serve"
    serve_dir.mkdir()
    shutil.copy(src / "objs" / case / f"{case}_{jaw}.obj", serve_dir)
    pipe = infer.main(["--input_dir_path", str(serve_dir), "--save_path", str(src / "pred"),
                       "--model_name", "tgnet", "--checkpoint_path", str(ckpts["fps"]),
                       "--checkpoint_path_bdl", str(bdl_npz), "--device", str(dev)])
    pipe.close()
    gt_json = src / "jsons" / case / f"{case}_{jaw}.json"
    pred_json = src / "pred" / f"{case}_{jaw}.json"
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        evaluate.main(["--gt_json_path", str(gt_json), "--pred_json_path", str(pred_json)])
    gt = np.array(json.loads(gt_json.read_text())["labels"])
    pred = np.array(json.loads(pred_json.read_text())["labels"])
    iou, f1, acc, sem_acc, _ = cal_metric(gt, pred, pred)
    want = (f"{pred_json.name}: IoU {iou:.4f} F1(TSA) {f1:.4f} ACC {acc:.4f} "
            f"SEM_ACC(TIR) {sem_acc:.4f}")
    log("workflow_evaluate", printed=printed.getvalue().strip(), vertices=len(pred),
        labels=sorted(set(pred.tolist())))
    if printed.getvalue().strip() != want or len(pred) != len(gt) \
            or not set(pred.tolist()) <= FDI:
        raise AssertionError(f"evaluate printed {printed.getvalue()!r}, cal_metric "
                             f"{want!r}")
    return {"per_bdl_step": per_step, "per_bdl_val_scan": per_val,
            "per_host_stage_case": host_launches}


# the families phase: the five other model families through cli.infer, each
# at its preset's full width, with the kernels each must launch; DGCNN's
# CPU reference runs at this many points (its plain O(N^2 C) selection)
FAMILIES = ("pointnet", "pointnetpp", "dgcnn", "pointtransformer", "tsegnet")
FAMILY_KERNELS = {
    "pointnet": ("fps",),
    "pointnetpp": ("fps", "knn_select"),
    "dgcnn": ("fps", "knn_select"),
    "pointtransformer": ("fps", "knn_select", "fused_vector_attention_packed_x",
                         "project_kv"),
    "tsegnet": ("fps", "knn_select"),
}
DGCNN_CPU_POINTS = 6000
FAMILY_STEADY_CALLS = 3
# tsegnet's proposals: the l3 points split into this many runs along x
TSEGNET_GROUPS = 12
# each semantic family's classifier, the last Dense before the logits
CLASSIFIER = {"pointnet": "cls", "pointnetpp": "cls_2", "dgcnn": "cls",
              "pointtransformer": "cls_head.cls"}


def centre_classifier(model, name: str, feat: torch.Tensor) -> None:
    """Re-centre the classifier on one input: ``W -= outer(mu, h) / |h|^2``
    with ``h`` its mean input over the points and ``mu`` the mean logits,
    so every class's mean logit on ``feat`` is 0. Random weights otherwise
    give every point of a smooth sheet the same class, and the card-vs-CPU
    agreement would compare one class."""
    layer = model.get_submodule(CLASSIFIER[name])
    seen = {}
    hook = layer.register_forward_pre_hook(lambda _m, a: seen.update(h=a[0]))
    with torch.no_grad():
        logits = model(feat, None)["cls_pred"]
        hook.remove()
        h = seen["h"].reshape(-1, seen["h"].shape[-1]).double().mean(0)
        mu = logits.reshape(-1, logits.shape[-1]).double().mean(0)
        layer.weight -= (torch.outer(mu, h) / (h @ h)).float()


def fit_centroid_heads(model, feat: torch.Tensor, gen, mask=None) -> None:
    """Fit tsegnet's centroid heads to ``feat`` so that DBSCAN finds
    TSEGNET_GROUPS clusters: the l3 points sorted by x, split into runs,
    each run's moved points within 0.004 of the run's mean, every distance
    0.1 (the heads' BatchNorm biases +5, the last Dense of each head the
    least-squares fit over its input, in eval mode). Random heads otherwise
    scatter the moved points and DBSCAN finds nothing."""
    cm = model.cent_module
    seen = {}
    hooks = [getattr(cm, n).register_forward_pre_hook(
        lambda _m, a, n=n: seen.update({n: a[0]})) for n in ("offset_2", "dist_2")]
    with torch.no_grad():
        cm.offset_bn.bias += 5.0
        cm.dist_bn.bias += 5.0
        out = model.centroid_forward(feat, mask)
        for h in hooks:
            h.remove()
        xyz = out["l3_xyz"][0].double().cpu().numpy()
        target = np.empty_like(xyz)
        for run in np.array_split(np.argsort(xyz[:, 0], kind="stable"),
                                  TSEGNET_GROUPS):
            target[run] = xyz[run].mean(0) + gen.uniform(-0.004, 0.004, (len(run), 3))
        for n, want in (("offset_2", target - xyz),
                        ("dist_2", np.full((len(xyz), 1), 0.1))):
            r = seen[n][0].double().cpu().numpy()
            sol = np.linalg.lstsq(np.concatenate([r, np.ones((len(r), 1))], 1),
                                  want, rcond=None)[0]
            layer = getattr(cm, n)
            layer.weight.copy_(torch.from_numpy(sol[:-1].T.astype(np.float32)))
            layer.bias.copy_(torch.from_numpy(sol[-1].astype(np.float32)))


def fit_tsegnet(model, pipe_cls, feat: torch.Tensor, scan: Path, dev, gen) -> None:
    """Fit tsegnet's centroid heads to the scan's sample ``feat``
    (``fit_centroid_heads``), then centre the paint logit on the valid
    crops' points (about half of each crop painted). The id head (``fc2``)
    is centred on the valid crops as the semantic classifiers are
    (``centre_classifier``), so the crops take other ids."""
    fit_centroid_heads(model, feat, gen)
    seen = {}
    seg = model.seg_module
    pipe = pipe_cls(None, module=model, device=dev)
    hooks = [seg.pd_mask_2.register_forward_hook(lambda _m, _a, o: seen.update(pd_2=o)),
             seg.fc2.register_forward_hook(lambda _m, a, o: seen.update(idh=a[0], ids=o))]
    pipe(str(scan))
    for h in hooks:
        h.remove()
    n_valid = pipe.last_stats["clusters"]
    with torch.no_grad():
        seg.pd_mask_2.bias -= seen["pd_2"][:n_valid].double().mean().float()
        h = seen["idh"][:n_valid].double().mean(0)
        mu = seen["ids"][:n_valid].double().mean(0)
        seg.fc2.weight -= (torch.outer(mu, h) / (h @ h)).float()


def phase_families(dev, work: Path, scan: Path) -> dict:
    """The five other families, each at its preset's full width with random
    weights (``randomize_``, the zero-initialised heads drawn too; the
    classifier centred, tsegnet's heads fitted to the scan) saved with
    ``save_npz``: the scan through ``cli.infer --model_name`` on the card
    with every count at 0 just before (the kernels of FAMILY_KERNELS must
    launch, none of K4-K8), the challenge JSON checked, a repeated scan
    identical, steady seconds a scan by phase, peak memory, one profiled
    call's busy share, and the full-width forward on the card against the
    CPU port (argmax agreement >= 0.999; DGCNN at DGCNN_CPU_POINTS points;
    tsegnet its proposals, paint decisions and ids). Returns each family's
    launches a scan."""
    from toothgroupnetwork_tpu_torch.cli import infer
    from toothgroupnetwork_tpu_torch.models.tasks import (_tsegnet_preset,
                                                          build_sem_model,
                                                          build_tsegnet)
    from toothgroupnetwork_tpu_torch.models import get_task
    from toothgroupnetwork_tpu_torch.ops.kernels import (attention, cell_select,
                                                         fps, gather, knn)
    from toothgroupnetwork_tpu_torch.pipelines import (ScanSegmentation,
                                                       TsegnetInferencePipeline)
    from toothgroupnetwork_tpu_torch.pipelines.base import (prep_mesh_feats,
                                                            sample_on_device)
    from toothgroupnetwork_tpu_torch.utils.weights import (load_npz, randomize_,
                                                           save_npz)

    kernels = (fps.fps, knn.knn_select, attention.fused_vector_attention_packed_x,
               attention.project_kv)
    unused = (cell_select.cell_select_x, cell_select.cell_select_p,
              attention.fused_vector_attention, attention.fused_vector_attention_packed,
              gather.onehot_gather_packed)
    t_phase = time.perf_counter()
    scan_dir = work / "families_scan"
    scan_dir.mkdir()
    (scan_dir / scan.name).write_bytes(scan.read_bytes())
    _, feats = prep_mesh_feats(str(scan), N_POINTS)
    sample, _ = sample_on_device(feats, N_POINTS, dev)
    sample = sample[None]
    gen = torch.Generator().manual_seed(9)
    np_gen = np.random.default_rng(9)
    per_scan = {}
    for name in FAMILIES:
        t_family = time.perf_counter()
        if name == "tsegnet":
            cfg = {"model_parameter": _tsegnet_preset().model_parameter}
            model = randomize_(build_tsegnet(cfg, device="cpu"), gen).to(dev)
            fit_tsegnet(model, TsegnetInferencePipeline, sample, scan, dev, np_gen)
        else:
            mp = get_task(name).default_config().model_parameter
            model = randomize_(build_sem_model(name, mp, device="cpu"), gen).to(dev)
            centre_classifier(model, name, sample)
        ckpt = work / f"{name}.npz"
        save_npz(str(ckpt), model)

        # the main path: cli.infer on the card
        for k in (*kernels, *unused):
            k.launches = 0
        knn.knn_select.launches_by_shape.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe = infer.main(["--input_dir_path", str(scan_dir), "--save_path",
                           str(work / f"out_{name}"), "--model_name", name,
                           "--checkpoint_path", str(ckpt), "--device", str(dev)])
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = {k.__name__: k.launches for k in (*kernels, *unused)}
        knn_by_c = dict(knn.knn_select.launches_by_shape)
        per_scan[name] = {k: v for k, v in launches.items() if v}
        missing = [k for k in FAMILY_KERNELS[name] if launches[k] <= 0]
        stray = [k.__name__ for k in unused if launches[k.__name__]]
        if missing or stray:
            raise AssertionError(f"{name}: kernels not launched {missing}, "
                                 f"launched off the path {stray}")
        if name == "dgcnn" and knn_by_c != {6: 1, 64: 2}:
            raise AssertionError(f"dgcnn: K2 launches by C {knn_by_c}, expected "
                                 "C=6 once and C=64 twice")
        res = json.loads((work / f"out_{name}" / (scan.stem + ".json")).read_text())
        n_vert = sum(1 for line in scan.open() if line.startswith("v "))
        labels = res["labels"]
        if (len(labels) != n_vert or len(res["instances"]) != n_vert
                or not set(labels) <= FDI or res["jaw"] not in ("upper", "lower")):
            raise AssertionError(f"{name}: bad challenge JSON ({len(labels)} labels "
                                 f"for {n_vert} vertices, {sorted(set(labels))[:8]})")

        # a repeated scan: the same output; then steady calls
        again, _, _ = ScanSegmentation(pipe).predict([str(scan)])
        if again != labels:
            raise AssertionError(f"{name}: a repeated scan gave another output")
        calls = []
        for _ in range(FAMILY_STEADY_CALLS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipe(str(scan))
            torch.cuda.synchronize()
            calls.append({"wall_s": time.perf_counter() - t0, **pipe.timings})
        torch.cuda.reset_peak_memory_stats(dev)
        pipe(str(scan))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev)
        busy = profile_call(lambda: pipe(str(scan)), f"family {name}")

        # the full-width forward on the card against the CPU port
        cpu_model = (build_tsegnet(cfg, device="cpu") if name == "tsegnet" else
                     build_sem_model(name, mp, device="cpu"))
        load_npz(str(ckpt), cpu_model).eval()
        t0 = time.perf_counter()
        agree = family_card_vs_cpu(name, pipe, cpu_model, sample, dev)
        cpu_s = time.perf_counter() - t0
        keys = calls[0].keys()
        log("family", model=name, first_scan_s=first_s,
            steady_median_s={k: float(np.median([c[k] for c in calls])) for k in keys},
            launches_per_scan=per_scan[name], knn_launches_by_c=knn_by_c,
            labels=sorted(set(labels)), peak_gib=peak / 2 ** 30, busy_share=busy,
            card_vs_cpu=agree, cpu_reference_s=cpu_s,
            stats=getattr(pipe, "last_stats", None),
            family_s=time.perf_counter() - t_family)
        if len(set(labels)) < 2:
            raise AssertionError(f"{name}: one label on the whole scan {set(labels)}")
        del pipe, model, cpu_model
        torch.cuda.empty_cache()
    log("families", seconds=time.perf_counter() - t_phase, launches_per_scan=per_scan)
    return per_scan


def family_card_vs_cpu(name, pipe, cpu_model, sample, dev) -> dict:
    """The family's forward on the card (the served model) and on the CPU
    (the same weights, the plain kernel versions) from the same sample:
    argmax agreement >= 0.999. DGCNN compares its first DGCNN_CPU_POINTS
    points; tsegnet its proposals (the same count, centres within 1e-3),
    then the paint decisions over the valid crops and the crop ids on the
    card's proposals."""
    from toothgroupnetwork_tpu_torch.models.tsegnet import tsegnet_crops

    cpu = torch.device("cpu")
    with torch.inference_mode():
        if name != "tsegnet":
            x = sample[:, :DGCNN_CPU_POINTS] if name == "dgcnn" else sample
            card = pipe.model(x, None)["cls_pred"].float().cpu()
            ref = cpu_model(x.cpu(), None)["cls_pred"]
            agree = float((card.argmax(-1) == ref.argmax(-1)).float().mean())
            out = {"points": x.shape[1], "argmax_agreement": agree,
                   "max_abs_dlogit": float((card - ref).abs().max())}
            if agree < 0.999:
                raise AssertionError(f"{name}: card vs CPU argmax agreement {agree}")
            return out
        props = []
        for model, d in ((pipe.module, dev), (cpu_model, cpu)):
            c = model.centroid_forward(sample.to(d))
            props.append((c, pipe.proposals(*(t.cpu().numpy() for t in (
                c["l3_xyz"][0], c["offset_result"][0], c["dist_result"][0, :, 0])))))
        (c_card, (cents, valid)), (c_cpu, (cents_cpu, valid_cpu)) = props
        d_cent = float(np.abs(cents[valid] - cents_cpu[valid_cpu]).max()) \
            if valid.sum() == valid_cpu.sum() else float("inf")
        seg = []
        for model, c, d in ((pipe.module, c_card, dev), (cpu_model, c_cpu, cpu)):
            crop, crop_mask, _ = tsegnet_crops(
                sample.to(d), c["l0_points"], torch.from_numpy(cents).to(d),
                torch.from_numpy(valid).to(d), pipe.crop_size)
            _, _, pd_2, id_pred = model.seg_forward(crop, crop_mask)
            seg.append(((pd_2[..., 0] > 0).cpu()[:int(valid.sum())],
                        id_pred.argmax(-1).cpu()[:int(valid.sum())]))
        paint_agree = float((seg[0][0] == seg[1][0]).float().mean())
        ids_equal = bool(torch.equal(seg[0][1], seg[1][1]))
        out = {"proposals": int(valid.sum()), "proposals_cpu": int(valid_cpu.sum()),
               "max_abs_dcentre": d_cent, "paint_agreement": paint_agree,
               "ids_equal": ids_equal}
        if not (d_cent <= 1e-3 and paint_agree >= 0.999 and ids_equal
                and valid.sum() >= 2):
            raise AssertionError(f"tsegnet: card vs CPU {out}")
        return out


# the families-training phase (13): each family at its preset's full width
# and batch 1 on the training phase's 24000-point arch cases, with the
# launches a train step must show (K1 fps, K2 knn_select; none of K4-K8,
# no K3: training runs the unfused attention), tsegnet's host stage's
# (its centroid forward) and a pointtransformer val scan's K3
FAMILY_TRAIN_LAUNCHES = {
    "pointnet": {"fps": 0, "knn_select": 0},
    "pointnetpp": {"fps": 3, "knn_select": 3},
    "dgcnn": {"fps": 0, "knn_select": 3},
    "pointtransformer": {"fps": 4, "knn_select": 17},
    "tsegnet": {"fps": 9, "knn_select": 9},
}
TSEGNET_HOST_LAUNCHES = {"fps": 3, "knn_select": 3}
PT_VAL_K3 = 18
FAMILY_REPEAT_STEPS = 3
FAMILY_FALL_STEPS = 8
FAMILY_TIMED_STEPS = 3
TSEGNET_HOST_REPS = 3


def match_running_stats(module, feat, mask) -> None:
    """Every BatchNorm of ``module`` takes its train-mode batch statistics
    on ``feat`` as running statistics (the masked mean and biased
    variance), so that its eval-mode forward (tsegnet's host stage) equals
    the train-mode one of a step on this batch."""
    from toothgroupnetwork_tpu_torch.nn.layers import MaskedBatchNorm

    stats, hooks = {}, []
    for m in module.modules():
        if isinstance(m, MaskedBatchNorm):
            def capture(bn, args):
                x = args[0].double().reshape(-1, args[0].shape[-1])
                w = (torch.ones(x.shape[0], dtype=torch.float64, device=x.device)
                     if args[1] is None else args[1].reshape(-1).double())
                mean = (x * w[:, None]).sum(0) / w.sum()
                stats[bn] = (mean, (((x - mean) ** 2) * w[:, None]).sum(0) / w.sum())
            hooks.append(m.register_forward_pre_hook(capture))
    module.train()
    with torch.no_grad():
        module(feat, mask)
    module.eval()
    for h in hooks:
        h.remove()
    with torch.no_grad():
        for bn, (mean, var) in stats.items():
            bn.mean.copy_(mean.float())
            bn.var.copy_(var.float())


def phase_family_train(dev, work: Path, scan: Path) -> dict:
    """Training of pointnet, pointnetpp, dgcnn, pointtransformer and tsegnet
    at each preset's full width, batch 1, on the first training case of
    phase 10 (24000 points), from flax-like initial weights:

      * tsegnet's host stage alone, on a copy whose centroid module has this
        batch's statistics and fitted heads (random heads propose no crop):
        the launches of TSEGNET_HOST_LAUNCHES exactly, its proposals on the
        card and on the CPU (the same number, centres within 1e-3), its
        seconds; tsegnet's steps below train on those proposals (fitted
        heads make the train step itself unstable);
      * every count at 0, one step: the launches of FAMILY_TRAIN_LAUNCHES
        exactly, none of K3 and K4-K8; a pointtransformer val scan launches
        K3 PT_VAL_K3 times;
      * step 1 on the card against the CPU port from the same weights within
        1e-3 relative (DGCNN over DGCNN_CPU_POINTS points of the case at
        dropout 0 on both sides, the two generators drawing other masks);
      * two seeded runs of FAMILY_REPEAT_STEPS steps bit-identical (DGCNN at
        the preset's dropout 0.5, its generator seeded as the Trainer seeds
        it); the loss falling over FAMILY_FALL_STEPS steps;
      * the median step seconds with and without deterministic algorithms,
        the peak memory of a step, one profiled step;
      * ``cli.train --model_name dgcnn`` and ``--model_name tsegnet`` for one
        epoch on the card, each count at 0 before, and the exported ``.npz``
        served through ``cli.infer --model_name``.

    Returns each family's launches a train step."""
    from toothgroupnetwork_tpu_torch.cli import infer
    from toothgroupnetwork_tpu_torch.cli import train as cli_train
    from toothgroupnetwork_tpu_torch.data import DentalScanDataset
    from toothgroupnetwork_tpu_torch.models import get_task
    from toothgroupnetwork_tpu_torch.ops.kernels import (attention, cell_select,
                                                         fps, gather, knn)
    from toothgroupnetwork_tpu_torch.train import eval_step, make_optimizer, train_step
    from toothgroupnetwork_tpu_torch.train.checkpoints import save_weights
    from toothgroupnetwork_tpu_torch.train.trainer import dropout_seed
    from toothgroupnetwork_tpu_torch.utils.weights import init_like_flax_

    counted = (fps.fps, knn.knn_select, attention.fused_vector_attention_packed_x,
               attention.project_kv, cell_select.cell_select_x, cell_select.cell_select_p,
               attention.fused_vector_attention, attention.fused_vector_attention_packed,
               gather.onehot_gather_packed)

    def zero():
        for k in counted:
            k.launches = 0
        knn.knn_select.launches_by_shape.clear()
        torch.cuda.synchronize()

    def counts():
        torch.cuda.synchronize()
        return {k.__name__: k.launches for k in counted}

    t_phase = time.perf_counter()
    data = work / "train_data"
    item = DentalScanDataset(str(data))[0]
    case = {k: item[k][None] for k in ("feat", "gt_seg_label", "mask")}
    sub = np.sort(np.random.default_rng(0).permutation(N_POINTS)[:DGCNN_CPU_POINTS])
    case_sub = {k: v[:, sub] for k, v in case.items()}
    per_step = {}
    for name in FAMILIES:
        t_family = time.perf_counter()
        task = get_task(name)
        cfg = task.default_config()
        model = task.build_module(cfg, device="cpu")
        init_like_flax_(model, torch.Generator().manual_seed(cfg.seed))
        state0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
        del model

        def fresh(device, dropout=None):
            m = task.build_module(cfg, device=device)
            m.load_state_dict(state0)
            if dropout is not None:
                m.drop.p = dropout
            return m, make_optimizer(cfg.optimizer, m.parameters())

        # tsegnet's host stage apart, on a copy whose centroid module has
        # this batch's statistics and fitted heads (random heads propose
        # nothing): launches, proposals card vs CPU, seconds; its steps
        # then train on those proposals
        proposals, host_counts, host_s = {}, None, None
        if name == "tsegnet":
            cal = []
            for device in (dev, torch.device("cpu")):
                m, _ = fresh(device)
                if not cal:
                    feat_dev = torch.from_numpy(case["feat"]).to(dev)
                    mask_dev = torch.from_numpy(case["mask"]).to(dev)
                    match_running_stats(m.cent_module, feat_dev, mask_dev)
                    fit_centroid_heads(m, feat_dev, np.random.default_rng(13), mask_dev)
                    fitted = {k: v.detach().cpu().clone() for k, v in m.state_dict().items()}
                    zero()
                    cal.append(task.host_stage(m, case, cfg, step=0))
                    host_counts = counts()
                    host_times = []
                    for i in range(TSEGNET_HOST_REPS):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        task.host_stage(m, case, cfg, step=i)
                        host_times.append(time.perf_counter() - t0)
                    host_s = float(np.median(host_times))
                else:
                    m.load_state_dict(fitted)
                    cal.append(task.host_stage(m, case, cfg, step=0))
                del m
            proposals, cpu_cal = cal
            live, cpu_live = proposals["center_valid"], cpu_cal["center_valid"]
            d_cent = (float(np.abs(cpu_cal["center_points"][live]
                                   - proposals["center_points"][live]).max())
                      if (live == cpu_live).all() else float("inf"))
            want_host = {**{k.__name__: 0 for k in counted}, **TSEGNET_HOST_LAUNCHES}
            log("family_train_host_stage", model=name, launches=host_counts,
                proposals=int(live.sum()), proposals_cpu=int(cpu_live.sum()),
                max_abs_dcentre=d_cent, seconds=host_s)
            if host_counts != want_host or not live.any() or d_cent > 1e-3:
                raise AssertionError(f"tsegnet host stage: launches {host_counts}, "
                                     f"{int(live.sum())} proposals, centres {d_cent}")

        def step_on(m, opt, batch, step, device, deterministic=True):
            gen = torch.Generator(device=device).manual_seed(dropout_seed(cfg.seed, step))
            vals = train_step(m, opt, task, cfg,
                              {k: torch.from_numpy(np.asarray(v)).to(device)
                               for k, v in {**batch, **proposals}.items()},
                              deterministic, gen)
            return {k: float(v) for k, v in vals.items()}

        # the launches of one step
        model, opt = fresh(dev)
        zero()
        step_on(model, opt, case, 0, dev)
        launches = counts()
        knn_by_c = dict(knn.knn_select.launches_by_shape)
        per_step[name] = launches
        want = {**{k.__name__: 0 for k in counted}, **FAMILY_TRAIN_LAUNCHES[name]}
        log("family_train_launches", model=name, per_step=launches,
            knn_launches_by_c=knn_by_c)
        if launches != want:
            raise AssertionError(f"{name}: a train step launched {launches}, expected {want}")
        if name == "dgcnn" and knn_by_c != {6: 1, 64: 2}:
            raise AssertionError(f"dgcnn: K2 by C {knn_by_c} a step")
        if name == "pointtransformer":
            zero()
            eval_step(model, task, cfg, {k: torch.from_numpy(v).to(dev)
                                         for k, v in case.items()})
            val = counts()
            log("family_train_val", model=name, per_val_scan=val)
            if val["fused_vector_attention_packed_x"] != PT_VAL_K3:
                raise AssertionError(f"pointtransformer val scan launched {val}")
        del model, opt

        # step 1, card against the CPU port
        batch = case_sub if name == "dgcnn" else case
        dropout = 0.0 if name == "dgcnn" else None
        results = []
        for device in (dev, torch.device("cpu")):
            model, opt = fresh(device, dropout)
            t0 = time.perf_counter()
            results.append((step_on(model, opt, batch, 0, device), time.perf_counter() - t0))
            del model, opt
        (card, card_s), (cpu, cpu_s) = results
        rel = {k: abs(card[k] - cpu[k]) / max(abs(cpu[k]), 1e-6) for k in cpu}
        log("family_train_step1", model=name, points=batch["feat"].shape[1], card=card,
            cpu=cpu, rel_diff=rel, card_step_s=card_s, cpu_step_s=cpu_s)
        if max(rel.values()) > 1e-3:
            raise AssertionError(f"{name}: step 1 card vs CPU {rel}")

        # two seeded runs bit for bit; then the loss falls
        runs = []
        for _ in range(2):
            model, opt = fresh(dev)
            losses = [step_on(model, opt, case, i, dev) for i in range(FAMILY_REPEAT_STEPS)]
            runs.append((model, opt, losses))
        (model, opt, losses), (other, _, again) = runs
        same = losses == again and all(torch.equal(a, b) for a, b in zip(
            model.state_dict().values(), other.state_dict().values()))
        del runs, other
        more = [step_on(model, opt, case, i, dev)
                for i in range(FAMILY_REPEAT_STEPS, FAMILY_FALL_STEPS)]
        totals = [sum(v * cfg.loss_weights.get(k, 1.0) for k, v in ls.items())
                  for ls in losses + more]
        log("family_train_repeat", model=name, steps=FAMILY_REPEAT_STEPS, identical=same,
            total_loss=totals)
        if not same:
            raise AssertionError(f"{name}: two seeded training runs differ")
        if not all(np.isfinite(list(ls.values())).all() for ls in losses + more):
            raise AssertionError(f"{name}: non-finite losses {losses + more}")
        if not totals[-1] < totals[0]:
            raise AssertionError(f"{name}: the loss did not fall: {totals}")

        # seconds a step each way, peak memory, one profiled step
        timed = {}
        for det in (True, False, True):
            for i in range(FAMILY_TIMED_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step_on(model, opt, case, FAMILY_FALL_STEPS + i, dev, det)
                torch.cuda.synchronize()
                timed.setdefault(det, []).append(time.perf_counter() - t0)
        torch.cuda.reset_peak_memory_stats(dev)
        step_on(model, opt, case, 0, dev)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev)
        busy = profile_call(lambda: step_on(model, opt, case, 0, dev),
                            f"family train step {name}")
        med = {det: float(np.median(v)) for det, v in timed.items()}
        log("family_train_time", model=name, deterministic_step_s=med[True],
            nondeterministic_step_s=med[False], determinism_cost=med[True] / med[False] - 1.0,
            steps_each=len(timed[True]), peak_memory_gib=peak / 2 ** 30, busy_share=busy,
            host_stage_s=host_s, family_s=time.perf_counter() - t_family)
        del model, opt
        torch.cuda.empty_cache()

    # one epoch through the CLI, the exported weights served
    n_vert = sum(1 for line in scan.open() if line.startswith("v "))
    for name in ("dgcnn", "tsegnet"):
        argv = ["--model_name", name, "--input_data_dir_path", str(data),
                "--train_data_split_txt_path", str(work / "train.txt"),
                "--val_data_split_txt_path", str(work / "val.txt"),
                "--checkpoint_path", str(work / "family_ckpt" / name), "--max_epochs", "1",
                "--device", str(dev)]
        zero()
        t0 = time.perf_counter()
        trainer = cli_train.main(argv)
        wall = time.perf_counter() - t0
        seen = counts()
        npz = work / f"trained_{name}.npz"
        save_weights(str(npz), trainer.model)
        out_dir = work / f"out_trained_{name}"
        infer.main(["--input_dir_path", str(scan.parent), "--save_path", str(out_dir),
                    "--model_name", name, "--checkpoint_path", str(npz),
                    "--device", str(dev)])
        res = json.loads((out_dir / (scan.stem + ".json")).read_text())
        log("family_train_cli", model=name, epochs=trainer.epoch, steps=trainer.step,
            wall_s=wall, best_val=trainer.best_val, launches=seen,
            served_labels=sorted(set(res["labels"])))
        if not (trainer.epoch == 1 and np.isfinite(trainer.best_val)
                and seen["knn_select"] and (name == "dgcnn" or seen["fps"])):
            raise AssertionError(f"cli.train {name}: epoch {trainer.epoch}, val "
                                 f"{trainer.best_val}, launches {seen}")
        if len(res["labels"]) != n_vert or not set(res["labels"]) <= FDI:
            raise AssertionError(f"{name}: the trained weights served {len(res['labels'])} "
                                 f"labels for {n_vert} vertices")
        del trainer
    log("family_train", seconds=time.perf_counter() - t_phase,
        launches_per_step={n: {k: v for k, v in c.items() if v} for n, c in per_step.items()})
    return per_step


def step_phases(model, opt, task, cfg, batch) -> dict:
    """The seconds of one train step's phases, as ``train_step`` runs them
    (deterministic algorithms on), each ended by a synchronise: the
    forward (stage 1, the crops, stage 2), the seven losses, the backward
    and the optimizer's update."""
    from toothgroupnetwork_tpu_torch.train.loss_meter import LossMap
    from toothgroupnetwork_tpu_torch.train.trainer import (deterministic_algorithms,
                                                           zero_missing_grads)

    def mark(name):
        torch.cuda.synchronize()
        marks.append((name, time.perf_counter()))

    model.train()
    marks = []
    mark("start")
    with deterministic_algorithms():
        out = model(batch["feat"], batch["mask"], **task.forward_kwargs(batch))
        mark("forward")
        losses = task.compute_losses(out, batch, cfg)
        total = LossMap(losses).get_sum()
        mark("losses")
        opt.zero_grad(set_to_none=True)
        total.backward()
        mark("backward")
        zero_missing_grads(opt)
        opt.step()
        mark("optimizer")
    return {name: t - marks[i][1] for i, (name, t) in enumerate(marks[1:])}


# the parallel phases (14, 15) on two ranks sharing the one card over gloo
# (parallel/distributed.py's backend rule), with one more rank alone on it
# over NCCL
DP_RANKS, DP_STEPS = 2, 2
# phase 14's tolerances, from the split BatchNorm sums: the data-parallel
# step sums each rank's rows and then the two partial sums, where one
# process sums the global batch at once. Two orders of a float32 sum of n
# terms differ by at most about log2(n) eps relative under torch's
# cascaded reductions: the widest BatchNorm of a step reduces
# 2 x 24000 x 36 = 1.7e6 neighbourhood rows, log2 = 21, so 1.3e-6 a
# statistic, and the 264 train-mode BatchNorms of the two stages stack at
# most to 3.4e-4 in a loss: ``DP_LOSS_RTOL``. The ranks also run every
# matrix product at one cloud's shapes, and cuBLAS rounds the ground-truth
# centroids' batched product (models/tgnet.py:43) otherwise at batch 1
# than at batch 2. The crops cut around them keep their points but sort
# near-tied distances into another order (23 of the 32 crops), and the
# crop stage's FPS and kNN break ties by that order, so its deep
# BatchNorms (12 points a crop) see other inputs. The control measures
# that alone: one process with its products run one cloud at a time
# (``products_per_cloud``) cuts the ranks' crops in the ranks' order and
# lands 2.97e-4 absolute from one process in a running statistic (first
# past the CPU tests' tolerance: ``second.enc4_down.bn.mean``), the ranks
# 2.97e-4, one process given the clouds in the other order 1.2e-6, and
# the ``Dense`` products alone at one cloud's shapes 2.4e-7 (measured on
# an H100, NVIDIA H100 80GB HBM3, 700.00 W). So the ranks
# are held to one process within twice the control's reading,
# ``DP_STAT_ATOL``, and to the control within the CPU tests' tolerance
# (``STAT_RTOL``/``STAT_ATOL``; the ranks read 1.1e-6 absolute there) and
# ``CONTROL_LOSS_RTOL`` (the CPU tests' loss tolerance; 1.7e-6 read). The
# parameters after step 1 (SGD, lr 0.1) are held to ``DP_PARAM_TOL`` of the
# largest: one process given the same two clouds in the other order lands
# 3.7e-3 of the largest away (the same measurement), since the full-width
# step's gradient sits on ReLU and max-pool kinks within rounding; that
# reordering runs beside the ranks here as the yardstick, and the later
# steps, which drift apart both ways, are logged beside it.
DP_LOSS_RTOL = 3.5e-4
DP_STAT_RTOL, DP_STAT_ATOL = 2e-4, 6e-4
# the CPU tests' tolerances on the statistics (tests/test_misc_parallel.py:
# 540-546) and the losses, against the control
STAT_RTOL, STAT_ATOL = 2e-4, 2e-6
CONTROL_LOSS_RTOL = 2e-5
DP_PARAM_TOL = 1e-2        # of the model's largest parameter, after step 1
# phase 15: the fps model's full-width stage-1 backbone over 24000 points
# rounded up to 96 x 256, a multiple of D x 4^4 (models/tgnet.py:104-107)
SHARD_N = 24576
SHARD_CLASSES = 17
SHARD_TOL = 1e-4           # of the largest output, sharded (K6) vs dense (K3)


def _digest(model) -> str:
    """sha256 of every parameter and buffer of ``model`` (bit-identity)."""
    import hashlib

    h = hashlib.sha256()
    for t in [*model.parameters(), *model.buffers()]:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _state_np(model) -> dict:
    return {k: v.detach().cpu().numpy().copy() for k, v in model.state_dict().items()}


def dp_steps(mesh, batch: dict, steps: int) -> dict:
    """Phase 14 on one rank: tgnet_fps at full width from the seeded
    flax-like initial weights, ``steps`` data-parallel SGD steps (the
    preset) on this rank's rows of the global ``batch``. Returns each step's
    losses, seconds, K1/K2 launches and state digest, and the state after
    step 1."""
    from toothgroupnetwork_tpu_torch.models import get_task
    from toothgroupnetwork_tpu_torch.ops.kernels import fps, knn
    from toothgroupnetwork_tpu_torch.parallel import replicate, shard_batch
    from toothgroupnetwork_tpu_torch.train import make_optimizer, train_step
    from toothgroupnetwork_tpu_torch.pipelines.tgn import use_full_fp32
    from toothgroupnetwork_tpu_torch.utils.weights import init_like_flax_

    use_full_fp32()
    task = get_task("tgnet_fps")
    cfg = task.default_config()
    model = task.build_module(cfg, device=mesh.device)
    init_like_flax_(model, torch.Generator().manual_seed(cfg.seed))
    opt = make_optimizer(cfg.optimizer, model.parameters())
    replicate(model, mesh)
    local = {k: torch.from_numpy(v).to(mesh.device)
             for k, v in shard_batch(batch, mesh).items()}
    out = {"steps": [], "mesh": mesh.describe()}
    hook = _crops_hook(model, out)
    for i in range(steps):
        fps.fps.launches = knn.knn_select.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vals = train_step(model, opt, task, cfg, local, mesh=mesh)
        torch.cuda.synchronize()
        out["steps"].append({"s": time.perf_counter() - t0,
                             "losses": {k: float(v) for k, v in vals.items()},
                             "launches": {"fps": fps.fps.launches,
                                          "knn_select": knn.knn_select.launches},
                             "digest": _digest(model)})
        hook.remove()
        if i == 0 and mesh.rank == 0:
            out["state1"] = _state_np(model)
    out["peak_gib"] = torch.cuda.max_memory_allocated(mesh.device) / 2**30
    return out


@contextlib.contextmanager
def products_per_cloud(clouds: int):
    """Phase 14's control: every matrix product of the one-process step
    (each ``Dense`` and each batched ``torch.einsum``: the ground-truth
    centroids the crops are cut around, the centroid loss) run on one
    cloud's rows at a time (the leading axis, cloud-major, in ``clouds``
    parts) and the parts concatenated, in the forward and so in the
    backward. The products then have the shapes a rank holding one cloud
    gives cuBLAS; the BatchNorm sums and the losses' reductions still run
    over the whole batch at once, as one process takes them."""
    from toothgroupnetwork_tpu_torch.nn.layers import Dense

    plain, plain_einsum = Dense.forward, torch.einsum

    def split(self, x):
        if x.shape[0] % clouds:
            return plain(self, x)
        return torch.cat([plain(self, part) for part in x.chunk(clouds)], 0)

    def split_einsum(eq, *ops):
        ins, out = eq.replace(" ", "").split("->")
        if not (out.startswith("b") and all(i.startswith("b") for i in ins.split(","))
                and ops[0].shape[0] % clouds == 0):
            return plain_einsum(eq, *ops)
        parts = zip(*(o.chunk(clouds) for o in ops))
        return torch.cat([plain_einsum(eq, *p) for p in parts], 0)

    Dense.forward, torch.einsum = split, split_einsum
    try:
        yield
    finally:
        Dense.forward, torch.einsum = plain, plain_einsum


def _crops_hook(model, store: dict):
    """Keep the first forward's crop indices ``[B, 16, S]`` in ``store``."""
    def keep(_module, _inputs, out):
        store.setdefault("crops", out["nn_crop_indexes"].cpu().numpy())
    return model.register_forward_hook(keep)


def sharded_forward(mesh, state: dict, feat, arch: dict) -> dict:
    """Phase 15 on one rank: the point-sharded eval forward
    (``parallel.sharded_backbone_forward``) of this rank's rows of ``feat``,
    every count set to 0 just before; its seconds, the sharded FPS's share
    of them (``sharded_fps`` timed inside, each call synchronised), and the
    K2 / K6 launches."""
    from toothgroupnetwork_tpu_torch.models.point_transformer.backbone import (
        PointTransformerSeg)
    from toothgroupnetwork_tpu_torch.ops.kernels import attention, knn
    from toothgroupnetwork_tpu_torch.parallel import shard_rows, sharded_backbone
    from toothgroupnetwork_tpu_torch.parallel.sharded_backbone import (
        extract_backbone_params)
    from toothgroupnetwork_tpu_torch.pipelines.tgn import use_full_fp32

    use_full_fp32()
    dev = mesh.device
    model = PointTransformerSeg(k=SHARD_CLASSES, c=feat.shape[-1], **arch, device=dev)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    params = extract_backbone_params(model)
    local = shard_rows(torch.from_numpy(feat).to(dev), mesh)
    fps_s = []
    inner = sharded_backbone.sharded_fps

    def timed_fps(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx = inner(*a, **kw)
        torch.cuda.synchronize()
        fps_s.append(time.perf_counter() - t0)
        return idx

    sharded_backbone.sharded_fps = timed_fps
    try:
        knn.knn_select.launches = attention.fused_vector_attention.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = sharded_backbone.sharded_backbone_forward(local, params, mesh)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        sharded_backbone.sharded_fps = inner
    return {"s": secs, "fps_s": sum(fps_s), "fps_steps": sum(len(i) - 1 for i in out["fps_idx"]),
            "launches": {"knn_select": knn.knn_select.launches,
                         "fused_vector_attention": attention.fused_vector_attention.launches},
            "mesh": mesh.describe(),
            **{k: out[k].cpu().numpy() for k in ("sem_1", "offset_1", "embed")},
            "fps_idx": [i.cpu().numpy() for i in out["fps_idx"]],
            "knn_idx": [i.cpu().numpy() for i in out["knn_idx"]]}


def knn_sets_close(pts: np.ndarray, query: np.ndarray, got: np.ndarray,
                   ref: np.ndarray) -> tuple[int, float]:
    """(rows whose neighbour sets differ, the worst ratio of a swapped
    candidate's d2 gap to the k-th against the rounding bound 10 eps
    (|q|^2 + |p|^2) of a float32 square distance, doubled). Raises past 1
    (the near-tie rule of tests/test_torch_port_families.py)."""
    rows = np.where((np.sort(got, 1) != np.sort(ref, 1)).any(1))[0]
    q, p = query.astype(np.float64), pts.astype(np.float64)
    worst = 0.0
    for i in rows:
        a, r = set(got[i].tolist()), set(ref[i].tolist())
        d2 = ((p[list(a | r)] - q[i]) ** 2).sum(1)
        d2 = dict(zip(list(a | r), d2))
        kth = max(d2[j] for j in r)
        for j in a ^ r:
            bound = 10 * np.finfo(np.float32).eps * ((q[i] ** 2).sum() + (p[j] ** 2).sum())
            worst = max(worst, abs(d2[j] - kth) / (2 * bound))
    if worst > 1.0:
        raise AssertionError(f"kNN lists differ past the near-tie bound ({worst:.3g})")
    return len(rows), worst


def phase_parallel(dev, work: Path) -> dict:
    """Phases 14-15, the parallel layer on the card (``parallel/``).

    14. tgnet_fps at full width, global batch 2 (phase 10's cases TR00 and
        TR01), on two ranks sharing the card over gloo, ``DP_STEPS`` steps:
        against the one-process batch-2 step on the card from the same
        weights and against the control (``products_per_cloud``) (step
        1's losses, BatchNorm running statistics and parameters within
        the tolerances derived above; where each run parts from one
        process, and the crops it cut; the later steps' losses logged
        beside those of one process given the clouds in the other order),
        every loss finite, the ranks bit-identical after
        every step, each rank's K1 / K2 launches a step equal to the
        one-process step's on one cloud, seconds a step each way; then one
        step on a world-size-1 NCCL group against the one-process batch-1
        step.
    15. the fps model's full-width stage-1 backbone (c = 6, 17 classes,
        planes 32..512) over a ``SHARD_N``-point synthetic arch, point-
        sharded at D = 2 over gloo (``parallel.sharded_backbone_forward``)
        against the dense port model's eval forward on the card: FPS
        indices equal at every stage, the stages' kNN lists by the near-
        tie rule, outputs within ``SHARD_TOL`` of the largest; K2 and K6
        launches per rank; seconds and the sharded FPS's share.

    Returns each kernel's launches per rank on both paths."""
    from synthetic import make_synthetic_jaw_points

    from toothgroupnetwork_tpu_torch.data import DentalScanDataset
    from toothgroupnetwork_tpu_torch.models import get_task
    from toothgroupnetwork_tpu_torch.models.point_transformer.backbone import (
        PointTransformerSeg)
    from toothgroupnetwork_tpu_torch.models.tasks import (TGNET_FPS_MODEL_PARAMETER,
                                                          backbone_kwargs)
    from toothgroupnetwork_tpu_torch.ops import farthest_point_sample, knn_self
    from toothgroupnetwork_tpu_torch.ops.kernels import fps, knn
    from toothgroupnetwork_tpu_torch.parallel import RankPool
    from toothgroupnetwork_tpu_torch.train import make_optimizer, train_step
    from toothgroupnetwork_tpu_torch.utils.weights import init_like_flax_

    t_phase = time.perf_counter()
    ds = DentalScanDataset(str(work / "train_data"))
    items = [ds[i] for i in range(2)]
    batch = {k: np.stack([it[k] for it in items]) for k in ("feat", "gt_seg_label", "mask")}
    task = get_task("tgnet_fps")
    cfg = task.default_config()

    # the one-process steps on the card: batch 2 (the reference), batch 1
    # (the launches of one cloud, and the NCCL step's reference)
    def one_process(b: dict, steps: int) -> dict:
        model = task.build_module(cfg, device=dev)
        init_like_flax_(model, torch.Generator().manual_seed(cfg.seed))
        opt = make_optimizer(cfg.optimizer, model.parameters())
        on_card = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        out = {"steps": []}
        hook = _crops_hook(model, out)
        for i in range(steps):
            fps.fps.launches = knn.knn_select.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            vals = train_step(model, opt, task, cfg, on_card)
            torch.cuda.synchronize()
            out["steps"].append({"s": time.perf_counter() - t0,
                                 "losses": {k: float(v) for k, v in vals.items()},
                                 "launches": {"fps": fps.fps.launches,
                                              "knn_select": knn.knn_select.launches}})
            hook.remove()
            if i == 0:
                out["state1"] = _state_np(model)
        del model, opt
        torch.cuda.empty_cache()
        return out

    ref2 = one_process(batch, DP_STEPS)
    ref1 = one_process({k: v[:1] for k, v in batch.items()}, 1)
    swapped = one_process({k: v[::-1].copy() for k, v in batch.items()}, DP_STEPS)
    swapped["crops"] = swapped["crops"][::-1]
    with products_per_cloud(DP_RANKS):
        tiled = one_process(batch, 1)

    def apart(run: dict, ref: dict = ref2) -> dict:
        """How far ``run`` lands from ``ref`` (the one-process step): each
        step's loss differences (relative), and after step 1 the largest
        parameter difference, the largest statistic difference (absolute,
        and over its tolerance and over the CPU tests'), the statistics
        read worst, and the first statistic in the model's order past the
        CPU tests' tolerance (where the two runs part); and the crops cut
        in step 1: the slots whose point sets differ, and the points."""
        got, want = run["state1"], ref["state1"]
        slots = list(zip(run["crops"].reshape(-1, run["crops"].shape[-1]),
                         ref["crops"].reshape(-1, ref["crops"].shape[-1])))
        crops = [len(set(a.tolist()) ^ set(b.tolist())) // 2 for a, b in slots]
        stats = [k for k in want if k.endswith((".mean", ".var"))]
        diff = {k: np.abs(got[k] - want[k]) for k in stats}
        over = {k: float((diff[k] / (DP_STAT_ATOL + DP_STAT_RTOL * np.abs(want[k]))).max())
                for k in stats}
        tight = {k: float((diff[k] / (STAT_ATOL + STAT_RTOL * np.abs(want[k]))).max())
                 for k in stats}
        return {
            "loss_rel_diff": [{k: abs(v - rs["losses"][k]) / max(abs(rs["losses"][k]), 1e-12)
                               for k, v in st["losses"].items()}
                              for st, rs in zip(run["steps"], ref["steps"])],
            "param_max_diff": max(float(np.abs(got[k] - want[k]).max())
                                  for k in want if k not in stats),
            "stat_max_abs_diff": max(float(d.max()) for d in diff.values()),
            "stat_diff_over_tol": max(over.values()),
            "stat_diff_over_cpu_test_tol": max(tight.values()),
            "worst_stats": dict(sorted(over.items(), key=lambda kv: -kv[1])[:3]),
            "first_stat_past_cpu_test_tol": next((k for k in stats if tight[k] > 1.0), None),
            "crop_slots_apart": sum(c > 0 for c in crops), "crop_points_apart": sum(crops),
            "crop_slots_in_another_order": sum(not np.array_equal(a, b) for a, b in slots)}

    reordered = apart(swapped)
    control = apart(tiled)
    del swapped

    # phase 14: two ranks over gloo on the one card
    with RankPool(DP_RANKS, "cuda") as pool:
        t0 = time.perf_counter()
        ranks = pool.run(dp_steps, batch, DP_STEPS)
        dp_wall = time.perf_counter() - t0

        identical = all(ranks[r]["steps"][i]["digest"] == ranks[0]["steps"][i]["digest"]
                        for r in range(1, DP_RANKS) for i in range(DP_STEPS))
        # rank r cut the crops of cloud r
        dp_run = dict(ranks[0], crops=np.concatenate([r["crops"] for r in ranks]))
        dp = apart(dp_run)
        vs_control = apart(dp_run, tiled)
        largest = max(float(np.abs(v).max()) for k, v in ref2["state1"].items()
                      if not k.endswith((".mean", ".var")))
        launches = [[s["launches"] for s in r["steps"]] for r in ranks]
        per_cloud = ref1["steps"][0]["launches"]
        log("dp_train", what="tgnet_fps full width, global batch 2 on 2 ranks "
            "sharing the card vs one process", mesh=ranks[0]["mesh"],
            ranks_identical=identical, data_parallel=dp, one_process_reordered=reordered,
            one_process_products_per_cloud=control,
            data_parallel_vs_products_per_cloud=vs_control,
            param_largest=largest, launches_per_rank_step=launches,
            one_process_launches_per_step={"batch 2": ref2["steps"][0]["launches"],
                                           "batch 1": per_cloud},
            dp_step_s=[s["s"] for s in ranks[0]["steps"]],
            one_process_batch2_step_s=[s["s"] for s in ref2["steps"]],
            one_process_batch1_step_s=ref1["steps"][0]["s"],
            rank_peak_gib=[r["peak_gib"] for r in ranks], pool_run_s=dp_wall)
        if not identical:
            raise AssertionError("data-parallel ranks differ after a step")
        finite = all(np.isfinite(v) for st in ranks[0]["steps"] for v in st["losses"].values())
        if not finite or max(dp["loss_rel_diff"][0].values()) > DP_LOSS_RTOL:
            raise AssertionError(f"data-parallel losses vs one process: {dp}")
        if dp["stat_diff_over_tol"] > 1.0 or dp["param_max_diff"] > DP_PARAM_TOL * largest:
            raise AssertionError(f"data-parallel state after step 1 vs one process: {dp}")
        if (max(vs_control["loss_rel_diff"][0].values()) > CONTROL_LOSS_RTOL
                or vs_control["stat_diff_over_cpu_test_tol"] > 1.0
                or vs_control["param_max_diff"] > DP_PARAM_TOL * largest):
            raise AssertionError(f"data-parallel step 1 vs the control: {vs_control}")
        if any(step != per_cloud for r in launches for step in r):
            raise AssertionError(f"launches a rank {launches} != one cloud's {per_cloud}")

        # phase 15: the point-sharded forward at D = 2
        arch = backbone_kwargs(TGNET_FPS_MODEL_PARAMETER)
        c = arch.pop("c")
        gen = torch.Generator().manual_seed(15)
        dense = PointTransformerSeg(k=SHARD_CLASSES, c=c, **arch, device=dev)
        init_like_flax_(dense, gen)
        with torch.no_grad():   # BatchNorm statistics off their identity
            for name, buf in dense.named_buffers():
                noise = torch.rand(buf.shape, generator=gen).to(dev)
                buf.add_(noise + 0.5 if name.endswith("var") else (noise - 0.5) * 0.2)
        pts, _, _ = make_synthetic_jaw_points(SHARD_N, 14, seed=15)
        nrm = np.random.default_rng(15).standard_normal((SHARD_N, 3))
        feat = np.concatenate([pts, nrm / np.linalg.norm(nrm, axis=1, keepdims=True)],
                              1).astype(np.float32)
        state = _state_np(dense)
        t0 = time.perf_counter()
        sh = pool.run(sharded_forward, state, feat, arch)
        shard_wall = time.perf_counter() - t0

    x = torch.from_numpy(feat).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        want = dense(x[None])
    torch.cuda.synchronize()
    dense_s = time.perf_counter() - t0
    # the dense path's FPS ladder (K1) and stage kNN lists (K2)
    p = x[:, :3].contiguous()
    fps_ok, knn_rows, knn_worst = [], [], 0.0
    strided = 0
    for i, (s, k) in enumerate(zip(arch["stride"], arch["nsample"])):
        if s != 1:
            idx = farthest_point_sample(p, p.shape[0] // s)
            fps_ok.append(all(np.array_equal(r["fps_idx"][strided], idx.cpu().numpy())
                              for r in sh))
            strided += 1
            p = p[idx.long()]
        ref_knn = knn_self(p, k)[0].cpu().numpy()
        got_knn = np.concatenate([r["knn_idx"][i] for r in sh])
        pts_np = p.cpu().numpy()
        rows, worst = knn_sets_close(pts_np, pts_np, got_knn, ref_knn)
        knn_rows.append(int(rows))
        knn_worst = max(knn_worst, worst)
    err = {}
    for key in ("sem_1", "offset_1", "embed"):
        ref = want[key][0].cpu().numpy()
        got_o = np.concatenate([r[key] for r in sh])
        err[key] = float(np.abs(got_o - ref).max() / np.abs(ref).max())
    log("sharded_forward", what=f"tgnet stage-1 backbone, {SHARD_N} points, "
        f"point-sharded on {DP_RANKS} ranks (K2 kNN, K6) vs the dense eval "
        "forward (K1, K2, K3) on the card", mesh=sh[0]["mesh"], fps_equal=fps_ok,
        knn_rows_differing=knn_rows, knn_worst_gap_over_bound=knn_worst,
        max_err_over_largest=err, launches_per_rank=[r["launches"] for r in sh],
        seconds=[r["s"] for r in sh], fps_seconds=[r["fps_s"] for r in sh],
        fps_share=[r["fps_s"] / r["s"] for r in sh], fps_steps=sh[0]["fps_steps"],
        dense_s=dense_s, pool_run_s=shard_wall)
    if not all(fps_ok):
        raise AssertionError("sharded FPS indices differ from K1's")
    if max(err.values()) > SHARD_TOL:
        raise AssertionError(f"sharded forward vs dense: {err}")
    # ring_knn calls: each stage's kNN, each strided stage's TransitionDown,
    # each decoder TransitionUp (k = 3) and each 1-NN upsample, one launch
    # each on the gathered coordinates; K6: every attention block, encoder
    # and decoder
    deep = len(arch["stride"]) - 1
    expect = {"knn_select": len(arch["stride"]) + 3 * deep,
              "fused_vector_attention": sum(arch["blocks"])}
    if any(r["launches"] != expect for r in sh):
        raise AssertionError(f"sharded forward launches {[r['launches'] for r in sh]} "
                             f"!= {expect}")

    # one step on a world-size-1 NCCL group, against the one-process step
    with RankPool(1, "cuda") as pool:
        nccl = pool.run(dp_steps, {k: v[:1] for k, v in batch.items()}, 1)[0]
    rel1 = {k: abs(v - ref1["steps"][0]["losses"][k]) / max(abs(ref1["steps"][0]["losses"][k]), 1e-12)
            for k, v in nccl["steps"][0]["losses"].items()}
    log("dp_nccl", what="one tgnet_fps step on a world-size-1 NCCL group vs one process",
        mesh=nccl["mesh"], loss_rel_diff=rel1, launches=nccl["steps"][0]["launches"],
        step_s=nccl["steps"][0]["s"], seconds=time.perf_counter() - t_phase)
    if "nccl" not in nccl["mesh"] or max(rel1.values()) > DP_LOSS_RTOL:
        raise AssertionError(f"NCCL step: {nccl['mesh']}, {rel1}")
    return {"dp_train_launches_per_rank_step": launches[0][0],
            "sharded_forward_launches_per_rank": sh[0]["launches"]}


# phase 16: the point-sharded train step (parallel/sharded_train.py), the
# pointtransformer preset at full width and batch 1 on phase 10's first
# 24000-point case, its point axis split over two ranks sharing the card
# over gloo, against the dense one-process step on the card. The sharded
# step runs the dense step's arithmetic on each rank's rows, its selections
# (FPS through K1, kNN through K2, on the gathered coordinates) equal to
# the dense ones, so the two part only where a sum is taken in another
# order: each BatchNorm sums its two shards' partial sums (the split sums
# of phase 14's derivation: about log2(n) eps relative a statistic under
# torch's cascaded reductions, n = 24000 x 36 = 8.6e5 neighbourhood rows at
# the widest, log2 = 20, 2.4e-6; the step's 132 train-mode BatchNorms
# stack at most to 3.2e-4 in a loss: ``PS_LOSS_RTOL``), the loss's
# normaliser, each gathered row's gradient summed by its owner after the
# other rank's share, and every matrix product at half the rows, which
# cuBLAS may tile otherwise (phase 14's control: 2.4e-7 a statistic from
# the products alone). A running statistic moves by a tenth of its batch
# moment, so ``PS_STAT_ATOL`` (1e-5) holds it to four times the split-sum
# bound of a moment of unit size.
#
# The parameters. The control is the dense step on the cloud twice (batch
# 2): the same function in exact arithmetic, the same selections, every
# sum over the point axis and every product taken over twice the rows, as
# the ranks take theirs over half. (The cloud's rows reordered would not
# do: the synthetic arch has exactly equidistant points, FPS and kNN break
# those ties by index, and the reordered step took other points: its loss
# 2.3e-5 and its statistics 1.9e-3 from the dense step's.) Its running
# variances part by design: the unbiased correction n / (n - 1) follows
# the row count (93 / 92 against 186 / 185 at the deepest stage), so the
# control's statistics are held by their means. After one SGD step at lr
# 0.1 (measured on an H100, NVIDIA H100 80GB HBM3, 700.00 W) the control
# lands 1.9e-3 of the largest parameter (1.313) from the dense step and
# the ranks 4.1e-3, both at ``enc1_down.linear.weight``, whose update is
# the step's largest, 0.861; in L2 over the whole update the control
# reads 3.1e-3 and the ranks 2.3e-3. A near-tie in a ReLU or a max over
# the neighbours, decided within rounding, moves a share of a gradient
# either way. So both are held to ``PS_PARAM_TOL`` of the largest (2.4x
# the ranks' reading) and ``PS_L2_TOL`` of the update in L2 (3x the
# control's), the first bound no more than ``PS_UPDATE_TOL`` of the dense
# step's largest update (pointtransformer's reads 1.5 %): a step that
# left the parameters unchanged, or one with a gradient off by a share of
# its own size, fails. The families' steps at batch 1 move their largest
# parameter by 2-7 % of its size (pointnet 0.028 of 1.00, DGCNN 0.019,
# PointNet++ 0.072 in a dry run of this phase on the CPU at 2048 points),
# so there the update's share is the smaller bound; that dry run read the
# ranks at 0.08-0.56 % of the update (the control 0.0004-0.12 %) and 0.03
# -0.1 % of it in L2 (the control up to 0.12 %).
#
# DGCNN's statistics. At batch 1 ``head1`` takes the global max, constant
# over the points, beside the per-point features, and ``head1_bn``'s mean
# sums a product whose rounding follows the global feature's: on the card
# (NVIDIA H100 80GB HBM3, 700.00 W) the control moved it by 1.2e-4, 9.3
# times the statistics' bound, and the ranks by 1.5e-5, 1.14 times. Its
# statistics, the control's and the ranks', are held to
# ``PS_STAT_SCALE`` times the bound (2.2x the control's reading).
PS_STAT_SCALE = {"dgcnn": 20.0}
#
# tsegnet's parameters. Its PointNet++ towers max-pool at every level, and
# its crop rows take the centroid backbone's features, so its update sits
# on kinks within rounding of the step (tests/test_torch_port_train_
# families_steps.py): on the card (NVIDIA H100 80GB HBM3, 700.00 W) the
# control moved the update by 1.08e-2 of it in L2 and a parameter by
# 2.05e-2 (1.04 times ``PS_PARAM_TOL`` of the largest), the ranks by
# 1.04e-2 and 1.13e-2 (0.57 times it). Its parameters and its update are
# held to ``PS_PARAM_SCALE`` times those bounds (1.9 times the control's
# reading).
PS_PARAM_SCALE = {"tsegnet": 2.0}
PS_RANKS = 2
PS_LOSS_RTOL = 3.2e-4
PS_STAT_RTOL, PS_STAT_ATOL = 2e-4, 1e-5
PS_PARAM_TOL = 1e-2        # of the model's largest parameter, after step 1
PS_L2_TOL = 1e-2           # of the dense step's update, in L2 over every parameter
PS_UPDATE_TOL = 5e-2       # of the dense step's largest update, if smaller
# The families' sharded steps (pointnet, dgcnn, pointnetpp at their presets'
# widths: pointnet scale 2, DGCNN k 20 and emb 1024, PointNet++ 24000 ->
# 1024 -> 512 -> 256) are held by the same bounds, each beside its own
# control, the dense step on the cloud twice: their sums over the point
# axis part in the same way (the BatchNorms' split sums, the global max's
# gradient split over its tied rows), and they have fewer train-mode
# BatchNorms than pointtransformer's 132, so ``PS_LOSS_RTOL`` bounds their
# losses too. They step with the pointtransformer preset's SGD (lr 0.1,
# momentum 0.9): under their Adam presets the first step moves every
# parameter by +-lr whatever its gradient's size, so a parameter whose
# gradient is rounding noise (a bias a BatchNorm cancels) flips sign, and
# no bound on the parameters would hold. DGCNN keeps its dropout (0.5):
# the dense step, the control (one cloud's mask drawn, used for both
# copies: ``_tile_dropout``) and the ranks draw one mask from one seed.
# The crop models (tgnet_fps, tgnet_bdl, tsegnet) are held by the same
# bounds beside the same control, its products run one cloud at a time
# (``products_per_cloud``): the batched centroid ``einsum`` over the cloud
# twice rounds otherwise and reorders crop near-ties (phase 14), and the
# stage-2 products then take the crop rows of one cloud, as the dense step
# does. tgnet_fps and tgnet_bdl step with their presets' SGD (the
# pointtransformer preset's), tsegnet with it in place of its Adam, as the
# families do.
PS_TASKS = ("pointtransformer", "pointnet", "dgcnn", "pointnetpp", "tgnet_fps",
            "tgnet_bdl", "tsegnet")
PS_CROP_TASKS = ("tgnet_fps", "tgnet_bdl", "tsegnet")
PS_DROPOUT_SEED = 15
# where each task's FPS is timed (the module whose ``farthest_point_sample``
# its model calls)
PS_FPS_MODULES = {"pointtransformer": "models.point_transformer.backbone",
                  "pointnetpp": "nn.set_abstraction",
                  "tgnet_fps": "models.point_transformer.backbone",
                  "tsegnet": "nn.set_abstraction"}
# a dense step's K1 / K2 launches (PERF.md's "family train" column): the
# families' FPS and kNN, each launched once a call
PS_DENSE_LAUNCHES = {"pointtransformer": {"fps": 4, "knn_select": 17},
                     "pointnet": {"fps": 0, "knn_select": 0},
                     "dgcnn": {"fps": 0, "knn_select": 3},
                     "pointnetpp": {"fps": 3, "knn_select": 3},
                     "tgnet_fps": {"fps": 8, "knn_select": 42},
                     "tgnet_bdl": {"fps": 0, "knn_select": 4},
                     "tsegnet": {"fps": 9, "knn_select": 9}}


def _ps_config(name: str, mp: dict | None = None):
    """The task and its preset for phase 16: the preset's widths (with the
    ``model_parameter`` entries ``mp``); the other tasks with the
    pointtransformer preset's SGD."""
    from toothgroupnetwork_tpu_torch.models import get_task

    task = get_task(name)
    cfg = task.default_config()
    cfg.model_parameter.update(copy.deepcopy(mp or {}))
    if name != "pointtransformer":
        sgd = get_task("pointtransformer").default_config().optimizer
        cfg.optimizer = copy.deepcopy(sgd)
    return task, cfg


def _ps_bdl_inputs(dev, work: Path) -> tuple[dict, dict]:
    """tgnet_bdl's inputs for phase 16, as phase 11 writes them: one
    labelled 100489-vertex case, preprocessed on the card to 24000 points,
    and a frozen fps model of random weights (``make_weights``). Returns
    (the loader's batch of the case, the ``model_parameter`` entries that
    name the case's obj/json roots, no cache, and the frozen model)."""
    from synthetic import write_synthetic_case

    from toothgroupnetwork_tpu_torch.data import DentalScanDataset, collate_batch
    from toothgroupnetwork_tpu_torch.data.preprocess import preprocess_dir
    from toothgroupnetwork_tpu_torch.models import get_task

    src = work / "ps_bdl"
    write_synthetic_case(str(src), "PS00", "lower", n_side=N_SIDE, seed=40)
    preprocess_dir(str(src / "objs"), str(src / "jsons"), str(src / "processed"),
                   verbose=False, device=dev)
    fps_npz = work / "fps.npz"
    if not fps_npz.exists():
        make_weights(work)
    mp = get_task("tgnet_bdl").default_config().model_parameter
    info = dict(mp["boundary_sampling_info"], orginal_data_obj_path=str(src / "objs"),
                orginal_data_json_path=str(src / "jsons"), bdl_cache_path=None)
    fps_info = dict(mp["fps_model_info"], load_ckpt_path=str(fps_npz))
    batch = collate_batch([DentalScanDataset(str(src / "processed"))[0]])
    return batch, {"boundary_sampling_info": info, "fps_model_info": fps_info}


def _ps_tsegnet_host_state(dev, state: dict, batch: dict) -> dict:
    """The state of phase 13's calibrated copy of tsegnet: its centroid
    module with this batch's statistics and fitted heads (random heads
    propose no crop), from which the host stage proposes the crops."""
    task, cfg = _ps_config("tsegnet")
    m = task.build_module(cfg, device=dev)
    m.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    feat = torch.from_numpy(batch["feat"]).to(dev)
    mask = torch.from_numpy(batch["mask"]).to(dev)
    match_running_stats(m.cent_module, feat, mask)
    fit_centroid_heads(m, feat, np.random.default_rng(13), mask)
    return _state_np(m)


def _ps_generator(device) -> torch.Generator:
    """Phase 16's dropout generator (DGCNN's), seeded alike on every rank."""
    return torch.Generator(device=device).manual_seed(PS_DROPOUT_SEED)


def _tile_dropout(model) -> None:
    """The control's dropout on the cloud twice: one cloud's mask drawn
    from the generator, as the dense step draws it, and used for both
    copies, so the control computes the dense step's function."""
    from toothgroupnetwork_tpu_torch.nn.layers import Dropout

    for m in model.modules():
        if isinstance(m, Dropout):
            def forward(x, m=m, draw=m.forward):
                if not m.training or m.p == 0.0:
                    return x
                keep = (draw(torch.ones_like(x[:1])) != 0).expand_as(x)
                return torch.where(keep, x / (1.0 - m.p), torch.zeros_like(x))
            m.forward = forward


def point_sharded_steps(mesh, batch: dict, state: dict, name: str, mp: dict | None = None,
                        host_state: dict | None = None) -> dict:
    """Phase 16 on one rank: the point-sharded step of task ``name``
    (``make_point_sharded_train_step``, :func:`_ps_config`'s SGD, with the
    ``model_parameter`` entries ``mp``) on this rank's rows of ``batch``,
    twice from ``state``; for a task with a host stage, this rank's rows of
    ``host_batch_points`` (rank 0 runs the stage on the whole batch, its
    model from ``host_state``, or ``state``), kept in the result. Each
    run's losses, seconds, the FPS's seconds (the gather and K1, each call
    synchronised), the K1 / K2 launches (every count set to 0 just before
    the step), the state digest and the peak memory; the first run's crops
    (this rank's rows of the crop axis); rank 0 also returns the state
    after the first."""
    import importlib

    from toothgroupnetwork_tpu_torch.ops.kernels import fps, knn
    from toothgroupnetwork_tpu_torch.parallel.sharded_train import (
        host_batch_points, make_point_sharded_train_step, shard_batch_points)
    from toothgroupnetwork_tpu_torch.pipelines.tgn import use_full_fp32
    from toothgroupnetwork_tpu_torch.train import make_optimizer

    use_full_fp32()
    task, cfg = _ps_config(name, mp)
    step = make_point_sharded_train_step(task, cfg, mesh)
    host_rows = None
    if task.host_stage is None:
        local = shard_batch_points(batch, mesh)
    else:
        model = task.build_module(cfg, device=mesh.device)
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in (host_state or state).items()})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        local = host_batch_points(task, model, batch, cfg, 0, mesh)
        torch.cuda.synchronize()
        host_rows = {k: v.cpu().numpy() for k, v in local.items()
                     if isinstance(v, torch.Tensor)}
        host_s = time.perf_counter() - t0
        del model
    fps_s = []
    where = (importlib.import_module(f"toothgroupnetwork_tpu_torch.{PS_FPS_MODULES[name]}")
             if name in PS_FPS_MODULES else None)
    inner = where.farthest_point_sample if where else None

    def timed_fps(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx = inner(*a, **kw)
        torch.cuda.synchronize()
        fps_s.append(time.perf_counter() - t0)
        return idx

    out = {"runs": [], "mesh": mesh.describe(),
           "rows": {k: list(v.shape) for k, v in local.items()
                    if isinstance(v, torch.Tensor)}}
    if host_rows is not None:
        out["host_rows"], out["host_s"] = host_rows, host_s
    if where:
        where.farthest_point_sample = timed_fps
    try:
        for run in range(2):
            model = task.build_module(cfg, device=mesh.device)
            model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
            if run == 0 and name in PS_CROP_TASKS:
                hook = _crops_hook(model, out)
            opt = make_optimizer(cfg.optimizer, model.parameters())
            gen = _ps_generator(mesh.device)
            fps_s.clear()
            torch.cuda.reset_peak_memory_stats(mesh.device)
            fps.fps.launches = knn.knn_select.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            vals = step(model, opt, local, generator=gen)
            torch.cuda.synchronize()
            out["runs"].append({
                "s": time.perf_counter() - t0, "fps_s": sum(fps_s),
                "losses": {k: float(v) for k, v in vals.items()},
                "launches": {"fps": fps.fps.launches, "knn_select": knn.knn_select.launches},
                "digest": _digest(model),
                "peak_gib": torch.cuda.max_memory_allocated(mesh.device) / 2**30})
            if run == 0 and mesh.rank == 0:
                out["state1"] = _state_np(model)
            if run == 0 and name in PS_CROP_TASKS:
                hook.remove()
            del model, opt
            torch.cuda.empty_cache()
    finally:
        if where:
            where.farthest_point_sample = inner
    return out


def phase_point_sharded_train(dev, work: Path) -> tuple[dict, dict]:
    """Phase 16, the point-sharded training step on the card
    (``parallel/sharded_train.py``), for each of ``PS_TASKS`` at its
    preset's full width from the seeded flax-like initial weights
    (pointtransformer: planes 32-512, nsample 36/24/24/24/24, blocks
    2/3/4/6/3, 24000 -> 6000 -> 1500 -> 375 -> 93 points, shards of 12000
    ... 46 / 47 rows; pointnet at scale 2; DGCNN at k 20, emb 1024, dropout
    0.5; PointNet++ at scale 4, 24000 -> 1024 -> 512 -> 256; tgnet_fps
    with stage 2 over 16 crops of 3072, 8 a rank; tgnet_bdl's planes 16 /
    32; tsegnet's 8 crop slots, 4 a rank), batch 1 on phase 10's first
    24000-point case (tgnet_bdl: its host stage's 24000-point cloud of one
    labelled 100489-vertex case, ``_ps_bdl_inputs``; tsegnet: with the
    proposals of its calibrated centroid module,
    ``_ps_tsegnet_host_state``), its point axis split over ``PS_RANKS``
    ranks sharing the card over gloo (one pool for the seven), against the
    dense one-process step on the card from the same weights: step 1's
    losses, BatchNorm running statistics and parameters within the
    tolerances derived above, beside the control (the dense step on the
    cloud twice, batch 2) and the dense step's own update; the crop
    models' crops and the host stages' arrays identical to the dense
    step's; two sharded steps from one state bit-identical; every rank's
    digest equal; K1 and K2 launched a rank as often as in the dense step;
    seconds a step, the FPS's share, peak memory a rank. Returns each
    task's launches a rank and step, and the phase's summary by task."""
    from toothgroupnetwork_tpu_torch.data import DentalScanDataset
    from toothgroupnetwork_tpu_torch.parallel import RankPool

    item = DentalScanDataset(str(work / "train_data"))[0]
    batch = {k: item[k][None] for k in ("feat", "gt_seg_label", "mask")}
    bdl_batch, bdl_mp = _ps_bdl_inputs(dev, work)
    inputs = {"tgnet_bdl": dict(batch=bdl_batch, mp=bdl_mp)}
    launches, summaries = {}, {}
    with RankPool(PS_RANKS, "cuda") as pool:
        for name in PS_TASKS:
            kw = {"batch": batch, **inputs.get(name, {})}
            launches[name], summaries[name] = _point_sharded_task(dev, pool, name, **kw)
    keys = {name: "point_sharded_train_launches_per_rank_step"
            if name == "pointtransformer"
            else f"point_sharded_train_{name}_launches_per_rank_step" for name in PS_TASKS}
    return {keys[n]: launches[n] for n in PS_TASKS}, summaries


def _point_sharded_task(dev, pool, name: str, batch: dict,
                        mp: dict | None = None) -> tuple[dict, dict]:
    """Phase 16 for task ``name`` on ``pool``'s ranks (``mp``: its
    ``model_parameter`` entries): (a rank's launches a step, the summary),
    every check raising. A task with a host stage runs it once here, on the
    loader's ``batch``, for the dense step and the control; the ranks run
    it through ``host_batch_points``."""
    from toothgroupnetwork_tpu_torch.ops.kernels import fps, knn
    from toothgroupnetwork_tpu_torch.train import make_optimizer, train_step
    from toothgroupnetwork_tpu_torch.train.trainer import apply_host_stage
    from toothgroupnetwork_tpu_torch.utils.weights import init_like_flax_

    t_phase = time.perf_counter()
    task, cfg = _ps_config(name, mp)
    model = task.build_module(cfg, device="cpu")
    init_like_flax_(model, torch.Generator().manual_seed(cfg.seed))
    state = _state_np(model)
    host_state = _ps_tsegnet_host_state(dev, state, batch) if name == "tsegnet" else None
    loader_batch, host_s = batch, None
    if task.host_stage is not None:
        model = task.build_module(cfg, device=dev)
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in (host_state or state).items()})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = apply_host_stage(task, model, batch, cfg, 0)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        batch = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
    del model

    def dense_step(b: dict, control: bool = False) -> dict:
        model = task.build_module(cfg, device=dev)
        model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
        if control:
            _tile_dropout(model)
        out = {}
        hook = _crops_hook(model, out) if name in PS_CROP_TASKS else None
        opt = make_optimizer(cfg.optimizer, model.parameters())
        on_card = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        gen = _ps_generator(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        fps.fps.launches = knn.knn_select.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with (products_per_cloud(2) if control and hook else contextlib.nullcontext()):
            vals = train_step(model, opt, task, cfg, on_card, generator=gen)
        torch.cuda.synchronize()
        out.update({"s": time.perf_counter() - t0,
                    "losses": {k: float(v) for k, v in vals.items()},
                    "launches": {"fps": fps.fps.launches,
                                 "knn_select": knn.knn_select.launches},
                    "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
                    "state1": _state_np(model)})
        if hook:
            hook.remove()
        del model, opt
        torch.cuda.empty_cache()
        return out

    dense = dense_step(batch)
    control = dense_step({k: np.concatenate([v, v]) for k, v in batch.items()}, True)
    t0 = time.perf_counter()
    ranks = pool.run(point_sharded_steps, loader_batch, state, name, mp, host_state)
    pool_s = time.perf_counter() - t0
    crops_same = host_same = None
    if name in PS_CROP_TASKS:
        want = dense["crops"].reshape(-1, dense["crops"].shape[-1])
        got = np.concatenate([r["crops"].reshape(-1, want.shape[-1]) for r in ranks])
        crops_same = {"ranks": bool(np.array_equal(got, want)),
                      "control": bool(np.array_equal(
                          control["crops"].reshape(-1, want.shape[-1]),
                          np.concatenate([want, want])))}
    if task.host_stage is not None:
        n = batch["feat"].shape[1]

        def rank_arrays(k):
            """The ranks' arrays of ``k``: their rows joined where it has the
            point axis, else each rank's whole array."""
            parts = [r["host_rows"][k] for r in ranks]
            if batch[k].ndim >= 2 and batch[k].shape[1] == n:
                return [np.concatenate(parts, axis=1)]
            return parts

        host_same = {k: all(np.array_equal(a, batch[k]) for a in rank_arrays(k))
                     for k in batch}

    runs = [r["runs"] for r in ranks]
    want = dense["state1"]
    stats = [k for k in want if k.endswith((".mean", ".var"))]
    params = [k for k in want if k not in stats]
    largest = max(float(np.abs(want[k]).max()) for k in params)
    update = {k: want[k] - state[k] for k in params}
    max_update = max(float(np.abs(u).max()) for u in update.values())
    scale = PS_PARAM_SCALE.get(name, 1.0)
    param_bound = scale * min(PS_PARAM_TOL * largest, PS_UPDATE_TOL * max_update)

    def vs_dense(got: dict, losses: dict, held: list) -> dict:
        """Where ``got`` (a state after step 1) and ``losses`` part from
        the dense step's, the statistics ``held`` against the tolerance."""
        over = {k: float((np.abs(got[k] - want[k])
                          / (PS_STAT_ATOL + PS_STAT_RTOL * np.abs(want[k]))).max())
                for k in held}
        diff = {k: float(np.abs(got[k] - want[k]).max()) for k in params}
        return {"loss_rel_diff": {k: abs(v - dense["losses"][k])
                                  / max(abs(dense["losses"][k]), 1e-12)
                                  for k, v in losses.items()},
                "stat_max_abs_diff": max(float(np.abs(got[k] - want[k]).max())
                                         for k in held),
                "stat_diff_over_tol": max(over.values()),
                "worst_stats": dict(sorted(over.items(), key=lambda kv: -kv[1])[:3]),
                "param_max_diff": max(diff.values()),
                "param_diff_over_largest": max(diff.values()) / largest,
                "param_l2_over_update": float(
                    np.sqrt(sum(np.sum((got[k] - want[k]) ** 2) for k in params))
                    / np.sqrt(sum(np.sum(u ** 2) for u in update.values()))),
                "worst_params": dict(sorted(diff.items(), key=lambda kv: -kv[1])[:3])}

    sharded = vs_dense(ranks[0]["state1"], runs[0][0]["losses"], stats)
    ctrl = vs_dense(control["state1"], control["losses"],
                    [k for k in stats if k.endswith(".mean")])
    repeat = all(r[0]["digest"] == r[1]["digest"] for r in runs)
    same = all(r[i]["digest"] == runs[0][i]["digest"] for r in runs for i in (0, 1))
    launches = [[x["launches"] for x in r] for r in runs]
    expect = dense["launches"]
    summary = {
        "what": f"{name} full width, batch 1, 24000 points point-sharded on "
                f"{PS_RANKS} ranks sharing the card vs the dense step",
        "sharded_vs_dense": {k: v for k, v in sharded.items() if not k.startswith("worst")},
        "control_vs_dense": {k: v for k, v in ctrl.items() if not k.startswith("worst")},
        "param_largest": largest, "max_update": max_update,
        "max_update_over_largest": max_update / largest, "param_bound": param_bound,
        "stat_bound_scale": PS_STAT_SCALE.get(name, 1.0), "param_bound_scale": scale,
        "repeat_identical": repeat, "ranks_identical": same,
        "launches_per_rank_step": launches, "dense_launches": expect,
        "step_s": [[x["s"] for x in r] for r in runs],
        "fps_share": [[x["fps_s"] / x["s"] for x in r] for r in runs],
        "rank_peak_gib": [[x["peak_gib"] for x in r] for r in runs],
        "dense_step_s": dense["s"], "dense_peak_gib": dense["peak_gib"],
        "control_step_s": control["s"], "crops_identical": crops_same,
        "host_stage_identical": host_same, "host_stage_s": host_s,
        "rank_host_stage_s": [r.get("host_s") for r in ranks]}
    log("point_sharded_train", **summary, mesh=ranks[0]["mesh"],
        rows=[r["rows"] for r in ranks], sharded_worst=sharded, control_worst=ctrl,
        fps_s=[[x["fps_s"] for x in r] for r in runs], losses=runs[0][0]["losses"],
        dense_losses=dense["losses"], pool_run_s=pool_s,
        seconds=time.perf_counter() - t_phase)
    finite = all(np.isfinite(v) for r in runs for x in r for v in x["losses"].values())
    if not finite:
        raise AssertionError(f"{name} point-sharded losses not finite: {runs}")
    if any(x["losses"] != runs[0][0]["losses"] for r in runs for x in r):
        raise AssertionError(f"{name} point-sharded ranks or runs report other losses")
    for what, got in (("point-sharded", sharded), ("control", ctrl)):
        if (max(got["loss_rel_diff"].values()) > PS_LOSS_RTOL
                or got["stat_diff_over_tol"] > PS_STAT_SCALE.get(name, 1.0)
                or got["param_max_diff"] > param_bound
                or got["param_l2_over_update"] > scale * PS_L2_TOL):
            raise AssertionError(f"{name} {what} state vs the dense step: {got}")
    if not (repeat and same):
        raise AssertionError(f"{name} point-sharded steps not bit-identical: repeat "
                             f"{repeat}, ranks {same}")
    if crops_same is not None and not all(crops_same.values()):
        raise AssertionError(f"{name} crops differ from the dense step's: {crops_same}")
    if host_same is not None and not all(host_same.values()):
        raise AssertionError(f"{name} host stage differs from the dense one: {host_same}")
    if any(x != expect for r in launches for x in r):
        raise AssertionError(f"{name} point-sharded launches {launches} != {expect}")
    if expect != PS_DENSE_LAUNCHES[name]:
        raise AssertionError(f"{name} dense step launches {expect} != "
                             f"{PS_DENSE_LAUNCHES[name]}")
    return launches[0][0], summary


def _ps_lines(summaries: dict) -> None:
    """Phase 16's summary lines: one a task, and the seconds a step and
    peak GiB a rank of every task on one line."""
    for name, summary in summaries.items():
        log("point_sharded_train_summary", task=name, **summary)
    log("point_sharded_train_seconds", **{
        name: {"step_s": s["step_s"], "rank_peak_gib": s["rank_peak_gib"],
               "dense_step_s": s["dense_step_s"], "launches_per_rank_step":
               s["launches_per_rank_step"][0][0]} for name, s in summaries.items()})


def short(kernel_name: str) -> str:
    """A device kernel's name without namespaces and arguments, template
    arguments kept (the two attention entries differ only there)."""
    name = kernel_name.replace("(anonymous namespace)::", "").replace("void ", "")
    return name.split("(")[0][:72]


def parallel_only(dev, smi: str) -> int:
    """``--parallel``: phases 14-16 alone, on phase 10's data."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        work = Path(tmp)
        write_train_data(work)
        phase_parallel(dev, work)
        _, summaries = phase_point_sharded_train(dev, work)
    _ps_lines(summaries)
    print(smi)
    return 0


def main() -> int:
    import argparse

    parser = argparse.ArgumentParser(description="Smoke run of the port on one GPU.")
    parser.add_argument("--parallel", action="store_true",
                        help="run phases 1-3 and 14-16 only (no kernels or ok line)")
    args = parser.parse_args()
    # before the first cuBLAS call: deterministic training steps need a
    # fixed cuBLAS workspace (the size torch picks on Hopper anyway)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path[:0] = [str(REPO), str(REPO / "tests")]
    from synthetic import write_synthetic_obj

    from toothgroupnetwork_tpu_torch.models.tasks import tgnet_fps_config
    from toothgroupnetwork_tpu_torch.ops.kernels import (attention, build,
                                                         cell_select, cluster, fps,
                                                         gather, knn)
    from toothgroupnetwork_tpu_torch.pipelines.tgn import use_full_fp32

    use_full_fp32()
    dev = card()
    smi = smi_line()
    CARD["card"] = smi
    try:
        import sklearn  # noqa: F401
        has_sklearn = True
    except ImportError:
        has_sklearn = False
    print(smi, flush=True)
    log("env", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0], sklearn=has_sklearn)

    build.library()
    log("build", **build.build_info)

    records = phase_kernels(dev, np.random.default_rng(0))
    if args.parallel:
        return parallel_only(dev, smi)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        work = Path(tmp)
        ckpts = make_weights(work)
        scan_dir = work / "scans"
        scan_dir.mkdir()
        scans, meshes = [], []
        for s, jaw in enumerate(("lower", "upper", "lower")):
            path = scan_dir / f"scan{s}_{jaw}.obj"
            meshes.append(write_synthetic_obj(str(path), n_side=N_SIDE, seed=s))
            scans.append(path)
        log("setup", weights=[p.name for p in ckpts.values()],
            scans=[p.name for p in scans])
        feats0 = vertex_feats(*meshes[0])
        f32_out = phase_model(dev, ckpts["fps"], feats0)
        phase_model(dev, ckpts["fps"], feats0, cell=True)
        bf16_out = phase_model(dev, ckpts["fps"], feats0, dtype="bfloat16")
        log("model", what="fps stage1 bfloat16 vs float32, both on the card",
            argmax_agreement=float((bf16_out["sem_1"].argmax(-1)
                                    == f32_out["sem_1"].argmax(-1)).float().mean()),
            max_abs_dlogit=float((bf16_out["sem_1"] - f32_out["sem_1"]).abs().max()),
            max_abs_doffset=float((bf16_out["offset_1"]
                                   - f32_out["offset_1"]).abs().max()))
        base = (fps.fps, knn.knn_select, attention.fused_vector_attention_packed_x,
                attention.project_kv)
        cell = (cell_select.cell_select_x, cell_select.cell_select_p,
                attention.fused_vector_attention)
        entry = (attention.fused_vector_attention_packed, gather.onehot_gather_packed)
        # the instancing's kernels: K9 on every scan with a foreground, K10
        # where a cluster is re-split
        clus = (cluster.dbscan, cluster.mean_shift)
        launches, pipe = phase_slice(dev, ckpts, scans, work / "out", base + clus[:1],
                                     cell + entry, counted=clus[1:])
        records += phase_instancing(dev, pipe, scans)

        # the cell-attention and the bfloat16 configurations through
        # --config_path, one scan each
        pipes = {"default": pipe}
        configs = {"default": None}
        slice_launches = {}
        for name, params, kernels, unused in (
                ("cell", {"cell_attention": True}, base + cell + clus[:1], entry),
                ("bf16", {"dtype": "bfloat16"}, base + clus[:1], cell + entry)):
            one_dir = work / f"scans_{name}"
            one_dir.mkdir()
            (one_dir / scans[0].name).write_bytes(scans[0].read_bytes())
            cfg = tgnet_fps_config()
            cfg["model_parameter"].update(params)
            configs[name] = cfg
            cfg_path = work / f"{name}_config.json"
            cfg_path.write_text(json.dumps(cfg))
            slice_launches[name], pipes[name] = phase_slice(
                dev, ckpts, [one_dir / scans[0].name], work / f"out_{name}",
                kernels, unused, config=cfg_path, what=f"{name}_slice",
                counted=clus[1:])
        phase_ab(pipes, scans[0])
        boundary = phase_device_boundary(dev, pipes, configs, scans, records,
                                         base + cell + entry + clus)
        entry_launches = phase_entries(dev, feats0)
        phase_serve_many(pipes, work, base + cell + entry + clus)
        train = phase_train(dev, work, ckpts, scans[0])
        workflow = phase_workflow(dev, work, ckpts)
        families = phase_families(dev, work, scans[1])
        family_train = phase_family_train(dev, work,
                                          work / "families_scan" / scans[1].name)
        parallel = phase_parallel(dev, work)
        ps_launches, ps_summaries = phase_point_sharded_train(dev, work)
        parallel.update(ps_launches)

    # each kernel's count from the run of its own path: K1-K3 and K9-K10
    # from the default slice, K4-K6 from the cell-attention slice, K7-K8
    # from the entries that call them
    for rec, k in zip(records, base + cell + entry + clus, strict=True):
        name = k.__name__
        rec.entry["launches"] = (launches if k in base + clus else slice_launches["cell"]
                                 if k in cell else entry_launches)[name]
        # each configuration's main-path run: launches a scan
        rec.entry["slice_launches_per_scan"] = {
            "default": launches.get(name, 0) / len(scans),
            **{config: seen.get(name, 0) for config, seen in slice_launches.items()}}
        # training (phase 10): K1-K3 a train step and a val scan
        rec.entry["train_launches_per_step"] = train["per_train_step"].get(name, 0)
        rec.entry["val_launches_per_scan"] = train["per_val_scan"].get(name, 0)
        # the workflow (phase 11): a tgnet_bdl train step, its val scan and
        # the host stage's uncached case (frozen fps model + resample)
        rec.entry["bdl_launches_per_step"] = workflow["per_bdl_step"].get(name, 0)
        rec.entry["bdl_val_launches_per_scan"] = workflow["per_bdl_val_scan"].get(name, 0)
        rec.entry["host_stage_launches_per_case"] = workflow["per_host_stage_case"].get(
            name, 0)
        # the families (phase 12): each family's launches a scan
        rec.entry["family_launches_per_scan"] = {
            family: seen.get(name, 0) for family, seen in families.items()}
        # the families' training (phase 13): each family's launches a step
        rec.entry["family_train_launches_per_step"] = {
            family: seen.get(name, 0) for family, seen in family_train.items()}
        # the device boundary route (phase 7b): a scan's launches
        rec.entry["device_boundary_launches_per_scan"] = {
            config: seen.get(name, 0) for config, seen in boundary.items()}
        # the parallel layer (phases 14-16): a rank's launches in a
        # data-parallel tgnet_fps step, in the point-sharded forward and in
        # the point-sharded step of each task of phase 16
        for key, seen in parallel.items():
            rec.entry[key] = seen.get(name, 0)
    # each K3 shape with its launches a scan, per configuration
    for row in records[2].entry["shapes"]:
        row["launches_per_scan"] = {what: seen.get(row["shape"], 0)
                                    for what, seen in SCAN_K3_SHAPES.items()}
    print(json.dumps({"kernels": [r.entry for r in records]}))
    _ps_lines(ps_summaries)
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
