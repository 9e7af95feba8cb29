"""Smoke run of the PyTorch + CUDA port (toothgroupnetwork_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA Hopper card and
the CUDA toolkit. It exits non-zero, before printing any result, when there
is no CUDA device or when the port is not beside it. Phases, one line each
(any failure raises and ends the run with a non-zero code):

  1. environment: the card's name and power limit (nvidia-smi), versions;
  2. build: nvcc compiles csrc/*.cu into build/kernels/ (keyed by a hash);
  3. each hand-written kernel against its plain PyTorch version on the card,
     at the shapes the inference path gives it, with CUDA-event times (the
     cell-attention kernels K4/K5/K6 on a spatially sorted 24000-point sheet);
  4. full-width fps model, stage 1 over a 24000-point cloud: the kernels on
     the card against the same port on the CPU (plain versions), once on the
     default path and once with ``cell_attention`` on the sorted cloud;
  5. the slice: random full-width fps + bdl weights (``save_npz``), three
     synthetic ~100k-vertex scans through ``cli.infer.main`` on the card,
     challenge JSON checked, a repeated scan identical, every kernel of the
     path launched (and none of the cell path); one more call under
     torch.profiler gives the device's busy share;
  6. the cell-attention configuration: one more scan through ``cli.infer.main
     --config_path`` with ``"cell_attention": true``, the same checks, K4, K5
     and K6 launched; then steady calls of both configurations in turns.

Every log line carries the card's nvidia-smi name and power limit. Then one
JSON line of the kernels, the nvidia-smi line again, and last the line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
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
              (1, 106496, 24000, 100489))       # mesh prep, padded to 8192s
KNN_SHAPES = ((1, 24000, 24000, 36, True),      # B, M, N, k, self-query
              (16, 3072, 3072, 36, True),
              (1, 6000, 24000, 24, False))
ATTENTION_SHAPES = ((1, 24000, 36, 32),         # B, N, K, C
                    (16, 3072, 36, 32),
                    (1, 93, 24, 512))
# the cell-attention kernels: (K, C) of each attention layer on a 24000-point
# stride-1 stage (fps stage 1; bdl stages 1 and 2), 32 candidate slots (L8=256)
CELL_SHAPES = ((36, 32), (36, 16), (24, 32))
CELL_SLOTS = 32
N_POINTS = 24000          # the fps model's input cloud
N_SIDE = 317              # synthetic scans of 317^2 = 100489 vertices
CARD = {"card": None}     # the nvidia-smi line, beside every number logged


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
    """Mean milliseconds of ``fn`` on the card (CUDA events, after warm-up)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


class KernelRecord:
    """Per-kernel results over the phase-3 shapes."""

    def __init__(self, name, source, replaces):
        self.entry = {"name": name, "route": "cuda", "source": source,
                      "replaces": replaces, "launches": 0, "max_abs_err": 0.0,
                      "ms": 0.0, "plain_ms": 0.0, "shapes": []}

    def add(self, shape: str, err: float, ms: float, plain_ms: float, **extra):
        e = self.entry
        e["max_abs_err"] = max(e["max_abs_err"], float(err))
        e["ms"] += ms
        e["plain_ms"] += plain_ms
        e["shapes"].append({"shape": shape, "max_abs_err": float(err), "ms": ms,
                            "plain_ms": plain_ms, **extra})
        log("kernel", name=e["name"], shape=shape, max_abs_err=float(err),
            ms=ms, plain_ms=plain_ms, **extra)


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

    # K1: identical indices on tie-free (continuous random) inputs
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
        rec_fps.add(f"[{b},{n}]->{m}" + (f" valid {n_valid}" if n_valid else ""),
                    err, cuda_ms(lambda: fps.fps(xyz, m, valid), 3),
                    cuda_ms(lambda: fps.fps_reference(xyz, m, valid), 1))

    # K2: identical except rows with a near-tie at the k-th place
    for b, m, n, k, self_q in KNN_SHAPES:
        pts = cloud(b, n, 3)
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
        rec_knn.add(f"[{b},{m}]x[{b},{n}] k={k}", err,
                    cuda_ms(lambda: knn.knn_select(qry, pts, k), 3),
                    cuda_ms(lambda: knn.knn_select_reference(qry, pts, k), 1),
                    rows_differ=int(row_bad.sum()),
                    near_tie_rows=int(near_tie.sum()))

    # K3: max |kernel - plain| <= 1e-4 (float32, other summation order)
    for b, n, kk, c in ATTENTION_SHAPES:
        layer = PointTransformerLayer(c, device=dev)
        randomize_(layer, torch.Generator().manual_seed(c))
        p = cloud(b, n, 3, scale=0.2)
        x = cloud(b, n, c, scale=0.5)
        idx, _ = knn_self(p, kk)
        with torch.no_grad():
            params = attention.fold_attention_params(layer)
            q = layer.linear_q(x).reshape(b * n, c).contiguous()
            got = attention.fused_vector_attention_packed_x(x, p, idx, q, params)
            ref = attention.fused_vector_attention_packed_x_reference(
                x, p, idx, q, params)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            if not err <= 1e-4:
                raise AssertionError(f"K3 attention B{b}/N{n}/K{kk}/C{c}: "
                                     f"max abs diff {err}")
            rec_att.add(f"B{b}/N{n}/K{kk}/C{c}", err,
                        cuda_ms(lambda: attention.fused_vector_attention_packed_x(
                            x, p, idx, q, params), 5),
                        cuda_ms(lambda: attention
                                .fused_vector_attention_packed_x_reference(
                                    x, p, idx, q, params), 3))
    return [rec_fps, rec_knn, rec_att] + phase_cell_kernels(dev, gen, cloud)


def sorted_sheet(gen, n: int) -> np.ndarray:
    """A curved sheet of n points in spatially sorted order (ops/cells.py)."""
    from toothgroupnetwork_tpu_torch.ops.cells import spatial_sort_perm

    u = gen.uniform(-1, 1, (n, 2))
    xyz = np.stack([u[:, 0], 0.3 * u[:, 0] ** 2 + 0.2 * u[:, 1] ** 2, u[:, 1]], 1)
    xyz = (xyz + gen.normal(0, 0.01, xyz.shape)).astype(np.float32)
    return xyz[spatial_sort_perm(xyz)]


def phase_cell_kernels(dev, gen, cloud):
    """K4/K5 bit-equal and K6 within 1e-4 of their plain versions, at the
    shapes of the cell path on a 24000-point stride-1 stage."""
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
              cuda_ms(lambda: cell_select.cell_select_p_reference(blk_p, pos, p), 5))
    p_r36 = got

    for kk, c in CELL_SHAPES:
        cand, pos = ctx[kk]
        x = cloud(n, c, scale=0.5)
        blk_x = cells.gather_candidate_blocks(x, cand)
        got = cell_select.cell_select_x(blk_x, pos)
        ref = cell_select.cell_select_x_reference(blk_x, pos)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"K4 cell_select_x K{kk}/C{c} differs")
        rec_x.add(f"N{n}/K{kk}/C{c}/L8={l8}", 0.0,
                  cuda_ms(lambda: cell_select.cell_select_x(blk_x, pos), 20),
                  cuda_ms(lambda: cell_select.cell_select_x_reference(blk_x, pos), 5),
                  blk_mb=blk_x.numel() * 4 / 1e6, x_g_mb=got.numel() * 4 / 1e6)

        layer = PointTransformerLayer(c, device=dev)
        randomize_(layer, torch.Generator().manual_seed(c))
        x_g = got.reshape(n * kk, c)
        p_r = p_r36[:, :kk].reshape(n * kk, 3).contiguous()
        with torch.no_grad():
            params = attention.fold_attention_params(layer)
            q = layer.linear_q(x).contiguous()
            out = attention.fused_vector_attention(q, x_g, p_r, params, k=kk)
            ref = attention.fused_vector_attention_reference(q, x_g, p_r, params,
                                                             k=kk)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            if not err <= 1e-4:
                raise AssertionError(f"K6 attention B1/N{n}/K{kk}/C{c}: "
                                     f"max abs diff {err}")
            rec_g.add(f"B1/N{n}/K{kk}/C{c}", err,
                      cuda_ms(lambda: attention.fused_vector_attention(
                          q, x_g, p_r, params, k=kk), 5),
                      cuda_ms(lambda: attention.fused_vector_attention_reference(
                          q, x_g, p_r, params, k=kk), 3))
    return [rec_x, rec_p, rec_g]


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


def phase_model(dev, ckpt: Path, feats: np.ndarray, cell: bool = False):
    """Stage 1 of the full-width fps model on the card (kernels) against the
    CPU (plain versions), on N_POINTS FPS points of a scan's vertices; with
    ``cell`` the points are spatially sorted and the model runs the
    cell-attention path (K4/K5/K6 must launch on the card)."""
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
    cfg["model_parameter"]["cell_attention"] = cell
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
        outs[name] = ({k: v.float().cpu() for k, v in out.items()},
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
        cell_attention=cell, argmax_agreement=agree, max_abs_doffset=d_off,
        max_abs_dlogit=d_sem, first_call_s_cuda=t_gpu, s_cpu=t_cpu,
        cell_launches=launched)
    if agree < 0.999:
        raise AssertionError(f"stage1 argmax agreement {agree} < 0.999")


def phase_slice(dev, ckpts, scans, out_dir: Path, kernels, unused=(),
                config: Path | None = None, what: str = "slice"):
    """The CLI over the scans on the card; every kernel of ``kernels`` must
    launch and none of ``unused``. Returns the launch counts and the
    pipeline."""
    from toothgroupnetwork_tpu_torch.cli import infer
    from toothgroupnetwork_tpu_torch.pipelines import ScanSegmentation

    argv = ["--input_dir_path", str(scans[0].parent), "--save_path", str(out_dir),
            "--model_name", "tgnet", "--checkpoint_path", str(ckpts["fps"]),
            "--checkpoint_path_bdl", str(ckpts["bdl"]), "--device", str(dev)]
    if config is not None:
        argv += ["--config_path", str(config)]
    for k in (*kernels, *unused):
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipeline = infer.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in (*kernels, *unused)}
    log(what, scans=len(scans), wall_s=wall, scans_per_s=len(scans) / wall,
        launches=launches, last_scan_timings_s=dict(pipeline.timings))
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
    profile_call(pipeline, scans[0], what)
    return launches, pipeline


def phase_ab(pipes: dict, scan: Path, rounds: int = 2) -> None:
    """Steady calls of the default and the cell-attention pipeline on one
    scan, in turns (default, cell, cell, default per round): wall and
    per-phase seconds of each call, so the two configurations are compared
    on one card within one run."""
    samples = {name: [] for name in pipes}
    for name in ("default", "cell", "cell", "default") * rounds:
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


def profile_call(pipeline, scan: Path, what: str) -> None:
    """One more call under torch.profiler: the device's busy share (merged
    kernel intervals over the call's wall time) and device time by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipeline(str(scan))
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
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    log("profile", what=what, wall_s=wall, device_busy_s=busy,
        busy_share=busy / wall,
        device_s_by_kernel={short(name): t for name, (t, _) in top},
        launches_by_kernel={short(name): n for name, (_, n) in top})


def short(kernel_name: str) -> str:
    """A device kernel's name without namespaces and arguments, template
    arguments kept (the two attention entries differ only there)."""
    name = kernel_name.replace("(anonymous namespace)::", "").replace("void ", "")
    return name.split("(")[0][:72]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path[:0] = [str(REPO), str(REPO / "tests")]
    from synthetic import write_synthetic_obj

    from toothgroupnetwork_tpu_torch.models.tasks import tgnet_fps_config
    from toothgroupnetwork_tpu_torch.ops.kernels import (attention, build,
                                                         cell_select, fps, knn)
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
        phase_model(dev, ckpts["fps"], feats0)
        phase_model(dev, ckpts["fps"], feats0, cell=True)
        base = (fps.fps, knn.knn_select, attention.fused_vector_attention_packed_x)
        cell = (cell_select.cell_select_x, cell_select.cell_select_p,
                attention.fused_vector_attention)
        launches, pipe = phase_slice(dev, ckpts, scans, work / "out", base, cell)

        # the cell-attention configuration through --config_path
        cell_dir = work / "scans_cell"
        cell_dir.mkdir()
        cell_scan = cell_dir / scans[0].name
        cell_scan.write_bytes(scans[0].read_bytes())
        cfg = tgnet_fps_config()
        cfg["model_parameter"]["cell_attention"] = True
        cfg_path = work / "cell_config.json"
        cfg_path.write_text(json.dumps(cfg))
        cell_launches, cell_pipe = phase_slice(
            dev, ckpts, [cell_scan], work / "out_cell", base + cell,
            config=cfg_path, what="cell_slice")
        phase_ab({"default": pipe, "cell": cell_pipe}, scans[0])

    # each kernel's count from the run of its own path: K1-K3 from the
    # default slice, K4-K6 from the cell-attention slice
    for rec, k in zip(records, base + cell):
        name = k.__name__
        rec.entry["launches"] = (launches if k in base else cell_launches)[name]
    print(json.dumps({"kernels": [r.entry for r in records]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
