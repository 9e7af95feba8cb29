"""Smoke run of the PyTorch + CUDA port (toothgroupnetwork_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA Hopper card and
the CUDA toolkit. It exits non-zero, before printing any result, when there
is no CUDA device or when the port is not beside it. Phases, one line each
(any failure raises and ends the run with a non-zero code):

  1. environment: the card's name and power limit (nvidia-smi), versions;
  2. build: nvcc compiles csrc/*.cu into build/kernels/ (keyed by a hash);
  3. each hand-written kernel against its plain PyTorch version on the card,
     at the shapes the inference path gives it, with CUDA-event times;
  4. full-width fps model, stage 1 over a 24000-point cloud: the kernels on
     the card against the same port on the CPU (plain versions);
  5. the slice: random full-width fps + bdl weights (``save_npz``), three
     synthetic ~100k-vertex scans through ``cli.infer.main`` on the card,
     challenge JSON checked, a repeated scan identical, every kernel launched;
     one more call under torch.profiler gives the device's busy share.

Then one JSON line of the kernels, the nvidia-smi line again, and last the
line ``{"ok": true, "device": {...}}``.
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
N_POINTS = 24000          # the fps model's input cloud
N_SIDE = 317              # synthetic scans of 317^2 = 100489 vertices


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields, default=float), flush=True)


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
            got = attention.fused_vector_attention(x, p, idx, q, params)
            ref = attention.fused_vector_attention_reference(x, p, idx, q, params)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            if not err <= 1e-4:
                raise AssertionError(f"K3 attention B{b}/N{n}/K{kk}/C{c}: "
                                     f"max abs diff {err}")
            rec_att.add(f"B{b}/N{n}/K{kk}/C{c}", err,
                        cuda_ms(lambda: attention.fused_vector_attention(
                            x, p, idx, q, params), 5),
                        cuda_ms(lambda: attention.fused_vector_attention_reference(
                            x, p, idx, q, params), 3))
    return [rec_fps, rec_knn, rec_att]


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


def phase_model(dev, ckpt: Path, feats: np.ndarray):
    """Stage 1 of the full-width fps model on the card (kernels) against the
    CPU (plain versions), on N_POINTS FPS points of a scan's vertices."""
    from toothgroupnetwork_tpu_torch.models.tasks import (build_tgnet_fps,
                                                          tgnet_fps_config)
    from toothgroupnetwork_tpu_torch.ops import farthest_point_sample
    from toothgroupnetwork_tpu_torch.utils.weights import load_npz

    src = torch.from_numpy(feats).to(dev)
    idx = farthest_point_sample(src[:, :3], N_POINTS).long()
    feat = src[idx][None]
    outs = {}
    for name, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        model = load_npz(str(ckpt), build_tgnet_fps(tgnet_fps_config(),
                                                    device=d)).eval()
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = model.stage1(feat.to(d))
        if d.type == "cuda":
            torch.cuda.synchronize()
        outs[name] = ({k: v.float().cpu() for k, v in out.items()},
                      time.perf_counter() - t0)
    (gpu, t_gpu), (cpu, t_cpu) = outs["cuda"], outs["cpu"]
    for key, val in gpu.items():
        if not torch.isfinite(val).all():
            raise AssertionError(f"stage1 {key}: non-finite values on the card")
    agree = float((gpu["sem_1"].argmax(-1) == cpu["sem_1"].argmax(-1))
                  .float().mean())
    d_off = float((gpu["offset_1"] - cpu["offset_1"]).abs().max())
    d_sem = float((gpu["sem_1"] - cpu["sem_1"]).abs().max())
    log("model", what=f"fps stage1 {N_POINTS} pts, card vs CPU port",
        argmax_agreement=agree, max_abs_doffset=d_off, max_abs_dlogit=d_sem,
        first_call_s_cuda=t_gpu, s_cpu=t_cpu)
    if agree < 0.999:
        raise AssertionError(f"stage1 argmax agreement {agree} < 0.999")


def phase_slice(dev, ckpts, scans, out_dir: Path, kernels):
    """The CLI over the scans on the card; returns the launch counts."""
    from toothgroupnetwork_tpu_torch.cli import infer
    from toothgroupnetwork_tpu_torch.pipelines import ScanSegmentation

    argv = ["--input_dir_path", str(scans[0].parent), "--save_path", str(out_dir),
            "--model_name", "tgnet", "--checkpoint_path", str(ckpts["fps"]),
            "--checkpoint_path_bdl", str(ckpts["bdl"]), "--device", str(dev)]
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipeline = infer.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    log("slice", scans=len(scans), wall_s=wall, scans_per_s=len(scans) / wall,
        launches=launches, last_scan_timings_s=dict(pipeline.timings))
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the slice")

    for scan in scans:
        res = json.loads((out_dir / (scan.stem + ".json")).read_text())
        n_vert = sum(1 for line in scan.open() if line.startswith("v "))
        labels, ins = res["labels"], res["instances"]
        if not (len(labels) == len(ins) == n_vert):
            raise AssertionError(f"{scan.name}: {len(labels)} labels, {len(ins)} "
                                 f"instances for {n_vert} vertices")
        if not set(labels) <= FDI or min(ins) < 0:
            raise AssertionError(f"{scan.name}: labels outside the FDI set")
        log("scan", name=scan.name, vertices=n_vert,
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
    log("repeat", scan=scans[0].name, identical=True, wall_s=again_s,
        timings_s=dict(pipeline.timings))
    profile_call(pipeline, scans[0])
    return launches


def profile_call(pipeline, scan: Path) -> None:
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
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    log("profile", wall_s=wall, device_busy_s=busy, busy_share=busy / wall,
        device_s_by_kernel={name[:48]: t for name, (t, _) in top},
        launches_by_kernel={name[:48]: n for name, (_, n) in top})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path[:0] = [str(REPO), str(REPO / "tests")]
    from synthetic import write_synthetic_obj

    from toothgroupnetwork_tpu_torch.ops.kernels import attention, build, fps, knn
    from toothgroupnetwork_tpu_torch.pipelines.tgn import use_full_fp32

    use_full_fp32()
    dev = card()
    smi = smi_line()
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
        phase_model(dev, ckpts["fps"], vertex_feats(*meshes[0]))
        launches = phase_slice(dev, ckpts, scans, work / "out",
                               [fps.fps, knn.knn_select,
                                attention.fused_vector_attention])

    for rec, fn in zip(records, ("fps", "knn_select", "fused_vector_attention")):
        rec.entry["launches"] = launches[fn]
    print(json.dumps({"kernels": [r.entry for r in records]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
