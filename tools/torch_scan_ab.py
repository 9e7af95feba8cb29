"""In-turn comparison of two checkouts of the PyTorch port on one card.

    python3 tools/torch_scan_ab.py --other DIR [--config JSON] [--steady 3]
    python3 tools/torch_scan_ab.py --other DIR --family dgcnn [--steady 5] [--steps 6]

Runs one process in this checkout ("this") and one in the checkout at DIR
("other") in the order other, this, this, other, on the same seeded inputs.

The default family, tgnet: Writes random full-width fps + bdl weights (``save_npz``) and three synthetic
100489-vertex scans, then runs the default inference pipeline. Each process serves the
three scans once, then the first scan ``--steady`` more times. It prints one
JSON line per process and a summary: whether every process gave the same
labels and instances on every scan, the share of vertices whose label and
instance (and whose label alone) equal those of the first process (run 0,
"other") in each later process, and the median wall and per-phase seconds of the steady calls of
each checkout, beside the card's nvidia-smi name and power limit. When the
config computes in bfloat16, each process also serves the three scans in
float32 (the same config, dtype float32), and the summary gives each
process's share of vertices equal to its own float32 outputs: how far
each checkout's bfloat16 lies from float32. Each process also times the
fused attention K3 (CUDA events, mean of 5 calls after one) at every
chip_smoke ATTENTION_SHAPES entry in float32 and bfloat16, and K1 and K2
(mean of 3 after one) at three main-path shapes each, on the same random
inputs. Needs one CUDA card; exits non-zero without one, and with 2 when a
float32 run's share falls below MIN_SHARE (bfloat16 shares are printed,
not gated: a sum in another order may round a bf16 value the other way).

``--family dgcnn``, K2's feature-space routes and the model that runs them.
Each process times ``knn_select`` at DGCNN's EdgeConv self-kNN ([1,24000]
k = 20 at C = 6 and 64, ``tgn_knn_c``) and at the three any-size shapes of
``chip_smoke.py`` phase 7b (``tgn_knn_any``): the device time of CUDA graph
replays and CUDA-event means of back-to-back calls
(``utils.profiling.chained_time``), each output ``torch.equal`` to
``knn_select_reference`` on the card; at the DGCNN shapes also
``torch.topk(torch.cdist(x, x), k, largest=False)``, a two-call yardstick
that rounds otherwise (timed only). It serves one synthetic 100489-vertex
scan through the dgcnn pipeline from random weights (the labels, a digest
of the full-width forward's logits, K2's launches by C, the steady seconds
a scan by phase, median of ``--steady`` calls) and trains dgcnn at full
width, batch 1, for ``--steps`` steps (the losses, the median seconds of
the steps after the first two). The summary gives each shape's device ms
by checkout (the median of its two processes) and the ratio other / this,
and whether every process gave the same labels, logits, launches and
losses. Exits 2 when a kernel output differs from its plain version or the
dgcnn outputs differ between processes.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
# least share of vertices equal to run 0's in a float32 configuration
MIN_SHARE = 0.999

# one tgnet process: serve the scans once, then the first scan again, timed
RUNNER = r"""
import json, sys, time
import torch
sys.path.insert(0, ".")
from toothgroupnetwork_tpu_torch.pipelines.tgn import TgnInferencePipeline

fps, bdl, config, steady, out, shapes, *scans = sys.argv[1:]
config = json.loads(config) if config else None
pipe = TgnInferencePipeline(fps, bdl, config, device="cuda")
res = {"outputs": [], "calls": []}
for s in scans:
    r = pipe(s)
    res["outputs"].append([r["sem"].tolist(), r["ins"].tolist()])
for _ in range(int(steady)):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe(scans[0])
    torch.cuda.synchronize()
    res["calls"].append({"wall_s": time.perf_counter() - t0, **pipe.timings})
if config and config.get("model_parameter", {}).get("dtype") == "bfloat16":
    f32 = json.loads(json.dumps(config))
    f32["model_parameter"]["dtype"] = "float32"
    pipe = TgnInferencePipeline(fps, bdl, f32, device="cuda")
    res["outputs_f32"] = [[r["sem"].tolist(), r["ins"].tolist()]
                          for r in map(pipe, scans)]

from toothgroupnetwork_tpu_torch.models.point_transformer.backbone import (
    PointTransformerLayer)
from toothgroupnetwork_tpu_torch.ops import knn_self
from toothgroupnetwork_tpu_torch.ops.kernels import attention, fps, knn
from toothgroupnetwork_tpu_torch.utils.weights import randomize_


def ms(call, reps):
    call()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(reps):
        call()
    ev[1].record()
    ev[1].synchronize()
    return ev[0].elapsed_time(ev[1]) / reps


res["k3_ms"], res["k1_ms"], res["k2_ms"] = {}, {}, {}
gen = torch.Generator().manual_seed(0)
for b, n, kk, c in json.loads(shapes):
    layer = randomize_(PointTransformerLayer(c, device="cuda"), gen)
    p = (torch.randn((b, n, 3), generator=gen) * 0.2).cuda()
    x32 = (torch.randn((b, n, c), generator=gen) * 0.5).cuda()
    idx, _ = knn_self(p, kk)
    for dtype in (torch.float32, torch.bfloat16):
        x = x32.to(dtype)
        with torch.no_grad():
            params = attention.fold_attention_params(layer, dtype)
            q = layer.linear_q(x32).reshape(b * n, c).to(dtype).contiguous()
            tag = " bf16" if dtype == torch.bfloat16 else ""
            res["k3_ms"][f"B{b}/N{n}/K{kk}/C{c}{tag}"] = ms(
                lambda: attention.fused_vector_attention_packed_x(x, p, idx, q, params), 5)
for b, n, m in ((1, 100489, 24000), (1, 24000, 6000), (16, 3072, 768)):
    p = torch.randn((b, n, 3), generator=gen).cuda()
    res["k1_ms"][f"[{b},{n}]->{m}"] = ms(lambda: fps.fps(p, m), 3)
for b, m, n, kk in ((1, 24000, 24000, 36), (16, 3072, 3072, 36), (1, 6000, 24000, 24)):
    p = torch.randn((b, n, 3), generator=gen).cuda()
    q = p if m == n else torch.randn((b, m, 3), generator=gen).cuda()
    res["k2_ms"][f"[{b},{m}]x[{b},{n}] k={kk}"] = ms(lambda: knn.knn_select(q, p, kk), 3)
json.dump(res, open(out, "w"))
"""

# one dgcnn process: K2's feature-space shapes, a served scan, train steps
DGCNN_RUNNER = r"""
import hashlib, json, os, sys, time
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
import numpy as np
import torch
sys.path.insert(0, ".")
from toothgroupnetwork_tpu_torch.ops.kernels import knn
from toothgroupnetwork_tpu_torch.pipelines.maker import make_inference_pipeline
from toothgroupnetwork_tpu_torch.utils.profiling import chained_time

ckpt, steady, out, steps, scan = sys.argv[1:]
dev = torch.device("cuda", 0)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
res = {"kernels": []}
gen = np.random.default_rng(0)


def cloud(*shape):
    return torch.from_numpy(gen.standard_normal(shape).astype(np.float32)).to(dev)


# (B, M, N, C, k, self-query)
SHAPES = ((1, 24000, 24000, 6, 20, True), (1, 24000, 24000, 64, 20, True),
          (1, 3000, 3000, 3, 65, False), (1, 3000, 3000, 300, 20, False),
          (2, 700, 3000, 300, 65, False))
for b, m, n, c, k, self_q in SHAPES:
    p = cloud(b, n, c)
    q = p if self_q else cloud(b, m, c)
    gi, gd = knn.knn_select(q, p, k)
    ri, rd = knn.knn_select_reference(q, p, k)
    torch.cuda.synchronize()
    row = {"shape": f"[{b},{m}]x[{b},{n}] C={c} k={k}", "route": knn.knn_route(c, k),
           "identical": bool(torch.equal(gi, ri) and torch.equal(gd, rd)),
           "device_ms": chained_time(lambda: knn.knn_select(q, p, k), iters=10,
                                     graph=True, device=dev) * 1e3,
           "ms": chained_time(lambda: knn.knn_select(q, p, k), iters=5, device=dev) * 1e3}
    if self_q:
        row["library_ms"] = chained_time(
            lambda: torch.topk(torch.cdist(q, p), k, largest=False), iters=3,
            device=dev) * 1e3
    res["kernels"].append(row)
    del p, q, gi, gd, ri, rd
    torch.cuda.empty_cache()

pipe = make_inference_pipeline("dgcnn", [ckpt], None, device=dev)
knn.knn_select.launches_by_shape.clear()
r = pipe(scan)
res["dgcnn_knn_by_c"] = {str(c): v for c, v in knn.knn_select.launches_by_shape.items()}
res["dgcnn_labels_sha"] = hashlib.sha256(np.asarray(r["sem"]).tobytes()).hexdigest()
res["dgcnn_labels"] = sorted(set(np.asarray(r["sem"]).tolist()))
feats = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 24000, 6))
                         .astype(np.float32)).to(dev)
with torch.inference_mode():
    logits = pipe.model(feats, None)["cls_pred"]
res["dgcnn_logits_sha"] = hashlib.sha256(logits.cpu().numpy().tobytes()).hexdigest()
calls = []
for _ in range(int(steady)):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe(scan)
    torch.cuda.synchronize()
    calls.append({"wall_s": time.perf_counter() - t0, **pipe.timings})
res["dgcnn_scan_median_s"] = {key: float(np.median([c[key] for c in calls]))
                              for key in calls[0]}
del pipe

from toothgroupnetwork_tpu_torch.models import get_task
from toothgroupnetwork_tpu_torch.train import make_optimizer, train_step
from toothgroupnetwork_tpu_torch.train.trainer import dropout_seed
from toothgroupnetwork_tpu_torch.utils.weights import init_like_flax_

task = get_task("dgcnn")
cfg = task.default_config()
model = task.build_module(cfg, device="cpu")
init_like_flax_(model, torch.Generator().manual_seed(cfg.seed))
state = model.state_dict()
model = task.build_module(cfg, device=dev)
model.load_state_dict(state)
opt = make_optimizer(cfg.optimizer, model.parameters())
bgen = np.random.default_rng(2)
batch = {"feat": torch.from_numpy(bgen.standard_normal((1, 24000, 6)).astype(np.float32)),
         "gt_seg_label": torch.from_numpy(bgen.integers(-1, 16, (1, 24000)).astype(np.int32)),
         "mask": torch.ones((1, 24000), dtype=torch.bool)}
batch = {key: v.to(dev) for key, v in batch.items()}
losses, secs = [], []
for step in range(int(steps)):
    g = torch.Generator(device=dev).manual_seed(dropout_seed(cfg.seed, step))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vals = train_step(model, opt, task, cfg, batch, True, g)
    torch.cuda.synchronize()
    secs.append(time.perf_counter() - t0)
    losses.append({key: float(v) for key, v in vals.items()})
res["dgcnn_train_losses"] = losses
res["dgcnn_train_step_median_s"] = float(np.median(secs[2:]))
with open(out, "w") as f:
    json.dump(res, f)
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="root of the other checkout")
    ap.add_argument("--family", default="tgnet", choices=("tgnet", "dgcnn"))
    ap.add_argument("--config", default="", help="tgnet: model_parameter config as JSON")
    ap.add_argument("--steady", type=int, default=3)
    ap.add_argument("--steps", type=int, default=6, help="dgcnn: train steps")
    args = ap.parse_args()
    sys.path[:0] = [str(REPO), str(REPO / "tests")]
    import torch

    if not torch.cuda.is_available():
        print("torch_scan_ab: no CUDA device", file=sys.stderr)
        return 1
    from synthetic import write_synthetic_obj

    import chip_smoke

    smi = chip_smoke.smi_line()
    roots = {"this": REPO, "other": Path(args.other).resolve()}
    with tempfile.TemporaryDirectory(prefix="torch_scan_ab_") as tmp:
        work = Path(tmp)
        if args.family == "tgnet":
            ckpts = chip_smoke.make_weights(work)
            scans = []
            for s, jaw in enumerate(("lower", "upper", "lower")):
                scans.append(work / f"scan{s}_{jaw}.obj")
                write_synthetic_obj(str(scans[-1]), n_side=chip_smoke.N_SIDE, seed=s)
            code, argv = RUNNER, [str(ckpts["fps"]), str(ckpts["bdl"]), args.config,
                                  str(args.steady)]
            tail = [json.dumps(chip_smoke.ATTENTION_SHAPES), *map(str, scans)]
        else:
            scans = [work / "scan_lower.obj"]
            write_synthetic_obj(str(scans[0]), n_side=chip_smoke.N_SIDE, seed=1)
            code, argv = DGCNN_RUNNER, [str(dgcnn_weights(work)), str(args.steady)]
            tail = [str(args.steps), str(scans[0])]
        runs = []
        for i, name in enumerate(("other", "this", "this", "other")):
            out = work / f"run{i}.json"
            subprocess.run([sys.executable, "-c", code, *argv, str(out), *tail],
                           cwd=roots[name], check=True)
            res = json.loads(out.read_text())
            runs.append((name, res))
            print(json.dumps({"run": i, "checkout": name, "card": smi,
                              **{k: v for k, v in res.items()
                                 if not k.startswith("outputs")}}), flush=True)
    if args.family == "dgcnn":
        summary = dgcnn_summary(runs)
        print(json.dumps({**summary, "card": smi}), flush=True)
        return 0 if summary["identical"] and all(summary["dgcnn_same"].values()) else 2
    same = all(r["outputs"] == runs[0][1]["outputs"] for _, r in runs)
    shares = [share_equal(r["outputs"], runs[0][1]["outputs"]) for _, r in runs[1:]]
    label_shares = [share_equal(r["outputs"], runs[0][1]["outputs"], labels_only=True)
                    for _, r in runs[1:]]
    medians = {}
    for name in ("other", "this"):
        calls = [c for n, r in runs if n == name for c in r["calls"]]
        medians[name] = {k: float(np.median([c[k] for c in calls]))
                         for k in calls[0]}
    summary = {"outputs_identical": same, "share_equal_to_run0": shares,
               "label_share_equal_to_run0": label_shares}
    bf16 = "outputs_f32" in runs[0][1]
    if bf16:
        summary["share_equal_to_own_float32"] = [
            share_equal(r["outputs"], r["outputs_f32"]) for _, r in runs]
        summary["label_share_equal_to_own_float32"] = [
            share_equal(r["outputs"], r["outputs_f32"], labels_only=True)
            for _, r in runs]
        summary["float32_share_equal_to_run0"] = [
            share_equal(r["outputs_f32"], runs[0][1]["outputs_f32"]) for _, r in runs[1:]]
    print(json.dumps({**summary, "median_s": medians, "config": args.config,
                      "card": smi}))
    return 0 if bf16 or min(shares) >= MIN_SHARE else 2


def dgcnn_weights(work: Path) -> Path:
    """Random full-width dgcnn weights (seeded), saved once for every
    process."""
    import torch

    from toothgroupnetwork_tpu_torch.models import get_task
    from toothgroupnetwork_tpu_torch.models.tasks import build_sem_model
    from toothgroupnetwork_tpu_torch.utils.weights import randomize_, save_npz

    mp = get_task("dgcnn").default_config().model_parameter
    model = randomize_(build_sem_model("dgcnn", mp, device="cpu"),
                       torch.Generator().manual_seed(9))
    ckpt = work / "dgcnn.npz"
    save_npz(str(ckpt), model)
    return ckpt


def dgcnn_summary(runs) -> dict:
    """Each K2 shape's medians by checkout and whether every output was
    identical to the plain version; whether every process gave the same
    dgcnn labels, logits, launches and losses; the scan and step seconds."""
    summary = {"kernels": [], "identical": True}
    for j, row in enumerate(runs[0][1]["kernels"]):
        by = {what: [r["kernels"][j] for n, r in runs if n == what]
              for what in ("other", "this")}
        entry = {"shape": row["shape"], "route": row["route"]}
        for what, rows in by.items():
            for key in ("device_ms", "ms", "library_ms"):
                if key in rows[0]:
                    entry[f"{key}_{what}"] = float(np.median([x[key] for x in rows]))
        entry["device_ratio_other_over_this"] = (entry["device_ms_other"]
                                                 / entry["device_ms_this"])
        entry["identical"] = all(x["identical"] for rows in by.values() for x in rows)
        summary["identical"] &= entry["identical"]
        summary["kernels"].append(entry)
    keys = ("dgcnn_knn_by_c", "dgcnn_labels_sha", "dgcnn_logits_sha", "dgcnn_train_losses")
    summary["dgcnn_same"] = {key: all(r[key] == runs[0][1][key] for _, r in runs)
                             for key in keys}
    for what in ("other", "this"):
        rs = [r for n, r in runs if n == what]
        summary[f"dgcnn_scan_s_{what}"] = {
            key: float(np.median([r["dgcnn_scan_median_s"][key] for r in rs]))
            for key in rs[0]["dgcnn_scan_median_s"]}
        summary[f"dgcnn_train_step_s_{what}"] = [r["dgcnn_train_step_median_s"]
                                                 for r in rs]
    summary["dgcnn_knn_by_c"] = runs[0][1]["dgcnn_knn_by_c"]
    return summary


def share_equal(outputs, ref, labels_only: bool = False) -> float:
    """Share of vertices, over all scans, whose label and instance (or
    label alone) equal those of ``ref`` (lists of [labels, instances] per
    scan)."""
    hit = total = 0
    for (sem, ins), (sem0, ins0) in zip(outputs, ref):
        same = np.asarray(sem) == np.asarray(sem0)
        if not labels_only:
            same &= np.asarray(ins) == np.asarray(ins0)
        hit += int(same.sum())
        total += same.size
    return hit / total


if __name__ == "__main__":
    sys.exit(main())
