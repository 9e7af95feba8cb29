"""In-turn comparison of two checkouts of the PyTorch port on one card.

    python3 tools/torch_scan_ab.py --other DIR [--config JSON] [--steady 3]

Writes random full-width fps + bdl weights (``save_npz``) and three synthetic
100489-vertex scans, then runs the default inference pipeline of this
checkout ("this") and of the checkout at DIR ("other") in separate
processes, in the order other, this, this, other. Each process serves the
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

# one process: serve the scans once, then the first scan again, timed
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="root of the other checkout")
    ap.add_argument("--config", default="", help="model_parameter config as JSON")
    ap.add_argument("--steady", type=int, default=3)
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
        ckpts = chip_smoke.make_weights(work)
        scans = []
        for s, jaw in enumerate(("lower", "upper", "lower")):
            scans.append(work / f"scan{s}_{jaw}.obj")
            write_synthetic_obj(str(scans[-1]), n_side=chip_smoke.N_SIDE, seed=s)
        runs = []
        for i, name in enumerate(("other", "this", "this", "other")):
            out = work / f"run{i}.json"
            subprocess.run([sys.executable, "-c", RUNNER, str(ckpts["fps"]),
                            str(ckpts["bdl"]), args.config, str(args.steady),
                            str(out), json.dumps(chip_smoke.ATTENTION_SHAPES),
                            *map(str, scans)],
                           cwd=roots[name], check=True)
            res = json.loads(out.read_text())
            runs.append((name, res))
            print(json.dumps({"run": i, "checkout": name, "calls": res["calls"],
                              "k3_ms": res["k3_ms"], "k1_ms": res["k1_ms"],
                              "k2_ms": res["k2_ms"], "card": smi}), flush=True)
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
