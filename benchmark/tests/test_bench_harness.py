"""The harness on the CPU: cells, configurations, traffic kinds and metrics
found by name from files; a cell added as files and entries alone; the
command refusing to run without a card or without the program; the
result line's keys."""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from conftest import BENCH, ROOT, make_copy, run_cell

sys.path.insert(0, str(BENCH))

import harness  # noqa: E402

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_everything_named_is_found():
    bench = harness.Bench(ROOT)
    for cell, spec in bench.cells.items():
        assert spec["traffic"] == cell and spec["chips"] == 1
        wl = bench.workload(cell)
        assert hasattr(bench.traffic(wl["kind"]), "Traffic")
        assert bench.config(cell)
        for group in ("end_to_end", "per_layer"):
            assert bench.metrics_of(cell, group)
        for m in bench.metrics_of(cell, "per_layer"):
            assert callable(bench.reader(m["name"]).read)
    for m in bench.spec["per_layer"]:
        assert m["moves"] in {e["name"] for e in bench.spec["end_to_end"]}
        for cell in m["workloads"]:
            e2e = next(e for e in bench.spec["end_to_end"] if e["name"] == m["moves"])
            assert cell in e2e.get("workloads", [cell])


def test_benchmark_json_names():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = ([c["name"] for c in spec["configs"]] + [w["name"] for w in spec["workloads"]]
             + [m["name"] for m in spec["end_to_end"] + spec["per_layer"]])
    assert len(names) == len(set(names))
    for n in names:
        assert n[0].isalnum() or n[0] == "_"
        assert all(ch.isalnum() or ch in "_.-" for ch in n) and len(n) <= 64
    for c in spec["configs"]:
        assert (ROOT / c["file"]).exists()


@pytest.mark.parametrize("cell, trace", [("tgnet.serve", False), ("tgnet.serve", True),
                                         ("dgcnn.train", False), ("dgcnn.train", True)])
def test_result_keys(tiny, cell, trace):
    out = run_cell(tiny, cell, trace=trace)["result"]
    keys = list(out)
    assert keys[:5] == RESULT_KEYS and keys[-1] == "checks"
    assert set(keys) == set(RESULT_KEYS) | {"checks"} | ({"breakdown"} if trace else set())
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    bench = harness.Bench(tiny)
    group = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in bench.metrics_of(cell, group)}
    assert set(out["metrics"]) <= want
    if not trace:
        assert set(out["metrics"]) == want
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


def digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts
            and p.name != "run_tiny.py"}


def test_cell_added_by_files_alone(tiny):
    """A new traffic mix of an existing kind: one workload file and one
    entry in BENCHMARK.json; no file of the benchmark is edited."""
    before = digest(tiny / "benchmark")
    wl = json.loads((tiny / "benchmark" / "workloads" / "tgnet.serve.json").read_text())
    wl.update(meshes=[[70, 30, 14, "lower"], [72, 30, 16, "upper"]], scans_per_call=2)
    (tiny / "benchmark" / "workloads" / "tgnet.serve_two.json").write_text(json.dumps(wl))
    spec = json.loads((tiny / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "tgnet.serve_two", "config": "tgnet",
                              "traffic": "tgnet.serve_two", "chips": 1,
                              "why": "two larger scans a call"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "tgnet.serve" in m.get("workloads", []):
            m["workloads"].append("tgnet.serve_two")
    (tiny / "BENCHMARK.json").write_text(json.dumps(spec))
    out = run_cell(tiny, "tgnet.serve_two")["result"]
    assert out["correct"] is True and set(out["metrics"]) == {"scans_per_s", "setup_s"}
    after = digest(tiny / "benchmark")
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {"workloads/tgnet.serve_two.json"}


@pytest.mark.parametrize("trace", [False, True])
def test_training_cell_of_another_task_by_files_alone(tiny, trace):
    """A training cell of a second task, pointnet: its configuration, its
    traffic mix and its reference module (``pointnet_reference.py`` beside
    this test) as new files, its entries appended to BENCHMARK.json; no
    file of the benchmark is edited, and the kind finds the task's
    reference and yardstick by its name."""
    bench = tiny / "benchmark"
    before = digest(bench)
    cfg = json.loads((bench / "configs" / "dgcnn.json").read_text())
    del cfg["emb_dims"]
    cfg.update(model_name="pointnet", model_parameter={"scale": 1})
    (bench / "configs" / "pointnet.json").write_text(json.dumps(cfg))
    wl = json.loads((bench / "workloads" / "dgcnn.train.json").read_text())
    wl["model"] = "pointnet"
    (bench / "workloads" / "pointnet.train.json").write_text(json.dumps(wl))
    shutil.copy(Path(__file__).with_name("pointnet_reference.py"),
                bench / "reference" / "pointnet.py")
    spec = json.loads((tiny / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "pointnet", "source": "https://arxiv.org/abs/1612.00593",
                            "file": "benchmark/configs/pointnet.json",
                            "reduced": ["model_parameter"], "why": "a second trained task"})
    spec["workloads"].append({"name": "pointnet.train", "config": "pointnet",
                              "traffic": "pointnet.train", "chips": 1,
                              "why": "Trainer.train_epoch over the arch cases"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "dgcnn.train" in m.get("workloads", []):
            m["workloads"].append("pointnet.train")
    (tiny / "BENCHMARK.json").write_text(json.dumps(spec))
    out = run_cell(tiny, "pointnet.train", trace=trace)["result"]
    assert out["correct"] is True, out["checks"]
    if trace:
        # its FLOPs read from its own module; no kernel of its step has a bound
        assert "train.mfu" in out["metrics"] and "k2_roofline" not in out["metrics"]
    else:
        assert set(out["metrics"]) == {"train_clouds_per_s", "setup_s"}
    after = digest(bench)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {"configs/pointnet.json",
                                        "workloads/pointnet.train.json",
                                        "reference/pointnet.py"}


def test_fitted_weights_kept_in_the_checkout(tiny):
    """tgnet's fitted weights are made by a checkout's first run and read
    by the next from ``build/bench_weights``."""
    first = run_cell(tiny, "tgnet.serve")["result"]
    kept = {p: p.stat().st_mtime_ns for p in (tiny / "build" / "bench_weights").iterdir()}
    assert sorted(p.name.rsplit(".", 2)[1] for p in kept) == ["bdl", "fps"]
    second = run_cell(tiny, "tgnet.serve")["result"]
    assert {p: p.stat().st_mtime_ns for p in kept} == kept
    assert first["correct"] is second["correct"] is True


def cli(root: Path, *extra_env):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", **dict(extra_env)}
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "dgcnn.train",
                           "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=300, cwd=root, env=env)


def test_cli_refuses_without_a_card():
    proc = cli(ROOT)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "CUDA" in proc.stderr


def test_cli_refuses_without_the_program(tmp_path):
    make_copy(tmp_path, with_program=False)
    proc = cli(tmp_path)
    assert proc.returncode != 0 and proc.stdout == ""


@pytest.mark.cuda
def test_cli_on_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "dgcnn.train",
                           "--seed", "3000000001", "--seconds", "3", "--trace", "0"],
                          capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert list(out)[:5] == RESULT_KEYS and out["correct"] is True
    assert out["device"]["platform"] == "gpu"
