"""Fixtures of the benchmark's CPU tests: a copy of the benchmark at tiny
sizes beside the program, and a runner of one cell in a subprocess there."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
PROGRAM = "toothgroupnetwork_tpu_torch"

# tiny sizes of every configuration and traffic mix (the widths too: these
# copies only exercise the harness on the CPU)
TINY_CONFIG = {
    "tgnet": {"model_parameter": {"planes": [8, 16, 16, 32, 32], "blocks": [2, 2, 2, 2, 2],
                                  "nsample": [8, 8, 8, 8, 8], "crop_sample_size": 512},
              "bdl_arch": {"planes": [8, 8], "stride": [1, 1], "nsample": [8, 8],
                           "blocks": [2, 2], "block_num": 2},
              "n_sample": 1024, "crop_sample_size": 512,
              "boundary_info": {"bdl_ratio": 0.7, "num_of_bdl_points": 800,
                                "num_of_all_points": 1024}},
    "dgcnn": {"n_points": 600},
}
TINY_WORKLOAD = {
    "tgnet.serve": {"meshes": [[60, 30, 12, "upper"], [62, 30, 14, "lower"],
                               [64, 30, 16, "upper"]],
                    "scans_per_call": 4, "workers": 2, "prep_workers": 1, "fit_meshes": 2},
    "dgcnn.train": {"cases": [[40, 20, 12, "upper"], [42, 20, 14, "lower"],
                              [44, 20, 16, "upper"], [40, 22, 12, "lower"]]},
}

RUNNER = """
import json, sys, tempfile, time
from pathlib import Path
root = Path(sys.argv[1])
sys.path[:0] = [str(root / "benchmark"), str(root)]
if __name__ == "__main__":
    t0 = time.perf_counter()
    import harness
    harness.cache_env(root)
    faults = frozenset(f for f in sys.argv[4].split(",") if f)
    with tempfile.TemporaryDirectory() as tmp:
        out = harness.run_cell(harness.Bench(root), sys.argv[2], 1234567890123, 1.0,
                               sys.argv[3] == "1", "cpu", Path(tmp), t0, faults,
                               "control" in sys.argv[5:])
    print(json.dumps({"result": out, "modules": sorted(sys.modules)}))
"""


def merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = merge(base[k], v) if isinstance(v, dict) and isinstance(base.get(k), dict) \
            else v
    return out


def make_copy(dest: Path, with_program: bool = True) -> Path:
    """``BENCHMARK.json`` and ``benchmark/`` in ``dest``, shrunk to tiny
    sizes, with the program linked beside them."""
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(BENCH, dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, over in TINY_CONFIG.items():
        path = dest / "benchmark" / "configs" / f"{name}.json"
        path.write_text(json.dumps(merge(json.loads(path.read_text()), over)))
    for name, over in TINY_WORKLOAD.items():
        path = dest / "benchmark" / "workloads" / f"{name}.json"
        path.write_text(json.dumps(merge(json.loads(path.read_text()), over)))
    if with_program:
        os.symlink(ROOT / PROGRAM, dest / PROGRAM)
    return dest


@pytest.fixture
def tiny(tmp_path) -> Path:
    return make_copy(tmp_path)


def run_cell(root: Path, cell: str, trace: bool = False, faults=(), control=False) -> dict:
    """One tiny CPU run of ``cell`` in a subprocess: ``{"result": the result
    line's dict, "modules": the modules loaded}``."""
    script = root / "run_tiny.py"
    script.write_text(RUNNER)
    args = [sys.executable, str(script), str(root), cell, "1" if trace else "0",
            ",".join(faults)] + (["control"] if control else [])
    proc = subprocess.run(args, capture_output=True, text=True, timeout=600, cwd=root,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])
