"""Readings behind the correctness limits of a cell, on the card: for each
seed, a run of the cell (set-up, a window of ``--seconds``, the check) whose
check also reads the control, the plain reference one precision below the
configuration's (TF32 products where the configuration states float32 with
TF32 off) put in the program's place and held to the same numbers.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 --seconds 10

``--faults`` plants faults in the timed path (the traffic kinds name them).
Prints one JSON line a seed: ``{"seed", "correct", "metrics", "program":
{number: reading}, "control_correct", "control": {number: reading}}``:
the control's readings held to the same limits as the program's, so that
``control_correct`` has to read false. The benchmark's own runs never run
this.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
sys.path[:0] = [str(BENCH_DIR), str(ROOT)]

import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--faults", default="",
                    help="comma-separated faults planted in the timed path")
    args = ap.parse_args(argv)
    harness.cache_env(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    bench = harness.Bench(ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="bench_control_") as tmp:
            out = harness.run_cell(bench, args.workload, seed, args.seconds, False,
                                   torch.device("cuda", 0), Path(tmp), t0,
                                   frozenset(f for f in args.faults.split(",") if f),
                                   control=True)
        print(json.dumps({"seed": seed, "correct": out["correct"],
                          "metrics": {k: v["value"] for k, v in out["metrics"].items()},
                          "program": {k: v["value"] for k, v in out["checks"].items()},
                          "control_correct": out["control"]["correct"],
                          "control": {k: v["value"]
                                      for k, v in out["control"]["checks"].items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
