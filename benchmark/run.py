"""The benchmark of the PyTorch and CUDA port: one cell of BENCHMARK.json.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the card(s) the cell
asks for. Set-up (weights and inputs made from ``--seed``, the program
built and warmed on every shape the traffic uses) is timed as ``setup_s``;
then the cell's traffic runs for ``--seconds``; then what the window
produced is compared with the plain reference (``reference/``). The last
line of standard output is the result as one JSON object: with ``--trace
0`` the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics
read from a profiler trace of the window. The compared numbers and their
limits are the last lines of standard error and the result's last key.

Exits non-zero, printing no result, without a CUDA card (or with fewer
than the cell asks for), without the program beside the benchmark, or when
a module of JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
PROGRAM = "toothgroupnetwork_tpu_torch"
sys.path[:0] = [str(BENCH_DIR), str(ROOT)]

import harness  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(msg: str) -> int:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    return 2


def main(argv=None) -> int:
    args = parse(argv)
    bench = harness.Bench(ROOT)
    chips = bench.cell(args.workload)["chips"]
    if not (ROOT / PROGRAM / "__init__.py").exists():
        return fail(f"the program {PROGRAM} is not beside the benchmark in {ROOT}")
    harness.cache_env(ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        return fail(f"{args.workload} needs {chips} CUDA card(s); this machine has "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    with tempfile.TemporaryDirectory(prefix="bench_") as tmp:
        out = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                               bool(args.trace), torch.device("cuda", 0), Path(tmp),
                               T_START)
    bad = harness.forbidden_modules()
    if bad:
        return fail(f"modules of JAX or the JAX package were loaded: {bad}")
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
