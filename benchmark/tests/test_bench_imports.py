"""No process of a run loads JAX or the JAX package, and the plain
reference loads nothing of the program: the module names are compared by
their top-level name, the part before the first dot, whole (the program's
name begins with the JAX package's)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import BENCH, PROGRAM, run_cell

JAX_SIDE = {"jax", "jaxlib", "flax", "toothgroupnetwork_tpu"}


def tops(modules) -> set:
    return {m.split(".")[0] for m in modules}


@pytest.mark.parametrize("cell", ["tgnet.serve", "dgcnn.train"])
def test_run_loads_no_jax(tiny, cell):
    got = run_cell(tiny, cell)
    assert got["result"]["correct"] is True
    loaded = tops(got["modules"])
    assert not loaded & JAX_SIDE, sorted(loaded & JAX_SIDE)
    assert PROGRAM in loaded          # the run did drive the program


def test_harness_imports_load_no_jax():
    code = ("import sys; sys.path[:0] = [sys.argv[1]];"
            "import harness, counts, trace_reader, synthetic, weights, calibrate;"
            "import json; print(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code, str(BENCH)], capture_output=True,
                         text=True, timeout=300, check=True)
    assert not tops(json.loads(out.stdout)) & JAX_SIDE


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path[:0] = [sys.argv[1]];"
            "import reference.tgnet, reference.dgcnn, reference.ops, reference.mesh;"
            "import reference.pointtransformer, reference.clustering, reference.fusion;"
            "import reference.optim, reference.training;"
            "import json; print(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code, str(BENCH)], capture_output=True,
                         text=True, timeout=300, check=True)
    loaded = tops(json.loads(out.stdout))
    assert not loaded & (JAX_SIDE | {PROGRAM}), sorted(loaded & (JAX_SIDE | {PROGRAM}))
