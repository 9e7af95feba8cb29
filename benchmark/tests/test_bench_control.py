"""What decides ``correct``, shown to fail: the control (the plain
reference in the program's place, its matrix products on TF32 operands)
and the faults each cell can have, planted in the timed path, each come
out as not correct, while the program comes out correct."""

from __future__ import annotations

import json

import pytest

from conftest import run_cell

# the tgnet_fps and pointtransformer presets' optimizer
SGD = {"name": "sgd", "momentum": 0.9, "lr": 0.1, "weight_decay": 1e-4}


@pytest.mark.parametrize("cell", ["tgnet.serve", "dgcnn.train"])
def test_control_fails(tiny, cell):
    out = run_cell(tiny, cell, control=True)["result"]
    assert out["correct"] is True
    assert out["control"]["correct"] is False, out["control"]
    held = out["control"]["checks"]
    assert {k: c["limit"] for k, c in held.items()} == \
        {k: c["limit"] for k, c in out["checks"].items()}
    assert [k for k, c in held.items() if c["value"] > c["limit"]], held


@pytest.mark.parametrize("cell, fault", [
    ("tgnet.serve", "alter_answer"),      # an answer altered where it is produced
    ("dgcnn.train", "unchanged_state"),   # a step that returns its state unchanged
    ("dgcnn.train", "half_batch"),        # half of the batch's points left out
])
def test_fault_fails(tiny, cell, fault):
    out = run_cell(tiny, cell, faults=[fault])["result"]
    assert out["correct"] is False, out["checks"]


def test_window_steps_are_followed(tiny):
    """A step broken only once set-up has ended fails the window's numbers
    and leaves set-up's alone."""
    out = run_cell(tiny, "dgcnn.train", faults=["window_unchanged_state"])["result"]
    checks = out["checks"]
    assert out["correct"] is False
    assert all(c["value"] <= c["limit"] for k, c in checks.items()
               if not k.startswith("window_")), checks
    assert any(c["value"] > c["limit"] for k, c in checks.items()
               if k.startswith("window_")), checks


@pytest.mark.parametrize("fault", [None, "unchanged_state", "window_unchanged_state",
                                   "half_batch"])
def test_sgd_route(tiny, fault):
    """The DGCNN cell under SGD with momentum: correct, and each fault not
    correct, through the same check."""
    path = tiny / "benchmark" / "configs" / "dgcnn.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()), optimizer=SGD)))
    out = run_cell(tiny, "dgcnn.train", faults=[fault] if fault else [])["result"]
    assert out["correct"] is (fault is None), out["checks"]
