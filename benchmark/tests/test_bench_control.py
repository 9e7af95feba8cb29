"""What decides ``correct``, shown to fail: the control (the plain
reference in the program's place, its matrix products on TF32 operands)
and the faults each cell can have, planted in the timed path, each come
out as not correct, while the program comes out correct."""

from __future__ import annotations

import pytest

from conftest import run_cell


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
