"""The per-layer metrics read from the program's spans
(``toothgroupnetwork_tpu_torch/utils/profiling.py``): each reader turns a
hand-made span list into its number and reads None where there is no scan
or step span; a tiny traced run of each cell reports them all."""

from __future__ import annotations

import sys

import pytest

from conftest import BENCH, ROOT, run_cell

sys.path.insert(0, str(BENCH))

import harness  # noqa: E402
from toothgroupnetwork_tpu_torch.utils import profiling  # noqa: E402

MS = 1_000_000
SERVE = ("scan_prep.host_s_per_scan", "postprocess.cluster_s_per_scan",
         "postprocess.points_per_scan", "pipeline.card_wait_s_per_scan")
TRAIN = ("train.card_wait_ms_per_step", "train.dispatch_ms_per_step",
         "data.next_ms_per_step")


def made(name, group, start_ms, end_ms, points=None):
    s = profiling.Span(name, group, 0, start_ns=start_ms * MS)
    s.end_ns = end_ms * MS
    if points is not None:
        s.count("points", points)
    return s


def scans():
    """Two scans of one call, and spans of another scan that is not in
    the list (its ``scan`` span missing) and of a training step."""
    a, b, other = (1, 0), (1, 1), (2, 0)
    return [made("scan", a, 0, 1000), made("scan", b, 0, 1200),
            made("scan_prep", a, 0, 100), made("scan_prep", b, 0, 140),
            made("cluster", a, 300, 400, points=5000), made("cluster", a, 500, 520, points=700),
            made("cluster", b, 300, 460, points=6000),
            made("card_wait", a, 200, 230), made("card_wait", b, 200, 250),
            made("card_wait", b, 900, 910),
            made("scan_prep", other, 0, 999), made("cluster", other, 0, 999, points=9),
            made("card_wait", other, 0, 999), made("card_wait", 7, 0, 999)]


def steps():
    """Two steps, and spans of a step that is not in the list and of a
    scan."""
    return [made("step", 3, 0, 70), made("step", 4, 70, 150),
            made("data.next", 3, 0, 5), made("data.next", 4, 70, 76),
            made("step.forward", 3, 6, 30), made("card_wait", 3, 50, 62),
            made("card_wait", 4, 120, 131),
            made("data.next", 9, 0, 99), made("card_wait", 9, 0, 99),
            made("card_wait", (1, 0), 0, 99)]


WANT = {
    "scan_prep.host_s_per_scan": (scans, (0.100 + 0.140) / 2),
    "postprocess.cluster_s_per_scan": (scans, (0.100 + 0.020 + 0.160) / 2),
    "postprocess.points_per_scan": (scans, (5000 + 700 + 6000) / 2),
    "pipeline.card_wait_s_per_scan": (scans, (0.030 + 0.050 + 0.010) / 2),
    "train.card_wait_ms_per_step": (steps, (12 + 11) / 2),
    "train.dispatch_ms_per_step": (steps, (70 + 80 - 5 - 6 - 12 - 11) / 2),
    "data.next_ms_per_step": (steps, (5 + 6) / 2),
}


def reader(name):
    return harness.Bench(ROOT).reader(name)


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_reader_of_hand_made_spans(name):
    spans, want = WANT[name]
    assert reader(name).value(spans()) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_reader_without_spans(name):
    mod = reader(name)
    other = steps if name in SERVE else scans
    assert mod.value([]) is None
    # the other cell's spans hold no scan (step) span
    assert mod.value(other()) is None
    profiling.reset_spans()
    assert mod.read({}) is None


def test_metrics_listed():
    spec = {m["name"]: m for m in harness.Bench(ROOT).spec["per_layer"]}
    for names, cell in ((SERVE, "tgnet.serve"), (TRAIN, "dgcnn.train")):
        for n in names:
            assert spec[n]["source"] == "program_span" and spec[n]["workloads"] == [cell]


@pytest.mark.parametrize("cell, names", [("tgnet.serve", SERVE), ("dgcnn.train", TRAIN)])
def test_traced_run_reports_them(tiny, cell, names):
    out = run_cell(tiny, cell, trace=True)["result"]
    assert out["correct"] is True
    for n in names:
        assert out["metrics"][n]["value"] >= 0, n
    if cell == "dgcnn.train":
        m = {k: v["value"] for k, v in out["metrics"].items()}
        # the program's loader span sits inside the traffic's timer around it
        assert m["data.next_ms_per_step"] <= m["data.load_ms_per_step"]
