"""``postprocess.card_points_share``: the ``cluster`` spans' ``card_points``
over their ``points`` in the window's scans, None without scan spans and
None from a program whose spans carry no ``card_points`` count; a tiny
traced run of ``tgnet.serve`` on the CPU reports 0 (the CPU pipeline keeps
the host route)."""

from __future__ import annotations

import sys

import pytest

from conftest import BENCH, ROOT, run_cell

sys.path.insert(0, str(BENCH))

import harness  # noqa: E402
from toothgroupnetwork_tpu_torch.utils import profiling  # noqa: E402

NAME = "postprocess.card_points_share"
MS = 1_000_000


def made(name, group, **counts):
    s = profiling.Span(name, group, 0, start_ns=0)
    s.end_ns = MS
    for key, n in counts.items():
        s.count(key, n)
    return s


def reader():
    return harness.Bench(ROOT).reader(NAME)


def test_share_of_hand_made_spans():
    a, b, other = (1, 0), (1, 1), (2, 0)
    spans = [made("scan", a), made("scan", b),
             made("cluster", a, points=5000, card_points=5000, climbs=12),
             made("cluster", a, points=4000, card_points=4000, climbs=0),
             made("cluster", a, points=3000),                    # the KMeans
             made("cluster", b, points=6000, card_points=0, climbs=0),
             made("cluster", other, points=9, card_points=9)]
    assert reader().value(spans) == pytest.approx(9000 / 18000, rel=1e-12)


def test_none_without_the_count_or_the_spans():
    mod = reader()
    scan = (1, 0)
    assert mod.value([]) is None
    assert mod.value([made("scan", scan), made("cluster", scan, points=700)]) is None
    assert mod.value([made("cluster", scan, points=7, card_points=7)]) is None
    profiling.reset_spans()
    assert mod.read({}) is None


def test_listed():
    (spec,) = [m for m in harness.Bench(ROOT).spec["per_layer"] if m["name"] == NAME]
    assert spec["source"] == "program_span" and spec["workloads"] == ["tgnet.serve"]
    assert spec["layer"] == "postprocess" and spec["moves"] == "scans_per_s"


def test_traced_cpu_run_reports_zero(tiny):
    out = run_cell(tiny, "tgnet.serve", trace=True)["result"]
    assert out["correct"] is True
    assert out["metrics"][NAME]["value"] == 0
