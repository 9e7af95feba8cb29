"""The port's spans (``utils/profiling.py``) on the CPU.

* ``run_many`` under a torch profiler: one ``run_many`` span, a ``scan``
  span for each mesh in its group ``(call, index)``, the ten phases under
  each scan, every child inside its parent, the phases' durations equal to
  the scan's ``timings``; outside a profiler no span at all.
* The spans' clock is the profiler's: a span and a ``record_function``
  around one block agree at both ends.
* ``Trainer.train_epoch`` under a profiler: a ``step`` span a batch with
  the loader's, the step's and the losses' fetch spans inside.
* ``profiling.trace`` writes the spans into its ``trace.json``.
* Many threads recording at once lose no span, and the bound holds.
"""

from __future__ import annotations

import json
import sys
import threading
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from synthetic import write_processed_npy, write_synthetic_obj
from toothgroupnetwork_tpu_torch.data import dataset
from toothgroupnetwork_tpu_torch.models.registry import get_task
from toothgroupnetwork_tpu_torch.models.tasks import build_tgnet_bdl, build_tgnet_fps
from toothgroupnetwork_tpu_torch.pipelines.tgn import TgnInferencePipeline
from toothgroupnetwork_tpu_torch.train.trainer import Trainer
from toothgroupnetwork_tpu_torch.utils import profiling
from toothgroupnetwork_tpu_torch.utils.weights import randomize_, save_npz

# the tiny pipeline of tests/test_torch_port_serving.py
N_SAMPLE, CROP = 512, 64
FPS_PARAMS = {"planes": [8, 16], "stride": [1, 4], "nsample": [8, 8],
              "blocks": [2, 2], "block_num": 2, "crop_sample_size": CROP}
BDL_ARCH = dict(planes=(8, 16), stride=(1, 1), nsample=(8, 8), blocks=(2, 2),
                block_num=2)
BOUNDARY = {"bdl_ratio": 0.7, "num_of_bdl_points": 300,
            "num_of_all_points": N_SAMPLE}
PHASES = ("mesh_prep", "fps:stage1_device", "fps:host_centroids", "fps:stage2_device",
          "host_instancing", "host_boundary_resample", "bdl:fused_device",
          "host_bdl_kmeans", "host_fusion", "host_1nn_transfer")


class Kept(TgnInferencePipeline):
    """Keeps every scan's ``timings`` under its path (``self.timings`` holds
    only the last scan's)."""

    _local = threading.local()

    @staticmethod
    def _t(timings, name, t0):
        Kept._local.timings = timings
        return profiling.phase(timings, name, t0)

    def _scan(self, stl_path, _prep):
        out = super()._scan(stl_path, _prep)
        self.kept[stl_path] = dict(Kept._local.timings)
        return out


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A tiny random-weight pipeline on the CPU and two scans of different
    sizes."""
    work = tmp_path_factory.mktemp("tracing")
    gen = torch.Generator().manual_seed(0)
    ckpts = []
    for name, model in (("fps", build_tgnet_fps({"model_parameter": FPS_PARAMS},
                                                device="cpu")),
                        ("bdl", build_tgnet_bdl(CROP, BDL_ARCH, device="cpu"))):
        randomize_(model, gen)
        with torch.no_grad():
            model.first.cls_head.cls.bias[0] -= 3.0
            model.second.cls_head.cls.bias[0] -= 2.0
        ckpts.append(str(work / f"{name}.npz"))
        save_npz(ckpts[-1], model)
    scans = []
    for seed, n_side in ((1, 40), (2, 36)):
        scans.append(str(work / f"scan{seed}_lower.obj"))
        write_synthetic_obj(scans[-1], n_side=n_side, seed=seed)
    pipe = Kept(*ckpts, {"model_parameter": dict(FPS_PARAMS)}, bdl_arch=BDL_ARCH,
                n_sample=N_SAMPLE, boundary_info=BOUNDARY, device="cpu")
    pipe.kept = {}
    yield pipe, scans
    pipe.close()


def _inside(child, parent):
    return parent.start_ns <= child.start_ns <= child.end_ns <= parent.end_ns


def test_run_many_spans_under_a_profiler(tiny):
    pipe, scans = tiny
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        pipe.run_many(scans, workers=2, prep_workers=0)
    got = profiling.spans()
    by_id = {s.id: s for s in got}
    (call,) = [s for s in got if s.name == "run_many"]
    found = sorted((s for s in got if s.name == "scan"), key=lambda s: s.group)
    assert [s.group for s in found] == [(call.group[0], 0), (call.group[0], 1)]
    for index, scan in enumerate(found):
        assert scan.parent == call.id and _inside(scan, call)
        mine = [s for s in got if s.group == scan.group]
        phases = [s for s in mine if s.parent == scan.id]
        assert [s.name for s in sorted(phases, key=lambda s: s.start_ns)] == list(PHASES)
        timings = pipe.kept[scans[index]]
        for s in phases:
            assert abs((s.end_ns - s.start_ns) / 1e9 - timings[s.name]) < 1e-4
        for s in mine:
            if s is not scan:
                assert _inside(s, by_id[s.parent]), s.name
        names = Counter(s.name for s in mine)
        # the prep in the scan's thread, the clusterings, the fetches
        assert names["scan_prep"] == 1 and names["cluster"] == 3
        assert names["card_wait"] >= 5
        assert all(s.counts["points"] > 0 for s in mine if s.name == "cluster")
        prep = next(s for s in mine if s.name == "scan_prep")
        assert by_id[prep.parent].name == "mesh_prep"
    assert profiling.dropped() == 0


def test_no_spans_outside_a_profiler(tiny):
    pipe, scans = tiny
    profiling.reset_spans()
    pipe.kept.clear()
    pipe.run_many(scans, workers=2, prep_workers=0)
    pipe(scans[0])
    assert profiling.spans() == []
    assert set(pipe.kept[scans[1]]) == set(PHASES)
    assert pipe.timings["mesh_prep"] > 0 and pipe.timings["host_1nn_transfer"] > 0


def test_serial_scan_and_prep_wait(tiny):
    """A serial call is a scan of its own call; a prep future's wait is a
    ``scan_prep.wait`` span, and the prep itself, in another process, none."""
    pipe, scans = tiny
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        pipe(scans[0])
        pipe.run_many(scans[:1], workers=1, prep_workers=1)
    got = profiling.spans()
    (serial, pooled) = [s for s in got if s.name == "scan"]
    assert serial.group[1] == 0 and serial.parent == 0
    assert [s.name for s in got if s.group == pooled.group].count("scan_prep") == 0
    (wait,) = [s for s in got if s.name == "scan_prep.wait"]
    assert wait.group == pooled.group


def test_span_clock_is_the_profilers():
    """Both ends of a span and of a ``record_function`` around the same
    block agree within 1 ms."""
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.tracing(), profiling.span("block"), record_function("block"):
            torch.ones(256, 256) @ torch.ones(256, 256)
    (mine,) = profiling.spans()
    (theirs,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "block"]
    assert abs(theirs.start_ns() - mine.start_ns) < 1e6
    assert abs(theirs.start_ns() + theirs.duration_ns() - mine.end_ns) < 1e6


def test_train_epoch_steps(tmp_path):
    d = str(tmp_path / "proc")
    for i in range(4):
        write_processed_npy(d, f"C{i:02d}", ("lower", "upper")[i % 2], n_points=256,
                            n_teeth=4 + i % 3, seed=i)
    task = get_task("dgcnn")
    cfg = task.default_config()
    cfg.checkpoint_path = str(tmp_path / "ckpt")
    loader = dataset.BatchLoader(dataset.DentalScanDataset(d), 2, shuffle=True, seed=0)
    trainer = Trainer(cfg, task, loader, None, log_fn=lambda s: None, device="cpu")
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        trainer.train_epoch()
    got = profiling.spans()
    steps = [s for s in got if s.name == "step"]
    assert [s.group for s in steps] == [0, 1]
    for step in steps:
        children = [s for s in got if s.parent == step.id]
        assert {s.name for s in children} == {"data.next", "step.batch", "step.forward",
                                              "step.backward", "step.optimizer",
                                              "card_wait"}
        assert all(_inside(s, step) and s.group == step.group for s in children)
    # the epoch's end found no batch: no step of its own
    assert len([s for s in got if s.name == "data.next"]) == 2


def test_trace_writes_the_spans(tiny, tmp_path):
    pipe, scans = tiny
    with profiling.trace(str(tmp_path / "t")):
        pipe(scans[1])
    doc = json.loads((tmp_path / "t" / "trace.json").read_text())
    events = doc["traceEvents"]
    mine = [e for e in events if e.get("cat") == "program_span"]
    assert {e["name"] for e in mine} >= {"scan", *PHASES, "cluster", "card_wait"}
    ops = [e for e in events if e.get("ph") == "X" and e.get("cat") != "program_span"]
    (scan,) = [e for e in mine if e["name"] == "scan"]
    # the scan lies over the profiler's operations, on the same clock
    assert min(e["ts"] for e in ops) < scan["ts"] + scan["dur"]
    assert max(e["ts"] for e in ops) > scan["ts"]
    assert {e["tid"] for e in mine}.isdisjoint(e["tid"] for e in ops)


def test_threads_lose_no_span(monkeypatch):
    """Sixteen threads recording at once, the switch interval shortened:
    every span kept up to the bound, and the rest counted."""
    threads_n, each = 16, 400
    monkeypatch.setattr(profiling, "SPAN_LIMIT", threads_n * each - 100)
    profiling.reset_spans()
    start = threading.Barrier(threads_n)

    def work():
        start.wait(timeout=60)
        with profiling.tracing(), profiling.span("root", group=threading.get_ident()):
            for _ in range(each - 1):
                with profiling.span("leaf") as s:
                    s.count("points", 1)

    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            # each thread's profiler state is its own: the entry turns
            # tracing on only where a profiler records, so the threads
            # are handed this one's call as run_many hands its workers
            with profiling.tracing(), profiling.span("call") as call:
                pool = [threading.Thread(target=lambda: _joined(call, work))
                        for _ in range(threads_n)]
                for t in pool:
                    t.start()
                for t in pool:
                    t.join(timeout=120)
                assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(before)
    kept = profiling.spans()
    assert len(kept) == profiling.SPAN_LIMIT
    assert len(kept) + profiling.dropped() == threads_n * each + 1
    assert len({s.id for s in kept}) == len(kept)


def _joined(call, fn):
    with profiling.joined(call, call.group):
        fn()


def test_null_span_when_not_tracing():
    assert profiling.span("x") is profiling.NULL
    with profiling.span("x") as s:
        s.count("points", 3)
        s.drop()
    t = torch.arange(3)
    assert torch.equal(profiling.fetch(t), t)
