"""Traffic kind ``serve_scans``: a closed loop of
``TgnInferencePipeline.run_many`` calls over a pool of synthetic jaw scans.

The traffic file gives the pool (``meshes``: ``[ns, nu, teeth, jaw]`` each,
so every seed serves the same sizes), the scans a call (``scans_per_call``),
the scans in flight (``workers``) and the prep processes
(``prep_workers``), the meshes the heads are fitted to (``fit_meshes``),
the scans the check compares (``check_scans``) and the limits of the
compared numbers. The seed draws the meshes' stations and noise, their
order and the check's sample; the models come from the configuration's
``weight_seed``, drawn and fitted once in a checkout and kept in its
``build/bench_weights/`` under a hash of what they are made from. Set-up
warms the program up on one call that serves each mesh of the pool once.

Each call takes the next ``scans_per_call`` scans of the pool in its
seeded order, round and round. The window runs from the first call's start
to the end of the last call begun before ``--seconds``; ``scans_per_s``
counts the scans completed in it.

Correctness, after the window and with the program's state freed, on
``check_scans`` meshes drawn from the seed (the largest among them), the
program's last scan of each: each model's stage 1 and stage 2 against the
plain reference's forwards (``reference/tgnet.py``) on the inputs the
program gave them; the per-vertex labels against those the reference
makes from the ``.obj`` and the weight files, its host stages run on the
program's model outputs (random weights make the clustering chaotic, so
an independent run would judge rounding, not the program); and, exactly,
what the stages hand each other: the mesh-prep sample's rows (K1), each
model's crops, and the boundary cloud's rows. Every scan of the window is
also held to the first serve of its mesh (``repeat_mismatch``), so that a
scan that reads otherwise when it shares the card shows.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

import calibrate
import counts
import synthetic
import weights
from harness import BENCH_DIR, Check
from reference.tgnet import handoff

MODELS = ("fps", "bdl")
# what the fitted weights are made from, beside the configuration and the
# meshes they are fitted to
WEIGHT_SOURCES = ("calibrate.py", "weights.py", "synthetic.py",
                  "reference/pointtransformer.py", "reference/mesh.py", "reference/ops.py")


def bdl_arch(config: dict) -> dict:
    return dict(config["bdl_arch"])


def fps_arch(config: dict) -> dict:
    mp = config["model_parameter"]
    return {k: mp[k] for k in ("planes", "stride", "nsample", "blocks", "block_num")}


def rel_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest elementwise gap over the reference's largest magnitude."""
    ref = ref.float()
    return float((got.float() - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


class Traffic:
    def __init__(self, run):
        self.run = run
        self.cfg, self.w = run.config, run.workload
        self.records: dict = {}
        self.rng = np.random.default_rng(run.seed)

    # ---------------------------------------------------------------- set-up
    def setup(self) -> None:
        marks = [("start", time.perf_counter())]
        from toothgroupnetwork_tpu_torch.pipelines.tgn import TgnInferencePipeline

        run, cfg, dev = self.run, self.cfg, torch.device(self.run.device)
        marks.append(("imports", time.perf_counter()))
        mesh_dir = run.workdir / "meshes"
        mesh_dir.mkdir()
        order = self.rng.permutation(len(self.w["meshes"]))
        self.paths, self.sizes = [], {}
        for i in order:
            ns, nu, teeth, jaw = self.w["meshes"][i]
            verts, faces, _ = synthetic.arch_mesh(self.rng, ns, nu, teeth)
            path = str(mesh_dir / f"scan{i:02d}_{jaw}.obj")
            synthetic.write_obj(Path(path), verts, faces)
            self.paths.append(path)
            self.sizes[path] = len(verts)
        marks.append(("meshes", time.perf_counter()))
        self.npz = self._weights(dev)
        marks.append(("weights", time.perf_counter()))
        traffic = self

        class Recorded(TgnInferencePipeline):
            """Records what each scan's model stages took and gave (tensors
            kept on the device, no wait), under the scan's path."""

            def __call__(self, stl_path, _prep=None):
                traffic._local.rec = rec = {}
                out = super().__call__(stl_path, _prep=_prep)
                if "alter_answer" in traffic.run.faults:
                    out = {"sem": out["sem"] + 1, "ins": out["ins"]}
                rec["labels"] = out
                traffic._finished(stl_path, rec)
                return out

        self._local, self._lock = threading.local(), threading.Lock()
        self._last, self._masks, self._first = {}, [], {}
        self._scans, self._repeat = 0, 0.0
        self.pipe = Recorded(self.npz["fps"], self.npz["bdl"],
                             {"model_parameter": dict(cfg["model_parameter"])},
                             bdl_arch(cfg), n_sample=cfg["n_sample"],
                             boundary_info=dict(cfg["boundary_info"]), device=dev)
        if dev.type == "cpu":
            # the CPU runs of the tests take the card's boundary route, which
            # the reference states
            self.pipe._boundary_on_device = True
        for name, module in (("fps", self.pipe.fps_module), ("bdl", self.pipe.bdl_module)):
            self._record_stages(name, module)
        self._next = 0
        marks.append(("pipeline", time.perf_counter()))
        # every mesh of the pool once: each size the window serves
        self.pipe.run_many(self.paths, workers=self.w["workers"],
                           prep_workers=self.w["prep_workers"])
        marks.append(("warm", time.perf_counter()))
        self._masks.clear()
        self._scans = 0
        run.log("setup s: " + " ".join(f"{name} {t - prev:.3f}" for (_, prev), (name, t)
                                        in zip(marks, marks[1:])))

    def _weights(self, dev) -> dict:
        """The two models' ``.npz`` files: drawn from the configuration's
        weight seed, the heads fitted (``calibrate.py``), and kept under a
        hash of what they are made from, so that only a checkout's first
        run draws and fits them."""
        cfg, w = self.cfg, self.w
        fit = w["meshes"][:w["fit_meshes"]]
        key = hashlib.sha256(json.dumps([cfg, fit], sort_keys=True).encode())
        for name in WEIGHT_SOURCES:
            key.update((BENCH_DIR / name).read_bytes())
        paths = {m: self.run.cache_dir / f"{key.hexdigest()[:24]}.{m}.npz" for m in MODELS}
        if all(p.exists() for p in paths.values()):
            return {m: str(p) for m, p in paths.items()}
        # the models' outputs set the host stages' work (how many points are
        # foreground, how the clusters split), so every --seed serves the
        # same models: drawn and fitted from the configuration's weight seed
        wrng = np.random.default_rng(cfg["weight_seed"])
        fit_clouds = [calibrate.labelled_cloud(*synthetic.arch_mesh(wrng, ns, nu, teeth),
                                               cfg["n_sample"], wrng, dev)
                      for ns, nu, teeth, _ in fit]
        mp = dict(cfg["model_parameter"])
        from toothgroupnetwork_tpu_torch.models.tasks import build_tgnet_bdl, build_tgnet_fps

        self.run.cache_dir.mkdir(parents=True, exist_ok=True)
        for name, model in (("fps", build_tgnet_fps({"model_parameter": mp}, device="meta")),
                            ("bdl", build_tgnet_bdl(cfg["crop_sample_size"], bdl_arch(cfg),
                                                    device="meta"))):
            shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
            drawn = weights.draw(shapes, dev, int(wrng.integers(2 ** 62)))
            with torch.no_grad():
                calibrate.fit(drawn, fps_arch(cfg) if name == "fps" else bdl_arch(cfg),
                              fit_clouds, cfg["crop_sample_size"])
            part = paths[name].with_name(f"{paths[name].stem}.part{os.getpid()}.npz")
            weights.save_npz(part, drawn, {k for k, _ in model.named_buffers()})
            os.replace(part, paths[name])
        return {m: str(p) for m, p in paths.items()}

    def _finished(self, path: str, rec: dict) -> None:
        """A scan is done: its crop masks kept for the FLOP count, its
        record kept as the mesh's last (the previous one freed), its labels
        held to the first serve of its mesh."""
        labels = rec["labels"]
        with self._lock:
            self._masks.append((rec["fps.s2"][1], rec["bdl.s2"][1]))
            self._last[path] = rec
            self._scans += 1
            first = self._first.setdefault(path, labels)
        if first is not labels:
            differ = float(np.mean((labels["sem"] != first["sem"])
                                   | (labels["ins"] != first["ins"])))
            with self._lock:
                self._repeat = max(self._repeat, differ)

    def _record_stages(self, name: str, module) -> None:
        stage1, stage2 = module.stage1, module.stage2
        local = self._local

        def recorded1(feat, mask=None):
            out = stage1(feat, mask)
            local.rec[name + ".in"] = feat
            local.rec[name + ".s1"] = {k: out[k] for k in ("sem_1", "offset_1")}
            return out

        def recorded2(crops, crop_mask=None):
            out = stage2(crops, crop_mask)
            local.rec[name + ".s2"] = (crops, crop_mask, out["sem_1"])
            return out

        module.stage1, module.stage2 = recorded1, recorded2

    def _call(self) -> list:
        n = self.w["scans_per_call"]
        paths = [self.paths[(self._next + i) % len(self.paths)] for i in range(n)]
        self._next = (self._next + n) % len(self.paths)
        return self.pipe.run_many(paths, workers=self.w["workers"],
                                  prep_workers=self.w["prep_workers"])

    # ---------------------------------------------------------------- window
    def window(self, seconds: float) -> dict:
        from toothgroupnetwork_tpu_torch.pipelines.tgn import TgnInferencePipeline

        phase_s, spans = defaultdict(float), self.records.setdefault("spans", [])
        wall0 = time.time_ns() - time.perf_counter_ns()
        original = TgnInferencePipeline.__dict__["_t"]
        lock, trace = threading.Lock(), self.run.trace

        def timed(timings, name, t0):
            now = original.__func__(timings, name, t0)
            with lock:
                phase_s[name] += now - t0
                if trace:
                    spans.append((name, wall0 + int(t0 * 1e9), wall0 + int(now * 1e9)))
            return now

        TgnInferencePipeline._t = staticmethod(timed)
        try:
            t0 = time.perf_counter()
            ends = []
            while True:
                self._call()
                ends.append(time.perf_counter() - t0)
                if ends[-1] >= seconds:
                    break
            elapsed = ends[-1]
            calls = len(ends)
        finally:
            TgnInferencePipeline._t = original
        scans = self._scans
        self.records.update(phase_s=dict(phase_s), scans=scans, calls=calls,
                            window_s=elapsed)
        self.run.log(f"window: {scans} scans, calls ending at "
                     + " ".join(f"{t:.3f}" for t in ends) + " s; phase s a scan: "
                     + " ".join(f"{k} {v / max(scans, 1):.4f}" for k, v in phase_s.items()))
        return {"attempted": scans, "failed": 0,
                "metrics": {"scans_per_s": scans / elapsed}}

    # ----------------------------------------------------------------- check
    def check(self) -> list[Check]:
        dev = torch.device(self.run.device)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        crops = [(int(a[:, 0].sum()), int(b[:, 0].sum())) for a, b in self._masks]
        self.records["flops"] = sum(counts.tgnet_scan_flops(self.cfg, a, b) for a, b in crops)
        self.records["crops"] = crops
        self.pipe.close()
        del self.pipe
        last = self._last
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        chosen = self.check_paths(sorted(last))
        from reference.ops import Precision
        from reference.tgnet import TgnetReference

        ref = TgnetReference(self.cfg, self.npz["fps"], self.npz["bdl"], dev)
        ctrl = (TgnetReference(self.cfg, self.npz["fps"], self.npz["bdl"], dev,
                               Precision(tf32=True)) if self.run.control else None)
        readings, control = defaultdict(float), defaultdict(float)
        for path in chosen:
            prog = program_outputs(last[path])
            want = {m: ref.stage_outputs(m, prog[m]["in"], prog[m]["crops"]) for m in MODELS}
            host = ref(path, given=prog)
            made = {"sample": prog["fps"]["in"][0], "boundary": prog["bdl"]["in"][0],
                    "crops": {m: prog[m]["crops"] for m in MODELS}}
            merge_max(readings, judge(prog, last[path]["labels"], want, host, made))
            if ctrl is not None:
                # the control in the program's place: its stage outputs on
                # the program's inputs, and the labels the host stages make
                # of them, held to the reference's own
                mine = {m: {**prog[m], **want[m]} for m in MODELS}
                theirs = {m: {**prog[m], **ctrl.stage_outputs(m, prog[m]["in"],
                                                              prog[m]["crops"])}
                          for m in MODELS}
                served = ref(path, given=theirs)
                merge_max(control, judge(theirs, served, want, ref(path, given=mine), served))
        readings["repeat_mismatch"] = self._repeat
        limits = self.w["limits"]
        if ctrl is not None:
            self.records["control"] = {k: control.get(k, 0.0) for k in limits}
        return [Check(k, readings[k], limits[k]) for k in limits]

    def check_paths(self, done: list) -> list:
        """``check_scans`` of the meshes served, drawn from the seed: the
        largest and others at random."""
        largest = max(done, key=lambda p: self.sizes[p])
        rest = [p for p in done if p != largest]
        pick = self.rng.permutation(len(rest))[:self.w["check_scans"] - 1]
        return [largest] + [rest[i] for i in pick]


def program_outputs(rec: dict) -> dict:
    """The program's recorded stage outputs in the reference's form: each
    model's stage 1 and its valid crops' stage 2."""
    out = {}
    for name in MODELS:
        crops, mask, sem = rec[name + ".s2"]
        valid = mask[:, 0]
        out[name] = {"in": rec[name + ".in"], "crops": crops[valid],
                     "sem_1": rec[name + ".s1"]["sem_1"],
                     "offset_1": rec[name + ".s1"]["offset_1"], "crop_sem": sem[valid]}
    return out


def merge_max(into: dict, readings: dict) -> None:
    for k, v in readings.items():
        into[k] = max(into[k], v)


def judge(judged: dict, labels: dict, want: dict, host: dict, made: dict) -> dict:
    """The compared numbers of one scan: each model's outputs in ``judged``
    against ``want`` (the reference's models on the same inputs);
    ``labels`` against ``host``'s (the reference's host stages on the
    judged outputs): the share of vertices whose label or instance
    differs; and what the judged side's stages handed on (``made``)
    against ``host``'s, exactly."""
    out = {}
    for m in MODELS:
        out[f"{m}_stage1_gap"] = max(rel_gap(judged[m]["sem_1"], want[m]["sem_1"]),
                                     rel_gap(judged[m]["offset_1"], want[m]["offset_1"]))
        out[f"{m}_crop_gap"] = (rel_gap(judged[m]["crop_sem"], want[m]["crop_sem"])
                                if "crop_sem" in want[m] else 0.0)
    out["label_mismatch"] = float(np.mean((labels["sem"] != host["sem"])
                                          | (labels["ins"] != host["ins"])))
    out.update(handoff(made, host))
    return out
