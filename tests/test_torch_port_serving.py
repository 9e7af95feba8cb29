"""Overlapped serving of the port (``TgnInferencePipeline.run_many``), its
spawned prep workers, and the whole pipeline held EXACTLY to the JAX
package's through injected stand-in predictors, on the CPU.

* ``run_many`` returns, in input order, outputs identical to serial calls,
  with threads only and with a spawned prep pool; the pool persists across
  calls and ``close()`` reaps it; a scan that raises makes it raise.
* ``data/scan_prep.py`` (what a prep worker imports) pulls in neither torch
  nor jax.
* ``inject_modules``: both packages' pipelines run on the same scan with the
  structured stand-ins of ``tests/test_ref_pipeline_parity.py`` (the same
  math, one written in torch, one in jax), so every host and device
  algorithm between the models runs on identical inputs, and the labels and
  instances must be equal, with cells off and on.
"""

import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthetic import write_synthetic_obj
from toothgroupnetwork_tpu.models import get_task
from toothgroupnetwork_tpu.pipelines.tgn import TgnInferencePipeline as JaxPipeline
from toothgroupnetwork_tpu_torch.data import scan_prep
from toothgroupnetwork_tpu_torch.data.mesh_io import parse_obj
from toothgroupnetwork_tpu_torch.models.tasks import build_tgnet_bdl, build_tgnet_fps
from toothgroupnetwork_tpu_torch.pipelines.tgn import TgnInferencePipeline
from toothgroupnetwork_tpu_torch.utils.weights import randomize_, save_npz

REPO = Path(__file__).resolve().parents[1]

# the tiny config of tests/test_torch_port_pipeline.py
N_SAMPLE, CROP = 512, 64
FPS_PARAMS = {"planes": [8, 16], "stride": [1, 4], "nsample": [8, 8],
              "blocks": [2, 2], "block_num": 2, "crop_sample_size": CROP}
BDL_ARCH = dict(planes=(8, 16), stride=(1, 1), nsample=(8, 8), blocks=(2, 2),
                block_num=2)
BOUNDARY = {"bdl_ratio": 0.7, "num_of_bdl_points": 300,
            "num_of_all_points": N_SAMPLE}
# class-0 shift of each model's classifier bias, so that random weights
# do not call every point background
BG_SHIFT = {"first": -3.0, "second": -2.0}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A tiny random-weight pipeline on the CPU and two n_side=40 scans."""
    work = tmp_path_factory.mktemp("serving")
    gen = torch.Generator().manual_seed(0)
    ckpts = []
    for name, model in (("fps", build_tgnet_fps({"model_parameter": FPS_PARAMS},
                                                device="cpu")),
                        ("bdl", build_tgnet_bdl(CROP, BDL_ARCH, device="cpu"))):
        randomize_(model, gen)
        with torch.no_grad():
            for half, shift in BG_SHIFT.items():
                getattr(model, half).cls_head.cls.bias[0] += shift
        ckpts.append(str(work / f"{name}.npz"))
        save_npz(ckpts[-1], model)
    scans = []
    for seed in (1, 2):
        scans.append(str(work / f"scan{seed}_lower.obj"))
        write_synthetic_obj(scans[-1], n_side=40, seed=seed)
    pipe = TgnInferencePipeline(*ckpts, {"model_parameter": dict(FPS_PARAMS)},
                                bdl_arch=BDL_ARCH, n_sample=N_SAMPLE,
                                boundary_info=BOUNDARY, device="cpu")
    yield pipe, scans
    pipe.close()


@pytest.fixture(scope="module")
def serial(tiny):
    """Serial outputs of scans a, b, a."""
    pipe, (a, b) = tiny
    return [pipe(p) for p in (a, b, a)]


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["sem"], w["sem"])
        np.testing.assert_array_equal(g["ins"], w["ins"])


class TestRunMany:
    @pytest.mark.parametrize("prep_workers", [0, 1])
    def test_matches_serial_in_input_order(self, tiny, serial, prep_workers):
        pipe, (a, b) = tiny
        # the two scans differ, so a result out of order shows
        assert not np.array_equal(serial[0]["ins"], serial[1]["ins"])
        got = pipe.run_many([a, b, a], workers=2, prep_workers=prep_workers)
        _assert_same(got, serial)
        # the last completed scan's phases
        assert pipe.timings["mesh_prep"] > 0 and "host_1nn_transfer" in pipe.timings

    def test_prefetched_prep_is_the_scan_prep(self, tiny, serial):
        pipe, (a, _) = tiny
        prep = scan_prep.prep_scan_host_tgn(a, N_SAMPLE)
        _assert_same([pipe(a, _prep=prep)], serial[:1])

    def test_pool_persists_and_close_reaps_it(self, tiny):
        pipe, (a, b) = tiny
        pipe.run_many([a, b], workers=2, prep_workers=1)
        pool = pipe._pool
        procs = list(pool._processes.values())
        assert len(procs) == 1 and all(p.is_alive() for p in procs)
        pipe.run_many([b], workers=1, prep_workers=1)
        assert pipe._pool is pool
        pipe.close()
        assert pipe._pool is None
        assert not any(p.is_alive() for p in procs)

    @pytest.mark.parametrize("prep_workers", [0, 1])
    def test_a_failing_scan_raises(self, tiny, tmp_path, prep_workers):
        pipe, (a, _) = tiny
        with pytest.raises(FileNotFoundError):
            pipe.run_many([a, str(tmp_path / "missing_lower.obj")], workers=2,
                          prep_workers=prep_workers)
        pipe.close()


class TestSharedState:
    """What the scans of ``run_many`` share, hammered from more threads than
    cores with a shortened interpreter switch interval."""

    N_THREADS, ROUNDS = 16, 20000

    def _hammer(self, work):
        """``work()`` on N_THREADS threads released together; their results."""
        from concurrent.futures import ThreadPoolExecutor
        from threading import Barrier

        start = Barrier(self.N_THREADS)

        def run():
            start.wait(timeout=60)
            return work()

        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            with ThreadPoolExecutor(self.N_THREADS) as ex:
                futs = [ex.submit(run) for _ in range(self.N_THREADS)]
                return [f.result(timeout=120) for f in futs]
        finally:
            sys.setswitchinterval(old)

    def test_launch_counts_lose_nothing(self):
        from toothgroupnetwork_tpu_torch.ops.kernels._launch import count_launch

        def kernel():
            pass

        kernel.launches, kernel.launches_by_shape = 0, {}

        def work():
            for i in range(self.ROUNDS):
                count_launch(kernel, i % 3)

        self._hammer(work)
        total = self.N_THREADS * self.ROUNDS
        assert kernel.launches == total
        assert sum(kernel.launches_by_shape.values()) == total

    def test_a_layout_is_made_once(self):
        from toothgroupnetwork_tpu_torch.ops.kernels.attention import cached_layout

        params = {"w": torch.ones(4), "b": torch.zeros(4)}
        made = []

        def make():
            made.append(1)
            time.sleep(0.01)   # a build long enough for every thread to arrive
            return {"packed": torch.cat([params["w"], params["b"]])}

        def work():
            return {id(cached_layout(params, "key", make)) for _ in range(100)}

        seen = set().union(*self._hammer(work))
        assert len(made) == 1 and len(seen) == 1


def test_scan_prep_imports_neither_torch_nor_jax():
    """What a spawned prep worker imports: numpy only, so it never touches
    the card."""
    code = ("import sys; import toothgroupnetwork_tpu_torch.data.scan_prep as m; "
            "assert m.warm_worker(); "
            "print(sorted(k for k in ('torch', 'jax') if k in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "[]"


# ---- the structured stand-in predictors (tests/test_ref_pipeline_parity.py
# FakeTGNet, constants and pick_tooth_centers of tests/ref_pipeline.py): T
# tooth centres on the normalised scan; points within STRUCT_RADIUS of a
# centre get class (t % 9) + 1, points within STRUCT_PULL_RADIUS are offset
# 0.9 of the way to it (tight, separated moved clusters), a thin band is
# flung to a ring of radius STRUCT_STRAY_R (DBSCAN noise); the crop stage
# calls foreground what lies within STRUCT_RADIUS of the centred crop's
# origin, with asymmetric logits so one foreground vote outweighs 16
# background ones
STRUCT_RADIUS = 0.05
STRUCT_PULL_RADIUS = 0.12
STRUCT_CONTRACT = 0.9
STRUCT_STRAY_BAND = (0.046, 0.05)
STRUCT_STRAY_R = 0.25
STRUCT_FG_LOGIT = 80.0
STRUCT_BG_LOGIT = 4.0


def pick_tooth_centers(vertices: np.ndarray, t: int = 9) -> np.ndarray:
    """T points spread along central-x quantiles of a normalised scan, in a
    central y band (interior, so each crop's mean sits on its tooth)."""
    v = vertices
    yc = np.median(v[:, 1])
    band = v[np.abs(v[:, 1] - yc) < 0.15]
    order = np.argsort(band[:, 0], kind="stable")
    q = (np.arange(t) + 0.5) / t * 0.7 + 0.15
    rows = order[(q * len(order)).astype(int)]
    return band[rows, :3].astype(np.float32)


class JaxStandIn:
    """The stand-in in jax, with the flax ``apply(variables, ...,
    method=...)`` the JAX pipeline calls."""

    def __init__(self, centers):
        self._c = jnp.asarray(centers, jnp.float32)

    def apply(self, variables, *args, method=None, **kw):
        return method(self, *args, **kw)

    def stage1(self, feats, mask=None):
        xyz = feats[..., :3]
        d = jnp.linalg.norm(xyz[..., None, :] - self._c, axis=-1)
        dmin, t = jnp.min(d, axis=-1), jnp.argmin(d, axis=-1)
        cls = jnp.where(dmin < STRUCT_RADIUS, (t % 9) + 1, 0)
        pull = (dmin < STRUCT_PULL_RADIUS)[..., None]
        off = jnp.where(pull, STRUCT_CONTRACT * (self._c[t] - xyz), 0.0)
        stray = ((dmin > STRUCT_STRAY_BAND[0])
                 & (dmin < STRUCT_STRAY_BAND[1]))[..., None]
        off = jnp.where(
            stray, (xyz - self._c[t]) * (STRUCT_STRAY_R / dmin - 1.0)[..., None], off)
        return {"sem_1": jax.nn.one_hot(cls, 10) * 8.0, "offset_1": off}

    def stage2(self, crop_feat, crop_mask=None):
        fg = jnp.linalg.norm(crop_feat[..., :3], axis=-1) < STRUCT_RADIUS
        return {"sem_1": jax.nn.one_hot(fg.astype(jnp.int32), 2)
                * jnp.asarray([STRUCT_BG_LOGIT, STRUCT_FG_LOGIT])}


class TorchStandIn:
    """The same stand-in in torch, with the stage interface of the port's
    ``models/tgnet.py:TGNet``."""

    def __init__(self, centers):
        self._c = torch.from_numpy(np.asarray(centers, np.float32))

    def stage1(self, feats, mask=None):
        xyz = feats[..., :3]
        c = self._c.to(xyz.device)
        d = torch.linalg.norm(xyz[..., None, :] - c, dim=-1)
        dmin, t = d.min(dim=-1)
        cls = torch.where(dmin < STRUCT_RADIUS, (t % 9) + 1, 0)
        pull = (dmin < STRUCT_PULL_RADIUS)[..., None]
        off = torch.where(pull, STRUCT_CONTRACT * (c[t] - xyz), 0.0)
        stray = ((dmin > STRUCT_STRAY_BAND[0])
                 & (dmin < STRUCT_STRAY_BAND[1]))[..., None]
        off = torch.where(
            stray, (xyz - c[t]) * (STRUCT_STRAY_R / dmin - 1.0)[..., None], off)
        return {"sem_1": torch.nn.functional.one_hot(cls, 10).float() * 8.0,
                "offset_1": off}

    def stage2(self, crop_feat, crop_mask=None):
        fg = torch.linalg.norm(crop_feat[..., :3], dim=-1) < STRUCT_RADIUS
        logits = torch.tensor([STRUCT_BG_LOGIT, STRUCT_FG_LOGIT],
                              device=crop_feat.device)
        return {"sem_1": torch.nn.functional.one_hot(fg.long(), 2).float() * logits}


# The stand-ins' radii are in normalised scan units: 30 sampled points
# within 0.05 of a centre (DBSCAN's min_samples) need a 20000-point sample.
# A 150^2-vertex scan takes the FPS route at mesh prep and at the boundary
# fill; a 70^2-vertex one is subdivided to 139^2 rows and repeated instead.
PARITY_SAMPLE, PARITY_CROP = 20000, 256
PARITY_BOUNDARY = {"bdl_ratio": 0.7, "num_of_bdl_points": 16000,
                   "num_of_all_points": PARITY_SAMPLE}


def _stand_in_scan(path, n_side, seed=1):
    """Write the scan; return the stand-ins' tooth centres on its
    normalised, deduplicated vertices (the pipelines' own prep)."""
    write_synthetic_obj(str(path), n_side=n_side, seed=seed)
    v, f = parse_obj(str(path))
    v, _ = scan_prep.dedup_vertices(v, f)
    return pick_tooth_centers(scan_prep.normalize_scan_vertices(v))


def _injected_port(centers, cells):
    stand_in = TorchStandIn(centers)
    return TgnInferencePipeline(
        None, None, {"model_parameter": {"crop_sample_size": PARITY_CROP,
                                         "cell_attention": cells}},
        n_sample=PARITY_SAMPLE, boundary_info=PARITY_BOUNDARY,
        inject_modules=(stand_in, stand_in), device="cpu")


class TestInjectedParity:
    @pytest.mark.parametrize("cells", [False, True])
    def test_whole_pipeline_equals_jax(self, tmp_path, cells):
        obj = tmp_path / "scan_lower.obj"
        centers = _stand_in_scan(obj, n_side=150)
        cfg = get_task("tgnet_fps").default_config()
        cfg.model_parameter.update(crop_sample_size=PARITY_CROP,
                                   cell_attention=cells)
        stand_in = JaxStandIn(centers)
        ref = JaxPipeline(None, None, cfg, n_sample=PARITY_SAMPLE,
                          boundary_info=PARITY_BOUNDARY,
                          inject_modules=(stand_in, {"params": {}},
                                          stand_in, {"params": {}}))(str(obj))
        got = _injected_port(centers, cells)(str(obj))
        # the stand-ins light the whole path up: several instances and
        # FDI classes of both halves of the arch
        assert len(np.unique(ref["ins"])) >= 5 and len(np.unique(ref["sem"])) >= 5
        np.testing.assert_array_equal(got["sem"], ref["sem"])
        np.testing.assert_array_equal(got["ins"], ref["ins"])

    def test_injected_run_many_matches_serial(self, tmp_path):
        paths = [tmp_path / "scan1_lower.obj", tmp_path / "scan2_lower.obj"]
        centers = _stand_in_scan(paths[0], n_side=70, seed=1)
        _stand_in_scan(paths[1], n_side=70, seed=2)
        pipe = _injected_port(centers, cells=False)
        paths = [str(paths[0]), str(paths[1]), str(paths[0])]
        serial = [pipe(p) for p in paths]
        assert len(np.unique(serial[0]["ins"])) >= 5
        try:
            _assert_same(pipe.run_many(paths, workers=3, prep_workers=1), serial)
        finally:
            pipe.close()
