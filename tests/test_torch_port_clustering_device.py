"""The tgnet instancing's card route (K9 ``dbscan`` and K10 ``mean_shift``
of ``ops/kernels/cluster.py``) held EXACTLY to the host clustering of
``postprocess/clustering.py``.

* On the CPU, the plain twins: K9's labels and core mask, K10's climbs
  (every final mean and ball size) and the MeanShift labels, and the
  instance labels of ``_foreground_instances`` through the twins,
  ``array_equal`` to the host functions' on clouds of float16-valued teeth:
  separated, two or three merged (1-3 re-splits), with scattered noise,
  fewer than 4 clusters, no foreground, all noise, fewer points than
  ``min_samples``. K10's stop-test norm bit-equal to this host's
  ``np.linalg.norm``.
* ``get_clustering_labels`` and the CPU pipeline keep the host route off
  a card: the kernels are not called, and the ``cluster`` spans count no
  ``card_points``.
* On the card (skipped without one), the kernels against the twins and the
  host functions at the serving cell's sizes, and ``run_many`` served twice
  with identical labels.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_port_clustering_device.py -q
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from synthetic import write_synthetic_obj
from toothgroupnetwork_tpu_torch.models.tasks import build_tgnet_bdl, build_tgnet_fps
from toothgroupnetwork_tpu_torch.ops.kernels import cluster
from toothgroupnetwork_tpu_torch.pipelines.tgn import TgnInferencePipeline
from toothgroupnetwork_tpu_torch.postprocess import clustering
from toothgroupnetwork_tpu_torch.utils import profiling
from toothgroupnetwork_tpu_torch.utils.weights import randomize_, save_npz

EPS, MIN_SAMPLES, BANDWIDTH = 0.03, 30, 0.07


def teeth(seed: int, n_teeth: int = 8, per: int = 300, merge=(), noise: int = 0,
          spread: float = 0.008) -> np.ndarray:
    """Blobs of ``per`` points along an arch, float16-valued float32 as the
    pipeline's moved points; each tooth in ``merge`` is moved to 0.05 from
    the one before it, so DBSCAN joins them; ``noise`` scattered points."""
    rng = np.random.default_rng(seed)
    t = np.linspace(-0.8, 0.8, n_teeth)
    cents = np.stack([t, 0.5 * t ** 2, np.zeros_like(t)], -1)
    for m in merge:
        step = cents[m] - cents[m - 1]
        cents[m] = cents[m - 1] + step / np.linalg.norm(step) * 0.05
    pts = [rng.normal(c, spread, (per, 3)) for c in cents]
    pts.append(rng.uniform(-1, 1, (noise, 3)))
    x = np.concatenate(pts)
    return x[rng.permutation(len(x))].astype(np.float16).astype(np.float32)


CLOUDS = {
    "separated": lambda: teeth(1),
    "merged_two": lambda: teeth(2, merge=(2,)),
    "merged_three": lambda: teeth(3, merge=(2, 3, 6)),
    "merged_noise": lambda: teeth(4, merge=(2, 5), noise=80),
    "three_teeth": lambda: teeth(5, n_teeth=3, noise=20),
    "all_noise": lambda: teeth(6, n_teeth=0, noise=200),
    "below_min_samples": lambda: teeth(7, n_teeth=1, per=MIN_SAMPLES - 10),
}
MERGED = ("merged_two", "merged_three", "merged_noise")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _host_dbscan(x):
    labels, core_idx = clustering.dbscan(x, EPS, MIN_SAMPLES)
    core = np.zeros(len(x), np.int64)
    core[core_idx] = 1
    return np.stack([labels, core])


def _merged_labels(x):
    """DBSCAN's labels of ``x`` and the clusters the instancing re-splits."""
    db, core = _host_dbscan(x)
    eg = np.array([clustering._pca_eigenvalues(x[(db == l) & (core == 1)])
                   for l in range(db.max() + 1)])
    top = np.argsort(-eg[:, 0])[:3]
    tail = np.sort(eg[:, 0])[::-1][3:].mean()
    return db, [int(l) for l in top if eg[l, 0] / tail > 8]


def _merged_clouds(x):
    """The points of each cluster the instancing re-splits."""
    db, merged = _merged_labels(x)
    return [x[db == l] for l in merged]


def _climb_all(clouds):
    """K10's arguments for ``clouds`` (their binned seeds, one cluster each)."""
    seeds = [clustering._bin_seeds(x, BANDWIDTH) for x in clouds]
    offsets = np.cumsum([0] + [len(x) for x in clouds]).astype(np.int32)
    owner = np.repeat(np.arange(len(clouds), dtype=np.int32), [len(s) for s in seeds])
    return (_t(np.concatenate(clouds)), _t(offsets), _t(np.concatenate(seeds)),
            _t(owner)), seeds, owner


@pytest.mark.parametrize("name", sorted(CLOUDS))
def test_dbscan_twin_equals_host(name):
    x = CLOUDS[name]()
    got = cluster.dbscan(_t(x), EPS, MIN_SAMPLES)
    assert got.dtype == torch.int64 and tuple(got.shape) == (2, len(x))
    np.testing.assert_array_equal(got.numpy(), _host_dbscan(x))


@pytest.mark.parametrize("name", MERGED)
def test_mean_shift_twin_equals_host_climbs(name):
    """Every seed's final mean and ball size as the host's climbs give
    them, and the labels of the one-launch route as ``mean_shift``'s."""
    cloud = CLOUDS[name]()
    db, merged = _merged_labels(cloud)
    core = _host_dbscan(cloud)[1].astype(bool)
    assert clustering._merged_clusters(cloud, db, core) == merged
    clouds = [cloud[db == l] for l in merged]
    assert 1 <= len(clouds) <= 3
    args, seeds, owner = _climb_all(clouds)
    means, counts = cluster.mean_shift(*args, BANDWIDTH)
    for c, (x, s) in enumerate(zip(clouds, seeds)):
        mine = owner == c
        want = clustering._climbs(x, BANDWIDTH, s, 300)
        assert clustering._intensity(means.numpy()[mine], counts.numpy()[mine]) == want
    labels, climbs = clustering._mean_shift_climbed(cloud, _t(cloud), db, merged,
                                                    BANDWIDTH)
    assert climbs == len(owner)
    for x, got in zip(clouds, labels):
        np.testing.assert_array_equal(got, clustering.mean_shift(x, BANDWIDTH))


def test_mean_shift_twin_stops_at_max_iter():
    """A climb cut at ``max_iter`` ends where the host's does."""
    x = CLOUDS["merged_two"]()
    clouds = _merged_clouds(x)[:1]
    args, seeds, _ = _climb_all(clouds)
    for max_iter in (0, 1, 3):
        means, counts = cluster.mean_shift(*args, BANDWIDTH, max_iter=max_iter)
        want = clustering._climbs(clouds[0], BANDWIDTH, seeds[0], max_iter)
        assert clustering._intensity(means.numpy(), counts.numpy()) == want


@pytest.mark.parametrize("name", sorted(CLOUDS))
def test_foreground_instances_twin_route_equals_host(name):
    x = CLOUDS[name]()
    want, no_climbs = clustering._foreground_instances(x)
    got, climbs = clustering._foreground_instances(x, _t(x))
    np.testing.assert_array_equal(got, want)
    assert no_climbs == 0
    resplit = (want >= 100).any()
    assert resplit == (name in MERGED) and (climbs > 0) == resplit
    if name == "all_noise" or name == "below_min_samples":
        assert (want == 0).all()


def test_get_clustering_labels_routes_and_counts():
    """Off a card the host route runs, handed a CPU copy or none: the same
    labels; the ``cluster`` span counts the foreground points, none
    instanced on a card and no seeds climbed; no foreground gives no
    labels."""
    x = CLOUDS["merged_noise"]()
    rng = np.random.default_rng(0)
    moved = np.concatenate([x, rng.uniform(-1, 1, (500, 3)).astype(np.float32)])
    labels = np.concatenate([rng.integers(1, 9, len(x)), np.zeros(500, np.int64)])
    order = rng.permutation(len(moved))
    moved, labels = moved[order], labels[order]
    zeros = np.zeros(len(moved))
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]), profiling.tracing():
        want = clustering.get_clustering_labels(moved, labels)
        got = clustering.get_clustering_labels(
            moved, labels, (_t(moved), _t(labels).to(torch.uint8)))
        empty = clustering.get_clustering_labels(moved, zeros,
                                                 (_t(moved), _t(zeros)))
    np.testing.assert_array_equal(got, want)
    assert (want >= 100).any() and empty.shape == (0,)
    host, copy, none = [s.counts for s in profiling.spans() if s.name == "cluster"]
    assert host == copy == {"points": len(x), "card_points": 0, "climbs": 0}
    assert none == {"points": 0, "card_points": 0, "climbs": 0}


def test_stop_norm_is_numpys():
    """K10 and its twin stop a climb on ``numpy_norm`` of the step, which
    assumes numpy's ``np.linalg.norm`` of a float32 3-vector is OpenBLAS's
    ``sdot`` (float32 products summed in float64) then a float32 root. Held
    bit for bit, and the stop decision with it, on random steps of every
    scale and on steps within a few ulps of the stop threshold."""
    rng = np.random.default_rng(0)
    stop = 1e-3 * BANDWIDTH
    unit = rng.normal(size=(4000, 3))
    unit /= np.linalg.norm(unit, axis=1, keepdims=True)
    near = unit[:2000] * (stop * (1 + rng.uniform(-4e-7, 4e-7, (2000, 1))))
    wide = unit[2000:] * 10.0 ** rng.uniform(-8, 0, (2000, 1))
    steps = np.concatenate([near, wide]).astype(np.float32)
    got = cluster.numpy_norm(_t(steps)).numpy()
    want = np.array([np.linalg.norm(v) for v in steps])
    assert want.dtype == np.float32
    bad = np.flatnonzero(got.view(np.int32) != want.view(np.int32))
    assert bad.size == 0, (
        f"np.linalg.norm of {bad.size} float32 3-vectors differs from float32 "
        "products summed in float64 and a float32 root (OpenBLAS's sdot): "
        "numpy's BLAS has changed, and K10's stop test no longer follows the "
        f"host's; first {steps[bad[0]]!r}: {got[bad[0]]!r} vs {want[bad[0]]!r}")
    threshold = cluster.stop_threshold(BANDWIDTH)
    np.testing.assert_array_equal(got.astype(np.float64) <= threshold,
                                  [n <= stop for n in want])
    assert (want <= stop).any() and (want > stop).any()


# the tiny pipeline of tests/test_torch_port_serving.py
N_SAMPLE, CROP = 512, 64
FPS_PARAMS = {"planes": [8, 16], "stride": [1, 4], "nsample": [8, 8],
              "blocks": [2, 2], "block_num": 2, "crop_sample_size": CROP}
BDL_ARCH = dict(planes=(8, 16), stride=(1, 1), nsample=(8, 8), blocks=(2, 2),
                block_num=2)
BOUNDARY = {"bdl_ratio": 0.7, "num_of_bdl_points": 300, "num_of_all_points": N_SAMPLE}


def _tiny_pipeline(work, device):
    """A tiny random-weight pipeline on ``device`` (the classifiers' class 0
    shifted down, so that some points are foreground) and two scans."""
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
    for seed in (1, 2):
        scans.append(str(work / f"scan{seed}_lower.obj"))
        write_synthetic_obj(scans[-1], n_side=40, seed=seed)
    pipe = TgnInferencePipeline(*ckpts, {"model_parameter": dict(FPS_PARAMS)},
                                bdl_arch=BDL_ARCH, n_sample=N_SAMPLE,
                                boundary_info=BOUNDARY, device=device)
    return pipe, scans


def test_cpu_pipeline_keeps_the_host_route(tmp_path, monkeypatch):
    def refused(*args, **kw):
        raise AssertionError("the CPU pipeline reached the card route")

    monkeypatch.setattr(cluster, "dbscan", refused)
    monkeypatch.setattr(cluster, "mean_shift", refused)
    pipe, (scan, _) = _tiny_pipeline(tmp_path, "cpu")
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        pipe(scan)
    counts = [s.counts for s in profiling.spans() if s.name == "cluster"]
    # the two instancings and the boundary cloud's KMeans
    assert len(counts) == 3 and all(c["points"] > 0 for c in counts)
    assert [c.get("card_points") for c in counts] == [0, 0, None]


# ------------------------------------------------------------------ card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def cell_cloud(seed: int) -> np.ndarray:
    """About 10k foreground points, the serving cell's size: 14 teeth of
    700, three of them merged, and scattered noise."""
    return teeth(seed, n_teeth=14, per=700, merge=(3, 4, 10), noise=300, spread=0.01)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CLOUDS) + ["cell"])
def test_k9_equals_twin_and_host(cuda_device, name):
    x = cell_cloud(11) if name == "cell" else CLOUDS[name]()
    before = cluster.dbscan.launches
    got = cluster.dbscan(_t(x).to(cuda_device), EPS, MIN_SAMPLES).cpu().numpy()
    assert cluster.dbscan.launches == before + 1
    np.testing.assert_array_equal(got, _host_dbscan(x))
    np.testing.assert_array_equal(got, cluster.dbscan_reference(_t(x), EPS, MIN_SAMPLES)
                                  .numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(MERGED) + ["cell"])
def test_k10_equals_twin_and_host(cuda_device, name):
    x = cell_cloud(12) if name == "cell" else CLOUDS[name]()
    clouds = _merged_clouds(x)
    args, seeds, owner = _climb_all(clouds)
    means, counts = cluster.mean_shift(*(a.to(cuda_device) for a in args), BANDWIDTH)
    means, counts = means.cpu().numpy(), counts.cpu().numpy()
    twin_means, twin_counts = cluster.mean_shift_reference(*args, BANDWIDTH)
    np.testing.assert_array_equal(means, twin_means.numpy())
    np.testing.assert_array_equal(counts, twin_counts.numpy())
    for c, (pts, s) in enumerate(zip(clouds, seeds)):
        mine = owner == c
        assert clustering._intensity(means[mine], counts[mine]) == \
            clustering._climbs(pts, BANDWIDTH, s, 300)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [21, 22, 23])
def test_card_route_equals_host_route(cuda_device, seed):
    """``get_clustering_labels`` handed a CUDA copy: the host route's
    labels, the same on a repeat, K9 once and K10 once a call."""
    x = cell_cloud(seed)
    rng = np.random.default_rng(seed)
    moved = np.concatenate([x, rng.uniform(-1, 1, (8000, 3)).astype(np.float32)])
    labels = np.concatenate([np.ones(len(x), np.int64), np.zeros(8000, np.int64)])
    order = rng.permutation(len(moved))
    moved, labels = moved[order], labels[order]
    want = clustering.get_clustering_labels(moved, labels)
    assert (want >= 100).any()
    before = (cluster.dbscan.launches, cluster.mean_shift.launches)
    for _ in range(2):
        got = clustering.get_clustering_labels(
            moved, labels, (_t(moved).to(cuda_device), _t(labels).to(cuda_device)))
        np.testing.assert_array_equal(got, want)
    assert (cluster.dbscan.launches, cluster.mean_shift.launches) == \
        (before[0] + 2, before[1] + 2)


@pytest.mark.cuda
def test_run_many_repeat_reads_identical_labels(cuda_device, tmp_path):
    pipe, (a, b) = _tiny_pipeline(tmp_path, cuda_device)
    before = cluster.dbscan.launches
    try:
        first = pipe.run_many([a, b, a], workers=2, prep_workers=0)
        second = pipe.run_many([a, b, a], workers=2, prep_workers=0)
    finally:
        pipe.close()
    assert cluster.dbscan.launches > before
    for got, want in zip(first + second, [first[0], first[1], first[0]] * 2):
        np.testing.assert_array_equal(got["ins"], want["ins"])
        np.testing.assert_array_equal(got["sem"], want["sem"])
