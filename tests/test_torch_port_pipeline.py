"""The port's host clustering and its whole inference slice against the JAX
package, on the CPU.

* The numpy/scipy estimators of ``postprocess/clustering.py`` against
  scikit-learn, which the JAX package calls (the GPU machine has none).
* ``TgnInferencePipeline.__call__`` of both packages on the same synthetic
  scan and the same ``.npz`` checkpoints (written by the JAX package's
  ``save_weights``, read by the port's ``load_npz``): per-vertex semantic
  agreement, and instance agreement after one-to-one id matching.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment
from sklearn.cluster import DBSCAN, KMeans, MeanShift
from sklearn.decomposition import PCA

from synthetic import make_synthetic_jaw_points, write_synthetic_obj
from toothgroupnetwork_tpu.models import get_task
from toothgroupnetwork_tpu.models.tgnet import TGNet as JaxTGNet
from toothgroupnetwork_tpu.pipelines.base import (
    class_logits_to_fdi as jax_class_logits_to_fdi, fps_sample as jax_fps_sample)
from toothgroupnetwork_tpu.pipelines.tgn import (
    TgnInferencePipeline as JaxPipeline)
from toothgroupnetwork_tpu.postprocess.boundary import (
    boundary_sampled_feats as jax_boundary_sampled_feats)
from toothgroupnetwork_tpu.postprocess.clustering import (
    get_clustering_labels as jax_get_clustering_labels)
from toothgroupnetwork_tpu.train.checkpoints import save_weights
from toothgroupnetwork_tpu_torch.cli import infer
from toothgroupnetwork_tpu_torch.pipelines import base
from toothgroupnetwork_tpu_torch.pipelines.tgn import TgnInferencePipeline
from toothgroupnetwork_tpu_torch.postprocess import boundary, clustering


def _same_partition(a, b):
    """True when two labelings are equal up to a relabelling."""
    pairs = set(zip(np.asarray(a).tolist(), np.asarray(b).tolist()))
    return len(pairs) == len(set(a)) == len(set(b))


def _blobs(rng, k=5, per=200, spread=0.02):
    cents = rng.uniform(-1, 1, (k, 3))
    return (cents[:, None] + rng.normal(0, spread, (k, per, 3))).reshape(
        -1, 3).astype(np.float32)


class TestClustering:
    @pytest.mark.parametrize("eps,min_samples", [(0.03, 30), (0.02, 8)])
    def test_dbscan_matches_sklearn(self, rng, eps, min_samples):
        pts, _, _ = make_synthetic_jaw_points(3000, n_teeth=10, seed=3)
        pts = pts + rng.normal(0, 0.01, pts.shape).astype(np.float32)
        ref = DBSCAN(eps=eps, min_samples=min_samples).fit(pts)
        labels, core = clustering.dbscan(pts, eps, min_samples)
        np.testing.assert_array_equal(labels, ref.labels_)
        np.testing.assert_array_equal(core, ref.core_sample_indices_)
        assert (labels == -1).any() and labels.max() >= 3

    def test_pca_matches_sklearn(self, rng):
        pts = rng.standard_normal((500, 3)) @ rng.standard_normal((3, 3))
        ref = PCA(n_components=3).fit(pts)
        np.testing.assert_allclose(clustering.pca_explained_variance(pts),
                                   ref.explained_variance_, rtol=1e-6)
        comp = clustering.pca_components(pts)
        for got, want in zip(comp, ref.components_):
            np.testing.assert_allclose(abs(got @ want), 1.0, rtol=1e-6)

    def test_mean_shift_matches_sklearn(self, rng):
        pts = _blobs(rng, k=4, per=300)
        ref = MeanShift(bandwidth=0.07, bin_seeding=True).fit(pts).labels_
        got = clustering.mean_shift(pts, 0.07)
        assert _same_partition(got, ref) and len(set(got)) == 4

    @pytest.mark.parametrize("k", [1, 3, 6])
    def test_kmeans_matches_sklearn(self, rng, k):
        pts = _blobs(rng, k=k, per=150)
        ref = KMeans(k, init="k-means++", random_state=0).fit(pts).labels_
        got = clustering.kmeans(pts, k, seed=0)
        assert _same_partition(got, ref) and len(set(got)) == k

    def test_kmeans_on_a_continuum_matches_sklearn(self, rng):
        """No separated blobs: the partition hangs on the seeding, which
        follows scikit-learn's RandomState draws."""
        pts = rng.uniform(-1, 1, (800, 3)).astype(np.float32)
        ref = KMeans(7, init="k-means++", random_state=0).fit(pts).labels_
        got = clustering.kmeans(pts, 7, seed=0)
        assert np.mean(got == ref) >= 0.99 or _same_partition(got, ref)

    @pytest.mark.parametrize("k", [1, 3, 10])
    def test_row_modes_match_unique(self, rng, k):
        """The noise absorption's vote, all rows at once: each row's most
        frequent label, the smallest among ties, as ``np.unique`` with
        counts and ``argmax`` give it row by row."""
        votes = rng.integers(-1, 5, (3000, k))
        want = []
        for row in votes:
            u, c = np.unique(row, return_counts=True)
            want.append(u[np.argmax(c)])
        np.testing.assert_array_equal(clustering._row_modes(votes), want)

    def test_instance_labels_match_jax(self, rng):
        pts, _, cls = make_synthetic_jaw_points(2400, n_teeth=8, seed=1)
        moved = pts + rng.normal(0, 0.002, pts.shape).astype(np.float32)
        sem = np.where(cls > 0, 1 + (cls - 1) % 8, 0)
        got = clustering.get_clustering_labels(moved, sem)
        ref = jax_get_clustering_labels(moved, sem)
        assert _same_partition(got, ref)


class TestBase:
    @pytest.mark.parametrize("n0", [300, 40])
    def test_fps_sample_matches_jax(self, rng, n0):
        """FPS down to 64 rows (or repeats of a smaller cloud), as the JAX
        package's host sampler on its exact route."""
        feats = rng.standard_normal((n0, 6)).astype(np.float32)
        ref = jax_fps_sample(feats, 64)
        got = base.fps_sample(feats, 64, device="cpu")
        np.testing.assert_array_equal(got, ref)

    @pytest.mark.parametrize("num_bdl", [100, 400])
    def test_boundary_sampled_feats_matches_jax(self, num_bdl):
        """Host-purity boundary resampling: the boundary draw (same
        default_rng(0) permutation), the FPS fill, the pseudo labels and the
        1-NN byproducts, identical to the JAX package's."""
        org, _, cls = make_synthetic_jaw_points(3000, n_teeth=8, seed=2)
        org = np.concatenate([org, np.zeros_like(org)], axis=1)
        sampled = org[::5]
        labels = cls[::5]
        kw = dict(bdl_ratio=0.7, num_bdl_points=num_bdl, num_all_points=500)
        ref = jax_boundary_sampled_feats(labels, org, sampled, return_nn1=True,
                                         **kw)
        got = boundary.boundary_sampled_feats(labels, org, sampled, device="cpu",
                                              **kw)
        assert got[2] == ref[2] and 0 < got[2] <= num_bdl
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)

    def test_class_logits_to_fdi(self):
        ids = np.arange(17)
        np.testing.assert_array_equal(base.class_logits_to_fdi(ids),
                                      jax_class_logits_to_fdi(ids))


# the tiny config of tests/test_tgn_pipeline.py::TestTgnPipelineEndToEnd
N_SAMPLE, CROP = 512, 64
FPS_PARAMS = {"planes": [8, 16], "stride": [1, 4], "nsample": [8, 8],
              "blocks": [2, 2], "block_num": 2, "crop_sample_size": CROP}
BDL_ARCH = dict(planes=(8, 16), stride=(1, 1), nsample=(8, 8), blocks=(2, 2),
                block_num=2)
BOUNDARY = {"bdl_ratio": 0.7, "num_of_bdl_points": 300,
            "num_of_all_points": N_SAMPLE}


# class-0 (background) shift of each model's classifier bias: with random
# weights and no shift every vertex comes out background, and the comparison
# would hold nothing but zeros
BG_SHIFT = {"first": -3.0, "second": -2.0}


def _checkpoint(module, path, rng):
    """flax init + randomised biases/BN state, written with save_weights."""
    feat = jnp.zeros((1, N_SAMPLE, 6), jnp.float32)
    lab = jnp.zeros((1, N_SAMPLE), jnp.int32)
    vs = jax.jit(module.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), feat, None, train=False, labels=lab)

    def jitter(kp, a):
        names = [str(getattr(k, "key", k)) for k in kp]
        if names[-1] == "var":
            return a + jnp.asarray(rng.uniform(0.5, 1.5, a.shape), a.dtype)
        if names[-1] in ("mean", "bias", "scale"):
            a = a + jnp.asarray(rng.standard_normal(a.shape) * 0.1, a.dtype)
        if names[-3:] == ["cls_head", "cls", "bias"]:
            a = a.at[0].add(BG_SHIFT[names[1]])
        return a

    save_weights(path, jax.tree_util.tree_map_with_path(jitter, dict(vs)))


def _ins_agreement(a, b):
    ua, ia = np.unique(a, return_inverse=True)
    ub, ib = np.unique(b, return_inverse=True)
    counts = np.zeros((len(ua), len(ub)), np.int64)
    np.add.at(counts, (ia, ib), 1)
    rows, cols = linear_sum_assignment(-counts)
    return counts[rows, cols].sum() / len(a)


def test_slice_matches_jax(tmp_path, rng, monkeypatch):
    task = get_task("tgnet_fps")
    cfg = task.default_config()
    cfg.model_parameter.update(FPS_PARAMS)
    fps_ckpt, bdl_ckpt = str(tmp_path / "fps.npz"), str(tmp_path / "bdl.npz")
    _checkpoint(task.build_module(cfg), fps_ckpt, rng)
    _checkpoint(JaxTGNet(crop_size=CROP, c=6, **BDL_ARCH), bdl_ckpt, rng)
    scan_dir = tmp_path / "scans"
    scan_dir.mkdir()
    obj = str(scan_dir / "case_lower.obj")
    write_synthetic_obj(obj, n_side=40, seed=1)

    ref = JaxPipeline(fps_ckpt, bdl_ckpt, cfg, bdl_arch=BDL_ARCH,
                      n_sample=N_SAMPLE, boundary_info=BOUNDARY)(obj)
    pipe = TgnInferencePipeline(
        fps_ckpt, bdl_ckpt, {"model_parameter": dict(FPS_PARAMS)},
        bdl_arch=BDL_ARCH, n_sample=N_SAMPLE, boundary_info=BOUNDARY,
        device="cpu")
    got = pipe(obj)

    assert got["sem"].shape == got["ins"].shape == (40 * 40,)
    sem_agree = np.mean(got["sem"] == ref["sem"])
    ins_agree = _ins_agreement(got["ins"], ref["ins"])
    print(f"slice agreement: sem {sem_agree:.4f} ins {ins_agree:.4f}")
    assert sem_agree >= 0.99 and ins_agree >= 0.99, (sem_agree, ins_agree)
    assert len(np.unique(ref["ins"])) > 1, "degenerate reference output"

    # the CLI drives the same pipeline and writes the challenge JSON of its
    # labels (lower jaw: +20 on the tooth labels)
    made = {}

    def make(model_name, ckpts, config, *, device):
        made.update(name=model_name, ckpts=ckpts, config=config, device=device)
        return pipe

    monkeypatch.setattr(infer, "make_inference_pipeline", make)
    out_dir = tmp_path / "out"
    config = tmp_path / "config.json"
    config.write_text(json.dumps({"model_parameter": FPS_PARAMS}))
    argv = ["--input_dir_path", str(scan_dir), "--save_path", str(out_dir),
            "--model_name", "tgnet", "--checkpoint_path", fps_ckpt,
            "--checkpoint_path_bdl", bdl_ckpt, "--config_path", str(config)]
    infer.main(argv + ["--device", "cpu"])
    assert made == {"name": "tgnet", "ckpts": [fps_ckpt, bdl_ckpt],
                    "config": {"model_parameter": FPS_PARAMS},
                    "device": torch.device("cpu")}
    res = json.loads((out_dir / "case_lower.json").read_text())
    sem = got["sem"].copy()
    sem[sem > 0] += 20
    assert res["jaw"] == "lower"
    assert res["labels"] == sem.tolist()
    assert res["instances"] == got["ins"].tolist()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            infer.main(argv)
