"""The port's tsegnet (``models/tsegnet.py``, ``pipelines/tsegnet.py``)
against the JAX package, on the CPU, with the tiny backbone of the JAX
package's tests: the centroid and seg forwards (padded crop slots among
them), the whole module with crop proposals, the ddf, and the inference
pipeline through ``make_inference_pipeline`` and ``cli.infer`` on the same
``.npz``.

Weights are the flax init with BatchNorm statistics, biases and scales
randomised and the zero-initialised heads (``offset_2``, ``dist_2``,
``fc2`` and its bias) drawn at random (tests/test_torch_port_families.py).
For the pipeline the centroid heads are then fitted to the scan
(``fit_centroid_heads``) and the seg heads centred on its crops
(``centre_seg_heads``), so that DBSCAN finds clusters and the crops, the
paint decisions and the ids do real work.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthetic import write_synthetic_obj
from test_torch_port_families import (_flat, _t, assert_close, carry,
                                      jax_init, randomize_variables)
from toothgroupnetwork_tpu.models import get_task as jax_get_task
from toothgroupnetwork_tpu.models.tsegnet import TSegNetModule as JaxTSegNet
from toothgroupnetwork_tpu.models.tsegnet import compute_ddf as jax_ddf
from toothgroupnetwork_tpu.pipelines.base import fps_sample as jax_fps_sample
from toothgroupnetwork_tpu.pipelines.base import prep_mesh_feats
from toothgroupnetwork_tpu.pipelines.tsegnet import (
    TsegnetInferencePipeline as JaxPipeline)
from toothgroupnetwork_tpu.train.checkpoints import save_weights
from toothgroupnetwork_tpu_torch.cli import infer
from toothgroupnetwork_tpu_torch.models.tasks import _tsegnet_preset, build_tsegnet
from toothgroupnetwork_tpu_torch.models.tsegnet import TSegNetModule, compute_ddf
from toothgroupnetwork_tpu_torch.pipelines import (TsegnetInferencePipeline,
                                                   make_inference_pipeline)
from toothgroupnetwork_tpu_torch.utils.weights import from_jax_variables

N, CROP, SLOTS = 512, 128, 16


def _init(rng, crop=CROP):
    module = JaxTSegNet(crop_size=crop, tiny_backbone=True)
    vs = jax_init(module, jnp.zeros((1, N, 6), jnp.float32), None, train=False,
                  center_points=jnp.zeros((1, 8, 3), jnp.float32),
                  center_valid=jnp.ones((1, 8), bool))
    vs = randomize_variables(vs, rng)
    port = carry(vs, TSegNetModule(crop_size=crop, tiny_backbone=True, device="cpu"))
    return module, vs, port


def _feat(rng, n=N):
    return (rng.standard_normal((1, n, 6)) * 0.3).astype(np.float32)


def test_centroid_forward_matches(rng):
    """The centroid module with a padded cloud (the last 64 points masked)."""
    module, vs, port = _init(rng)
    feat = _feat(rng)
    mask = np.ones((1, N), bool)
    mask[:, -64:] = False
    ref = jax.jit(lambda v, f, m: module.apply(v, f, m, method="centroid_forward"))(
        vs, jnp.asarray(feat), jnp.asarray(mask))
    with torch.no_grad():
        got = port.centroid_forward(_t(feat), _t(mask))
    for key in ("l3_points", "l3_xyz", "offset_result", "dist_result"):
        assert_close(got[key].numpy(), np.asarray(ref[key]))
    assert_close(got["l0_points"].numpy()[:, :-64], np.asarray(ref["l0_points"])[:, :-64])
    np.testing.assert_array_equal(got["l3_mask"].numpy(), np.asarray(ref["l3_mask"]))


def test_seg_forward_matches_with_padded_slots(rng):
    """The seg module over 16 crop slots, six of them padded (a fully false
    mask): K1 seeds at index 0, the ball query falls back to the nearest
    point, and the group-all pool gives 0 for them in both packages."""
    module, vs, port = _init(rng)
    c = port.seg_module.tower1.sa1.scale_0.dense_0.weight.shape[1] - 3
    crop = (rng.standard_normal((SLOTS, CROP, c)) * 0.3).astype(np.float32)
    crop_mask = np.ones((SLOTS, CROP), bool)
    crop_mask[10:] = False
    ref = jax.jit(lambda v, f, m: module.apply(v, f, m, method="seg_forward"))(
        vs, jnp.asarray(crop), jnp.asarray(crop_mask))
    with torch.no_grad():
        got = port.seg_forward(_t(crop), _t(crop_mask))
    for g, r in zip(got, ref):
        assert_close(g.numpy(), np.asarray(r))


def test_full_forward_with_centers(rng):
    """The whole module: centroid module, crops around 8 proposals (two of
    them invalid), seg module."""
    module, vs, port = _init(rng)
    feat = _feat(rng)
    cp = (rng.standard_normal((1, 8, 3)) * 0.3).astype(np.float32)
    cv = np.ones((1, 8), bool)
    cv[0, 6:] = False
    ref = jax.jit(lambda v, f, p, q: module.apply(v, f, None, False, center_points=p,
                                                  center_valid=q))(
        vs, jnp.asarray(feat), jnp.asarray(cp), jnp.asarray(cv))
    with torch.no_grad():
        got = port(_t(feat), None, _t(cp), _t(cv))
    np.testing.assert_array_equal(got["nn_crop_indexes"].numpy(),
                                  np.asarray(ref["nn_crop_indexes"]))
    np.testing.assert_array_equal(got["crop_mask"].numpy(), np.asarray(ref["crop_mask"]))
    for key in ("cropped_feature_ls", "pd_1", "weight_1", "pd_2", "id_pred",
                "offset_result", "dist_result"):
        assert_close(got[key].numpy(), np.asarray(ref[key]))


def test_compute_ddf(rng):
    xyz = rng.standard_normal((2, 10, 3)).astype(np.float32)
    cents = rng.standard_normal((2, 3)).astype(np.float32)
    np.testing.assert_allclose(compute_ddf(_t(xyz), _t(cents)).numpy(),
                               np.asarray(jax_ddf(jnp.asarray(xyz), jnp.asarray(cents))),
                               rtol=1e-6)


def test_preset_and_build_tsegnet():
    cfg, jcfg = _tsegnet_preset(), jax_get_task("tsegnet").default_config()
    assert cfg.model_parameter == jcfg.model_parameter
    assert cfg.loss_weights == jcfg.loss_weights
    model = build_tsegnet({"model_parameter": {"tiny_backbone": True,
                                               "crop_sample_size": 64}},
                          device="cpu")
    assert model.crop_size == 64 and not model.training


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

def fit_centroid_heads(variables, port, sample, rng, groups):
    """Fit the centroid module's offset and distance heads to ``sample``
    (the pipeline's FPS cloud) so that DBSCAN(eps=.05, min_samples=3) finds
    ``groups`` clusters: the l3 points, sorted by x, split into ``groups``
    runs, each run's moved points placed within 0.004 of the run's mean
    xyz, and every distance 0.1 (< 0.3). The heads' BatchNorms get a bias
    of +5 (every ReLU unit open, so their inputs have full rank) and the
    last Dense of each head is the least-squares fit of those targets over
    its input at the l3 points. Random heads otherwise scatter the moved
    points and DBSCAN finds no cluster. Returns the new flax variables."""
    cm = port.cent_module
    for bn in (cm.offset_bn, cm.dist_bn):
        with torch.no_grad():
            bn.bias += 5.0
    seen = {}
    hooks = [getattr(cm, name).register_forward_pre_hook(
        lambda _m, a, name=name: seen.update({name: a[0]}))
        for name in ("offset_2", "dist_2")]
    with torch.no_grad():
        out = port.centroid_forward(_t(sample))
    for h in hooks:
        h.remove()
    xyz = out["l3_xyz"][0].double().numpy()
    order = np.argsort(xyz[:, 0], kind="stable")
    target = np.empty_like(xyz)
    for run in np.array_split(order, groups):
        target[run] = xyz[run].mean(0) + rng.uniform(-0.004, 0.004, (len(run), 3))
    fits = {}
    for name, want in (("offset_2", target - xyz),
                       ("dist_2", np.full((len(xyz), 1), 0.1))):
        r = seen[name][0].double().numpy()
        a = np.concatenate([r, np.ones((len(r), 1))], axis=1)
        sol = np.linalg.lstsq(a, want, rcond=None)[0]
        fits[name] = {"kernel": sol[:-1].astype(np.float32),
                      "bias": sol[-1].astype(np.float32)}

    def fit(kp, a):
        keys = [str(getattr(k, "key", k)) for k in kp]
        if keys[:2] == ["params", "cent_module"]:
            if keys[2] in ("offset_bn", "dist_bn") and keys[3] == "bias":
                return a + 5.0
            if keys[2] in fits:
                return jnp.asarray(fits[keys[2]][keys[3]])
        return a
    return jax.tree_util.tree_map_with_path(fit, variables)


def centre_seg_heads(variables, obj, mp):
    """Centre the seg module's heads on this scan's valid crops: the paint
    logit (``pd_mask_2``'s bias shifted so that its mean over the crops'
    points is 0, about half of each crop painted) and the id head (``fc2``'s
    kernel less ``outer(h, mu) / |h|^2``, ``h`` its mean input and ``mu``
    the mean id logits, so the crops take other ids). Random weights
    otherwise paint every point or none, with one id. Returns the new flax
    variables."""
    port = carry(variables, TSegNetModule(crop_size=mp["crop_sample_size"],
                                          tiny_backbone=True, device="cpu"))
    pipe = TsegnetInferencePipeline(None, {"model_parameter": mp}, n_sample=N,
                                    module=port, device="cpu")
    seg, seen = port.seg_module, {}
    hooks = [seg.pd_mask_2.register_forward_hook(lambda _m, _a, o: seen.update(pd_2=o)),
             seg.fc2.register_forward_hook(lambda _m, a, o: seen.update(h=a[0], ids=o))]
    pipe(obj)
    for h in hooks:
        h.remove()
    n = pipe.last_stats["clusters"]
    shift = np.float32(seen["pd_2"][:n].double().mean())
    h = seen["h"][:n].double().mean(0).numpy()
    mu = seen["ids"][:n].double().mean(0).numpy()
    delta = (np.outer(h, mu) / (h @ h)).astype(np.float32)

    def centre(kp, a):
        keys = [str(getattr(k, "key", k)) for k in kp]
        if keys == ["params", "seg_module", "pd_mask_2", "bias"]:
            return a - shift
        if keys == ["params", "seg_module", "fc2", "kernel"]:
            return a - delta
        return a
    return jax.tree_util.tree_map_with_path(centre, variables)


def test_pipeline_matches_jax(tmp_path, rng, monkeypatch):
    """``make_inference_pipeline("tsegnet")`` and ``cli.infer --model_name
    tsegnet --config_path`` on a synthetic sheet (1600 vertices, FPS to
    512, crops of 128) against the JAX pipeline on the same ``.npz``: two
    DBSCAN clusters, at least one crop painted, labels equal on at least
    0.999 of the vertices and equal wherever the JAX seg module's paint
    logit and id margin are clear of float32 noise."""
    scan_dir = tmp_path / "scans"
    scan_dir.mkdir()
    obj = str(scan_dir / "case_lower.obj")
    write_synthetic_obj(obj, n_side=40, seed=3)
    _, feats = prep_mesh_feats(obj, N)
    sampled = jax_fps_sample(feats, N)

    module, vs, port = _init(rng)
    mp = {"crop_sample_size": CROP, "run_tooth_segmentation_module": True,
          "tiny_backbone": True}
    vs = fit_centroid_heads(vs, port, sampled[None], rng, groups=2)
    vs = centre_seg_heads(vs, obj, mp)
    ckpt = str(tmp_path / "tsegnet.npz")
    save_weights(ckpt, vs)
    jcfg = jax_get_task("tsegnet").default_config()
    jcfg.model_parameter.update(mp)

    jpipe = JaxPipeline(ckpt, jcfg, n_sample=N)
    ref = jpipe(obj)
    config = {"model_parameter": mp}
    pipe = make_inference_pipeline("tsegnet", [ckpt], config, device="cpu")
    assert isinstance(pipe, TsegnetInferencePipeline)
    pipe.n_sample = N
    got = pipe(obj)
    print("proposals", pipe.last_stats)
    assert pipe.last_stats["clusters"] >= 2 and pipe.last_stats["painted_crops"] >= 1
    assert got["sem"].shape == ref["sem"].shape == (1600,)
    assert got["sem"].dtype == np.int64 and np.array_equal(got["sem"], got["ins"])
    agree = float(np.mean(got["sem"] == ref["sem"]))
    print(f"label agreement {agree:.5f}, labels {np.unique(ref['sem'])}")
    assert agree >= 0.999
    # this scan's paint logits and id margins are far from float32 noise,
    # so every label is equal
    np.testing.assert_array_equal(got["sem"], ref["sem"])
    assert len(np.unique(ref["sem"])) >= 2, "degenerate reference output"

    # the same weights from the JAX-written .npz: the port's state equals
    # the flax variables leaf for leaf
    state = from_jax_variables(_flat(vs))
    for k, v in pipe.module.state_dict().items():
        assert torch.equal(v, state[k]), k

    # the CLI writes the challenge JSON of the same labels
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps(config))
    orig = TsegnetInferencePipeline.__init__

    def small(self, *args, **kwargs):
        kwargs["n_sample"] = N
        orig(self, *args, **kwargs)
    monkeypatch.setattr(TsegnetInferencePipeline, "__init__", small)
    out_dir = tmp_path / "out"
    infer.main(["--input_dir_path", str(scan_dir), "--save_path", str(out_dir),
                "--model_name", "tsegnet", "--checkpoint_path", ckpt,
                "--config_path", str(cfg_path), "--device", "cpu"])
    res = json.loads((out_dir / "case_lower.json").read_text())
    sem = got["sem"].copy()
    sem[sem > 0] += 20
    assert res["jaw"] == "lower" and res["labels"] == sem.tolist()


def test_unknown_model_raises():
    with pytest.raises(ValueError, match="unknown model"):
        make_inference_pipeline("pointnet2", ["x.npz"], device="cpu")
