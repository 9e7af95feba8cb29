"""The port's other model families against the JAX package, on the CPU:
the ops and layers they add (ball query, sampling, three-NN upsampling,
pointops subtraction/aggregation, feature-space kNN, PointMLP, LayerNorm,
the PointNet++ SA/FP layers), the eval forwards of PointNetSeg,
PointNetPPSeg, DGCNNSeg and the semantic PointTransformerSeg, and their
serving pipelines through ``make_inference_pipeline`` and ``cli.infer``.

Weights are the JAX modules' flax init with every BatchNorm statistic,
bias and scale randomised and the zero-initialised heads drawn at random
(so those heads do work), carried to the port by ``from_jax_variables`` or
a ``.npz`` written by the JAX package's ``save_weights``. Inputs come from
a numpy seed. The sizes are those of tests/test_models.py (pointnet and
pointnetpp at scale 1, dgcnn at k = 8).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthetic import write_synthetic_obj
from toothgroupnetwork_tpu.models import get_task as jax_get_task
from toothgroupnetwork_tpu.models import dgcnn as jax_dgcnn_mod
from toothgroupnetwork_tpu.nn import layers as jax_layers
from toothgroupnetwork_tpu.nn import set_abstraction as jax_sa
from toothgroupnetwork_tpu.ops import (aggregation as jax_aggregation,
                                      ball_query as jax_ball_query,
                                      knn_points as jax_knn,
                                      sample_and_group as jax_sag,
                                      sample_and_group_all as jax_sag_all,
                                      subtraction as jax_subtraction,
                                      three_nn_interpolate as jax_three_nn)
from toothgroupnetwork_tpu.ops.pallas.knn_kernel import knn_pallas_select
from toothgroupnetwork_tpu.pipelines.maker import (
    make_inference_pipeline as jax_make_pipeline)
from toothgroupnetwork_tpu.train.checkpoints import save_weights
from toothgroupnetwork_tpu_torch import ops
from toothgroupnetwork_tpu_torch.cli import infer
from toothgroupnetwork_tpu_torch.models import get_task
from toothgroupnetwork_tpu_torch.models.tasks import build_sem_model
from toothgroupnetwork_tpu_torch.nn import set_abstraction as sa
from toothgroupnetwork_tpu_torch.nn.layers import LayerNorm, PointMLP
from toothgroupnetwork_tpu_torch.ops.kernels import knn
from toothgroupnetwork_tpu_torch.pipelines import (SemInferencePipeline,
                                                   make_inference_pipeline)
from toothgroupnetwork_tpu_torch.utils.weights import from_jax_variables

# float32 forwards: the two packages sum in other orders (XLA's dots and
# reductions against torch's), so outputs agree to a few float32 ulps of
# the largest activations, far inside this relative tolerance
RTOL = 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cloud(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _flat(variables) -> dict:
    """Flattened leaves keyed as ``save_weights`` keys them."""
    return {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(leaf)
            for kp, leaf in jax.tree_util.tree_flatten_with_path(dict(variables))[0]}


def randomize_variables(variables, rng):
    """BatchNorm statistics, biases and scales jittered; every all-zero
    kernel (the zero-initialised output heads) drawn as N(0, 1/fan_in)."""
    def jitter(kp, a):
        name = str(getattr(kp[-1], "key", kp[-1]))
        if name == "var":
            return a + jnp.asarray(rng.uniform(0.5, 1.5, a.shape), a.dtype)
        if name in ("mean", "bias", "scale"):
            return a + jnp.asarray(rng.standard_normal(a.shape) * 0.1, a.dtype)
        if name == "kernel" and not np.any(np.asarray(a)):
            return jnp.asarray(rng.standard_normal(a.shape) / np.sqrt(a.shape[0]),
                               a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(jitter, dict(variables))


def carry(variables, module):
    """Load flax ``variables`` into the port ``module``; the two key sets
    (and shapes) must be the same."""
    state = from_jax_variables(_flat(variables))
    own = module.state_dict()
    assert set(state) == set(own), sorted(set(state) ^ set(own))[:8]
    module.load_state_dict(state)
    return module.eval()


def assert_close(got, ref, rtol=RTOL):
    """``|got - ref| <= rtol * max|ref|`` elementwise (a relative tolerance
    against the tensor's scale), printing the worst ratio."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-6)
    worst = float(np.abs(got - ref).max()) / scale
    print(f"max |diff| / max |ref| = {worst:.3g} (limit {rtol})")
    assert worst <= rtol


def jax_init(module, *args, **kwargs):
    return jax.jit(module.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), *args, **kwargs)


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

class TestBallQuery:
    @pytest.mark.parametrize("k", [8, 64])
    def test_matches_jax(self, rng, k):
        """Lowest in-ball indices, the first one repeated, the nearest for an
        empty ball (far queries), masked points never in a ball, a fully
        masked cloud (index 0 everywhere), and k > n (n = 40 at k = 64)."""
        n = 40 if k == 64 else 300
        xyz = _cloud(rng, 3, n, 3, scale=0.3)
        new = np.concatenate([xyz[:, :20] + 0.01, _cloud(rng, 3, 5, 3) + 5.0], 1)
        mask = rng.random((3, n)) > 0.3
        mask[2] = False
        for m in (None, mask):
            ref = np.asarray(jax_ball_query(0.15, k, jnp.asarray(xyz), jnp.asarray(new),
                                            None if m is None else jnp.asarray(m)))
            got = ops.ball_query(0.15, k, _t(xyz), _t(new),
                                 None if m is None else _t(m))
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), ref)
        assert (got[2].numpy() == 0).all()

    def test_chunks_and_unbatched(self, rng):
        xyz = _cloud(rng, 500, 3, scale=0.3)
        new = xyz[:70]
        ref = np.asarray(jax_ball_query(0.1, 16, jnp.asarray(xyz), jnp.asarray(new),
                                        chunk=32))
        got = ops.ball_query(0.1, 16, _t(xyz), _t(new), chunk=32)
        np.testing.assert_array_equal(got.numpy(), ref)


class TestSamplingAndMisc:
    def test_sample_and_group(self, rng):
        xyz, pts = _cloud(rng, 2, 400, 3, scale=0.3), _cloud(rng, 2, 400, 5)
        mask = rng.random((2, 400)) > 0.2
        ref = jax_sag(64, 0.12, 16, jnp.asarray(xyz), jnp.asarray(pts),
                      jnp.asarray(mask))
        got = ops.sample_and_group(64, 0.12, 16, _t(xyz), _t(pts), _t(mask))
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6)

    def test_sample_and_group_all(self, rng):
        xyz, pts = _cloud(rng, 2, 50, 3), _cloud(rng, 2, 50, 4)
        mask = rng.random((2, 50)) > 0.5
        for p in (None, pts):
            ref = jax_sag_all(jnp.asarray(xyz), None if p is None else jnp.asarray(p),
                              jnp.asarray(mask))
            got = ops.sample_and_group_all(_t(xyz), None if p is None else _t(p),
                                           _t(mask))
            for g, r in zip(got, ref):
                np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6)

    def test_three_nn_interpolate(self, rng):
        tgt, src = _cloud(rng, 2, 200, 3), _cloud(rng, 2, 50, 3)
        feat = _cloud(rng, 2, 50, 16)
        smask = rng.random((2, 50)) > 0.2
        ref = jax_three_nn(jnp.asarray(tgt), jnp.asarray(src), jnp.asarray(feat),
                           None, jnp.asarray(smask))
        got = ops.three_nn_interpolate(_t(tgt), _t(src), _t(feat), None, _t(smask))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)

    def test_subtraction_aggregation(self, rng):
        x1, x2 = _cloud(rng, 2, 30, 8), _cloud(rng, 2, 40, 8)
        idx = rng.integers(0, 40, (2, 30, 6)).astype(np.int32)
        pos, w = _cloud(rng, 2, 30, 6, 8), _cloud(rng, 2, 30, 6, 2)
        np.testing.assert_allclose(
            ops.subtraction(_t(x1), _t(x2), _t(idx)).numpy(),
            np.asarray(jax_subtraction(jnp.asarray(x1), jnp.asarray(x2),
                                       jnp.asarray(idx))), atol=1e-6)
        np.testing.assert_allclose(
            ops.aggregation(_t(x2), _t(pos), _t(w), _t(idx)).numpy(),
            np.asarray(jax_aggregation(jnp.asarray(x2), jnp.asarray(pos),
                                       jnp.asarray(w), jnp.asarray(idx))), atol=1e-5)

    def test_group_points_and_pairwise(self, rng):
        pts = _cloud(rng, 2, 30, 5)
        idx = rng.integers(0, 30, (2, 7, 4)).astype(np.int32)
        assert torch.equal(ops.group_points(_t(pts), _t(idx)),
                           ops.index_points(_t(pts), _t(idx)))
        assert torch.equal(ops.pairwise_sqdist(_t(pts), _t(pts)),
                           ops.square_distance(_t(pts), _t(pts)))


def assert_knn_sets_close(query, pts, got_i, ref_i, bias=None):
    """The port's and JAX's neighbour sets equal, except where a swapped
    candidate's d2 lies within the expansion's rounding bound of the row's
    k-th d2: each package's float32 expansion |q|^2 - 2 q.p + |p|^2 (the
    port's fixed channel order, XLA's dot) sits within
    10 eps (|q|^2 + |p|^2) of the exact value, so the two can order such
    near-ties differently. Prints the worst ratio of a swapped candidate's
    gap to that bound, over the swapped rows."""
    q, p = np.asarray(query, np.float64), np.asarray(pts, np.float64)
    b, m, c = q.shape
    d2 = ((q[:, :, None, :] - p[:, None, :, :]) ** 2).sum(-1)
    if bias is not None:
        d2 = d2 + np.asarray(bias, np.float64)[:, None, :]
    scale = (q ** 2).sum(-1)[..., None] + (p ** 2).sum(-1)[:, None, :]
    bound = 10 * np.finfo(np.float32).eps * scale
    worst, swapped = 0.0, 0
    for bi in range(b):
        for i in range(m):
            a, r = set(got_i[bi, i].tolist()), set(ref_i[bi, i].tolist())
            if a == r:
                continue
            swapped += 1
            kth = max(d2[bi, i, j] for j in r)
            for j in a ^ r:
                gap = abs(d2[bi, i, j] - kth)
                ratio = gap / (2 * bound[bi, i, j])
                worst = max(worst, ratio)
                assert ratio <= 1.0, (bi, i, j, gap, bound[bi, i, j])
    print(f"rows with swapped near-ties {swapped}/{b * m}, "
          f"worst gap / bound {worst:.3g}")


class TestFeatureKnn:
    @pytest.mark.parametrize("c", [6, 64])
    @pytest.mark.parametrize("include_self", [False, True])
    @pytest.mark.parametrize("need_dist", [False, True])
    def test_matches_jax(self, rng, c, include_self, need_dist):
        """``knn_points`` in feature space (DGCNN's C = 6 and 64) against the
        JAX package's exact route, with a mask."""
        pts = _cloud(rng, 2, 300, c)
        query = pts if include_self else _cloud(rng, 2, 120, c)
        mask = rng.random((2, 300)) > 0.25
        jm = jnp.asarray(mask)
        ref_i, ref_d = jax_knn(jnp.asarray(query), jnp.asarray(pts), 20,
                               jm if include_self else None, jm,
                               include_self=include_self, need_dist=need_dist)
        got_i, got_d = ops.knn_points(_t(query), _t(pts), 20, _t(mask), _t(mask),
                                      include_self=include_self,
                                      need_dist=need_dist)
        ref_i, got_i = np.asarray(ref_i), got_i.numpy()
        bias = np.where(mask, 0.0, 1e10)
        assert_knn_sets_close(query, pts, got_i, ref_i, bias)
        same = (got_i == ref_i).all(-1)
        if include_self:
            assert (got_i[..., 0] == np.arange(300)).all()
        # rows whose lists agree: the same distances (need_dist: both
        # re-score by direct subtraction, in another summation order)
        d_ref, d_got = np.asarray(ref_d)[same], got_d.numpy()[same]
        if need_dist:
            np.testing.assert_allclose(d_got, d_ref, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_allclose(d_got ** 2, d_ref ** 2, rtol=0,
                                       atol=20 * np.finfo(np.float32).eps
                                       * 2 * float((np.asarray(pts) ** 2).sum(-1).max()))

    @pytest.mark.parametrize("c", [6, 64])
    def test_twin_matches_pallas_select(self, rng, c):
        """K2's plain twin at C = 6 and 64 against ``knn_pallas_select`` in
        interpret mode (its own matmul expansion), with a mask and k > n."""
        for n, k in ((200, 20), (12, 20)):
            pts = _cloud(rng, n, c)
            query = _cloud(rng, 90, c)
            mask = rng.random(n) > 0.25
            ref = np.asarray(knn_pallas_select(jnp.asarray(query), jnp.asarray(pts),
                                               k, jnp.asarray(mask)))
            bias = torch.where(_t(mask), 0.0, 1e10).to(torch.float32)[None]
            got, got_d = knn.knn_select_reference(_t(query)[None], _t(pts)[None], k,
                                                  bias)
            got = got[0].numpy()
            # the Pallas kernel excludes masked points (3e38) where the
            # port's contract (that of knn_points) biases them by 1e10, and
            # past n it repeats its last index where the port gives index 0
            # at 1e10: the two agree on the valid points' places
            kv = min(k, int(mask.sum()))
            assert_knn_sets_close(query[None], pts[None], got[None, :, :kv],
                                  ref[None, :, :kv])
            if n < k:
                assert (got[:, n:] == 0).all()
                assert (got_d[0, :, n:] == 1e10).all()


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

class TestLayers:
    def test_point_mlp(self, rng):
        x = _cloud(rng, 2, 50, 6)
        mask = rng.random((2, 50)) > 0.3
        for kw in ({}, {"last_activation": False}):
            jm = jax_layers.PointMLP([16, 32], **kw)
            vs = randomize_variables(jax_init(jm, jnp.asarray(x), None, train=False),
                                     rng)
            port = carry(vs, PointMLP(6, [16, 32], **kw, device="cpu"))
            ref = jm.apply(vs, jnp.asarray(x), jnp.asarray(mask), False)
            with torch.no_grad():
                assert_close(port(_t(x), _t(mask)).numpy(), ref)

    def test_layer_norm_and_masked_max(self, rng):
        import flax.linen as fnn

        x = _cloud(rng, 4, 64, scale=3.0) + 2.0
        jm = fnn.LayerNorm()
        vs = randomize_variables(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
        port = carry(vs, LayerNorm(64, device="cpu"))
        assert port.eps == 1e-6
        with torch.no_grad():
            assert_close(port(_t(x)).numpy(), jm.apply(vs, jnp.asarray(x)), 1e-5)
        from toothgroupnetwork_tpu_torch.nn.layers import masked_max

        y = _cloud(rng, 2, 30, 5)
        m = rng.random((2, 30)) > 0.5
        m[1] = False
        np.testing.assert_array_equal(
            masked_max(_t(y), _t(m), 1).numpy(),
            np.asarray(jax_layers.masked_max(jnp.asarray(y), jnp.asarray(m), 1)))

    def test_group_mlp(self, rng):
        x = _cloud(rng, 2, 10, 4, 7)
        mask = rng.random((2, 10, 4)) > 0.3
        jm = jax_sa.GroupMLP([8, 16])
        vs = randomize_variables(jax_init(jm, jnp.asarray(x), None, train=False), rng)
        port = carry(vs, sa.GroupMLP(7, [8, 16], device="cpu"))
        with torch.no_grad():
            assert_close(port(_t(x), _t(mask)).numpy(),
                         jm.apply(vs, jnp.asarray(x), jnp.asarray(mask), False))

    @pytest.mark.parametrize("what", ["single", "group_all", "msg"])
    def test_set_abstraction(self, rng, what):
        """SA layers with a mask; the group-all case has a fully masked row
        (a padded crop slot), which pools to 0 in both."""
        xyz, pts = _cloud(rng, 3, 200, 3, scale=0.3), _cloud(rng, 3, 200, 5)
        mask = rng.random((3, 200)) > 0.2
        mask[2] = False
        if what == "single":
            jm = jax_sa.SetAbstraction(32, 0.15, 8, [8, 16])
            port = sa.SetAbstraction(32, 0.15, 8, 5, [8, 16], device="cpu")
        elif what == "group_all":
            jm = jax_sa.SetAbstraction(0, 0.0, 0, [8, 16], group_all=True)
            port = sa.SetAbstraction(0, 0.0, 0, 5, [8, 16], group_all=True,
                                     device="cpu")
        else:
            jm = jax_sa.SetAbstractionMsg(32, [0.1, 0.2], [4, 8], [[8, 8], [8, 16]])
            port = sa.SetAbstractionMsg(32, [0.1, 0.2], [4, 8], 5,
                                        [[8, 8], [8, 16]], device="cpu")
        args = (jnp.asarray(xyz), jnp.asarray(pts), jnp.asarray(mask))
        vs = randomize_variables(jax_init(jm, *args, train=False), rng)
        carry(vs, port)
        ref = jm.apply(vs, *args, False)
        with torch.no_grad():
            got = port(_t(xyz), _t(pts), _t(mask))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=1e-6)
        assert_close(got[1].numpy(), ref[1])
        if what == "group_all":
            assert (got[1][2].numpy() == 0).all() and got[2] is None
        else:
            np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))

    @pytest.mark.parametrize("s", [1, 40])
    def test_feature_propagation(self, rng, s):
        xyz1, xyz2 = _cloud(rng, 2, 100, 3), _cloud(rng, 2, s, 3)
        p1, p2 = _cloud(rng, 2, 100, 6), _cloud(rng, 2, s, 12)
        m1, m2 = rng.random((2, 100)) > 0.2, rng.random((2, s)) > -1
        jm = jax_sa.FeaturePropagation([16, 8])
        args = tuple(jnp.asarray(a) for a in (xyz1, xyz2, p1, p2, m1, m2))
        vs = randomize_variables(jax_init(jm, *args, train=False), rng)
        port = carry(vs, sa.FeaturePropagation(18, [16, 8], device="cpu"))
        with torch.no_grad():
            got = port(*(_t(a) for a in (xyz1, xyz2, p1, p2, m1, m2)))
        assert_close(got.numpy(), jm.apply(vs, *args, False))


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

# the tiny configurations of tests/test_models.py (and a narrow
# pointtransformer), for the model and the pipeline tests
SMALL_PARAMS = {
    "pointnet": {"scale": 1},
    "pointnetpp": {"scale": 1},
    "dgcnn": {"k": 8},
    "pointtransformer": {"input_feat": 6, "planes": [8, 16, 16], "stride": [1, 4, 4],
                         "nsample": [8, 8, 8], "blocks": [1, 2, 1], "block_num": 3},
}


def _jax_family(name):
    task = jax_get_task(name)
    cfg = task.default_config()
    cfg.model_parameter.update(SMALL_PARAMS[name])
    return task.build_module(cfg), cfg


def same_selection_as_port(monkeypatch):
    """Give the JAX DGCNN the port's feature-space neighbour lists, so the
    model comparison holds everything but the selection, which
    TestFeatureKnn holds to JAX by the near-tie rule. A ``pure_callback``,
    so it also runs under ``jit``."""
    def port_knn(x, _x2, k, mask=None, _mask2=None, *, include_self, need_dist,
                 sel_bf16=False):
        def select(xv, mv):
            idx, _ = ops.knn_points(_t(np.asarray(xv)), _t(np.asarray(xv)), k,
                                    None if mv is None else _t(np.asarray(mv)),
                                    None if mv is None else _t(np.asarray(mv)),
                                    include_self=include_self, need_dist=need_dist)
            return idx.numpy()
        shape = jax.ShapeDtypeStruct(x.shape[:2] + (k,), jnp.int32)
        if mask is None:
            idx = jax.pure_callback(lambda xv: select(xv, None), shape, x)
        else:
            idx = jax.pure_callback(select, shape, x, mask)
        return idx, jnp.zeros(idx.shape, jnp.float32)
    monkeypatch.setattr(jax_dgcnn_mod, "knn_points", port_knn)


class TestModels:
    @pytest.mark.parametrize("name", ["pointnet", "pointnetpp", "dgcnn",
                                      "pointtransformer"])
    def test_eval_forward_matches(self, rng, monkeypatch, name):
        """Eval forward, random BN statistics and heads, a padded cloud (the
        last 64 points masked) and, for pointnetpp, 512 points under 1024
        sa1 centres (FPS repeats valid points)."""
        if name == "dgcnn":
            same_selection_as_port(monkeypatch)
        module, cfg = _jax_family(name)
        n = 512
        feat = _cloud(rng, 1, n, 6, scale=0.3)
        mask = np.ones((1, n), bool)
        mask[:, -64:] = False
        vs = randomize_variables(
            jax_init(module, jnp.asarray(feat), None, train=False), rng)
        port = carry(vs, build_sem_model(name, cfg.model_parameter, device="cpu"))
        ref = jax.jit(module.apply, static_argnums=3)(vs, jnp.asarray(feat),
                                                       jnp.asarray(mask), False)
        with torch.no_grad():
            got = port(_t(feat), _t(mask))
        keys = ["cls_pred"] + [k for k in ("offset", "dist") if k in ref]
        if name == "pointtransformer":
            keys = ["cls_pred", "offset_1"]
        for key in keys:
            assert_close(got[key].numpy()[:, :n - 64], np.asarray(ref[key])[:, :n - 64])

    def test_tasks_registered(self):
        for name in ("pointnet", "pointnetpp", "dgcnn", "pointtransformer"):
            task, jtask = get_task(name), jax_get_task(name)
            cfg, jcfg = task.default_config(), jtask.default_config()
            for part in ("optimizer", "scheduler"):
                assert (dataclasses.asdict(getattr(cfg, part))
                        == dataclasses.asdict(getattr(jcfg, part)))
            assert cfg.loss_weights == jcfg.loss_weights
            assert cfg.model_parameter == jcfg.model_parameter


# ---------------------------------------------------------------------------
# pipelines
# ---------------------------------------------------------------------------

N_SAMPLE = 512
# the label rule: where the JAX logits' top-two margin exceeds this, the
# port's label must be the same; overall at least 0.999 of the vertices
MARGIN = 1e-3


# each family's classifier, the last Dense before the logits
CLASSIFIER = {"pointnet": "cls", "pointnetpp": "cls_2", "dgcnn": "cls",
              "pointtransformer": "cls_head/cls"}


def centre_classifier(variables, port, name, sample):
    """Re-centre the classifier on one input: its kernel ``W`` becomes
    ``W - outer(h, mu) / |h|^2``, with ``h`` the classifier's mean input
    over the points and ``mu`` the mean logits, so every class's mean logit
    on ``sample`` is 0. Random weights otherwise give every point of a
    smooth scan the same class (the per-point spread of the logits is a
    few hundredths of the spread of their means), and a comparison of
    labels would hold one class. Returns the new flax variables."""
    layer = port.get_submodule(CLASSIFIER[name].replace("/", "."))
    seen = {}
    hook = layer.register_forward_pre_hook(lambda _m, a: seen.update(h=a[0]))
    with torch.no_grad():
        logits = port(_t(sample), None)["cls_pred"]
    hook.remove()
    h = seen["h"].reshape(-1, seen["h"].shape[-1]).double().mean(0).numpy()
    mu = logits.reshape(-1, logits.shape[-1]).double().mean(0).numpy()
    delta = (np.outer(h, mu) / (h @ h)).astype(np.float32)
    path = ["params"] + CLASSIFIER[name].split("/") + ["kernel"]

    def shift(kp, a):
        keys = [str(getattr(k, "key", k)) for k in kp]
        return a - delta if keys == path else a
    return jax.tree_util.tree_map_with_path(shift, variables)


def write_family_checkpoint(name, path, rng, sample):
    """The JAX family at the small configuration, randomised, its
    classifier centred on ``sample`` ``[1, N_SAMPLE, 6]``, saved with
    ``save_weights``; returns the config."""
    module, cfg = _jax_family(name)
    vs = randomize_variables(jax_init(module, jnp.asarray(sample), None,
                                      train=False), rng)
    port = carry(vs, build_sem_model(name, cfg.model_parameter, device="cpu"))
    save_weights(path, centre_classifier(vs, port, name, sample))
    return cfg


def assert_labels_agree(got, ref, margin_ok):
    agree = float(np.mean(got == ref))
    print(f"label agreement {agree:.5f}, "
          f"disagreeing beyond the margin {int(np.sum((got != ref) & margin_ok))}")
    assert agree >= 0.999
    np.testing.assert_array_equal(got[margin_ok], ref[margin_ok])


@pytest.mark.parametrize("name", ["pointnet", "pointnetpp", "dgcnn",
                                  "pointtransformer"])
def test_sem_pipeline_matches_jax(tmp_path, rng, monkeypatch, name):
    """``make_inference_pipeline`` and ``cli.infer --model_name
    --config_path`` on a synthetic sheet (1600 vertices, FPS to 512)
    against the JAX pipeline on the same ``.npz``. DGCNN runs the JAX side
    with the port's neighbour lists (``same_selection_as_port``)."""
    scan_dir = tmp_path / "scans"
    scan_dir.mkdir()
    obj = str(scan_dir / "case_upper.obj")
    write_synthetic_obj(obj, n_side=40, seed=2)
    from toothgroupnetwork_tpu.pipelines.base import (fps_sample as jax_fps_sample,
                                                      nn_upsample as jax_nn,
                                                      prep_mesh_feats)
    org, feats = prep_mesh_feats(obj, N_SAMPLE)
    sampled = jax_fps_sample(feats, N_SAMPLE)
    ckpt = str(tmp_path / f"{name}.npz")
    cfg = write_family_checkpoint(name, ckpt, rng, sampled[None])

    jpipe = jax_make_pipeline(name, [ckpt], cfg)
    jpipe.n_sample = N_SAMPLE
    if name == "dgcnn":   # before the forward's first trace
        same_selection_as_port(monkeypatch)
    ref = jpipe(obj)
    config = {"model_parameter": cfg.model_parameter}
    pipe = make_inference_pipeline(name, [ckpt], config, device="cpu")
    assert isinstance(pipe, SemInferencePipeline)
    pipe.n_sample = N_SAMPLE
    got = pipe(obj)
    assert got["sem"].shape == ref["sem"].shape == (1600,)
    assert np.array_equal(got["sem"], got["ins"])

    # the JAX logits' top-two margin at the sampled points, carried to the
    # vertices as the labels are
    logits = np.asarray(jpipe.forward_fn(jnp.asarray(sampled[None])))[0]
    top2 = np.sort(logits, axis=-1)[:, -2:]
    margin_ok = jax_nn(top2[:, 1] - top2[:, 0] > MARGIN * np.abs(top2).max(),
                       sampled[:, :3], org[:, :3]).astype(bool)
    assert_labels_agree(got["sem"], ref["sem"], margin_ok)
    assert len(np.unique(ref["sem"])) > 1, "degenerate reference output"

    # the CLI: the same model, the challenge JSON of its labels
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps(config))
    out_dir = tmp_path / "out"
    monkeypatch.setattr(SemInferencePipeline, "__init__",
                        _small_sample(SemInferencePipeline.__init__))
    infer.main(["--input_dir_path", str(scan_dir), "--save_path", str(out_dir),
                "--model_name", name, "--checkpoint_path", ckpt,
                "--config_path", str(cfg_path), "--device", "cpu"])
    res = json.loads((out_dir / "case_upper.json").read_text())
    assert res["jaw"] == "upper"
    assert res["labels"] == got["sem"].tolist()
    assert res["instances"] == got["ins"].tolist()
    if not torch.cuda.is_available():   # the card is the default device
        with pytest.raises(RuntimeError, match="no CUDA device"):
            infer.main(["--input_dir_path", str(scan_dir), "--save_path",
                        str(out_dir), "--model_name", name, "--checkpoint_path",
                        ckpt])


@pytest.mark.parametrize("n_side", [20, 40])
def test_mesh_prep_matches_jax(tmp_path, n_side):
    """``prep_mesh_feats`` bit-equal to the JAX package's (no dedup; a mesh
    under ``n_sample`` vertices subdivided once), and ``prep_mesh``'s K1
    sample (its plain version here) equal to the JAX ``prep_mesh``: the
    FPS of a cloud over 512 points, or the repeated cloud."""
    from toothgroupnetwork_tpu.pipelines import base as jax_base
    from toothgroupnetwork_tpu_torch.pipelines import base

    obj = str(tmp_path / "scan_lower.obj")
    write_synthetic_obj(obj, n_side=n_side, seed=4)
    for got, ref in zip(base.prep_mesh_feats(obj, N_SAMPLE),
                        jax_base.prep_mesh_feats(obj, N_SAMPLE)):
        np.testing.assert_array_equal(got, ref)
    for got, ref in zip(base.prep_mesh(obj, N_SAMPLE, device="cpu"),
                        jax_base.prep_mesh(obj, N_SAMPLE)):
        np.testing.assert_array_equal(got, ref)
    org, feats = base.prep_mesh_feats(obj, N_SAMPLE)
    _, sampled = base.sample_on_device(feats, N_SAMPLE, "cpu")
    np.testing.assert_array_equal(sampled, jax_base.prep_mesh(obj, N_SAMPLE)[1])
    labels = np.arange(N_SAMPLE)
    np.testing.assert_array_equal(
        base.nn_upsample(labels, sampled[:, :3], org[:, :3]),
        jax_base.nn_upsample(labels, sampled[:, :3], org[:, :3]))


def _small_sample(init):
    """The pipeline's constructor with ``n_sample`` = N_SAMPLE (the CLI
    builds the pipeline itself, at the preset's 24000 points)."""
    def small(self, *args, **kwargs):
        kwargs["n_sample"] = N_SAMPLE
        init(self, *args, **kwargs)
    return small
