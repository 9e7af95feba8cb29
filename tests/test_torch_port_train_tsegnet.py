"""The port's tsegnet training against the JAX package, on the CPU: the
losses (``losses/tsg_loss.py``), the task's host stage, ``forward_kwargs``,
the train forward over 8 crop slots, the step-1 gradient on fixed
proposals, the Adam preset's update, three ``make_train_step`` states with
both packages' host stages and the port's step from each, and
``cli.train --model_name tsegnet``.

The model is the JAX package's tiny backbone with crops of 64 over a
synthetic jaw of 512 slots (448 valid). Random weights give no crop
proposal (the moved l3 points scatter, and DBSCAN finds no cluster), so for
the host-stage steps the centroid heads are least-squares fitted to the
cloud (``fit_centroid_heads`` of tests/test_torch_port_tsegnet.py: two
clusters of the 8 l3 points), and the seg losses run on two valid crop
slots of 8.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthetic import make_synthetic_jaw_points
from test_torch_port_families import _flat, _t, assert_close, jax_init, randomize_variables
from test_torch_port_train import _processed
from test_torch_port_train_families_steps import (KINKED_NORM_RTOL, SharedMaxima,
                                                  as_float64, assert_close_or_rounding,
                                                  check_adam_steps, check_gradients,
                                                  float32_selections, float64_jax,
                                                  jax_loss_and_grad, jax_state)
from test_torch_port_tsegnet import fit_centroid_heads
from toothgroupnetwork_tpu.losses import tsg_loss as jax_tsg
from toothgroupnetwork_tpu.models import get_task as jax_get_task
from toothgroupnetwork_tpu.models import tasks as jax_tasks
from toothgroupnetwork_tpu.train.train_state import make_optimizer as jax_make_optimizer
from toothgroupnetwork_tpu.train.trainer import make_train_step
from toothgroupnetwork_tpu_torch.cli import train as cli_train
from toothgroupnetwork_tpu_torch.losses import tsg_loss
from toothgroupnetwork_tpu_torch.models import get_task
from toothgroupnetwork_tpu_torch.models.tsegnet import N_CROPS_TRAIN, TSegNetModule
from toothgroupnetwork_tpu_torch.train import make_optimizer, train_step
from toothgroupnetwork_tpu_torch.utils.weights import from_jax_variables, init_like_flax_

N, N_VALID, CROP = 512, 448, 64
MP = {"tiny_backbone": True, "crop_sample_size": CROP}
SIX = {"dist_loss", "cent_loss", "chamf_loss", "seg_1_loss", "seg_2_loss",
       "id_pred_loss"}


def _batch() -> dict:
    """One synthetic jaw (8 teeth), unit z normals, 64 padded slots."""
    pts, _, cls = make_synthetic_jaw_points(N_VALID, 8, seed=7)
    feat = np.zeros((1, N, 6), np.float32)
    feat[0, :N_VALID, :3] = pts
    feat[0, :N_VALID, 5] = 1.0
    labels = np.full((1, N), -1, np.int32)
    labels[0, :N_VALID] = cls - 1
    return {"feat": feat, "gt_seg_label": labels, "mask": np.arange(N)[None] < N_VALID}


def _configs():
    jtask, ptask = jax_get_task("tsegnet"), get_task("tsegnet")
    jcfg, pcfg = jtask.default_config(), ptask.default_config()
    for cfg in (jcfg, pcfg):
        cfg.model_parameter.update(MP)
    return jtask, jcfg, ptask, pcfg


_INIT: dict = {}


def _init_variables(module, b):
    """flax's init of the tsegnet module, once per process (every test here
    builds it from one config on one batch shape)."""
    if not _INIT:
        _INIT["variables"] = jax_init(
            module, jnp.asarray(b["feat"]), None, train=False,
            center_points=jnp.zeros((1, N_CROPS_TRAIN, 3), jnp.float32),
            center_valid=jnp.ones((1, N_CROPS_TRAIN), bool))
    return _INIT["variables"]


# ---------------------------------------------------------------- losses

def _loss_inputs(rng):
    """Inputs of every tsg loss: 40 l3 points of 2 clouds, 16 centroid
    slots (5 invalid in cloud 1), 6 crops of 32 points."""
    b, m, k, s = 2, 40, 6, 32
    cents = rng.uniform(-0.5, 0.5, (b, 16, 3)).astype(np.float32)
    cvalid = np.ones((b, 16), bool)
    cvalid[1, 11:] = False
    xyz = (cents[:, rng.integers(0, 11, m)] + rng.normal(0, 0.2, (b, m, 3))).astype(np.float32)
    logits = rng.standard_normal((k, s, 2)).astype(np.float32)
    return {
        "pred_offset": rng.normal(0, 0.1, (b, m, 3)).astype(np.float32),
        "sample_xyz": xyz,
        "pred_distance": rng.uniform(0.0, 0.4, (b, m, 1)).astype(np.float32),
        "centroids": cents, "cent_valid": cvalid,
        "mask": rng.random((b, m)) > 0.2,
        "pd_1": np.exp(logits) / np.exp(logits).sum(-1, keepdims=True),
        "weight_1": rng.standard_normal((k, s, 1)).astype(np.float32),
        "pd_2": rng.standard_normal((k, s, 1)).astype(np.float32),
        "gt_bin": (rng.random((k, s)) > 0.5).astype(np.int32),
        "crop_mask": rng.random((k, s)) > 0.3,
        "id_pred": rng.standard_normal((k, 17)).astype(np.float32),
        "gt_ids": rng.integers(0, 17, k).astype(np.int32),
        "crop_valid": np.array([True, True, True, False, True, False]),
    }


# (function, its float arguments, the rest); each with and without its mask
LOSSES = {
    "distance_loss": (("pred_distance", "sample_xyz", "centroids"), ("cent_valid", "mask")),
    "centroid_dist_loss": (("pred_offset", "sample_xyz", "pred_distance", "centroids"),
                           ("cent_valid", "mask")),
    "chamfer_distance_loss": (("pred_offset", "sample_xyz", "centroids"),
                              ("cent_valid", "mask")),
    "first_seg_loss": (("pd_1", "weight_1"), ("gt_bin", "crop_mask")),
    "second_seg_loss": (("pd_2", "weight_1"), ("gt_bin", "crop_mask")),
    "id_loss": (("id_pred",), ("gt_ids", "crop_valid")),
}


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("fn", sorted(LOSSES))
def test_tsg_loss_and_grad_match_jax(rng, fn, masked):
    """Each loss and its gradient with respect to every float input
    (``jax.grad`` against autograd): the value within 1e-6 relative, the
    gradients within 1e-5 of the largest (float32 sums in other orders);
    an input the loss only thresholds has no gradient in the port and a
    zero one in JAX."""
    inputs = _loss_inputs(rng)
    floats, rest = LOSSES[fn]
    rest = rest if masked else rest[:-1]
    jfn = getattr(jax_tsg, fn)
    jval, jgrads = jax.value_and_grad(
        lambda *f: jfn(*f, *[jnp.asarray(inputs[r]) for r in rest]),
        argnums=tuple(range(len(floats))))(*[jnp.asarray(inputs[f]) for f in floats])
    args = [_t(inputs[f]).requires_grad_(True) for f in floats]
    val = getattr(tsg_loss, fn)(*args, *[_t(inputs[r]) for r in rest])
    val.backward()
    assert float(val) == pytest.approx(float(jval), rel=1e-6, abs=1e-7)
    assert float(jval) != 0.0
    for name, a, g in zip(floats, args, jgrads):
        if a.grad is None:      # only compared with a threshold
            assert not np.asarray(g).any(), name
        else:
            assert_close(a.grad.numpy(), np.asarray(g), 1e-5)


def test_smooth_l1_and_the_centroid_loss_triple(rng):
    x = np.linspace(-3, 3, 61, dtype=np.float32)
    np.testing.assert_allclose(tsg_loss.smooth_l1(_t(x), _t(x * 0)).numpy(),
                               np.asarray(jax_tsg.smooth_l1(x, x * 0)), rtol=1e-7)
    inputs = _loss_inputs(rng)
    names = ("pred_offset", "sample_xyz", "pred_distance", "centroids", "cent_valid",
             "mask")
    ref = jax_tsg.centroid_loss(*[jnp.asarray(inputs[n]) for n in names])
    got = tsg_loss.centroid_loss(*[_t(inputs[n]) for n in names])
    for g, r in zip(got, ref):
        assert float(g) == pytest.approx(float(r), rel=1e-6)


# ---------------------------------------------------------------- host stage

def _stand_in_outputs(rng, clusters: int = 12, m: int = 256):
    """A centroid forward's outputs with ``clusters`` tight groups of moved
    l3 points (predicted distance 0.1), 20 far noise points, and 30 points
    whose predicted distance (0.5) drops them."""
    centres = rng.uniform(-1, 1, (clusters, 3))
    l3 = rng.uniform(-1, 1, (1, m, 3)).astype(np.float32)
    moved = np.concatenate([centres[rng.integers(0, clusters, m - 20)]
                            + rng.uniform(-0.004, 0.004, (m - 20, 3)),
                            rng.uniform(5, 9, (20, 3))])
    dist = np.full((1, m, 1), 0.1, np.float32)
    dist[0, rng.permutation(m)[:30]] = 0.5
    return {"l3_xyz": l3, "offset_result": (moved[None] - l3).astype(np.float32),
            "dist_result": dist}


class _StandInModel(torch.nn.Module):
    """The port's side of the stand-in: ``centroid_forward`` returns the
    recorded outputs."""

    def __init__(self, outputs):
        super().__init__()
        self.outputs = outputs
        self.anchor = torch.nn.Parameter(torch.zeros(1))

    def centroid_forward(self, feat, mask=None):
        return {k: torch.from_numpy(v) for k, v in self.outputs.items()}


@pytest.mark.parametrize("clusters,step", [(12, 0), (12, 5), (5, 3), (0, 1)])
def test_host_stage_matches_jax_through_a_stand_in(rng, clusters, step):
    """The host stage of both tasks on one recorded centroid forward (the
    JAX state's ``apply_fn`` and the port's model return the same arrays):
    proposals ``array_equal`` (sklearn's DBSCAN in JAX, the port's numpy
    one; at most 8 clusters drawn by ``default_rng(step)``, the rest of the
    slots at the 1e3 sentinel and invalid)."""
    outputs = (_stand_in_outputs(rng, clusters) if clusters else
               {"l3_xyz": np.zeros((1, 8, 3), np.float32),
                "offset_result": rng.uniform(-1, 1, (1, 8, 3)).astype(np.float32),
                "dist_result": np.full((1, 8, 1), 0.1, np.float32)})
    jouts = {k: jnp.asarray(v) for k, v in outputs.items()}
    state = types.SimpleNamespace(
        apply_fn=lambda variables, feat, mask, method: jouts,
        params={}, batch_stats={}, step=jnp.asarray(step, jnp.int32))
    b = _batch()
    ref = jax_get_task("tsegnet").host_stage(state, b, None)
    got = get_task("tsegnet").host_stage(_StandInModel(outputs), b, None, step=step)
    assert set(got) == set(ref) == {"center_points", "center_valid"}
    for key in ref:
        np.testing.assert_array_equal(got[key], np.asarray(ref[key]), err_msg=key)
    assert got["center_points"].shape == (1, N_CROPS_TRAIN, 3)
    assert int(got["center_valid"].sum()) == min(clusters, N_CROPS_TRAIN)


def test_host_stage_runs_the_centroid_module_in_eval_mode():
    """The stage reads the running statistics (the centroid forward in eval
    mode, without gradients) and leaves a training model in train mode."""
    model = TSegNetModule(crop_size=CROP, tiny_backbone=True, device="cpu")
    init_like_flax_(model, torch.Generator().manual_seed(0))
    model.train()
    before = {k: v.clone() for k, v in model.named_buffers()}
    b = _batch()
    get_task("tsegnet").host_stage(model, b, None, step=0)
    assert model.training and all(m.training for m in model.modules())
    assert all(torch.equal(v, before[k]) for k, v in model.named_buffers())
    with torch.no_grad():
        out = model.centroid_forward(_t(b["feat"]), _t(b["mask"]))
        model.eval()
        want = model.cent_module(_t(b["feat"]), _t(b["mask"]))
    assert torch.equal(out["offset_result"], want["offset_result"])


def test_forward_kwargs_match_jax():
    """No proposals yet: ``N_CROPS_TRAIN`` zero centres, all valid; with
    proposals: the batch's."""
    b = _batch()
    ref = jax_tasks._tsegnet_forward_kwargs(b)
    got = get_task("tsegnet").forward_kwargs({k: _t(v) for k, v in b.items()})
    for key in ref:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]))
    assert got["center_points"].shape == (1, 8, 3) and bool(got["center_valid"].all())
    cp = np.ones((1, 8, 3), np.float32)
    cv = np.arange(8)[None] < 3
    got = get_task("tsegnet").forward_kwargs({**b, "center_points": _t(cp),
                                              "center_valid": _t(cv)})
    ref = jax_tasks._tsegnet_forward_kwargs({**b, "center_points": cp, "center_valid": cv})
    for key in ref:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]))


# ---------------------------------------------------------------- model

def _proposals(rng, b):
    """8 crop centres near points of the jaw, three slots invalid."""
    cp = (b["feat"][:, rng.permutation(N_VALID)[:8], :3]
          + rng.normal(0, 0.02, (1, 8, 3))).astype(np.float32)
    return cp, np.array([[True, True, False, True, True, False, True, False]])


def test_train_forward_with_eight_slots(rng):
    """The train forward (``apply(..., True, mutable=["batch_stats"])``)
    over 8 crop slots, three of them invalid, on the padded cloud: the
    crops' indexes of the valid slots equal, the centroid outputs, the seg
    outputs of the valid slots within 1e-4 of the largest, and every
    mutated BatchNorm statistic within rtol 1e-4 + atol 1e-5."""
    jtask, jcfg, ptask, pcfg = _configs()
    module = jtask.build_module(jcfg)
    b = _batch()
    vs = randomize_variables(_init_variables(module, b), rng)
    cp, cv = _proposals(rng, b)
    ref, mutated = jax.jit(lambda v, f, m, p, q: module.apply(
        v, f, m, True, mutable=["batch_stats"], center_points=p, center_valid=q))(
        vs, *(jnp.asarray(a) for a in (b["feat"], b["mask"], cp, cv)))
    model = ptask.build_module(pcfg, device="cpu")
    model.load_state_dict(from_jax_variables(_flat(vs)))
    model.train()
    with torch.no_grad():
        got = model(_t(b["feat"]), _t(b["mask"]), **ptask.forward_kwargs(
            {"feat": _t(b["feat"]), "center_points": _t(cp), "center_valid": _t(cv)}))
    live = cv[0]
    np.testing.assert_array_equal(got["nn_crop_indexes"].numpy()[:, live],
                                  np.asarray(ref["nn_crop_indexes"])[:, live])
    np.testing.assert_array_equal(got["crop_mask"].numpy(), np.asarray(ref["crop_mask"]))
    for key in ("offset_result", "dist_result", "l3_points"):
        assert_close(got[key].numpy(), np.asarray(ref[key]))
    for key in ("pd_1", "weight_1", "pd_2", "id_pred", "cropped_feature_ls"):
        assert_close(got[key].numpy()[live], np.asarray(ref[key])[live])
    want = from_jax_variables(_flat({"batch_stats": mutated["batch_stats"]}))
    buffers = dict(model.named_buffers())
    assert set(buffers) == set(want)
    for key, buf in buffers.items():
        np.testing.assert_allclose(buf.numpy(), want[key].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=key)


def test_init_like_flax():
    """Zeros exactly where flax's init has zeros (the centroid heads'
    ``offset_2``/``dist_2`` and the id head ``fc2``, its bias too), the
    other constants equal (the id head's LayerNorm 1 and 0)."""
    jtask, jcfg, ptask, pcfg = _configs()
    b = _batch()
    ref = from_jax_variables(_flat(_init_variables(jtask.build_module(jcfg), b)))
    model = ptask.build_module(pcfg, device="cpu")
    init_like_flax_(model, torch.Generator().manual_seed(0))
    state = model.state_dict()
    assert set(state) == set(ref)
    for key, want in ref.items():
        if not want.any():
            assert not state[key].any(), key
        elif key.endswith(".weight"):
            assert state[key].all(), key
        else:
            assert torch.equal(state[key], want), key
    for key in ("cent_module.offset_2.weight", "cent_module.dist_2.weight",
                "seg_module.fc2.weight", "seg_module.fc2.bias"):
        assert not state[key].any(), key


def _step_batch(rng, b):
    """The batch with 8 fixed crop proposals, three of them invalid."""
    cp, cv = _proposals(rng, b)
    return {**b, "center_points": cp, "center_valid": cv}


def test_step_one_gradients_match_jax(rng, monkeypatch):
    """The port's first ``train_step`` on fixed proposals (the preset's
    Adam at lr 0, so that only the gradient is read) against the float64
    JAX gradient of the six losses, held as
    tests/test_torch_port_train_families_steps.py holds PointNet++ (its
    towers' max-pools taken where the port took them, every tensor within
    5e-3 in L2 norm): the centroid backbone's gradient through the centroid
    losses and through ``crop_l0`` into the seg towers, the seg, id and
    LayerNorm heads' (drawn, so that every layer has a gradient)."""
    float32_selections(monkeypatch)
    jtask, jcfg, ptask, pcfg = _configs()
    module = jtask.build_module(jcfg)
    b = _step_batch(rng, _batch())
    vs = randomize_variables(_init_variables(module, b), rng)
    model = ptask.build_module(pcfg, device="cpu")
    model.load_state_dict(from_jax_variables(_flat(vs)))
    maxima = SharedMaxima(model)
    optimizer = make_optimizer(pcfg.optimizer, model.parameters())
    for group in optimizer.param_groups:
        group["lr"] = 0.0
    pvals = train_step(model, optimizer, ptask, pcfg, {k: _t(v) for k, v in b.items()})
    with maxima.shared():
        jvals, ref = jax_loss_and_grad(jtask, jcfg, module, vs, b)
    assert set(pvals) == set(jvals) == SIX
    for key, val in jvals.items():
        assert val > 0 and float(pvals[key]) == pytest.approx(val, rel=1e-4), key
    check_gradients(model, ref, KINKED_NORM_RTOL)


def test_adam_preset_steps_match_optax(rng):
    """The Adam preset (lr 1e-3, L2 decay 1e-4) over tsegnet's parameters:
    tests/test_torch_port_train_families_steps.py's ``check_adam_steps``."""
    jtask, jcfg, ptask, pcfg = _configs()
    module = jtask.build_module(jcfg)
    vs = _init_variables(module, _batch())
    model = ptask.build_module(pcfg, device="cpu")
    model.load_state_dict(from_jax_variables(_flat(vs)))
    check_adam_steps(jcfg, pcfg, module, model, vs, rng)


def match_running_stats(variables, port, feat, mask):
    """Set every BatchNorm's running statistics of the centroid module to
    its train-mode batch statistics on ``feat`` (the masked mean and biased
    variance), so that the eval-mode centroid forward of the host stage
    equals the train-mode one of the step on this batch. Returns the new
    flax variables (``port`` is changed too)."""
    from toothgroupnetwork_tpu_torch.nn.layers import MaskedBatchNorm

    stats, hooks = {}, []
    for name, m in port.cent_module.named_modules():
        if isinstance(m, MaskedBatchNorm):
            def capture(_m, args, name=name):
                x = args[0].double().reshape(-1, args[0].shape[-1])
                w = (torch.ones(x.shape[0], dtype=torch.float64) if args[1] is None
                     else args[1].reshape(-1).double())
                mean = (x * w[:, None]).sum(0) / w.sum()
                var = (((x - mean) ** 2) * w[:, None]).sum(0) / w.sum()
                stats["cent_module." + name] = (mean.float(), var.float())
            hooks.append(m.register_forward_pre_hook(capture))
    port.cent_module.train()
    with torch.no_grad():
        port.cent_module(_t(feat), _t(mask))
    port.eval()
    for h in hooks:
        h.remove()
    with torch.no_grad():
        for name, (mean, var) in stats.items():
            bn = port.get_submodule(name)
            bn.mean.copy_(mean)
            bn.var.copy_(var)

    def set_stats(kp, a):
        keys = [str(getattr(k, "key", k)) for k in kp]
        name = ".".join(keys[1:-1])
        if keys[0] == "batch_stats" and name in stats:
            return jnp.asarray(stats[name][keys[-1] == "var"].numpy())
        return a
    return jax.tree_util.tree_map_with_path(set_stats, variables)


def test_steps_with_the_host_stage_match_jax(monkeypatch, rng):
    """Three steps of JAX ``make_train_step`` at the Adam preset (lr 1e-4:
    at its 1e-3 the first step already scatters the fitted proposals), the
    host stage before each (the analog of tests/test_tsegnet.py's
    ``test_host_stage_and_train_step``), and at each of the three states
    the port's host stage and ``train_step`` from the same variables: the
    proposals agree (validity equal, centres within 1e-5), the six losses
    within 1e-4 relative, the mutated statistics within rtol 1e-4 + atol
    1e-5, or, for a statistic with an element past that, no farther from
    the same JAX step in float64 than twice JAX's float32 step is
    (``assert_close_or_rounding``: on an AVX-512 host step 2's
    ``seg_module.flatten_sa.mlp.bn_0.mean`` missed by 1.95e-5 in 1 of 256
    elements, a masked mean's sum in another order). (The step's gradient: ``test_step_one_gradients_match_jax``;
    the preset's update: ``test_adam_preset_steps_match_optax``.) The
    centroid module starts with this batch's statistics as running
    statistics (``match_running_stats``: fitted in eval mode, its heads
    then give the train-mode step the same clustered offsets) and heads
    fitted so that DBSCAN proposes two crops."""
    jtask, jcfg, ptask, pcfg = _configs()
    jcfg.optimizer.lr = 1e-4
    module = jtask.build_module(jcfg)
    b = _batch()
    vs = randomize_variables(_init_variables(module, b), rng)
    probe = ptask.build_module(pcfg, device="cpu")
    probe.load_state_dict(from_jax_variables(_flat(vs)))
    vs = match_running_stats(vs, probe, b["feat"], b["mask"])
    # fitted on the valid points: the host stage's masked forward sees
    # the same l3 points
    vs = fit_centroid_heads(vs, probe, b["feat"][:, :N_VALID], rng, groups=2)
    state = jax_state(module, jax_make_optimizer(jcfg.optimizer), vs["params"],
                      vs["batch_stats"])
    jstep = jax.jit(make_train_step(jtask, jcfg))
    model = ptask.build_module(pcfg, device="cpu")
    optimizer = make_optimizer(pcfg.optimizer, model.parameters())
    for step in (1, 2, 3):
        variables = {"params": state.params, "batch_stats": state.batch_stats}
        model.load_state_dict(from_jax_variables(_flat(variables)))
        extra = jtask.host_stage(state, b, jcfg)
        pextra = ptask.host_stage(model, b, pcfg, step=step - 1)
        assert extra["center_points"].shape == (1, N_CROPS_TRAIN, 3)
        np.testing.assert_array_equal(pextra["center_valid"], extra["center_valid"])
        live = pextra["center_valid"]
        assert int(live.sum()) == 2
        np.testing.assert_allclose(pextra["center_points"][live],
                                   extra["center_points"][live], rtol=0, atol=1e-5)
        jb = {**b, **extra}
        before, float64_stats = state, {}

        def reference(key, before=before, jb=jb, float64_stats=float64_stats):
            """The statistics after this step taken by JAX in float64 from
            the same state and proposals, computed on the first miss."""
            if not float64_stats:
                with float64_jax(monkeypatch):
                    s64 = jax_state(module, jax_make_optimizer(jcfg.optimizer),
                                    as_float64(before.params),
                                    as_float64(before.batch_stats))
                    s64, _ = jax.jit(make_train_step(jtask, jcfg))(
                        s64, as_float64({k: jnp.asarray(v) for k, v in jb.items()}))
                    float64_stats.update(from_jax_variables(
                        _flat({"batch_stats": s64.batch_stats})))
            return float64_stats[key].numpy()

        state, jvals = jstep(state, {k: jnp.asarray(v) for k, v in jb.items()})
        pvals = train_step(model, optimizer, ptask, pcfg,
                           {k: _t(np.asarray(v)) for k, v in jb.items()})
        assert set(pvals) == set(jvals) == SIX
        assert all(float(pvals[k]) > 0 for k in ("seg_1_loss", "seg_2_loss",
                                                 "id_pred_loss"))
        for key, val in jvals.items():
            assert float(pvals[key]) == pytest.approx(float(val), rel=1e-4), (step, key)
        want = from_jax_variables(_flat({"batch_stats": state.batch_stats}))
        for key, buf in model.named_buffers():
            assert_close_or_rounding(buf.numpy(), want[key].numpy(),
                                     lambda key=key, ref=reference: ref(key),
                                     err_msg=f"step {step} {key}", rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------- CLI

def test_cli_train_one_epoch(tmp_path):
    """``cli.train --model_name tsegnet --device cpu`` for one epoch with a
    config the JAX package wrote (the tiny backbone, crops of 64): the host
    stage before every train and val step, both checkpoint slots, a finite
    val loss."""
    d = _processed(tmp_path, n=3, n_points=256)
    jcfg = jax_get_task("tsegnet").default_config()
    jcfg.model_parameter.update(MP)
    jcfg.save_json(str(tmp_path / "cfg.json"))
    trainer = cli_train.main([
        "--model_name", "tsegnet", "--config_path", str(tmp_path / "cfg.json"),
        "--input_data_dir_path", d, "--checkpoint_path", str(tmp_path / "ck" / "tsg"),
        "--max_epochs", "1", "--device", "cpu"])
    assert trainer.epoch == 1 and trainer.step == 3
    assert np.isfinite(trainer.best_val)
    assert (tmp_path / "ck" / "tsg_val").exists()
