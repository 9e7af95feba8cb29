"""The port's train steps of the four cross-entropy families (pointnet,
pointnetpp, dgcnn, pointtransformer) against the JAX package, on the CPU:
the batch, sizes and variables of tests/test_torch_port_train_families.py
(two padded synthetic jaws; DGCNN at dropout 0). A step is held in three
parts:

  * its gradient (``test_step_one_gradients_match_jax``): every
    parameter's ``.grad`` after the port's first ``train_step`` against
    ``jax.grad`` of the loss ``make_train_step`` differentiates, from the
    same variables (the zero-initialised heads drawn, so that every layer
    has a gradient), elementwise within rtol 1e-4 + atol 1e-5 of the
    tensor's largest gradient (``check_gradients``);
  * the Adam presets' update (``test_adam_preset_steps_match_optax``):
    three steps of the port's optimizer and of JAX's ``apply_gradients``
    on the same gradients, every parameter within rtol 1e-4 + atol 1e-5;
  * three SGD steps (``test_steps_match_jax``) of ``train_step`` beside
    ``make_train_step``: each loss within 1e-4 relative every step, every
    parameter and statistic within rtol 1e-4 + atol 1e-5 after steps 1
    and 3. JAX's float32 gradients on the CPU sum in sequence and lie up to
    1.5e-2 of a tensor's largest away from their float64 value here, so
    lr times that must stay under the parameter tolerance: pointnet and
    pointnetpp run at 1e-4, dgcnn and pointtransformer at 0.01, as
    tests/test_torch_port_train_step.py runs tgnet. A tensor with an
    element past that tolerance is held to the same steps of JAX in float64
    instead (``assert_close_or_rounding``): the port no farther from it
    than twice JAX's float32 steps are, in L2 norm. The BatchNorm running means sum a
    few thousand products in an order that follows the SIMD width of the
    host (XLA's and ATen's CPU kernels), so a mean near zero can miss the
    absolute 1e-5 by its own rounding: on an AVX-512 host pointnet's
    ``head.bn_0.mean`` did after step 3 (4 of 512 elements, up to 1.6e-5).

The gradient's reference is the JAX function computed in float64 (x64
enabled, variables and batch cast; its BatchNorms keep the float32 the
module fixes): the port's float32 gradients lie within 1e-5 of each
tensor's largest. JAX takes the port's discrete choices, which the forward
tests hold equal: FPS, ball query and kNN computed in float32
(``float32_selections``), DGCNN's neighbour lists (``shared_selection``
at step 1; over the SGD steps the lists the port chose in each step,
``ReplayedSelection``) and the argmax of every PointNet++ neighbourhood max-pool
(``SharedMaxima``). PointNet++'s gradient still has kinks within rounding
of the step: among its 10^6 grouped ReLU units and max-pools a few are
near-ties that float32 rounding decides, and each moves the gradient of a
whole channel (JAX's own float64 gradient moves by up to 7e-3 in norm when
its parameters move by one part in 10^7). Its tensors, and tsegnet's, are
held within 5e-3 of the reference in L2 norm instead: they lie within
4.4e-4 and 2.3e-3 of it, and with one path detached (sa1's output into
sa2, tsegnet's ``crop_l0``) they miss by about 1. Only a parameter whose
gradient is zero in exact arithmetic, a bias that a train-mode BatchNorm
or the softmax takes out again (``CANCELLED``, named by the layer that
follows it), is held apart: within 1e-5 of the model's largest gradient
in both packages.
"""

import contextlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_port_families import _flat, _t
from test_torch_port_train_families import (LOSS_RTOL, TOL, ReplayedSelection, _batch,
                                            _load, _modules, _variables,
                                            shared_selection)
from toothgroupnetwork_tpu.models import tsegnet as jax_tsegnet_mod
from toothgroupnetwork_tpu.models.point_transformer import backbone as jax_pt_backbone
from toothgroupnetwork_tpu.nn import layers as jax_layers
from toothgroupnetwork_tpu.nn import set_abstraction as jax_sa
from toothgroupnetwork_tpu.ops import interpolate as jax_interpolate
from toothgroupnetwork_tpu.train.loss_meter import LossMap
from toothgroupnetwork_tpu.train.train_state import TrainState
from toothgroupnetwork_tpu.train.train_state import make_optimizer as jax_make_optimizer
from toothgroupnetwork_tpu.train.trainer import make_train_step
from toothgroupnetwork_tpu_torch.nn.set_abstraction import GroupMLP
from toothgroupnetwork_tpu_torch.train import make_optimizer, train_step
from toothgroupnetwork_tpu_torch.utils.weights import from_jax_variables

# Biases whose gradient is zero in exact arithmetic: a Dense bias right
# before a train-mode BatchNorm (PointMLP's and GroupMLP's dense_i before
# bn_i, the heads' first Dense before their BatchNorm, the semantic head's
# stage Dense, the up-stages' linears), the attention's linears before
# linear_p_bn, the softmax or the block's bn2, and a BatchNorm bias that
# only shifts the per-cloud global feature the next BatchNorm normalises
# (PointNet's mlp3.bn_0, DGCNN's emb_bn).
CANCELLED = re.compile(r"(dense_\d+\.bias|(cls|offset|dist)_1\.bias|stage_\d+\.dense\.bias"
                       r"|transformer\.linear_(q|k|v|p0|p1|w0|w1)\.bias|_up\.linear[12]\.bias"
                       r"|mlp3\.bn_0\.bias|emb_bn\.bias)$")
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
KINKED_NORM_RTOL = 5e-3


def jax_state(module, tx, params, batch_stats):
    return TrainState(step=jnp.zeros((), jnp.int32), params=params,
                      batch_stats=batch_stats, opt_state=tx.init(params),
                      apply_fn=module.apply, tx=tx)


# ---------------------------------------------------------------- gradients

def _in_float32(fn):
    """``fn`` on float32 copies of its float arguments, its float results
    cast back to their type: a selection made as the float32 forward
    makes it."""
    def floating(a):
        return jnp.issubdtype(getattr(a, "dtype", np.int32), jnp.floating)

    def cast(a, dtype):
        return a.astype(dtype) if floating(a) else a

    def run(*args, **kwargs):
        dtype = next((a.dtype for a in (*args, *kwargs.values()) if floating(a)),
                     jnp.float32)
        out = fn(*(cast(a, jnp.float32) for a in args),
                 **{k: cast(v, jnp.float32) for k, v in kwargs.items()})
        return jax.tree_util.tree_map(lambda o: cast(o, dtype), out)
    return run


def float32_selections(monkeypatch):
    """JAX's FPS, ball query and kNN (the three-NN and the crops among
    them) computed in float32 inside the float64 reference."""
    for module, names in ((jax_sa, ("ball_query", "farthest_point_sample")),
                          (jax_interpolate, ("knn_points",)),
                          (jax_tsegnet_mod, ("knn_points",)),
                          (jax_pt_backbone, ("farthest_point_sample", "knn_points"))):
        for name in names:
            monkeypatch.setattr(module, name, _in_float32(getattr(module, name)))


class SharedMaxima:
    """JAX's PointNet++ max-pools over a neighbourhood (``jnp.max(h,
    axis=2)`` in nn/set_abstraction.py), inside ``shared()``, take the
    element the port's max-pool took: the argmax of the port's train-mode
    ``GroupMLP`` outputs, recorded in call order since the last
    ``shared()`` (positions JAX masks to -1e30 excluded), each taken once.
    Where two neighbours tie up to rounding, the two packages may pool
    different ones, and the gradient differs in the whole channel; where
    they tie exactly (a neighbour repeated), the split of the gradient
    does not change it."""

    def __init__(self, model):
        self.recorded: list = []
        for m in model.modules():
            if isinstance(m, GroupMLP):
                m.register_forward_hook(self._record)

    def _record(self, module, _args, out):
        if module.training:
            self.recorded.append(out.detach().numpy())

    @contextlib.contextmanager
    def shared(self):
        pending, self.recorded = self.recorded, []
        assert pending

        class Jnp:
            def __getattr__(self, name):
                return getattr(jnp, name)

            @staticmethod
            def max(h, axis):
                assert axis == 2 and pending
                port = pending.pop(0)
                assert port.shape == h.shape, (port.shape, h.shape)
                idx = jnp.argmax(jnp.where(h <= -1e29, -jnp.inf, port), axis=2)
                return jnp.take_along_axis(h, idx[:, :, None, :], axis=2)[:, :, 0, :]

        before, jax_sa.jnp = jax_sa.jnp, Jnp()
        try:
            yield
        finally:
            jax_sa.jnp = before
        assert not pending


class _Float64Jnp:
    """``jnp`` with ``float32`` read as ``float64``: the JAX BatchNorm casts
    its input and its statistics to ``jnp.float32`` (nn/layers.py), so under
    this module object its sums run in float64 too (its output keeps the
    float32 ``dtype`` the module fixes)."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def as_float64(tree):
    """Every floating leaf of ``tree`` as a float64 JAX array (inside
    ``float64_jax``)."""
    return jax.tree_util.tree_map(
        lambda a: (jnp.asarray(a, jnp.float64)
                   if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating) else a), tree)


@contextlib.contextmanager
def float64_jax(monkeypatch):
    """JAX with x64 on and its BatchNorm summing in float64
    (``_Float64Jnp``), the selections (FPS, ball query, kNN) in float32 as
    the float32 forward makes them (``float32_selections``), for the
    block's calls only. Nothing of the JAX package changes on disk."""
    with monkeypatch.context() as m, jax.enable_x64(True):
        float32_selections(m)
        m.setattr(jax_layers, "jnp", _Float64Jnp())
        yield


def assert_close_or_rounding(got, want, reference, err_msg="", rtol=1e-4, atol=1e-5):
    """``got`` (the port, float32) within ``rtol``/``atol`` of ``want`` (JAX
    in float32), or, where an element misses, the tensor no farther from
    ``reference()`` (the same JAX computation in float64) than twice JAX's
    float32 result is, in L2 norm over the tensor (as
    tests/test_torch_port_train_bf16.py holds its bf16 update): the miss is
    then the two packages' float32 rounding, not the port's arithmetic.
    ``reference`` is called only on a miss."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if np.allclose(got, want, rtol=rtol, atol=atol):
        return
    ref = np.asarray(reference(), np.float64)
    port_err, jax_err = np.linalg.norm(got - ref), np.linalg.norm(want - ref)
    assert port_err <= 2 * jax_err, (
        f"{err_msg}: past rtol {rtol} + atol {atol} of JAX (largest "
        f"{np.abs(got - want).max():.3g}), and {port_err:.3g} from JAX in float64 "
        f"against JAX float32's {jax_err:.3g}")


def jax_loss_and_grad(jtask, jcfg, module, variables, batch):
    """The losses and, in float64, the gradient of their weighted sum (what
    ``make_train_step`` differentiates) with respect to the parameters, at
    ``variables`` on ``batch``. Returns ({loss: float}, port-named float32
    gradients)."""
    key = jax.random.fold_in(jax.random.PRNGKey(jcfg.seed + 1), 0)

    def loss_fn(params, batch_stats, batch):
        outputs, _ = module.apply(
            {"params": params, "batch_stats": batch_stats}, batch["feat"],
            batch.get("mask"), True, mutable=["batch_stats"], rngs={"dropout": key},
            **jtask.forward_kwargs(batch))
        losses = jtask.compute_losses(outputs, batch, jcfg)
        return LossMap(losses).get_sum(), {k: v for k, (v, _) in losses.items()}

    with jax.enable_x64(True):
        def as64(tree):
            return jax.tree_util.tree_map(
                lambda a: (jnp.asarray(a, jnp.float64)
                           if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating)
                           else jnp.asarray(a)), tree)
        (_, values), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            as64(variables["params"]), as64(variables["batch_stats"]), as64(batch))
        return ({k: float(v) for k, v in values.items()},
                from_jax_variables(_flat({"params": grads})))


def check_gradients(model, ref: dict, norm_rtol: float | None = None) -> None:
    """Every parameter's ``.grad`` within rtol 1e-4 + atol 1e-5 of the
    tensor's largest reference gradient, elementwise, or (``norm_rtol``,
    for a model whose max-pools and ReLUs put kinks within rounding of
    the step) within ``norm_rtol`` of the reference in L2 norm; a
    ``CANCELLED`` one within 1e-5 of the model's largest gradient, in both
    packages."""
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert set(grads) == set(ref)
    top = max(float(g.abs().max()) for g in ref.values())
    assert top > 0
    for key, want in ref.items():
        got, want = grads[key].numpy(), want.numpy()
        if CANCELLED.search(key):
            assert np.abs(got).max() <= GRAD_ATOL * top, key
            assert np.abs(want).max() <= GRAD_ATOL * top, key
        elif norm_rtol is not None:
            err = float(np.linalg.norm(got - want))
            assert err <= norm_rtol * float(np.linalg.norm(want)), (key, err)
        else:
            np.testing.assert_allclose(got, want, rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL * np.abs(want).max(), err_msg=key)


FAMILIES = ("pointnet", "pointnetpp", "dgcnn", "pointtransformer")


@pytest.mark.parametrize("name", FAMILIES)
def test_step_one_gradients_match_jax(monkeypatch, name):
    """The port's first ``train_step`` (its preset optimizer at lr 0, so
    that only the gradient is read) against the float64 JAX gradient, as
    the module docstring holds it; the losses within 1e-4 relative."""
    if name == "dgcnn":
        shared_selection(monkeypatch)
    float32_selections(monkeypatch)
    jtask, jcfg, module, ptask, pcfg, model = _modules(name)
    b = _batch()
    vs = _variables(name, module, b)
    model = _load(model, vs)
    maxima = SharedMaxima(model)
    optimizer = make_optimizer(pcfg.optimizer, model.parameters())
    for group in optimizer.param_groups:
        group["lr"] = 0.0
    pvals = train_step(model, optimizer, ptask, pcfg, {k: _t(v) for k, v in b.items()})
    with maxima.shared() if name == "pointnetpp" else contextlib.nullcontext():
        jvals, ref = jax_loss_and_grad(jtask, jcfg, module, vs, b)
    assert set(pvals) == set(jvals)
    for key, val in jvals.items():
        assert float(pvals[key]) == pytest.approx(val, rel=LOSS_RTOL), key
    check_gradients(model, ref, KINKED_NORM_RTOL if name == "pointnetpp" else None)


# ---------------------------------------------------------------- Adam

def check_adam_steps(jcfg, pcfg, module, model, vs, rng) -> None:
    """Three steps of the port's optimizer (``make_optimizer`` of the
    preset) and of JAX's (``apply_gradients``, as ``make_train_step``
    applies it), each fed the same gradients: normal draws scaled by
    10^U(-10, 0) elementwise, from under Adam's epsilon to the size of a
    real gradient. Every parameter within rtol 1e-4 + atol 1e-5 after
    steps 1 and 3."""
    assert jcfg.optimizer.name == pcfg.optimizer.name == "adam"
    assert (jcfg.optimizer.lr, jcfg.optimizer.weight_decay) == (
        pcfg.optimizer.lr, pcfg.optimizer.weight_decay)
    tx = jax_make_optimizer(jcfg.optimizer)
    state = jax_state(module, tx, vs["params"], vs["batch_stats"])
    optimizer = make_optimizer(pcfg.optimizer, model.parameters())
    params = dict(model.named_parameters())
    apply = jax.jit(lambda s, g: s.apply_gradients(g))
    for step in (1, 2, 3):
        grads = jax.tree_util.tree_map(
            lambda a: jnp.asarray(rng.standard_normal(a.shape)
                                  * 10.0 ** rng.uniform(-10, 0, a.shape), a.dtype),
            state.params)
        state = apply(state, grads)
        for key, g in from_jax_variables(_flat({"params": grads})).items():
            params[key].grad = g
        optimizer.step()
        if step == 2:
            continue
        want = from_jax_variables(_flat({"params": state.params}))
        for key, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(), want[key].numpy(),
                                       err_msg=f"step {step} {key}", **TOL)


@pytest.mark.parametrize("name", ["pointnet", "pointnetpp", "dgcnn"])
def test_adam_preset_steps_match_optax(rng, name):
    """The Adam presets (lr 1e-3, L2 decay 1e-4 folded into the gradient)
    over the family's parameters."""
    jtask, jcfg, module, ptask, pcfg, model = _modules(name)
    vs = _variables(name, module, _batch(), draw_zero_heads=False)
    check_adam_steps(jcfg, pcfg, module, _load(model, vs), vs, rng)


# ---------------------------------------------------------------- SGD

STEP_CASES = [("pointnet", "sgd", 1e-4), ("pointnetpp", "sgd", 1e-4),
              ("dgcnn", "sgd", 1e-2), ("pointtransformer", "sgd", 1e-2)]


def _variables_of(state) -> dict:
    return from_jax_variables(_flat({"params": state.params,
                                     "batch_stats": state.batch_stats}))


def check_state(model, state, step, reference=None) -> None:
    """Every parameter and statistic of ``model`` within rtol 1e-4 + atol
    1e-5 of JAX's ``state``, or, tensor by tensor, as near to
    ``reference()`` (the port-named float64 state after the same steps) as
    ``assert_close_or_rounding`` holds it."""
    want = _variables_of(state)
    for key, val in [*model.named_parameters(), *model.named_buffers()]:
        assert_close_or_rounding(val.detach().numpy(), want[key].numpy(),
                                 lambda key=key: reference()[key].numpy(),
                                 err_msg=f"step {step} {key}", **TOL)


@pytest.mark.parametrize("name,opt,lr", STEP_CASES)
def test_steps_match_jax(monkeypatch, name, opt, lr):
    """Steps 1-3 beside JAX ``make_train_step`` from the same variables
    (the zero-initialised heads at zero, as training starts): the loss
    every step, every parameter and statistic after steps 1 and 3. Each
    port step runs first, and JAX's DGCNN takes the neighbour lists that
    step chose (``ReplayedSelection``), in float32 and in the float64
    reference alike."""
    selection = ReplayedSelection(monkeypatch) if name == "dgcnn" else None

    def record():
        return selection.record() if selection else contextlib.nullcontext()

    def replay(step):
        return selection.replay(step) if selection else contextlib.nullcontext()

    jtask, jcfg, module, ptask, pcfg, model = _modules(name)
    for cfg in (jcfg, pcfg):
        cfg.optimizer.name, cfg.optimizer.lr = opt, lr
    b = _batch()
    vs = _variables(name, module, b, draw_zero_heads=False)
    state = jax_state(module, jax_make_optimizer(jcfg.optimizer), vs["params"],
                      vs["batch_stats"])
    jstep = jax.jit(make_train_step(jtask, jcfg))
    db = {k: jnp.asarray(v) for k, v in b.items()}
    model = _load(model, vs)
    optimizer = make_optimizer(pcfg.optimizer, model.parameters())
    tb = {k: _t(v) for k, v in b.items()}
    float64_states: list = []
    float64_run: dict = {}

    def reference(step):
        """The port-named state after ``step`` JAX steps in float64 from the
        same variables (``float64_jax``), each step computed on the first
        miss that needs it."""
        with float64_jax(monkeypatch):
            if not float64_run:
                float64_run["state"] = jax_state(
                    module, jax_make_optimizer(jcfg.optimizer),
                    as_float64(vs["params"]), as_float64(vs["batch_stats"]))
                float64_run["step"] = jax.jit(make_train_step(jtask, jcfg))
            while len(float64_states) < step:
                with replay(len(float64_states) + 1):
                    s64, _ = float64_run["step"](float64_run["state"], as_float64(db))
                    jax.block_until_ready(s64)
                float64_run["state"] = s64
                float64_states.append(_variables_of(s64))
        return float64_states[step - 1]

    for step in (1, 2, 3):
        with record():
            pvals = train_step(model, optimizer, ptask, pcfg, tb)
        with replay(step):
            state, jvals = jax.block_until_ready(jstep(state, db))
        assert set(pvals) == set(jvals) == {"tooth_class_loss_1"}
        for key, val in jvals.items():
            assert float(pvals[key]) == pytest.approx(float(val), rel=LOSS_RTOL), (step, key)
        if step != 2:
            check_state(model, state, step, lambda step=step: reference(step))
