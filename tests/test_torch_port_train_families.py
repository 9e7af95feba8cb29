"""The port's training of the four cross-entropy families (pointnet,
pointnetpp, dgcnn, pointtransformer) against the JAX package, on the CPU.

The sizes are those of tests/test_torch_port_families.py (pointnet and
pointnetpp at scale 1, dgcnn at k = 8, a narrow pointtransformer). The
batch holds two synthetic jaws of 512 slots each, 32 and 64 of them padding
outside the mask. Two clouds, not one: at batch 1 a per-cloud global
feature (PointNet's and DGCNN's max-pooled embedding) is constant over the
points a train-mode BatchNorm normalises, so its whole branch has a zero
gradient in exact arithmetic and trains on rounding noise in either
package. Weights are the flax init with every BatchNorm statistic, bias and
scale jittered and the zero-initialised heads drawn
(``randomize_variables``), carried to the port by ``from_jax_variables``.

  * ``init_like_flax_`` against ``module.init``: zeros exactly where flax
    has zeros (the zero-initialised heads among them), the other constants
    equal, every other Dense kernel from lecun_normal;
  * the train forward (``apply(..., True, mutable=["batch_stats"])``): the
    outputs at the valid points within 1e-4 of the largest output, every
    mutated statistic within rtol 1e-4 + atol 1e-5;
  * (1 and 3 steps against JAX ``make_train_step``:
    tests/test_torch_port_train_families_steps.py);
  * DGCNN runs at dropout 0 in both packages and the JAX model is given the
    port's feature-space neighbour lists through a ``pure_callback`` on
    ``stop_gradient(x)`` (only the indices cross; near-ties swap between
    JAX's matmul expansion and the port's fixed-order sum,
    tests/test_torch_port_families.py holds the selection itself); over
    several steps it replays the lists the port chose on its own features
    (``ReplayedSelection``). The port's dropout is held to its contract in
    a test of its own;
  * ``cli.train --device cpu`` for one epoch for each name.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthetic import make_synthetic_jaw_points
from test_torch_port_families import (SMALL_PARAMS, _flat, _t, assert_close,
                                      jax_init, randomize_variables)
from test_torch_port_train import _processed
from toothgroupnetwork_tpu.models import dgcnn as jax_dgcnn_mod
from toothgroupnetwork_tpu.models import get_task as jax_get_task
from toothgroupnetwork_tpu_torch import ops
from toothgroupnetwork_tpu_torch.cli import train as cli_train
from toothgroupnetwork_tpu_torch.models import dgcnn as port_dgcnn_mod
from toothgroupnetwork_tpu_torch.models import get_task
from toothgroupnetwork_tpu_torch.nn.layers import Dropout
from toothgroupnetwork_tpu_torch.train import make_optimizer, train_step
from toothgroupnetwork_tpu_torch.train.trainer import Trainer, dropout_seed
from toothgroupnetwork_tpu_torch.utils.weights import (from_jax_variables,
                                                       init_like_flax_)

FAMILIES = ("pointnet", "pointnetpp", "dgcnn", "pointtransformer")
N = 512
PAD = (32, 64)
LR = {"sgd": 1e-2, "adam": 1e-3}
LOSS_RTOL = 1e-4
TOL = dict(rtol=1e-4, atol=1e-5)
# flax's lecun_normal: a standard normal truncated to [-2, 2] over its std
TRUNC_STD = 0.87962566103423978


def _batch() -> dict:
    """Two synthetic jaws (8 teeth each), unit normals, padded slots zero."""
    rng = np.random.default_rng(0)
    feat = np.zeros((2, N, 6), np.float32)
    labels = np.full((2, N), -1, np.int32)
    mask = np.zeros((2, N), bool)
    for b, pad in enumerate(PAD):
        n = N - pad
        pts, _, cls = make_synthetic_jaw_points(n, 8, seed=1 + b)
        nrm = rng.standard_normal((n, 3))
        feat[b, :n, :3] = pts
        feat[b, :n, 3:] = nrm / np.linalg.norm(nrm, axis=1, keepdims=True)
        labels[b, :n] = cls - 1
        mask[b, :n] = True
    return {"feat": feat, "gt_seg_label": labels, "mask": mask}


def _configs(name):
    jtask, ptask = jax_get_task(name), get_task(name)
    jcfg, pcfg = jtask.default_config(), ptask.default_config()
    for cfg in (jcfg, pcfg):
        cfg.model_parameter.update(SMALL_PARAMS[name])
        cfg.optimizer.lr = LR[cfg.optimizer.name]
    return jtask, jcfg, ptask, pcfg


def _modules(name):
    """(JAX task, config, module; port task, config, model), DGCNN at
    dropout 0 in both."""
    jtask, jcfg, ptask, pcfg = _configs(name)
    module = jtask.build_module(jcfg)
    model = ptask.build_module(pcfg, device="cpu")
    if name == "dgcnn":
        module = module.clone(dropout=0.0)
        model.drop.p = 0.0
    return jtask, jcfg, module, ptask, pcfg, model


def shared_selection(monkeypatch):
    """The JAX DGCNN selects its neighbours with the port's ``knn_points``
    through a ``pure_callback`` on ``stop_gradient(x)``: under ``jax.grad``
    only the indices cross (a callback has no derivative, and an index has
    none to give)."""
    def port_knn(x, _x2, k, mask=None, _mask2=None, *, include_self, need_dist,
                 sel_bf16=False):
        def select(xv, mv):
            m = _t(np.asarray(mv))
            idx, _ = ops.knn_points(_t(np.asarray(xv)), _t(np.asarray(xv)), k, m, m,
                                    include_self=include_self, need_dist=need_dist)
            return idx.numpy()
        xs = jax.lax.stop_gradient(x)
        if mask is None:
            mask = jnp.ones(x.shape[:2], bool)
        shape = jax.ShapeDtypeStruct(x.shape[:2] + (k,), jnp.int32)
        idx = jax.pure_callback(select, shape, xs, mask)
        return idx, jnp.zeros(idx.shape, jnp.float32)
    monkeypatch.setattr(jax_dgcnn_mod, "knn_points", port_knn)


class ReplayedSelection:
    """The JAX DGCNN takes the neighbour lists the port's DGCNN chose on its
    own features in the same step. Inside ``record()`` every list the port's
    ``models.dgcnn.knn_points`` returns is kept, in call order, as the
    lists of one more step (``steps``; a caller may append a step's lists
    itself, such as the point-sharded ranks' rows joined); inside
    ``replay(step)`` the JAX DGCNN's selections return that step's lists
    through a ``pure_callback`` on ``stop_gradient(x)``, in the same order
    (only the indices cross), each taken once.

    Over several steps the two packages' features part by their rounding,
    and a feature-space near-tie can fall to opposite sides: under an AVX2
    dispatch one row of step 3's third selection in the DGCNN SGD steps
    holds candidate 133 on the port's features (d2 12.576379 against 37's
    12.576382) and 37 on JAX's (12.576330 against 12.576447), so
    ``shared_selection`` handed JAX another list than the port's. The
    harness's rule is that JAX takes the port's discrete choices, so it
    takes the port's own lists."""

    def __init__(self, monkeypatch):
        self.steps: list[list[np.ndarray]] = []
        self._recording = False
        self._pending: list[np.ndarray] | None = None
        select = port_dgcnn_mod.knn_points

        def record(*args, **kwargs):
            out = select(*args, **kwargs)
            if self._recording:
                self.steps[-1].append(out[0].numpy().copy())
            return out

        def replay(x, _x2, k, mask=None, _mask2=None, *, include_self, need_dist,
                   sel_bf16=False):
            del include_self, need_dist, sel_bf16

            def take(_xv):
                assert self._pending, "a JAX selection without a port list to replay"
                idx = self._pending.pop(0)
                assert idx.shape == _xv.shape[:2] + (k,), (idx.shape, _xv.shape)
                return idx
            shape = jax.ShapeDtypeStruct(x.shape[:2] + (k,), jnp.int32)
            idx = jax.pure_callback(take, shape, jax.lax.stop_gradient(x))
            return idx, jnp.zeros(idx.shape, jnp.float32)

        monkeypatch.setattr(port_dgcnn_mod, "knn_points", record)
        monkeypatch.setattr(jax_dgcnn_mod, "knn_points", replay)

    @contextlib.contextmanager
    def record(self):
        self.steps.append([])
        self._recording = True
        try:
            yield
        finally:
            self._recording = False
        assert self.steps[-1], "the port's forward made no selection"

    @contextlib.contextmanager
    def replay(self, step: int):
        """JAX's forwards inside take the lists of ``step`` (1-based); the
        caller blocks on the JAX results inside, so that every callback has
        run when the block ends."""
        self._pending = list(self.steps[step - 1])
        try:
            yield
        finally:
            pending, self._pending = self._pending, None
        assert not pending, f"{len(pending)} port lists of step {step} not replayed"


_INIT: dict = {}


def flax_init(name: str, module, b):
    """``module.init`` on the batch, once per family and process."""
    if name not in _INIT:
        _INIT[name] = jax_init(module, jnp.asarray(b["feat"]), None, train=False)
    return _INIT[name]


def _variables(name, module, b, draw_zero_heads: bool = True):
    """flax's init with every BatchNorm statistic, bias and scale jittered;
    the zero-initialised heads drawn at random too, or (for the steps)
    kept at zero, as training starts."""
    vs = flax_init(name, module, b)
    rng = np.random.default_rng(1)
    if draw_zero_heads:
        return randomize_variables(vs, rng)
    kernels = {kp: a for kp, a in jax.tree_util.tree_flatten_with_path(dict(vs))[0]
               if str(getattr(kp[-1], "key", kp[-1])) == "kernel"}
    jittered = randomize_variables(vs, rng)
    return jax.tree_util.tree_map_with_path(
        lambda kp, a: kernels.get(kp, a), jittered)


def _load(model, vs):
    model.load_state_dict(from_jax_variables(_flat(vs)))
    return model


def _output_keys(name, ref):
    if name == "pointtransformer":
        return ["cls_pred", "offset_1"]
    return ["cls_pred"] + [k for k in ("offset", "dist") if k in ref]


@pytest.mark.parametrize("name", FAMILIES)
def test_init_like_flax(name):
    """Zeros exactly where flax's init has zeros (biases, BatchNorm and
    LayerNorm shifts and means, the zero-initialised heads), ones where it
    has ones, and every other Dense kernel lecun_normal: over all of them,
    each weight times sqrt(fan_in) has standard deviation 1 within 3 % and
    lies inside flax's truncation bound 2 / 0.8796."""
    _, _, module, _, _, model = _modules(name)
    b = _batch()
    ref = from_jax_variables(_flat(flax_init(name, module, b)))
    init_like_flax_(model, torch.Generator().manual_seed(0))
    state = model.state_dict()
    assert set(state) == set(ref)
    z = []
    for key, want in ref.items():
        got = state[key]
        if not want.any():
            assert not got.any(), key
        elif key.endswith(".weight") and want.dim() == 2:
            assert got.all(), key
            z.append(got.flatten() * want.shape[1] ** 0.5)
        else:
            assert torch.equal(got, want), key
    z = torch.cat(z)
    assert abs(float(z.std()) - 1.0) < 0.03
    assert float(z.abs().max()) <= 2.0 / TRUNC_STD * (1 + 1e-6)
    zero_heads = {"pointnet": ["feat.stn.Dense_2.weight", "feat.fstn.Dense_2.weight"],
                  "pointnetpp": ["offset_2.weight", "dist_2.weight"],
                  "dgcnn": ["offset.weight", "dist.weight"],
                  "pointtransformer": []}[name]
    for key in zero_heads:
        assert not state[key].any() and not ref[key].any(), key


@pytest.mark.parametrize("name", FAMILIES)
def test_train_forward_matches_jax(monkeypatch, name):
    """The train-mode forward over the padded two-cloud batch: outputs at
    the valid points and every mutated BatchNorm statistic (the padding
    excluded from each, or the statistics would differ)."""
    if name == "dgcnn":
        shared_selection(monkeypatch)
    _, _, module, _, _, model = _modules(name)
    b = _batch()
    vs = _variables(name, module, b)
    ref, mutated = jax.jit(lambda v, f, m: module.apply(
        v, f, m, True, mutable=["batch_stats"]))(
        vs, jnp.asarray(b["feat"]), jnp.asarray(b["mask"]))
    model = _load(model, vs).train()
    with torch.no_grad():
        got = model(_t(b["feat"]), _t(b["mask"]))
    for key in _output_keys(name, ref):
        assert_close(got[key].numpy()[b["mask"]], np.asarray(ref[key])[b["mask"]])
    want = from_jax_variables(_flat({"batch_stats": mutated["batch_stats"]}))
    buffers = dict(model.named_buffers())
    assert set(buffers) == set(want)
    for key, buf in buffers.items():
        np.testing.assert_allclose(buf.numpy(), want[key].numpy(), err_msg=key, **TOL)


# ---------------------------------------------------------------- dropout

def test_dropout_contract():
    """flax's ``nn.Dropout`` contract: identity in eval mode and at p = 0;
    in train mode each element kept with probability 1 - p and scaled by
    1 / (1 - p), the rest 0, the mask a function of the generator's state
    alone; all zeros at p = 1; no generator, no train-mode dropout."""
    x = torch.rand(64, 256, generator=torch.Generator().manual_seed(3)) + 0.5
    drop = Dropout(0.3).eval()
    assert torch.equal(drop(x), x)
    drop.train()
    with pytest.raises(ValueError, match="generator"):
        drop(x)
    drop.generator = torch.Generator().manual_seed(7)
    y = drop(x)
    kept = y != 0
    assert torch.allclose(y[kept], x[kept] / 0.7, rtol=1e-6, atol=0)
    assert abs(float(kept.float().mean()) - 0.7) < 0.01
    drop.generator = torch.Generator().manual_seed(7)
    assert torch.equal(drop(x), y)
    drop.generator = torch.Generator().manual_seed(8)
    assert not torch.equal(drop(x), y)
    assert torch.equal(Dropout(0.0).train()(x), x)
    assert not Dropout(1.0).train()(x).any()
    drop.eval()
    assert torch.equal(drop(x), x)


def test_dgcnn_dropout_in_train_step():
    """DGCNN at the preset's dropout 0.5: a train step draws its mask from
    the generator ``train_step`` is given (the same seed, the same step;
    another seed, another step), eval mode draws nothing, and without a
    generator the step raises, also after a step that had one;
    ``dropout_seed`` depends on (seed, step) alone."""
    _, pcfg = _configs("dgcnn")[2:]
    b = {k: _t(v) for k, v in _batch().items()}

    def step(seed):
        model = get_task("dgcnn").build_module(pcfg, device="cpu")
        init_like_flax_(model, torch.Generator().manual_seed(0))
        assert model.drop.p == 0.5
        opt = make_optimizer(pcfg.optimizer, model.parameters())
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        vals = train_step(model, opt, get_task("dgcnn"), pcfg, b, generator=gen)
        return float(vals["tooth_class_loss_1"]), model

    a, model = step(dropout_seed(0, 0))
    assert step(dropout_seed(0, 0))[0] == a
    assert step(dropout_seed(0, 1))[0] != a
    with pytest.raises(ValueError, match="generator"):
        step(None)
    # the generator lasts one step: a later step without one raises
    assert model.drop.generator is None
    with pytest.raises(ValueError, match="generator"):
        train_step(model, make_optimizer(pcfg.optimizer, model.parameters()),
                   get_task("dgcnn"), pcfg, b)
    model.eval()
    with torch.no_grad():
        first = model(b["feat"], b["mask"])["cls_pred"]
        assert torch.equal(model(b["feat"], b["mask"])["cls_pred"], first)
    assert dropout_seed(0, 5) == dropout_seed(0, 5) != dropout_seed(1, 5)


def test_resumed_run_draws_what_an_unbroken_run_draws(tmp_path):
    """DGCNN (dropout 0.5) through ``Trainer.run``: two epochs in one run,
    and one epoch, then ``resume`` in a new Trainer and one more, end on
    bit-identical parameters: the dropout generator is seeded from
    ``(config.seed + 1, step)`` before every step."""
    _, pcfg = _configs("dgcnn")[2:]
    b = _batch()
    loader = [{k: v[:1] for k, v in b.items()}, {k: v[1:] for k, v in b.items()}]

    def trainer():
        pcfg.checkpoint_path = str(tmp_path / "ckpt" / "dgcnn")
        return Trainer(pcfg, get_task("dgcnn"), loader, loader[:1],
                       log_fn=lambda s: None, device="cpu")

    unbroken = trainer()
    unbroken.run(max_epochs=2)
    trainer().run(max_epochs=1)
    resumed = trainer()
    assert resumed.resume() == 1
    resumed.run(max_epochs=1)
    assert resumed.step == unbroken.step == 4
    for (key, a), bb in zip(unbroken.model.state_dict().items(),
                            resumed.model.state_dict().values()):
        assert torch.equal(a, bb), key


# ---------------------------------------------------------------- CLI

@pytest.mark.parametrize("name", FAMILIES)
def test_cli_train_one_epoch(tmp_path, name):
    """``cli.train --model_name <name> --device cpu`` for one epoch with a
    config the JAX package wrote (the preset at the small size): both
    checkpoint slots written, a finite val loss."""
    d = _processed(tmp_path, n=3, n_points=256)
    jcfg = jax_get_task(name).default_config()
    jcfg.model_parameter.update(SMALL_PARAMS[name])
    jcfg.save_json(str(tmp_path / "cfg.json"))
    trainer = cli_train.main([
        "--model_name", name, "--config_path", str(tmp_path / "cfg.json"),
        "--input_data_dir_path", d, "--checkpoint_path", str(tmp_path / "ck" / name),
        "--max_epochs", "1", "--device", "cpu"])
    assert trainer.epoch == 1 and trainer.step == 3 and trainer.device.type == "cpu"
    assert np.isfinite(trainer.best_val)
    assert (tmp_path / "ck" / f"{name}_val").exists()


def test_available_models_equal_jax():
    from toothgroupnetwork_tpu.models import available_models as jax_available
    from toothgroupnetwork_tpu_torch.models import available_models

    assert available_models() == jax_available()
    assert len(available_models()) == 7
