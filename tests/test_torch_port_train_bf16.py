"""bfloat16 training of the port against the JAX package's, on the CPU.

``model_parameter["dtype"] = "bfloat16"`` trains the tgnet backbones with a
bf16 body; parameters, BatchNorm statistics, logits, offsets and losses
stay float32 (the JAX ``TestBf16Training``). The tiny fps config and batch
of tests/test_torch_port_train_step.py, SGD at lr 0.01, from the same
jittered JAX variables.

The two packages round to bf16 at the same places: the train-mode
BatchNorm and attention layer alone, fed the same bf16 input, give the same
bits (held below; the attention's softmax is computed step by step as the
JAX graph computes it, which a fused softmax did not). The BatchNorm's
float32 statistics are sums in an order that follows the SIMD width of the
host's CPU kernels, so where its float32 output lies within that rounding
of a bf16 rounding boundary the two packages round it to neighbouring bf16
values: one element of 9600 did on an AVX-512 host. Such an element may
differ by one bf16 ulp, and only where the exact (float64) output lies
within the two packages' float32 errors of the boundary between them, with
the port's float32 output and statistics no farther from float64 than
twice JAX's (``assert_bits_or_rounding``).

The tolerance, from a bf16 ulp (2^-8 relative; a rounding moves a value by
at most half of it).
Where a float32 sum is taken in another order before a rounding (the
BatchNorm statistics, the 3-NN interpolation), one element in thousands
lands one bf16 ulp away, and the stack of BatchNorms and max-pools carries
such flips on. So no bf16 run is reproducible to better than its own
rounding against float32: here JAX's own bf16 step-1 losses lie up to
1.3e-2 (3.3 bf16 ulps) from its float32 losses, and a one-float32-ulp
change of JAX's starting parameters moves its bf16 losses after three
steps by up to 5.8e-2 (measured when this test was written). Held:

  * step 1's seven losses within 4 bf16 ulps (2^-6 relative) of JAX's
    float32 step, and within 8 (2^-5; two such roundings, one each side)
    of JAX's bf16 step;
  * the update of that step, the parameters and separately the BatchNorm
    statistics: the bf16 gradients are rounded sums of rounded products, so
    JAX's own bf16 update lies 29 % (parameters) and 0.5 % (statistics) of
    its float32 update's norm from that update. The port's bf16 update is
    held within twice that norm of JAX's bf16 update (two independent
    roundings of the same size, by the triangle inequality), and nearer to
    the float32 update than that update's own norm;
  * every parameter and statistic is float32;
  * the loss curve of 25 steps: the analog of the JAX ``TestBf16Training``
    (both curves fall below 0.6 of their first loss, and the bf16 curve ends
    within 0.15 of the float32 one, relative), at SGD lr 0.01. At the
    preset's 0.1 this batch of one 256-point cloud is past the step's
    stability edge (the trajectory rule of the other step tests): the
    float32 curve alone ended at 3.93 with ATen's AVX-512 kernels and at
    3.40 with its AVX2 ones (``_curve("float32", lr=0.1)`` under
    ``ATEN_CPU_CAPABILITY``), 15 % apart from the rounding of its sums
    alone, so the 0.15 gap to bf16 measured the dispatch, not bf16.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_train_step import ARCH, _batch, _flat, _torch_batch
from toothgroupnetwork_tpu.models import get_task as jax_get_task
from toothgroupnetwork_tpu.models.point_transformer import backbone as jax_backbone
from toothgroupnetwork_tpu.nn.layers import MaskedBatchNorm as JaxBN
from toothgroupnetwork_tpu.train.train_state import TrainState
from toothgroupnetwork_tpu.train.train_state import make_optimizer as jax_make_optimizer
from toothgroupnetwork_tpu.train.trainer import make_train_step
from toothgroupnetwork_tpu_torch.models import get_task
from toothgroupnetwork_tpu_torch.models.point_transformer.backbone import (
    PointTransformerLayer)
from toothgroupnetwork_tpu_torch.nn.layers import MaskedBatchNorm
from toothgroupnetwork_tpu_torch.train import make_optimizer, train_step
from toothgroupnetwork_tpu_torch.utils.weights import from_jax_variables, init_like_flax_

BF16_ULP = 2.0 ** -8
LOSS_TO_F32 = 4 * BF16_ULP
LOSS_TO_BF16 = 8 * BF16_ULP
STATS = re.compile(r"\.(mean|var)$")


def jittered(variables, rng):
    """``variables`` with each BatchNorm ``var`` raised by U(0.5, 1.5) and
    every ``mean``, ``bias`` and ``scale`` moved by N(0, 0.1), from ``rng``."""
    def jitter(path, a):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "var":
            return a + jnp.asarray(rng.uniform(0.5, 1.5, a.shape), a.dtype)
        if name in ("mean", "bias", "scale"):
            return a + jnp.asarray(rng.standard_normal(a.shape) * 0.1, a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(jitter, dict(variables))


def _bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, dtype=np.float32)).bfloat16()


@pytest.mark.parametrize("layer", ["batchnorm", "attention"])
def test_train_layers_bit_equal(rng, layer):
    """A masked train-mode layer in bf16 on the same bf16 input: the same
    bits as the JAX layer (a BatchNorm over [2, 300, 16]; the attention at
    C16, K8 over 200 points, 20 of them masked, BatchNorm state jittered)."""
    bf16 = jnp.bfloat16
    if layer == "batchnorm":
        x = jnp.asarray(rng.standard_normal((2, 300, 16)) * 3 + 1, bf16)
        mask = rng.random((2, 300)) > 0.2
        module = JaxBN(dtype=bf16)
        args = (x, jnp.asarray(mask))
        port = MaskedBatchNorm(16, device="cpu", dtype=torch.bfloat16)
        port_args = (_bf16(x), torch.from_numpy(mask))
    else:
        n, kk, c = 200, 8, 16
        x = jnp.asarray(rng.standard_normal((1, n, c)), bf16)
        p = rng.standard_normal((1, n, 3)).astype(np.float32)
        idx = rng.integers(0, n, (1, n, kk)).astype(np.int32)
        mask = np.arange(n)[None] < n - 20
        module = jax_backbone.PointTransformerLayer(c, 8, bf16)
        args = (jnp.asarray(p), x, jnp.asarray(idx), jnp.asarray(mask))
        port = PointTransformerLayer(c, 8, device="cpu", dtype=torch.bfloat16)
        pt, it = torch.from_numpy(p), torch.from_numpy(idx).long()
        p_r = (pt[0][it] - pt[:, :, None, :]).reshape(-1, 3).bfloat16()
        port_args = (pt, _bf16(x), it, None, torch.from_numpy(mask), p_r)
    vs = jittered(module.init(jax.random.PRNGKey(1), *args, True), rng)
    ref, _ = module.apply(vs, *args, True, mutable=["batch_stats"])
    port.load_state_dict(from_jax_variables(_flat(vs)))
    with torch.no_grad():
        got = port.train()(*port_args)
    assert got.dtype == torch.bfloat16
    if layer == "attention":
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))
    else:
        assert_bits_or_rounding(got, ref, vs, x, mask)


def _float64_batchnorm(x, mask, scale, bias, eps=1e-5):
    """The train-mode masked BatchNorm in float64: (output, mean, biased
    variance)."""
    w = mask[..., None].astype(np.float64)
    n = w.sum()
    mean = (x * w).sum(axis=(0, 1)) / n
    var = (((x - mean) ** 2) * w).sum(axis=(0, 1)) / n
    return (x - mean) / np.sqrt(var + eps) * scale + bias, mean, var


def assert_bits_or_rounding(got, ref, vs, x, mask):
    """The port's bf16 BatchNorm output ``got`` equal to JAX's ``ref``, but
    where the two round a float32 output to neighbouring bf16 values. The
    same layer in float32 in each package (the same bf16 input, the same
    variables) gives the outputs before that rounding and the running
    statistics; the float64 layer the exact ones. Held: each differing
    element is one bf16 ulp apart, each package's bf16 output is its float32
    output rounded, and the exact output lies within the two float32
    outputs' errors of the boundary between the two bf16 values; the port's
    float32 output and statistics are no farther from float64 than twice
    JAX's."""
    got = got.float().numpy()
    ref = np.asarray(ref, np.float32)
    x32 = np.asarray(x, np.float32)
    jax32, jstate = JaxBN().apply(vs, jnp.asarray(x32), jnp.asarray(mask), True,
                                  mutable=["batch_stats"])
    port = MaskedBatchNorm(16, device="cpu")
    port.load_state_dict(from_jax_variables(_flat(vs)))
    with torch.no_grad():
        port32 = port.train()(torch.from_numpy(x32), torch.from_numpy(mask)).numpy()
    jax32 = np.asarray(jax32)
    p = vs["params"]
    y64, mean64, var64 = _float64_batchnorm(x32.astype(np.float64), mask,
                                            np.asarray(p["scale"], np.float64),
                                            np.asarray(p["bias"], np.float64))
    # the running statistics after the step, exact: 0.9 old + 0.1 batch
    n = mask.sum()
    old = vs["batch_stats"]
    stats64 = {"mean": 0.9 * np.asarray(old["mean"], np.float64) + 0.1 * mean64,
               "var": 0.9 * np.asarray(old["var"], np.float64)
               + 0.1 * var64 * n / (n - 1)}
    for name, exact in stats64.items():
        port_err = np.abs(getattr(port, name).numpy() - exact).max()
        jax_err = np.abs(np.asarray(jstate["batch_stats"][name], np.float64) - exact).max()
        assert port_err <= 2 * jax_err, (name, port_err, jax_err)
    port_err, jax_err = np.abs(port32 - y64), np.abs(jax32 - y64)
    assert port_err.max() <= 2 * jax_err.max(), (port_err.max(), jax_err.max())
    as_bf16 = lambda a: torch.tensor(a).bfloat16().float().numpy()  # noqa: E731
    np.testing.assert_array_equal(as_bf16(port32), got)
    np.testing.assert_array_equal(as_bf16(jax32), ref)
    miss = got != ref
    if not miss.any():
        return
    lo, hi = np.minimum(got, ref)[miss], np.maximum(got, ref)[miss]
    # neighbours: one sign, bit patterns one apart
    bits = lambda a: torch.tensor(a).bfloat16().view(torch.int16).numpy()  # noqa: E731
    assert (np.sign(lo) == np.sign(hi)).all()
    np.testing.assert_array_equal(np.abs(bits(hi).astype(np.int32) - bits(lo)), 1)
    boundary = (lo.astype(np.float64) + hi) / 2
    assert (np.abs(y64[miss] - boundary)
            <= np.maximum(port_err[miss], jax_err[miss])).all(), (
        y64[miss], boundary, port_err[miss], jax_err[miss])


def _configs(dtype: str):
    jtask, ptask = jax_get_task("tgnet_fps"), get_task("tgnet_fps")
    jcfg, pcfg = jtask.default_config(), ptask.default_config()
    for cfg in (jcfg, pcfg):
        cfg.model_parameter.update(ARCH, dtype=dtype)
        cfg.optimizer.lr = 1e-2
    return jtask, jcfg, ptask, pcfg


@pytest.fixture(scope="module")
def variables():
    """Jittered float32 variables of the tiny JAX TGNet (the dtype changes
    no variable)."""
    jtask, jcfg, _, _ = _configs("float32")
    b = _batch()
    vs = jax.jit(jtask.build_module(jcfg).init, static_argnames=("train",))(
        jax.random.PRNGKey(0), jnp.asarray(b["feat"]), jnp.asarray(b["mask"]),
        train=False, labels=jnp.asarray(b["gt_seg_label"]))
    return jittered(vs, np.random.default_rng(1))


def _jax_step(dtype, vs):
    """One JAX step: (losses, the state dict after it)."""
    jtask, jcfg, _, _ = _configs(dtype)
    module = jtask.build_module(jcfg)
    tx = jax_make_optimizer(jcfg.optimizer)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=vs["params"],
                       batch_stats=vs["batch_stats"], opt_state=tx.init(vs["params"]),
                       apply_fn=module.apply, tx=tx)
    state, values = jax.jit(make_train_step(jtask, jcfg))(
        state, {k: jnp.asarray(v) for k, v in _batch().items()})
    after = from_jax_variables(_flat({"params": state.params,
                                      "batch_stats": state.batch_stats}))
    return {k: float(v) for k, v in values.items()}, after


def test_one_step_matches_jax(variables):
    _, _, ptask, pcfg = _configs("bfloat16")
    model = ptask.build_module(pcfg, device="cpu")
    model.load_state_dict(from_jax_variables(_flat(variables)))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = make_optimizer(pcfg.optimizer, model.parameters())
    got = {k: float(v) for k, v in
           train_step(model, opt, ptask, pcfg, _torch_batch(_batch())).items()}
    f32, f32_after = _jax_step("float32", variables)
    bf16, bf16_after = _jax_step("bfloat16", variables)
    assert set(got) == set(bf16) and len(got) == 7
    for key in got:
        assert got[key] == pytest.approx(f32[key], rel=LOSS_TO_F32), key
        assert got[key] == pytest.approx(bf16[key], rel=LOSS_TO_BF16), key
    state = model.state_dict()
    assert all(v.dtype == torch.float32 for v in state.values())
    for stats in (False, True):
        names = [k for k in state if bool(STATS.search(k)) == stats]

        def update(d):
            return torch.cat([(d[k] - before[k]).flatten() for k in names])

        f32_update, jax_bf16, port = update(f32_after), update(bf16_after), update(state)
        jax_error = (jax_bf16 - f32_update).norm()
        assert (port - jax_bf16).norm() <= 2 * jax_error, (stats, float(jax_error))
        assert (port - f32_update).norm() < f32_update.norm(), stats


def _curve(dtype: str, steps: int = 25, lr: float = 0.01) -> np.ndarray:
    """The JAX TestBf16Training batch and preset (SGD, momentum 0.9) on the
    port at ``lr`` (the preset's is 0.1), from flax-like initial weights."""
    task = get_task("tgnet_fps")
    cfg = task.default_config()
    cfg.model_parameter.update(ARCH, dtype=dtype)
    cfg.optimizer.lr = lr
    model = task.build_module(cfg, device="cpu")
    init_like_flax_(model, torch.Generator().manual_seed(0))
    opt = make_optimizer(cfg.optimizer, model.parameters())
    n = 256
    rng = np.random.default_rng(0)
    batch = {"feat": torch.from_numpy(rng.standard_normal((1, n, 6)).astype(np.float32) * .3),
             "gt_seg_label": torch.from_numpy(rng.integers(-1, 16, (1, n)).astype(np.int32)),
             "mask": torch.ones((1, n), dtype=torch.bool)}
    return np.asarray([float(sum(train_step(model, opt, task, cfg, batch).values()))
                       for _ in range(steps)])


def test_loss_curve_tracks_float32():
    f32, bf16 = _curve("float32"), _curve("bfloat16")
    assert np.isfinite(f32).all() and np.isfinite(bf16).all()
    assert f32[-1] < 0.6 * f32[0]
    assert bf16[-1] < 0.6 * bf16[0]
    assert abs(bf16[-1] - f32[-1]) / f32[-1] < 0.15, (f32[-1], bf16[-1])
