"""The port's tgnet_fps train path against the JAX package's, on the CPU.

The tiny fps config (planes [8, 16], stride [1, 4], nsample [8, 8], blocks
[2, 2], block_num 2, crops of 32 over a 256-point cloud: 240 synthetic jaw
points with 6 teeth, so 10 of the 16 crop slots are empty, and 16 padded
points outside the mask). The JAX ``TGNet`` is initialised, its biases and
BatchNorm state jittered, and the same variables are loaded into the port
(``from_jax_variables``). Then:

  * the train-mode forward (``TGNet.apply(..., True, mutable=["batch_stats"])``):
    outputs and mutated statistics within atol 1e-4 / rtol 1e-4 (float32,
    other summation orders through two backbones);
  * 1 and 3 optimizer steps, the JAX ``make_train_step`` beside the port's
    ``train_step``: each of the seven losses within 1e-4 relative, every
    parameter and BatchNorm statistic within rtol 1e-4 + atol 1e-5.

Learning rates: SGD at 0.01, Adam at 1e-3 (the Adam presets' rate). At the
tgnet preset's 0.1 this 256-point batch is past the step's stability edge:
the JAX package itself, from parameters 5e-6 apart (the two packages'
rounding after two steps), computes gradients up to 0.04 apart, so no two
float32 implementations stay within 1e-5 over three steps there.

Adam divides each gradient by its own magnitude, so a parameter whose
gradient the batch statistics cancel exactly (a Dense bias before a
train-mode BatchNorm or the softmax; at batch 1 the bottleneck's per-cloud
embedding) is moved by its rounding noise, +-lr a step, in either package,
and so are the running means of the BatchNorms right after those
(``CANCELLED``, ``SHIFTED_MEANS``). Under Adam these are held to at most 2 lr
a step apart; every loss, every other parameter and statistic keep the
tolerances above. Under SGD nothing is exempt.
"""

import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from synthetic import make_synthetic_jaw_points  # noqa: E402

from toothgroupnetwork_tpu.models import get_task as jax_get_task
from toothgroupnetwork_tpu.train.train_state import TrainState
from toothgroupnetwork_tpu.train.train_state import make_optimizer as jax_make_optimizer
from toothgroupnetwork_tpu.train.trainer import make_train_step
from toothgroupnetwork_tpu_torch.models import get_task
from toothgroupnetwork_tpu_torch.train import make_optimizer, train_step
from toothgroupnetwork_tpu_torch.utils.weights import from_jax_variables

ARCH = {"planes": [8, 16], "stride": [1, 4], "nsample": [8, 8], "blocks": [2, 2],
        "block_num": 2, "crop_sample_size": 32}
N, N_VALID = 256, 240
LOSS_RTOL = 1e-4
TOL = dict(rtol=1e-4, atol=1e-5)
LR = {"sgd": 1e-2, "adam": 1e-3}


def _flat(variables) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(variables)[0]}


def _batch() -> dict:
    rng = np.random.default_rng(0)
    pts, _, cls = make_synthetic_jaw_points(N_VALID, 6, seed=1)
    feat = np.zeros((1, N, 6), np.float32)
    feat[0, :N_VALID, :3] = pts
    nrm = rng.standard_normal((N_VALID, 3))
    feat[0, :N_VALID, 3:] = nrm / np.linalg.norm(nrm, axis=1, keepdims=True)
    labels = np.full((1, N), -1, np.int32)
    labels[0, :N_VALID] = cls - 1
    mask = np.zeros((1, N), bool)
    mask[0, :N_VALID] = True
    return {"feat": feat, "gt_seg_label": labels, "mask": mask}


def _configs(opt: str):
    jtask, ptask = jax_get_task("tgnet_fps"), get_task("tgnet_fps")
    jcfg, pcfg = jtask.default_config(), ptask.default_config()
    for cfg in (jcfg, pcfg):
        cfg.model_parameter.update(ARCH)
        cfg.optimizer.name = opt
        cfg.optimizer.lr = LR[opt]
    return jtask, jcfg, ptask, pcfg


@pytest.fixture(scope="module")
def jax_setup():
    """The JAX module and jittered variables, made once for the file."""
    jtask, jcfg, _, _ = _configs("sgd")
    module = jtask.build_module(jcfg)
    b = _batch()
    vs = jax.jit(module.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), jnp.asarray(b["feat"]), jnp.asarray(b["mask"]),
        train=False, labels=jnp.asarray(b["gt_seg_label"]))
    rng = np.random.default_rng(1)

    def jitter(path, a):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "var":
            return a + jnp.asarray(rng.uniform(0.5, 1.5, a.shape), a.dtype)
        if name in ("mean", "bias", "scale"):
            return a + jnp.asarray(rng.standard_normal(a.shape) * 0.1, a.dtype)
        return a

    return module, jax.tree_util.tree_map_with_path(jitter, dict(vs))


def _port(ptask, pcfg, vs):
    model = ptask.build_module(pcfg, device="cpu")
    model.load_state_dict(from_jax_variables(_flat(vs)))
    return model


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def test_train_forward_matches_jax(jax_setup):
    module, vs = jax_setup
    _, _, ptask, pcfg = _configs("sgd")
    b = _batch()
    apply = jax.jit(lambda v, f, m, lab: module.apply(
        v, f, m, True, mutable=["batch_stats"], labels=lab))
    ref, mutated = apply(vs, jnp.asarray(b["feat"]), jnp.asarray(b["mask"]),
                         jnp.asarray(b["gt_seg_label"]))
    model = _port(ptask, pcfg, vs).train()
    tb = _torch_batch(b)
    with torch.no_grad():
        got = model(tb["feat"], tb["mask"], labels=tb["gt_seg_label"])
    for key in ("crop_valid", "crop_mask", "nn_crop_indexes", "cluster_gt_seg_label"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]), err_msg=key)
    assert int(np.asarray(ref["crop_valid"]).sum()) == 6
    # rows that feed a loss: the cloud's valid points, the live crops
    rows = {"1": b["mask"], "2": np.asarray(ref["crop_mask"])}
    for key, half in (("sem_1", "1"), ("offset_1", "1"), ("first_features", "1"),
                      ("sem_2", "2"), ("offset_2", "2"), ("cropped_feature_ls", "2")):
        np.testing.assert_allclose(got[key].numpy()[rows[half]],
                                   np.asarray(ref[key])[rows[half]], err_msg=key,
                                   atol=1e-4, rtol=1e-4)
    for half in ("1", "2"):
        for i, (st, rst) in enumerate(zip(got["cbl_stages_" + half],
                                          ref["cbl_stages_" + half])):
            m = np.asarray(rst["mask"])
            np.testing.assert_array_equal(st["knn_idx"].numpy(), np.asarray(rst["knn_idx"]))
            np.testing.assert_allclose(st["latent"].numpy()[m], np.asarray(rst["latent"])[m],
                                       err_msg=f"cbl {half} stage {i}", atol=1e-4, rtol=1e-4)
    want = from_jax_variables(_flat({"batch_stats": mutated["batch_stats"]}))
    for name, buf in model.named_buffers():
        np.testing.assert_allclose(buf.numpy(), want[name].numpy(), err_msg=name, **TOL)


# Parameters whose gradient is zero in exact arithmetic: a per-channel shift
# that the train-mode BatchNorm after it (or the attention softmax) takes
# out again, and at batch 1 the bottleneck's per-cloud embedding (its
# Dense linear2 and the columns of linear1 it feeds), constant over the
# points its BatchNorm normalises. Adam moves them by rounding noise.
CANCELLED = re.compile(r"(transformer\.linear_(q|k|v|p0|p1|w0|w1)\.bias"
                       r"|_up\.linear[12]\.bias|stage_\d+\.dense\.bias"
                       r"|dec2_up\.linear2\.weight)$")
# the BatchNorms right after those: their running means take the shift
SHIFTED_MEANS = re.compile(r"(linear_p_bn|linear_w_bn[01]|block\d+\.bn2|_up\.bn[12]"
                           r"|stage_\d+\.bn)\.mean$")


def _cancelled(name: str, shape) -> np.ndarray:
    free = np.full(shape, bool(CANCELLED.search(name)))
    if name.endswith("dec2_up.linear1.weight"):     # [out, 2 * planes]
        free[:, shape[1] // 2:] = True
    return free


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_steps_match_jax(jax_setup, opt):
    module, vs = jax_setup
    jtask, jcfg, ptask, pcfg = _configs(opt)
    b = _batch()
    tx = jax_make_optimizer(jcfg.optimizer)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=vs["params"],
                       batch_stats=vs["batch_stats"], opt_state=tx.init(vs["params"]),
                       apply_fn=module.apply, tx=tx)
    jstep = jax.jit(make_train_step(jtask, jcfg))
    db = {k: jnp.asarray(v) for k, v in b.items()}

    model = _port(ptask, pcfg, vs)
    optimizer = make_optimizer(pcfg.optimizer, model.parameters())
    tb = _torch_batch(b)
    for step in (1, 2, 3):
        state, jvals = jstep(state, db)
        pvals = train_step(model, optimizer, ptask, pcfg, tb)
        assert set(pvals) == set(jvals) and len(pvals) == 7
        for key, val in jvals.items():
            assert float(pvals[key]) == pytest.approx(float(val), rel=LOSS_RTOL), (step, key)
        if step == 2:
            continue
        want = from_jax_variables(_flat({"params": state.params,
                                         "batch_stats": state.batch_stats}))
        # lr a step each at most apart, where Adam moves by rounding noise
        bound = 2 * LR[opt] * step + 1e-5
        for name, val in [*model.named_parameters(), *model.named_buffers()]:
            got, ref = val.detach().numpy(), want[name].numpy()
            free = (_cancelled(name, got.shape) if opt == "adam"
                    else np.zeros(got.shape, bool))
            if opt == "adam" and SHIFTED_MEANS.search(name):
                free[:] = True
            assert np.abs(got - ref)[free].max(initial=0.0) <= bound, name
            np.testing.assert_allclose(got[~free], ref[~free],
                                       err_msg=f"step {step} {name}", **TOL)
