"""Models of the PyTorch port against the JAX package, on the CPU.

The JAX ``TGNet`` is initialised, its BatchNorm statistics and biases are
randomised, and the flattened variables (the ``save_weights`` layout) are
loaded into the port through ``utils/weights.py``. Both sides then run the
same numpy inputs: the backbone, ``stage1`` over the cloud and ``stage2`` over
the live crops of ``make_crops``. Tolerance atol 1e-4 / rtol 1e-4 (float32,
different summation orders across three to five stages).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toothgroupnetwork_tpu.models.tgnet import TGNet as JaxTGNet
from toothgroupnetwork_tpu.models.tgnet import make_crops as jax_make_crops
from toothgroupnetwork_tpu_torch.models.tgnet import TGNet, make_crops
from toothgroupnetwork_tpu_torch.utils.weights import (from_jax_variables,
                                                       load_npz, save_npz,
                                                       to_jax_variables)

TOL = dict(atol=1e-4, rtol=1e-4)

CONFIGS = {
    # the tiny fps config of tests/test_tgn_pipeline.py
    "fps": dict(planes=(8, 16), stride=(1, 4), nsample=(8, 8), blocks=(2, 2),
                block_num=2),
    # the bdl shape: stride (1, 1) takes the k-prefix kNN reuse, the identity
    # TransitionUp and the identity 1-NN head upsample
    "bdl": dict(planes=(8, 16), stride=(1, 1), nsample=(12, 8), blocks=(2, 3),
                block_num=2),
    # 64-point crops come down to 4 points at the third stage, below
    # nsample=8: the k > n kNN tail, and knn_interpolate in the decoder
    "deep": dict(planes=(8, 16, 32), stride=(1, 4, 4), nsample=(8, 8, 8),
                 blocks=(2, 2, 2), block_num=3),
}
N_POINTS, CROP = 256, 64


def _flat(variables) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(variables)[0]}


def _cloud(rng, n):
    xyz = rng.uniform(-1.0, 1.0, (1, n, 3))
    nrm = rng.standard_normal((1, n, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    return np.concatenate([xyz, nrm], -1).astype(np.float32)


def _models(rng, arch):
    jax_model = JaxTGNet(crop_size=CROP, c=6, **arch)
    feat = jnp.zeros((1, N_POINTS, 6), jnp.float32)
    lab = jnp.zeros((1, N_POINTS), jnp.int32)
    vs = jax_model.init(jax.random.PRNGKey(0), feat, None, train=False, labels=lab)

    def jitter(path, a):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "var":
            return a + jnp.asarray(rng.uniform(0.5, 1.5, a.shape), a.dtype)
        if name in ("mean", "bias", "scale"):
            return a + jnp.asarray(rng.standard_normal(a.shape) * 0.1, a.dtype)
        return a

    vs = jax.tree_util.tree_map_with_path(jitter, dict(vs))
    port = TGNet(crop_size=CROP, c=6, **arch, device="cpu")
    port.load_state_dict(from_jax_variables(_flat(vs)))
    return jax_model, vs, port.eval()


@pytest.mark.parametrize("name", list(CONFIGS))
def test_stage1_matches_jax(rng, name):
    jax_model, vs, port = _models(rng, CONFIGS[name])
    feat = _cloud(rng, N_POINTS)
    ref = jax_model.apply(vs, jnp.asarray(feat), None, method=JaxTGNet.stage1)
    with torch.no_grad():
        got = port.stage1(torch.from_numpy(feat))
    for key in ("sem_1", "offset_1"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   err_msg=key, **TOL)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_stage2_on_crops_matches_jax(rng, name):
    jax_model, vs, port = _models(rng, CONFIGS[name])
    feat = _cloud(rng, N_POINTS)
    cents = np.full((1, 16, 3), 1e3, np.float32)
    valid = np.zeros((1, 16), bool)
    cents[0, :5] = feat[0, rng.choice(N_POINTS, 5, replace=False), :3]
    valid[0, :5] = True
    j_crops, j_mask, j_idx, _ = jax_make_crops(
        jnp.asarray(feat), jnp.asarray(cents), jnp.asarray(valid), CROP)
    crops, mask, idx = make_crops(torch.from_numpy(feat), torch.from_numpy(cents),
                                  torch.from_numpy(valid), CROP)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(crops.numpy(), np.asarray(j_crops), atol=1e-6)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(j_mask))

    ref = jax_model.apply(vs, j_crops, j_mask, method=JaxTGNet.stage2)
    with torch.no_grad():
        got = port.stage2(crops, mask)
    live = valid.reshape(-1)
    for key in ("sem_1", "offset_1"):
        np.testing.assert_allclose(got[key].numpy()[live],
                                   np.asarray(ref[key])[live], err_msg=key, **TOL)


def test_weight_bridge_round_trip(rng, tmp_path):
    """save_npz writes the JAX package's layout: its keys and shapes are those
    of the flax variables, and load_npz restores the module exactly."""
    _, vs, port = _models(rng, CONFIGS["bdl"])
    flat = _flat(vs)
    mine = to_jax_variables(port)
    assert set(mine) == set(flat)
    for key, val in flat.items():
        np.testing.assert_array_equal(mine[key], val, err_msg=key)
    path = str(tmp_path / "bdl.npz")
    save_npz(path, port)
    other = TGNet(crop_size=CROP, c=6, **CONFIGS["bdl"], device="cpu")
    load_npz(path, other)
    for (ka, a), (kb, b) in zip(port.state_dict().items(),
                                other.state_dict().items()):
        assert ka == kb and torch.equal(a, b)
