"""The port's point-sharded training step
(toothgroupnetwork_tpu_torch/parallel/sharded_train.py) against the JAX
package's dense step, on the CPU.

The ranks are a module-scoped pool of four spawned CPU processes in a gloo
group (``parallel.RankPool``, as tests/test_torch_port_parallel.py runs
them); each case runs on the first 2 or 4 (the jobs in
tests/torch_port_parallel_ranks.py, which imports no JAX).

  * one step of the ``pointtransformer`` task at the JAX test's arch
    (planes 8/16, n = 512, batch 2; tests/test_misc_parallel.py:495-561)
    with the point axis split over D = 2 and 4, and an uneven cloud of 500
    points at D = 4 (shards of 125 / 31-32 rows): its losses within the JAX
    test's rtol 2e-5 / atol 1e-6 of JAX ``make_train_step`` on the whole
    batch, and every updated BatchNorm statistic within its rtol 2e-4 /
    atol 2e-6; the same step from a jittered state at SGD lr 0.01 against
    the port's dense one-process step (``_check_data_parallel``: losses
    rtol 2e-5, statistics rtol 2e-4 + atol 2e-6, every parameter within
    1e-6 of the largest parameter, the ranks bit-identical);
  * ``ring_gather``'s gradient against the dense gather's, indices
    repeated so that owners sum several rows, over uneven shards, and two
    backward passes bit-identical;
  * ``ring_knn`` with k above the smallest shard, past the whole cloud,
    and with a candidate mask, and ``knn_self`` / ``knn_points`` /
    ``farthest_point_sample`` inside the point-sharded context, against
    the dense ops (bit-equal: K2's plain version scores each pair alike);
  * ``shard_batch_points`` splitting the point axis (the analog of JAX's
    ``test_batch_leaves_sharded``);
  * the tasks and ops without a point-sharded route raising.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_port_parallel_ranks as ranks  # noqa: E402
from test_torch_port_families import _flat  # noqa: E402
from test_torch_port_parallel import (_check_data_parallel, _jittered_state,  # noqa: E402,F401
                                      _run, pool)

from toothgroupnetwork_tpu_torch.models import get_task
from toothgroupnetwork_tpu_torch.parallel import Mesh, points
from toothgroupnetwork_tpu_torch.parallel.sharded_train import (
    POINT_AXIS, SUPPORTED_TASKS, make_point_sharded_train_step, shard_batch_points)
from toothgroupnetwork_tpu_torch.utils.weights import from_jax_variables

ARCH = {"planes": [8, 16], "stride": [1, 4], "nsample": [8, 8], "blocks": [2, 2],
        "block_num": 2}
LOSS_TOL = dict(rtol=2e-5, atol=1e-6)
STAT_TOL = dict(rtol=2e-4, atol=2e-6)


def _batch(n: int) -> dict:
    """The JAX test's batch (tests/test_misc_parallel.py:510-514) at ``n``
    points."""
    rng = np.random.default_rng(3)
    return {"feat": rng.standard_normal((2, n, 6)).astype(np.float32) * .3,
            "gt_seg_label": rng.integers(0, 17, (2, n)).astype(np.int32),
            "mask": np.ones((2, n), bool)}


def _fake_mesh(rank: int, size: int) -> Mesh:
    """A mesh for calls that exchange nothing (no process group)."""
    return Mesh(None, rank, size, torch.device("cpu"), POINT_AXIS, "gloo")


# ------------------------------------------------------------ the step

@pytest.fixture(scope="module")
def jax_reference():
    """The JAX test's initial state (flax init, batch 2 x 512) and the JAX
    dense step's (losses, statistics) on a batch of ``n`` points, each
    ``n`` compiled once."""
    from toothgroupnetwork_tpu.models import get_task as jax_get_task
    from toothgroupnetwork_tpu.train.train_state import create_train_state
    from toothgroupnetwork_tpu.train.trainer import make_train_step

    task = jax_get_task("pointtransformer")
    cfg = task.default_config()
    cfg.model_parameter.update(ARCH)
    module = task.build_module(cfg)
    b = _batch(512)
    state = create_train_state(module, cfg.optimizer, b, jax.random.PRNGKey(0),
                               task.forward_kwargs(b))
    port_state = {k: v.numpy() for k, v in from_jax_variables(
        _flat({"params": state.params, "batch_stats": state.batch_stats})).items()}
    step = jax.jit(make_train_step(task, cfg))
    done = {}

    def dense(n):
        if n not in done:
            after, values = step(state, {k: jnp.asarray(v) for k, v in _batch(n).items()})
            done[n] = ({k: float(v) for k, v in values.items()},
                       from_jax_variables(_flat({"batch_stats": after.batch_stats})))
        return done[n]

    return port_state, dense


@pytest.mark.parametrize("d,n", [(2, 512), (4, 512), (4, 500)])
def test_step_matches_jax_dense_step(pool, jax_reference, d, n):
    """One point-sharded step from the JAX test's flax-initialised state
    (its preset: SGD lr 0.1, momentum 0.9) against one JAX dense step on
    the whole batch: the losses and every updated BatchNorm statistic
    within the JAX test's tolerances."""
    state, dense = jax_reference
    want_vals, want_stats = dense(n)
    parts = _run(pool, ranks.point_sharded_step_job, d, ARCH, _batch(n), state, 0.1)
    got = parts[0][0]
    assert set(got["stats"]) == {"tooth_class_loss_1_train"}
    assert set(want_vals) == {"tooth_class_loss_1"}
    for key, val in want_vals.items():
        np.testing.assert_allclose(got["stats"][f"{key}_train"], val, err_msg=key,
                                   **LOSS_TOL)
    assert len(want_stats) > 0
    assert set(want_stats) == {k for k in got["state"] if k.endswith((".mean", ".var"))}
    for key, want in want_stats.items():
        np.testing.assert_allclose(got["state"][key], want.numpy(), err_msg=key, **STAT_TOL)
    for other, _ in parts[1:]:
        assert other["stats"] == got["stats"]


@pytest.mark.parametrize("d,n", [(2, 512), (4, 500)])
def test_step_matches_port_dense_step(pool, d, n):
    """One point-sharded step from a jittered state (no unit at exactly
    zero, where a sum in another order would flip a ReLU's gate) at SGD lr
    0.01 against the port's dense one-process step on the whole batch: the
    losses, statistics and updated parameters as ``_check_data_parallel``
    holds a data-parallel step, the ranks bit-identical."""
    state = _jittered_state("pointtransformer", ARCH)
    _check_data_parallel(_run(pool, ranks.point_sharded_step_job, d, ARCH, _batch(n),
                              state, 0.01))


# ------------------------------------------------------------ primitives

@pytest.mark.parametrize("d,n", [(2, 160), (4, 157)])
def test_ring_gather_gradient(pool, rng, d, n):
    """The gradient of a weighted sum of ring-gathered rows against the
    dense gather's: indices drawn from a quarter of the cloud's points,
    spread over every shard, so that an owner sums several rows into one,
    over shards of unequal size; the forward bit-equal, the gradient within
    float32 rounding of the sums, two backward passes bit-identical."""
    x = rng.standard_normal((2, n, 5)).astype(np.float32)
    some = rng.choice(n, n // 4, replace=False)
    idx = some[rng.integers(0, n // 4, (2, 96, 7))].astype(np.int32)
    w = rng.standard_normal((2, 96, 7, 5)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    want_out = xt[torch.arange(2)[:, None, None], torch.from_numpy(idx).long()]
    (want_out * torch.from_numpy(w)).sum().backward()
    parts = _run(pool, ranks.ring_gather_grad_job, d, x, idx, w)
    np.testing.assert_array_equal(np.concatenate([p["out"] for p in parts], axis=1),
                                  want_out.detach().numpy())
    grad = np.concatenate([p["grad"] for p in parts], axis=1)
    assert all(np.abs(p["grad"]).max() > 0 for p in parts)    # every owner
    np.testing.assert_allclose(grad, xt.grad.numpy(), rtol=1e-6, atol=1e-6)
    for p in parts:
        np.testing.assert_array_equal(p["grad"], p["again"])


@pytest.mark.parametrize("d,n,k,masked", [(4, 90, 24, False), (4, 90, 24, True),
                                          (2, 45, 24, True), (4, 20, 24, False)])
def test_ring_knn_k_above_shard_and_mask(pool, rng, d, n, k, masked):
    """``ring_knn`` at k above the smallest shard (90 points at D = 4: 22
    and 23 rows; 45 at D = 2: 22 and 23), past the whole cloud (20 < 24:
    the dense tail, index 0 at d2 1e10) and with a candidate mask (a padded
    tail and scattered holes), against the dense ``knn_points``; and inside
    the point-sharded context ``knn_self``, ``knn_points`` (re-scored) and
    ``farthest_point_sample`` against the dense ops on the whole cloud:
    indices and distances bit-equal."""
    from toothgroupnetwork_tpu_torch.ops import farthest_point_sample, knn_points, knn_self

    xyz = rng.standard_normal((2, n, 3)).astype(np.float32)
    q = rng.standard_normal((2, n, 3)).astype(np.float32)
    mask = np.ones((2, n), bool)
    if masked:
        mask[0, n - 7:] = False
        mask[1, rng.choice(n, n // 3, replace=False)] = False
    pt, qt, mt = (torch.from_numpy(a) for a in (xyz, q, mask))
    want = {"ring": knn_points(qt[0], pt[0], k, None, mt[0], need_dist=False),
            "self": knn_self(pt, k, mt),
            "rescored": knn_points(qt, pt, k, None, mt),
            "fps": farthest_point_sample(pt, n // 4, mt)}
    parts = _run(pool, ranks.ring_knn_context_job, d, xyz, q, mask, k)
    for key, ref in want.items():
        if key == "fps":
            got = np.concatenate([p[key] for p in parts], axis=1)
            np.testing.assert_array_equal(got, ref.numpy(), err_msg=key)
            continue
        axis = 0 if key == "ring" else 1
        for i in (0, 1):
            got = np.concatenate([p[key][i] for p in parts], axis=axis)
            np.testing.assert_array_equal(got, ref[i].numpy(), err_msg=key)
    if n < k:
        tail = np.concatenate([p["ring"][0] for p in parts])[:, n:]
        assert (tail == 0).all()


# ------------------------------------------------------------ layout and scope

def test_shard_batch_points_splits_the_point_axis():
    """Each rank's leaves hold its rows of the point axis and not the whole
    cloud (rows ``[r N // D, (r + 1) N // D)``, 500 points over 4 ranks:
    125 each); an array without the point axis stays whole, a non-array
    field passes through."""
    b = {**_batch(500), "center": np.zeros((2, 8, 3), np.float32), "path": "scan.obj"}
    seen = []
    for r in range(4):
        got = shard_batch_points(b, _fake_mesh(r, 4))
        lo, hi = points.rows(500, _fake_mesh(r, 4))
        assert (lo, hi) == (125 * r, 125 * (r + 1))
        for key in ("feat", "gt_seg_label", "mask"):
            assert isinstance(got[key], torch.Tensor)
            assert got[key].shape[:2] == (2, hi - lo), key
            np.testing.assert_array_equal(got[key].numpy(), b[key][:, lo:hi])
        assert got["center"].shape == (2, 8, 3)
        assert got["path"] == "scan.obj"
        seen.append(got["feat"].numpy())
    np.testing.assert_array_equal(np.concatenate(seen, axis=1), b["feat"])
    uneven = shard_batch_points(_batch(90), _fake_mesh(3, 4))
    assert uneven["feat"].shape[1] == 90 - 3 * 90 // 4


@pytest.mark.parametrize("name", ["pointnet", "pointnetpp", "dgcnn", "tgnet_fps",
                                  "tgnet_bdl", "tsegnet"])
def test_tasks_without_a_sharded_route_raise(name):
    """Every task but pointtransformer raises, naming the ROADMAP item."""
    assert name not in SUPPORTED_TASKS
    task = get_task(name)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_point_sharded_train_step(task, task.default_config(), _fake_mesh(0, 2))


@pytest.mark.parametrize("op", ["masked_max", "ball_query", "feature_knn",
                                "masked_mean_other_axis"])
def test_ops_without_a_sharded_route_raise(op):
    """Inside the point-sharded context the point-axis ops it does not
    route raise (pointnet's and dgcnn's global max, PointNet++'s ball
    query, DGCNN's feature-space kNN), and outside it they run."""
    from toothgroupnetwork_tpu_torch.nn.layers import masked_max, masked_mean
    from toothgroupnetwork_tpu_torch.ops import ball_query, knn_points

    x = torch.randn(1, 16, 6)
    calls = {"masked_max": lambda: masked_max(x, None, dim=1),
             "ball_query": lambda: ball_query(0.5, 4, x[..., :3], x[..., :3]),
             "feature_knn": lambda: knn_points(x, x, 4),
             "masked_mean_other_axis": lambda: masked_mean(x, None, dim=2)}
    calls[op]()
    with points.context(_fake_mesh(0, 2), 32):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            calls[op]()
    assert points.active() is None


def test_sizes_a_rank_cannot_tell_apart_raise():
    """A step whose point axes would give a rank one row count for two
    global sizes raises on every rank (each resolves a global size from its
    own count)."""
    with points.context(_fake_mesh(0, 4), 9):
        assert points.global_size(2) == 9
        with pytest.raises(ValueError, match="cannot tell them apart"):
            points.register(8)
        with pytest.raises(ValueError, match="leaves a rank none"):
            points.register(3)
