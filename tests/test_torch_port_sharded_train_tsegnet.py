"""The port's point-sharded training step for ``tsegnet``
(toothgroupnetwork_tpu_torch/parallel/sharded_train.py) against the JAX
package's dense step and the port's, and its new routes against the dense
ops, on the CPU.

The ranks are a module-scoped pool of four spawned CPU processes in a gloo
group, as in tests/test_torch_port_sharded_train_tgnet.py (the jobs in
tests/torch_port_parallel_ranks.py). The model is the JAX package's tiny
tsegnet backbone (32 / 16 / 8 centres) with crops of 64 over two
synthetic jaws of 8 teeth in 512 slots, the last 32 and 64 of them
padding, and 8 fixed crop proposals a cloud (three slots invalid): 16
crops, 10 of them live.

  * one step at D = 2 and 4 (shards of 256 / 128 rows) and on 509 slots
    at D = 4 (127 / 128 rows), against JAX ``make_train_step`` on the
    whole batch from the flax init: the six losses within rtol 2e-5 / atol
    1e-6, every updated statistic within rtol 2e-4 / atol 2e-6; the ranks'
    crops joined ``array_equal`` to the dense forward's; the ranks
    bit-identical;
  * one step from a jittered state against the port's dense step, also at
    D = 3 on one cloud, whose 8 crops split 2 / 3 / 3, and stage 2's
    statistics counting each crop once (as the tgnet tests hold them);
  * the new routes against the dense ops over uneven shards: the crops' l0
    rows over the ring (``sharded_ops.crop_rows_gather``) and their
    gradient, the centroid term's global minimum over the l3 points
    (``points.pmax`` of the negation) with a tie across two ranks, and the
    host-stage helper with tsegnet's proposals (``default_rng(step)``
    draws, no replay of other ranks' clouds), and a failure of its stage
    on rank 0 reaching every rank.
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
from synthetic import make_synthetic_jaw_points  # noqa: E402
from test_torch_port_families import _flat  # noqa: E402
from test_torch_port_parallel import (_check_data_parallel, _jittered_state,  # noqa: E402,F401
                                      _run, pool)
from test_torch_port_sharded_train_tgnet import (check_against_jax,  # noqa: E402
                                                 check_crops_count_once, check_updates,
                                                 dense_crops)

from toothgroupnetwork_tpu_torch.models import get_task
from toothgroupnetwork_tpu_torch.parallel import points
from toothgroupnetwork_tpu_torch.utils.weights import from_jax_variables

MP = {"tiny_backbone": True, "crop_sample_size": 64}
LIVE = [True, True, False, True, True, False, True, False]
JAX_CASES = [(2, 512), (4, 512), (4, 509)]
PORT_CASES = [(4, 509, 2), (3, 512, 1)]
# The port's dense step from a jittered state has max-pool and ReLU kinks
# within rounding of the step (tests/test_torch_port_train_families_steps.py):
# at lr 1e-3 the dense step on the clouds given twice, the same function
# with its sums in another order, moves a weight of the centroid backbone's
# first layer by 3.9e-4 of the largest parameter, 392 times the 1e-6 bound
# of ``_check_data_parallel``, and the point-sharded step by 1.9e-6. At lr
# 1e-4 the point-sharded step keeps that bound; each update is held in L2
# as at any rate.
LR = 1e-4


def tsegnet_batch(n: int, clouds: int = 2) -> dict:
    """Synthetic jaws of 8 teeth in ``n`` slots, cloud i's last 32 (i + 1)
    slots padding, unit z normals; 8 crop proposals a cloud near its
    points, the ``LIVE`` slots valid."""
    rng = np.random.default_rng(0)
    feat = np.zeros((clouds, n, 6), np.float32)
    labels = np.full((clouds, n), -1, np.int32)
    centres = np.zeros((clouds, 8, 3), np.float32)
    for i in range(clouds):
        valid = n - 32 * (i + 1)
        pts, _, cls = make_synthetic_jaw_points(valid, 8, seed=7 + i)
        feat[i, :valid, :3] = pts
        feat[i, :valid, 5] = 1.0
        labels[i, :valid] = cls - 1
        centres[i] = pts[rng.permutation(valid)[:8]] + rng.normal(0, 0.02, (8, 3))
    return {"feat": feat, "gt_seg_label": labels,
            "mask": np.arange(n)[None] < n - 32 * (np.arange(clouds)[:, None] + 1),
            "center_points": centres, "center_valid": np.array([LIVE] * clouds)}


# ------------------------------------------------------------ against JAX

@pytest.fixture(scope="module")
def jax_reference():
    """The flax-initialised state as the port's state dict, and the JAX
    dense step's (losses, statistics) on the batch of ``n`` slots, each
    ``n`` compiled once."""
    from toothgroupnetwork_tpu.models import get_task as jax_get_task
    from toothgroupnetwork_tpu.train.train_state import create_train_state
    from toothgroupnetwork_tpu.train.trainer import make_train_step

    task = jax_get_task("tsegnet")
    cfg = task.default_config()
    cfg.model_parameter.update(MP)
    b = {k: jnp.asarray(v) for k, v in tsegnet_batch(512).items()}
    state = create_train_state(task.build_module(cfg), cfg.optimizer, b,
                               jax.random.PRNGKey(0), task.forward_kwargs(b))
    port = {k: v.numpy() for k, v in from_jax_variables(_flat(
        {"params": state.params, "batch_stats": state.batch_stats})).items()}
    step = jax.jit(make_train_step(task, cfg))
    done = {}

    def dense(n):
        if n not in done:
            after, values = step(state, {k: jnp.asarray(v)
                                         for k, v in tsegnet_batch(n).items()})
            done[n] = ({k: float(v) for k, v in values.items()},
                       from_jax_variables(_flat({"batch_stats": after.batch_stats})))
        return done[n]

    return port, dense


@pytest.mark.parametrize("d,n", JAX_CASES)
def test_step_matches_jax_dense_step(pool, jax_reference, d, n):
    """One point-sharded step from the flax init against one JAX dense step
    on the whole batch: the centroid and seg losses and every updated
    BatchNorm statistic (the centroid module's and the seg towers') within
    the JAX point-sharded test's tolerances; the crops the dense crops;
    the ranks bit-identical."""
    state, dense = jax_reference
    want_vals, want_stats = dense(n)
    assert len(want_vals) == 6
    batch = tsegnet_batch(n)
    parts = _run(pool, ranks.point_sharded_step_job, d, MP, batch, state, 0.1, "tsegnet",
                 None, None, False)
    check_against_jax(parts, want_vals, want_stats,
                      dense_crops("tsegnet", MP, state, batch))


# ------------------------------------------------------------ against the port

_PORT_RUNS: dict = {}


def port_run(pool, d: int, n: int, clouds: int):
    key = (d, n, clouds)
    if key not in _PORT_RUNS:
        state = _jittered_state("tsegnet", MP)
        batch = tsegnet_batch(n, clouds)
        _PORT_RUNS[key] = (state, batch, _run(pool, ranks.point_sharded_step_job, d, MP,
                                              batch, state, LR, "tsegnet"))
    return _PORT_RUNS[key]


@pytest.mark.parametrize("d,n,clouds", PORT_CASES)
def test_step_matches_port_dense_step(pool, d, n, clouds):
    """One point-sharded step from a jittered state at SGD lr ``LR``
    against the port's dense step: ``_check_data_parallel``, each update
    within 1e-2 in L2, the crops the dense step's (8 crops of one cloud
    split 2 / 3 / 3 at D = 3)."""
    state, _, parts = port_run(pool, d, n, clouds)
    _check_data_parallel(parts)
    check_updates(parts, state)
    rows = [len(p["crops"]) for p, _ in parts]
    assert sum(rows) == 8 * clouds
    if d == 3:
        assert rows == [2, 3, 3]
    np.testing.assert_array_equal(np.concatenate([p["crops"] for p, _ in parts]),
                                  parts[0][1]["crops"])


def test_seg_statistics_count_once(pool):
    """The seg towers' running statistics equal the dense step's, each crop
    counted once: 10 live crops of 64 points, 80 rows at the towers' third
    level and in the id head's group-all layer, where the replicated
    design's Bessel factor over D·n rows would miss the tolerance
    (``check_crops_count_once``)."""
    d, n, clouds = PORT_CASES[0]
    state, batch, parts = port_run(pool, d, n, clouds)
    check_crops_count_once("tsegnet", MP, "seg_module.", batch, state, parts, d)


# ------------------------------------------------------------ the routes

@pytest.mark.parametrize("d,n", [(3, 61), (4, 157)])
def test_crop_rows_gather_and_gradient(pool, rng, d, n):
    """``crop_rows_gather`` of each rank's crop rows (10 crops of 7 points
    over two clouds: 3 / 3 / 4 and 2 / 3 / 2 / 3 rows) against the dense
    row gather: the rows bit-equal; the gradient of a weighted sum, the
    ranks' rows joined, within float32 rounding of the dense one, the
    indices drawn from a quarter of the points so that owners sum several
    rows."""
    from toothgroupnetwork_tpu_torch.ops import index_points

    x = rng.standard_normal((2, n, 5)).astype(np.float32)
    some = rng.choice(n, n // 4, replace=False)
    idx = some[rng.integers(0, n // 4, (2, 5, 7))].astype(np.int64)
    w = rng.standard_normal((10, 7, 5)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    want = index_points(xt, torch.from_numpy(idx)).reshape(10, 7, 5)
    (want * torch.from_numpy(w)).sum().backward()
    parts = _run(pool, ranks.crop_rows_gather_job, d, x, idx, w)
    assert [len(p["out"]) for p in parts] == np.diff(points.bounds(10, d)).tolist()
    np.testing.assert_array_equal(np.concatenate([p["out"] for p in parts]),
                                  want.detach().numpy())
    assert all(np.abs(p["grad"]).max() > 0 for p in parts)
    np.testing.assert_allclose(np.concatenate([p["grad"] for p in parts], axis=1),
                               xt.grad.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("d,m", [(2, 61), (4, 90)])
def test_centroid_minimum_over_shards(pool, rng, d, m):
    """``centroid_dist_loss`` over l3 points split across the ranks (and the
    data-parallel sums, as in the step) against the dense loss: the value
    within float32 rounding of the sums, the gradient (divided by D) of the
    offsets and points within it too. Centroid 0's nearest moved point is
    a tie of two points at 0.25 on either side of it, on the first and the
    last rank: the gradient splits over the two, as ``amin``'s does."""
    from toothgroupnetwork_tpu_torch.losses.tsg_loss import centroid_dist_loss

    cents = rng.uniform(-0.5, 0.5, (2, 16, 3)).astype(np.float32)
    cents[0, 0] = (0.5, 0.25, -0.125)
    cvalid = np.ones((2, 16), bool)
    cvalid[1, 11:] = False
    xyz = (cents[:, rng.integers(1, 11, m)] + rng.normal(0, 0.3, (2, m, 3))).astype(np.float32)
    off = rng.normal(0, 0.1, (2, m, 3)).astype(np.float32)
    near = ((xyz + off - cents[0, 0]) ** 2).sum(-1) < 0.1
    xyz[near] += 2.0                      # nothing else near centroid 0
    a, b = 1, m - 2                       # on the first and the last rank
    for i, dx in ((a, 0.25), (b, -0.25)):
        xyz[0, i] = cents[0, 0] + np.float32((dx, 0, 0))
        off[0, i] = 0.0
    inputs = {"pred_offset": off, "sample_xyz": xyz,
              "pred_distance": rng.uniform(0.0, 0.4, (2, m, 1)).astype(np.float32),
              "centroids": cents, "cent_valid": cvalid, "mask": rng.random((2, m)) > 0.2}
    inputs["mask"][0, [a, b]] = True
    inputs["pred_distance"][0, [a, b]] = 0.5  # only the centroid's minimum reads them
    ot, xt = (torch.from_numpy(inputs[k]).requires_grad_(True)
              for k in ("pred_offset", "sample_xyz"))
    want = centroid_dist_loss(ot, xt, *(torch.from_numpy(inputs[k]) for k in (
        "pred_distance", "centroids", "cent_valid", "mask")))
    want.backward()
    d2 = np.where(inputs["mask"][0], ((xyz[0] + off[0] - cents[0, 0]) ** 2).sum(-1), np.inf)
    assert d2[a] == d2[b] == d2.min() == 0.0625 and (d2 == d2.min()).sum() == 2
    assert (xt.grad[0, [a, b], 0] != 0).all()
    parts = _run(pool, ranks.centroid_dist_job, d, inputs)
    for p in parts:
        assert p["loss"] == pytest.approx(want.item(), rel=1e-6)
    for key, ref in (("offset_grad", ot.grad), ("xyz_grad", xt.grad)):
        np.testing.assert_allclose(np.concatenate([p[key] for p in parts], axis=1),
                                   ref.numpy(), rtol=1e-5, atol=1e-7, err_msg=key)


def _stand_in_outputs(rng, clouds: int = 2, m: int = 64) -> dict:
    """A centroid forward's outputs for ``clouds`` clouds: moved l3 points
    in 12 (then 9, ...) tight groups, predicted distance 0.1."""
    l3, moved = [], []
    for c in range(clouds):
        groups = 12 - 3 * c
        centres = rng.uniform(-1, 1, (groups, 3))
        l3.append(rng.uniform(-1, 1, (m, 3)))
        moved.append(centres[rng.integers(0, groups, m)] + rng.uniform(-0.004, 0.004, (m, 3)))
    l3, moved = np.array(l3, np.float32), np.array(moved, np.float32)
    return {"l3_xyz": l3, "offset_result": moved - l3,
            "dist_result": np.full((clouds, m, 1), 0.1, np.float32)}


@pytest.mark.parametrize("d", [2, 4])
def test_host_stage_helper_tsegnet(pool, rng, d):
    """``host_batch_points`` with tsegnet's host stage on a stand-in
    centroid forward over two batches (optimizer steps 0 and 1): the
    proposals on every rank ``array_equal`` to one process's stage on the
    whole batch, whose second cloud draws after the first from one
    ``default_rng(step)`` (a replay of other ranks' clouds would draw
    other permutations); every rank's rows of the cloud joined to the
    batch's; the stage run on rank 0 alone, once a batch."""
    from toothgroupnetwork_tpu_torch.train.trainer import apply_host_stage

    task = get_task("tsegnet")
    outputs = _stand_in_outputs(rng)
    batches = [tsegnet_batch(509), tsegnet_batch(509)]
    for b in batches:
        del b["center_points"], b["center_valid"]
    model = ranks.StandInCentroids(outputs)
    want = [apply_host_stage(task, model, b, None, step) for step, b in enumerate(batches)]
    assert [int(w["center_valid"].sum()) for w in want] == [16, 16]
    assert not np.array_equal(want[0]["center_points"], want[1]["center_points"])
    parts = _run(pool, ranks.host_stage_job, d, "tsegnet", batches, outputs)
    assert [calls for _, calls, _ in parts] == [2] + [0] * (d - 1)
    for i, ref in enumerate(want):
        for p in parts:
            for key in ("center_points", "center_valid"):
                np.testing.assert_array_equal(p[0][i][key], ref[key], err_msg=key)
        np.testing.assert_array_equal(np.concatenate([p[0][i]["feat"] for p in parts],
                                                     axis=1), ref["feat"])


def test_host_stage_helper_failure_reaches_every_rank(pool):
    """A host stage that fails on rank 0 raises ``RankFailure`` on every
    rank (``data_parallel.fail``), none left waiting in the exchange."""
    batch = tsegnet_batch(509)
    del batch["center_points"], batch["center_valid"]
    assert _run(pool, ranks.host_stage_failure_job, 3, batch) == ["RankFailure"] * 3
