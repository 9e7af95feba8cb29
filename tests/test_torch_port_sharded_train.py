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
  * one step of ``pointnet``, ``dgcnn`` and ``pointnetpp`` at the
    families' tiny sizes on their padded two-jaw batch
    (tests/test_torch_port_train_families.py: ``SMALL_PARAMS``, 32 and 64
    padded slots) at D = 2 and 4 and on 506 slots at D = 4 (shards of
    126 / 127 rows), against JAX ``make_train_step`` on the whole batch from
    the flax init: the losses within rtol 2e-5 / atol 1e-6 and every
    updated statistic within rtol 2e-4 / atol 2e-6, the JAX point-sharded
    test's tolerances (DGCNN at dropout 0, JAX replaying the neighbour
    lists the ranks chose, ``ReplayedSelection``; the other selections are
    on the input coordinates, equal in both packages); and against the
    port's dense step from a jittered state at SGD lr 0.01, DGCNN with its
    dropout (0.5) on, as ``_check_data_parallel`` holds it;
  * the new point-axis routes against the dense ops over uneven, masked
    shards: ``masked_max`` (the value bit-equal; the gradient, divided by D
    as the step's all-reduce divides it, bit-equal to ``amax``'s, with a
    tie across two ranks and a shard holding only padding),
    ``ball_query`` (an empty ball, k above the in-ball count, a masked
    tail), DGCNN's feature-space ``knn_points`` at C = 6 and 64 with
    ``include_self`` and the dropout draw, each ``array_equal``;
  * ``shard_batch_points`` splitting the point axis (the analog of JAX's
    ``test_batch_leaves_sharded``);
  * the ops without a point-sharded route raising (the crop models' steps
    are tests/test_torch_port_sharded_train_tgnet.py's and
    tests/test_torch_port_sharded_train_tsegnet.py's).
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

from synthetic import make_synthetic_jaw_points  # noqa: E402
from test_torch_port_families import SMALL_PARAMS  # noqa: E402
from test_torch_port_train_families import (PAD, ReplayedSelection,  # noqa: E402
                                            _modules, _variables)
from test_torch_port_train_families_steps import CANCELLED, jax_state  # noqa: E402

from toothgroupnetwork_tpu_torch.parallel import Mesh, points
from toothgroupnetwork_tpu_torch.parallel.sharded_train import POINT_AXIS, shard_batch_points
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


# ------------------------------------------------------------ the families

FAMILIES = ("pointnet", "dgcnn", "pointnetpp")
# 512 slots: the families' batch; 506 at D = 4: shards of 126 / 127 rows,
# none equal to a rank's rows of pointnetpp's samples (1024 / 512 / 256)
FAMILY_CASES = [(2, 512), (4, 512), (4, 506)]


def _family_batch(n: int) -> dict:
    """The families' two synthetic jaws (test_torch_port_train_families.py
    ``_batch``, which this is at 512) in ``n`` slots a cloud, the last 32
    and 64 of them padding."""
    rng = np.random.default_rng(0)
    feat = np.zeros((2, n, 6), np.float32)
    labels = np.full((2, n), -1, np.int32)
    mask = np.zeros((2, n), bool)
    for b, pad in enumerate(PAD):
        valid = n - pad
        pts, _, cls = make_synthetic_jaw_points(valid, 8, seed=1 + b)
        nrm = rng.standard_normal((valid, 3))
        feat[b, :valid, :3] = pts
        feat[b, :valid, 3:] = nrm / np.linalg.norm(nrm, axis=1, keepdims=True)
        labels[b, :valid] = cls - 1
        mask[b, :valid] = True
    return {"feat": feat, "gt_seg_label": labels, "mask": mask}


@pytest.fixture(scope="module")
def family_reference():
    """Per family: the flax-initialised state (jittered statistics, the
    zero-initialised heads at zero) as the port's state dict, and the JAX
    dense step's (losses, statistics) on the batch of ``n`` slots, each
    family's step compiled once for each ``n``. JAX's DGCNN (dropout 0)
    replays the neighbour lists it is given (``ReplayedSelection``, set up
    for the module)."""
    from toothgroupnetwork_tpu.train.train_state import make_optimizer as jax_opt
    from toothgroupnetwork_tpu.train.trainer import make_train_step

    with pytest.MonkeyPatch.context() as patch:
        selection = ReplayedSelection(patch)
        setups, done = {}, {}

        def setup(name):
            if name not in setups:
                jtask, jcfg, module, _, _, _ = _modules(name)
                vs = _variables(name, module, _family_batch(512), draw_zero_heads=False)
                state = jax_state(module, jax_opt(jcfg.optimizer), vs["params"],
                                  vs["batch_stats"])
                port = {k: v.numpy() for k, v in from_jax_variables(_flat(vs)).items()}
                setups[name] = (port, state, jax.jit(make_train_step(jtask, jcfg)))
            return setups[name]

        def dense(name, n, lists=None):
            key = (name, n)
            if lists is None and key in done:
                return done[key]
            _, state, step = setup(name)
            batch = {k: jnp.asarray(v) for k, v in _family_batch(n).items()}
            if lists is not None:
                selection.steps.append(lists)
                with selection.replay(len(selection.steps)):
                    after, values = jax.block_until_ready(step(state, batch))
            else:
                after, values = step(state, batch)
            out = ({k: float(v) for k, v in values.items()},
                   from_jax_variables(_flat({"batch_stats": after.batch_stats})))
            if lists is None:
                done[key] = out
            return out

        yield setup, dense


@pytest.mark.parametrize("d,n", FAMILY_CASES)
@pytest.mark.parametrize("name", FAMILIES)
def test_family_step_matches_jax_dense_step(pool, family_reference, name, d, n):
    """One point-sharded step of the family from the flax init (DGCNN at
    dropout 0) against one JAX dense step on the whole padded batch: the
    loss and every updated BatchNorm statistic within the JAX point-sharded
    test's tolerances; JAX's DGCNN takes the lists the ranks chose, joined
    in rank order."""
    setup, dense = family_reference
    state = setup(name)[0]
    parts = _run(pool, ranks.point_sharded_step_job, d, SMALL_PARAMS[name],
                 _family_batch(n), state, 0.01, name, 0.0 if name == "dgcnn" else None)
    got = parts[0][0]
    lists = None
    if name == "dgcnn":
        assert all(len(p["knn"]) == 3 for p, _ in parts)
        lists = [np.concatenate([p["knn"][i] for p, _ in parts], axis=1) for i in range(3)]
    want_vals, want_stats = dense(name, n, lists)
    assert set(got["stats"]) == {f"{k}_train" for k in want_vals} == {
        "tooth_class_loss_1_train"}
    for key, val in want_vals.items():
        np.testing.assert_allclose(got["stats"][f"{key}_train"], val, err_msg=key,
                                   **LOSS_TOL)
    assert len(want_stats) > 0
    assert set(want_stats) == {k for k in got["state"] if k.endswith((".mean", ".var"))}
    for key, want in want_stats.items():
        np.testing.assert_allclose(got["state"][key], want.numpy(), err_msg=key, **STAT_TOL)
    for other, _ in parts[1:]:
        assert other["stats"] == got["stats"]


@pytest.mark.parametrize("d,n", [(2, 512), (4, 506)])
@pytest.mark.parametrize("name", FAMILIES)
def test_family_step_matches_port_dense_step(pool, name, d, n):
    """One point-sharded step of the family from a jittered state at SGD
    lr 1e-3 against the port's dense one-process step on the whole padded
    batch, DGCNN with its preset's dropout (0.5) on, both steps drawing
    from one seed: the losses, statistics and updated parameters as
    ``_check_data_parallel`` holds them, the ranks bit-identical; and each
    parameter's update within 1e-2 of the dense update in L2 norm, plus
    the norm of one float32 spacing of each updated element, since each
    side rounds its parameter (the biases whose gradient is zero in exact
    arithmetic, ``CANCELLED``, apart).

    The step size: these families max-pool (the global max, DGCNN's and
    PointNet++'s neighbourhood maxima), and a max whose two largest
    entries lie within float32 rounding moves a whole channel's gradient
    with the order of the sums. At lr 0.01 the dense step against itself
    on the cloud given twice (the same function, its sums in another
    order) moves PointNet++'s ``sa1.scale_1.dense_0.weight`` by 1.8e-5,
    14 times the parameters' tolerance, and the updates by up to 7e-3 of
    their norm (pointnet 4.6e-3, DGCNN at dropout 0 under 1e-4): the
    sharded step stays within those (1.1e-5, 4.6e-3 and 4.1e-3). At lr
    1e-3 that spread is a tenth of the tolerance."""
    state = _jittered_state(name, SMALL_PARAMS[name])
    parts = _run(pool, ranks.point_sharded_step_job, d, SMALL_PARAMS[name],
                 _family_batch(n), state, 1e-3, name, None, 11)
    _check_data_parallel(parts)
    (got, ref), = parts[:1]
    for key, start in state.items():
        if key.endswith((".mean", ".var")) or CANCELLED.search(key):
            continue
        want = ref["state"][key] - start
        err = np.linalg.norm(got["state"][key] - ref["state"][key])
        ulp = np.linalg.norm(np.spacing(np.abs(ref["state"][key])))
        assert err <= 1e-2 * np.linalg.norm(want) + ulp, (key, err, np.linalg.norm(want))


@pytest.mark.parametrize("d,n", [(2, 61), (4, 90)])
def test_masked_max_over_shards(pool, rng, d, n):
    """``masked_max`` over the point axis inside the point-sharded context
    against the dense op: the value bit-equal; the gradient of a weighted
    sum, divided by D, bit-equal to ``amax``'s, which splits it evenly over
    tied rows. In the first cloud channel 0 ties at two rows on the first
    and the last rank; in both channel 1 ties at three rows of one rank;
    the second cloud's last shard holds only padding, whose values lie
    above every valid one."""
    c = 5
    x = rng.standard_normal((2, n, c)).astype(np.float32)
    mask = np.ones((2, n), bool)
    last = points.bounds(n, d)[d - 1]
    mask[1, last:] = False
    x[1, last:] = 10.0                                  # padding, above all
    x[0, 1, 0] = x[0, n - 2, 0] = 5.0                   # a tie across ranks
    x[:, 2, 1] = x[:, 3, 1] = x[:, 4, 1] = 6.0          # a tie inside a rank
    w = rng.standard_normal((2, c)).astype(np.float32)
    from toothgroupnetwork_tpu_torch.nn.layers import masked_max

    xt = torch.from_numpy(x).requires_grad_(True)
    want = masked_max(xt, torch.from_numpy(mask), dim=1)
    (want * torch.from_numpy(w)).sum().backward()
    grad = xt.grad.numpy()
    assert (grad[0, [1, n - 2], 0] != 0).all() and (grad[:, [2, 3, 4], 1] != 0).all()
    parts = _run(pool, ranks.masked_max_job, d, x, mask, w)
    for p in parts:
        np.testing.assert_array_equal(p["out"], want.detach().numpy())
    np.testing.assert_array_equal(np.concatenate([p["grad"] for p in parts], axis=1), grad)
    assert not parts[-1]["grad"][1].any()


@pytest.mark.parametrize("d,n", [(2, 75), (4, 130)])
def test_ball_query_over_shards(pool, rng, d, n):
    """``ball_query`` inside the point-sharded context against the dense
    op, ``array_equal``: a few points in most balls (k = 6 above many of
    their counts: the fill with the first in-ball point), a centre far from
    every point (an empty ball: the nearest point), a masked tail and
    scattered holes (never in a ball), centres on every shard."""
    from toothgroupnetwork_tpu_torch.ops import ball_query

    xyz = rng.uniform(-1, 1, (2, n, 3)).astype(np.float32)
    mask = np.ones((2, n), bool)
    mask[0, n - 9:] = False
    mask[1, rng.choice(n, n // 5, replace=False)] = False
    s = n // 3
    centres = xyz[:, rng.choice(n, s, replace=False)].copy()
    centres[:, s // 2] = 5.0
    want = ball_query(0.3, 6, torch.from_numpy(xyz), torch.from_numpy(centres),
                      torch.from_numpy(mask)).numpy()
    counts = (((centres[:, :, None] - xyz[:, None]) ** 2).sum(-1) <= 0.09) & mask[:, None]
    assert (counts.sum(-1) == 0).any() and ((counts.sum(-1) > 0)
                                             & (counts.sum(-1) < 6)).any()
    parts = _run(pool, ranks.ball_query_job, d, xyz, mask, centres, 0.3, 6)
    np.testing.assert_array_equal(np.concatenate(parts, axis=1), want)


@pytest.mark.parametrize("d,n,c", [(2, 83, 6), (4, 90, 6), (2, 83, 64), (4, 90, 64)])
def test_feature_knn_over_shards(pool, rng, d, n, c):
    """DGCNN's selection (``knn_points(x, x, 8, mask, mask,
    include_self=True, need_dist=False)``) at C = 6 and 64 inside the
    point-sharded context against the dense op on uneven shards with a
    masked tail: indices and distances ``array_equal`` (K2's plain version
    scores each pair alike, whatever the query rows)."""
    from toothgroupnetwork_tpu_torch.ops import knn_points

    x = rng.standard_normal((2, n, c)).astype(np.float32)
    mask = np.ones((2, n), bool)
    mask[:, n - 11:] = False
    mt = torch.from_numpy(mask)
    want = knn_points(torch.from_numpy(x), torch.from_numpy(x), 8, mt, mt,
                      include_self=True, need_dist=False)
    parts = _run(pool, ranks.feature_knn_job, d, x, mask, 8)
    for i in (0, 1):
        np.testing.assert_array_equal(np.concatenate([p[i] for p in parts], axis=1),
                                      want[i].numpy())


@pytest.mark.parametrize("d,n", [(2, 61), (4, 90)])
def test_dropout_draw_over_shards(pool, d, n):
    """A train-mode ``Dropout`` on point rows inside the point-sharded
    context (and the data-parallel one, as in the step): the ranks' masks,
    joined in rank order, bit-equal to the dense draw from the same seed."""
    from toothgroupnetwork_tpu_torch.nn.layers import Dropout

    drop = Dropout(0.5).train()
    drop.generator = torch.Generator().manual_seed(5)
    want = drop(torch.ones(2, n, 7)).numpy()
    parts = _run(pool, ranks.dropout_draw_job, d, (2, n, 7), 0.5, 5)
    np.testing.assert_array_equal(np.concatenate(parts, axis=1), want)


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


@pytest.mark.parametrize("op", ["masked_mean_other_axis", "masked_max_other_axis",
                                "dropout_on_replicated_rows"])
def test_ops_without_a_sharded_route_raise(op):
    """Inside the point-sharded context the point-axis ops it does not
    route raise (a mean or a max over another axis than the point axis,
    dropout on rows without a point axis), and outside it they run."""
    from toothgroupnetwork_tpu_torch.nn.layers import Dropout, masked_max, masked_mean

    x = torch.randn(1, 16, 6)
    drop = Dropout(0.5).train()
    drop.generator = torch.Generator().manual_seed(0)
    calls = {"masked_mean_other_axis": lambda: masked_mean(x, None, dim=2),
             "masked_max_other_axis": lambda: masked_max(x, None, dim=2),
             "dropout_on_replicated_rows": lambda: drop(x[:, 0])}
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
