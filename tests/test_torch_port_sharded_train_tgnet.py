"""The port's point-sharded training step for the tgnet tasks
(``tgnet_fps``, ``tgnet_bdl``; toothgroupnetwork_tpu_torch/parallel/
sharded_train.py) against the JAX package's dense step and the port's, on
the CPU.

The ranks are a module-scoped pool of four spawned CPU processes in a gloo
group (``parallel.RankPool``, as tests/test_torch_port_parallel.py runs
them); each case runs on the first 2, 3 or 4 (the jobs in
tests/torch_port_parallel_ranks.py, which imports no JAX). The models are
tests/test_torch_port_train_step.py's tiny tgnet (planes [8, 16], blocks
[2, 2], nsample [8, 8]; stride [1, 4] for the fps model, [1, 1] for the
bdl model) with crops of 32, on two synthetic jaws of 6 teeth in 256
slots, the last 16 and 32 of them padding: 32 crops, 12 of them live.

  * one step of each task at D = 2 and 4 (shards of 128 / 64 rows) and on
    251 slots at D = 4 (62 / 63 rows), against JAX ``make_train_step`` on
    the whole batch from the flax init: the losses within rtol 2e-5 / atol
    1e-6 and every updated statistic within rtol 2e-4 / atol 2e-6, the
    JAX point-sharded test's tolerances (tests/test_misc_parallel.py:
    536-549); the ranks' crops (``nn_crop_indexes``, each rank's rows of
    the crop axis), joined in rank order, ``array_equal`` to the dense
    forward's; the ranks bit-identical;
  * one step from a jittered state at SGD lr 1e-3 against the port's dense
    step (``_check_data_parallel``; each update within 1e-2 in L2), also
    at D = 3 on one cloud, whose 16 crops do not divide over the ranks (5,
    5 and 6 rows);
  * the crop stage's statistics count each crop once: stage 2's running
    variances equal the dense step's, where the replicated design (every
    rank running all the crops under the data-parallel sums) would have
    taken the running variance's ``n / (n - 1)`` over ``D·n`` rows and
    missed the tolerance;
  * the host-stage helper ``host_batch_points`` with tgnet_bdl's boundary
    engine (the labels standing in for the frozen model's): every rank's
    rows, joined, ``array_equal`` to one process's stage on the whole
    batch, two batches in turn; the engine's generator on rank 0 in the
    one-process state (no replay of other ranks' draws), the stage run on
    rank 0 alone.
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
from test_torch_port_train_families_steps import CANCELLED  # noqa: E402

from toothgroupnetwork_tpu_torch.models import get_task
from toothgroupnetwork_tpu_torch.nn.layers import MaskedBatchNorm
from toothgroupnetwork_tpu_torch.utils.weights import from_jax_variables

FPS_MP = {"planes": [8, 16], "stride": [1, 4], "nsample": [8, 8], "blocks": [2, 2],
          "block_num": 2, "crop_sample_size": 32}
MODEL_PARAMETERS = {"tgnet_fps": FPS_MP, "tgnet_bdl": {**FPS_MP, "stride": [1, 1]}}
TASKS = tuple(MODEL_PARAMETERS)
LOSS_TOL = dict(rtol=2e-5, atol=1e-6)
STAT_TOL = dict(rtol=2e-4, atol=2e-6)
# (D, slots): even shards at D = 2 and 4, uneven ones at D = 4
JAX_CASES = [(2, 256), (4, 256), (4, 251)]
# (task, D, slots, clouds): uneven shards; 16 crops over 3 ranks
PORT_CASES = [("tgnet_fps", 4, 251, 2), ("tgnet_fps", 3, 256, 1), ("tgnet_bdl", 2, 256, 2)]


def tgnet_batch(n: int, clouds: int = 2) -> dict:
    """Synthetic jaws of 6 teeth in ``n`` slots, cloud i's last 16 (i + 1)
    slots padding, unit random normals."""
    rng = np.random.default_rng(0)
    feat = np.zeros((clouds, n, 6), np.float32)
    labels = np.full((clouds, n), -1, np.int32)
    mask = np.zeros((clouds, n), bool)
    for i in range(clouds):
        valid = n - 16 * (i + 1)
        pts, _, cls = make_synthetic_jaw_points(valid, 6, seed=1 + i)
        nrm = rng.standard_normal((valid, 3))
        feat[i, :valid, :3] = pts
        feat[i, :valid, 3:] = nrm / np.linalg.norm(nrm, axis=1, keepdims=True)
        labels[i, :valid] = cls - 1
        mask[i, :valid] = True
    return {"feat": feat, "gt_seg_label": labels, "mask": mask}


def port_model(name: str, mp: dict, state: dict):
    task = get_task(name)
    cfg = task.default_config()
    cfg.model_parameter.update(mp)
    model = task.build_module(cfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return task, model


def dense_crops(name: str, mp: dict, state: dict, batch: dict) -> np.ndarray:
    """The dense train forward's crops, ``[B·K, S]``."""
    task, model = port_model(name, mp, state)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        out = model.train()(tb["feat"], tb["mask"], **task.forward_kwargs(tb))
    return out["nn_crop_indexes"].numpy().reshape(-1, out["nn_crop_indexes"].shape[-1])


def check_against_jax(parts, want_vals: dict, want_stats: dict, crops: np.ndarray) -> None:
    """The ranks' step against the JAX dense step's losses and statistics,
    their crops against the dense crops, the ranks bit-identical."""
    got = parts[0][0]
    assert set(got["stats"]) == {f"{k}_train" for k in want_vals}
    for key, val in want_vals.items():
        np.testing.assert_allclose(got["stats"][f"{key}_train"], val, err_msg=key,
                                   **LOSS_TOL)
    assert len(want_stats) > 0
    assert set(want_stats) == {k for k in got["state"] if k.endswith((".mean", ".var"))}
    for key, want in want_stats.items():
        np.testing.assert_allclose(got["state"][key], want.numpy(), err_msg=key, **STAT_TOL)
    np.testing.assert_array_equal(np.concatenate([p["crops"] for p, _ in parts]), crops)
    for other, _ in parts[1:]:
        assert other["stats"] == got["stats"]
        for key, val in got["state"].items():
            np.testing.assert_array_equal(other["state"][key], val, err_msg=key)


def check_updates(parts, state: dict) -> None:
    """Rank 0's update within 1e-2 of the dense step's in L2 norm, plus the
    norm of one float32 spacing of each updated element (each side rounds
    its parameter); the biases a BatchNorm cancels (``CANCELLED``) apart."""
    (got, ref), = parts[:1]
    for key, start in state.items():
        if key.endswith((".mean", ".var")) or CANCELLED.search(key):
            continue
        want = ref["state"][key] - start
        err = np.linalg.norm(got["state"][key] - ref["state"][key])
        ulp = np.linalg.norm(np.spacing(np.abs(ref["state"][key])))
        assert err <= 1e-2 * np.linalg.norm(want) + ulp, (key, err, np.linalg.norm(want))


def bn_counts(model, prefix: str, batch: dict, forward_kwargs) -> dict:
    """Each BatchNorm under ``prefix``'s row count in one train-mode forward
    (None for one called more than once)."""
    seen: dict = {}
    hooks = []
    for name, m in model.named_modules():
        if isinstance(m, MaskedBatchNorm) and name.startswith(prefix):
            def count(_m, args, name=name):
                x, mask = args[0], args[1] if len(args) > 1 else None
                n = float(x[..., 0].numel() if mask is None else mask.sum())
                seen[name] = n if name not in seen else None
            hooks.append(m.register_forward_pre_hook(count))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        model.train()(tb["feat"], tb["mask"], **forward_kwargs(tb))
    for h in hooks:
        h.remove()
    return seen


def check_crops_count_once(name, mp, prefix, batch, state, parts, d) -> None:
    """The crop stage's running statistics against the dense step's (within
    the statistics' tolerance), and the replicated design's running
    variances, predicted from the dense step's: the batch's biased variance
    ``(var_new - 0.9 var_old) / 0.1 * (n - 1) / n`` taken back to the
    running variance with ``D n / (D n - 1)``, which must miss the
    tolerance for at least one BatchNorm of the crop stage."""
    task, model = port_model(name, mp, state)
    counts = bn_counts(model, prefix, batch, task.forward_kwargs)
    (got, ref), = parts[:1]
    missed = 0
    for bn, n in counts.items():
        for leaf in ("mean", "var"):
            key = f"{bn}.{leaf}"
            np.testing.assert_allclose(got["state"][key], ref["state"][key], err_msg=key,
                                       **STAT_TOL)
        if n is None or n < 2:
            continue
        old, new = state[f"{bn}.var"].astype(np.float64), ref["state"][f"{bn}.var"]
        biased = (new - 0.9 * old) / 0.1 * (n - 1) / n
        replicated = 0.9 * old + 0.1 * biased * d * n / (d * n - 1)
        missed += not np.allclose(replicated, new, **STAT_TOL)
    assert len(counts) > 0 and missed > 0, (counts, missed)


# ------------------------------------------------------------ against JAX

@pytest.fixture(scope="module")
def jax_reference():
    """Per task: the flax-initialised state as the port's state dict, and
    the JAX dense step's (losses, statistics) on the batch of ``n`` slots,
    each (task, n) compiled once."""
    from toothgroupnetwork_tpu.models import get_task as jax_get_task
    from toothgroupnetwork_tpu.train.train_state import create_train_state
    from toothgroupnetwork_tpu.train.trainer import make_train_step

    setups, done = {}, {}

    def setup(name):
        if name not in setups:
            task = jax_get_task(name)
            cfg = task.default_config()
            cfg.model_parameter.update(MODEL_PARAMETERS[name])
            b = {k: jnp.asarray(v) for k, v in tgnet_batch(256).items()}
            state = create_train_state(task.build_module(cfg), cfg.optimizer, b,
                                       jax.random.PRNGKey(0), task.forward_kwargs(b))
            port = {k: v.numpy() for k, v in from_jax_variables(_flat(
                {"params": state.params, "batch_stats": state.batch_stats})).items()}
            setups[name] = (port, state, jax.jit(make_train_step(task, cfg)))
        return setups[name]

    def dense(name, n):
        if (name, n) not in done:
            _, state, step = setup(name)
            after, values = step(state, {k: jnp.asarray(v)
                                         for k, v in tgnet_batch(n).items()})
            done[name, n] = ({k: float(v) for k, v in values.items()},
                             from_jax_variables(_flat({"batch_stats": after.batch_stats})))
        return done[name, n]

    return setup, dense


@pytest.mark.parametrize("d,n", JAX_CASES)
@pytest.mark.parametrize("name", TASKS)
def test_step_matches_jax_dense_step(pool, jax_reference, name, d, n):
    """One point-sharded step of the task from the flax init (its preset's
    SGD) against one JAX dense step on the whole batch: the seven losses
    and every updated BatchNorm statistic, both stages', within the JAX
    point-sharded test's tolerances; the crops the dense crops; the ranks
    bit-identical."""
    setup, dense = jax_reference
    state = setup(name)[0]
    want_vals, want_stats = dense(name, n)
    assert len(want_vals) == 7
    mp = MODEL_PARAMETERS[name]
    batch = tgnet_batch(n)
    parts = _run(pool, ranks.point_sharded_step_job, d, mp, batch, state, 0.1, name,
                 None, None, False)
    check_against_jax(parts, want_vals, want_stats, dense_crops(name, mp, state, batch))


# ------------------------------------------------------------ against the port

_PORT_RUNS: dict = {}


def port_run(pool, name: str, d: int, n: int, clouds: int):
    """The step from a jittered state at SGD lr 1e-3 on D ranks and, on rank
    0, the dense step (one run a case for the module)."""
    key = (name, d, n, clouds)
    if key not in _PORT_RUNS:
        mp = MODEL_PARAMETERS[name]
        state = _jittered_state(name, mp)
        batch = tgnet_batch(n, clouds)
        _PORT_RUNS[key] = (state, batch, _run(pool, ranks.point_sharded_step_job, d, mp,
                                              batch, state, 1e-3, name))
    return _PORT_RUNS[key]


@pytest.mark.parametrize("name,d,n,clouds", PORT_CASES)
def test_step_matches_port_dense_step(pool, name, d, n, clouds):
    """One point-sharded step from a jittered state (no unit at exactly
    zero) at SGD lr 1e-3 against the port's dense one-process step on the
    whole batch: the losses, statistics and parameters as
    ``_check_data_parallel`` holds a data-parallel step, the ranks
    bit-identical, each update within 1e-2 in L2 (as
    tests/test_torch_port_sharded_train.py holds the families), the crops
    the dense step's; at D = 3 the 16 crops of one cloud
    split 5 / 5 / 6."""
    state, _, parts = port_run(pool, name, d, n, clouds)
    _check_data_parallel(parts)
    check_updates(parts, state)
    rows = [len(p["crops"]) for p, _ in parts]
    assert sum(rows) == 16 * clouds
    if d == 3:
        assert rows == [5, 5, 6]
    np.testing.assert_array_equal(np.concatenate([p["crops"] for p, _ in parts]),
                                  parts[0][1]["crops"])


@pytest.mark.parametrize("name,d,n,clouds", [PORT_CASES[0], PORT_CASES[2]])
def test_crop_stage_statistics_count_once(pool, name, d, n, clouds):
    """Stage 2's running means and variances equal the dense step's: each
    crop counted once. The crops are sized so that this shows: 12 live
    crops of 32 points, 96 rows at stage 2's stride-4 level (the fps
    model), where the replicated design's Bessel factor over D·n rows
    moves a running variance by about 0.1 (1 - 1/D) / n of it, past the
    2e-4 tolerance (``check_crops_count_once``)."""
    state, batch, parts = port_run(pool, name, d, n, clouds)
    check_crops_count_once(name, MODEL_PARAMETERS[name], "second.", batch, state, parts, d)


# ------------------------------------------------------------ the host stage

BDL_INFO = {"num_of_bdl_points": 100, "num_of_all_points": 256}


def bdl_batches() -> list:
    """Two loader batches of two 300-point clouds (more than the 256 the
    engine keeps, so every cloud draws), jittered apart."""
    out = []
    for i in range(2):
        b = tgnet_batch(300)
        rng = np.random.default_rng(10 + i)
        b["feat"] = b["feat"] + rng.normal(0, 1e-3, b["feat"].shape).astype(np.float32)
        b["mask"][:] = True
        out.append(b)
    return out


@pytest.mark.parametrize("d", [2, 4])
def test_host_stage_helper_bdl(pool, d):
    """``host_batch_points`` with tgnet_bdl's boundary engine over two
    batches in turn: every rank's rows joined ``array_equal`` to one
    process's stage on the whole batch; the stage runs on rank 0 only, its
    generator left in the one-process state (a replay of the other ranks'
    clouds would have advanced it)."""
    from toothgroupnetwork_tpu_torch.models import tasks
    from toothgroupnetwork_tpu_torch.train.trainer import apply_host_stage

    batches = bdl_batches()
    task = get_task("tgnet_bdl")
    cfg = task.default_config()
    cfg.model_parameter["boundary_sampling_info"].update(BDL_INFO)
    engine = tasks.bdl_engine(cfg, "cpu")
    engine.rng = np.random.default_rng(0)
    engine._stage_labels = lambda _cfg, _feat, lab: lab.astype(np.float64)
    model = torch.nn.Linear(1, 1)
    want = [apply_host_stage(task, model, b, cfg, step) for step, b in enumerate(batches)]
    parts = _run(pool, ranks.host_stage_job, d, "tgnet_bdl", batches, None, BDL_INFO)
    clouds = sum(len(b["feat"]) for b in batches)
    assert [calls for _, calls, _ in parts] == [clouds] + [0] * (d - 1)
    assert parts[0][2] == engine.rng.bit_generator.state
    for i, ref in enumerate(want):
        assert ref["feat"].shape == (2, 256, 6)
        for key in ("feat", "gt_seg_label", "mask"):
            got = np.concatenate([p[0][i][key] for p in parts], axis=1)
            np.testing.assert_array_equal(got, ref[key], err_msg=key)
