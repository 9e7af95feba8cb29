"""tgnet_bdl training of the port against the JAX package's, on the CPU.

The boundary engine (train/bdl_engine.py) runs a frozen tgnet_fps model on
each scan, then host logic: crop votes, KMeans, 40-NN purity of the
original mesh, a uniform draw of the boundary and FPS of the rest. A
random-weight frozen model makes the votes and KMeans chaotic (one ulp can
move a partition), so the host logic is held to the JAX ``BdlDataEngine``
EXACTLY through a stand-in for the frozen forward: both engines' ``_frozen``
set to one numpy function (crops around the ground-truth centroids,
ground-truth FG/BG votes with seeded noise, offsets to the centroids with
seeded noise). The frozen forward itself is held to the JAX module's eval
``apply`` with labels separately (1e-4).

Synthetic cases: 900-vertex labelled meshes (``write_synthetic_case``,
``objs/<case>/`` + ``jsons/<case>/``), preprocessed to 512 points, so the
original mesh is larger than ``num_of_all_points`` and the FPS of the
non-boundary vertices runs. Tiny models: the fps model of
tests/test_torch_port_train_step.py with crops of 64, the bdl model planes
[8, 16], stride [1, 1]. The train step is held as in that file: SGD at lr
0.01, losses within 1e-4 relative, parameters and statistics rtol 1e-4 +
atol 1e-5.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthetic import write_synthetic_case
from test_torch_port_train_bf16 import jittered
from test_torch_port_train_step import _flat
import toothgroupnetwork_tpu.models.tasks as jax_tasks
from toothgroupnetwork_tpu.data.augment import build_augmenter as jax_build_augmenter
from toothgroupnetwork_tpu.models import get_task as jax_get_task
from toothgroupnetwork_tpu.train.bdl_engine import BdlDataEngine as JaxEngine
from toothgroupnetwork_tpu.train.checkpoints import save_weights as jax_save_weights
from toothgroupnetwork_tpu.train.train_state import TrainState
from toothgroupnetwork_tpu.train.train_state import make_optimizer as jax_make_optimizer
from toothgroupnetwork_tpu.train.trainer import make_train_step
import toothgroupnetwork_tpu_torch.data.preprocess as preprocess
import toothgroupnetwork_tpu_torch.models.tasks as tasks
from toothgroupnetwork_tpu_torch.cli import train as cli_train
from toothgroupnetwork_tpu_torch.data.augment import build_augmenter
from toothgroupnetwork_tpu_torch.data.dataset import DentalScanDataset, collate_batch
from toothgroupnetwork_tpu_torch.models import get_task
from toothgroupnetwork_tpu_torch.models.point_transformer.backbone import (
    PointTransformerLayer)
from toothgroupnetwork_tpu_torch.train import Trainer, make_optimizer, train_step
from toothgroupnetwork_tpu_torch.train.bdl_engine import BdlDataEngine
from toothgroupnetwork_tpu_torch.train.checkpoints import save_weights
from toothgroupnetwork_tpu_torch.utils.weights import from_jax_variables, init_like_flax_

N_POINTS = 512
CROP = 64
FPS_PARAMS = {"planes": [8, 16], "stride": [1, 4], "nsample": [8, 8],
              "blocks": [2, 2], "block_num": 2, "crop_sample_size": CROP}
BDL_PARAMS = {"planes": [8, 16], "stride": [1, 1], "nsample": [8, 8],
              "blocks": [2, 2], "block_num": 2, "crop_sample_size": CROP,
              "n_points": N_POINTS}
CASES = (("CASE01", "lower", 0), ("CASE02", "upper", 1), ("CASE03", "lower", 2))
SPECS = [("scaling", [0.85, 1.15]), ("rotation", [-30, 30], "fixed"),
         ("translation", [-0.2, 0.2])]
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Three labelled 900-vertex cases, preprocessed by the port to 512
    points (the module constant set for the call, as the tests of the
    preprocessing set it in both packages)."""
    root = tmp_path_factory.mktemp("bdl")
    for case, jaw, seed in CASES:
        write_synthetic_case(str(root), case, jaw, n_side=30, seed=seed)
    saved = preprocess.N_POINTS
    preprocess.N_POINTS = N_POINTS
    try:
        preprocess.preprocess_dir(str(root / "objs"), str(root / "jsons"),
                                  str(root / "processed"), verbose=False, device="cpu")
    finally:
        preprocess.N_POINTS = saved
    return root


def standin(feat, labels):
    """The frozen forward's four outputs from the ground truth, numpy:
    crops of the CROP points nearest each tooth's centroid (stable order),
    FG/BG votes of +-1 with seeded noise, offsets to the centroid with
    seeded noise. The same arrays for the same input."""
    xyz, lab = feat[0, :, :3], labels[0]
    rng = np.random.default_rng(5)
    cents = np.full((16, 3), 1e3, np.float32)
    valid = np.zeros(16, bool)
    for c in range(16):
        if (lab == c).any():
            cents[c], valid[c] = xyz[lab == c].mean(axis=0), True
    d2 = ((cents[:, None] - xyz[None]) ** 2).sum(-1)
    idx = np.argsort(d2, axis=1, kind="stable")[:, :CROP].astype(np.int32)
    fg = lab[idx] >= 0
    sem = (np.stack([~fg, fg], -1) * 2.0 - 1 + rng.normal(0, 0.3, (16, CROP, 2))
           ).astype(np.float32)
    off = np.where((lab >= 0)[:, None], cents[np.clip(lab, 0, 15)] - xyz, 0)
    off = (off + rng.normal(0, 2e-3, off.shape)).astype(np.float32)
    return sem, idx[None], valid[None], off[None]


def _configs(root, original=True, cache=None, ckpt=None):
    """The JAX and port tgnet_bdl configs: tiny bdl model, 300 of 512
    boundary points, the obj/json roots (or none), a cache dir (or none)."""
    out = []
    for task in (jax_get_task("tgnet_bdl"), get_task("tgnet_bdl")):
        cfg = task.default_config()
        cfg.model_parameter.update(BDL_PARAMS)
        cfg.model_parameter["boundary_sampling_info"].update(
            num_of_bdl_points=300, num_of_all_points=N_POINTS,
            orginal_data_obj_path=str(root / "objs") if original else None,
            orginal_data_json_path=str(root / "jsons") if original else None,
            bdl_cache_path=None if cache is None else str(cache))
        cfg.model_parameter["fps_model_info"] = {"model_parameter": dict(FPS_PARAMS),
                                                 "load_ckpt_path": ckpt}
        cfg.optimizer.lr = 1e-2
        out.append(cfg)
    return out


def _batches(root, specs=None, seed=0):
    """One batch per processed case (the port's dataset, bit-equal to the
    JAX one), with an augmenter of each package drawn from the same seed."""
    out = []
    for build in (jax_build_augmenter, build_augmenter):
        ds = DentalScanDataset(str(root / "processed"), augmenter=build(specs),
                               seed=seed)
        out.append([collate_batch([ds[i]]) for i in range(len(ds))])
    return out


def _counted(fn):
    def wrapped(*args):
        wrapped.calls += 1
        return fn(*args)
    wrapped.calls = 0
    return wrapped


@pytest.mark.parametrize("original,specs", [(False, None), (True, None), (True, SPECS)],
                         ids=["fallback", "original", "original-augmented"])
def test_engine_matches_jax(data, tmp_path, original, specs):
    """Each case's resampled cloud, labels and mask ``array_equal`` to the
    JAX engine's; the cache files equal; a second epoch hits the cache
    (the frozen forward not called) and re-augments the cached cloud as
    JAX does."""
    jcfg, pcfg = _configs(data, original, cache=tmp_path / "cache")
    jcache = tmp_path / "jax_cache"
    jcfg.model_parameter["boundary_sampling_info"]["bdl_cache_path"] = str(jcache)
    jax_engine, engine = JaxEngine(), BdlDataEngine("cpu")
    jax_engine._frozen = _counted(standin)
    engine._frozen = _counted(standin)
    for epoch in (0, 1):
        jax_batches, batches = _batches(data, specs, seed=epoch)
        for jb, pb in zip(jax_batches, batches):
            want = jax_engine(None, jb, jcfg)
            got = engine(None, pb, pcfg)
            assert set(got) == set(want)
            for key in want:
                assert got[key].dtype == want[key].dtype, key
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert engine._frozen.calls == jax_engine._frozen.calls == len(CASES)
    names = sorted(os.listdir(jcache))
    assert names == [f"{c}_{j}.npy" for c, j, _ in CASES]
    assert sorted(os.listdir(tmp_path / "cache")) == names
    for name in names:
        np.testing.assert_array_equal(np.load(tmp_path / "cache" / name),
                                      np.load(jcache / name))
    # the original meshes (900 vertices) are larger than the sample, so the
    # FPS of the non-boundary vertices ran; the fallback needs no FPS here
    assert ("fps" in engine.seconds) == original
    assert ("load_original" in engine.seconds) == original


def test_frozen_forward_matches_jax(data, tmp_path):
    """The frozen fps model, from a JAX-saved .npz, in eval mode with the
    labels, on the three cases: crop validity and crop indices equal, the
    live crops' votes and the offsets within 1e-4 of the JAX module's
    ``apply(..., train=False, labels=...)``.

    The preprocessed clouds are FPS samples of a grid, so two points of a
    crop can lie at exactly the same distance from its centroid; each
    package's float32 distance then decides their order, and the crop's
    first point seeds its FPS. Such a crop may hold its points in another
    order: only where the two points of every differing slot are at one
    float64 distance from the centroid, and its votes are then not
    compared."""
    ckpt = _jax_fps_npz(tmp_path)
    jcfg, pcfg = _configs(data, ckpt=ckpt)
    jax_forward = JaxEngine()._ensure_frozen(jcfg)
    forward = BdlDataEngine("cpu")._ensure_frozen(pcfg)
    ds = DentalScanDataset(str(data / "processed"))
    compared = 0
    for i in range(len(ds)):
        feat, labels = ds[i]["feat"][None], ds[i]["gt_seg_label"][None]
        want = [np.asarray(a) for a in jax_forward(jnp.asarray(feat),
                                                   jnp.asarray(labels))]
        sem, idx, valid, off = forward(feat, labels)
        np.testing.assert_array_equal(valid, want[2])
        np.testing.assert_allclose(off, want[3], atol=1e-4, rtol=1e-4)
        live = want[2][0].copy()
        xyz = feat[0, :, :3].astype(np.float64)
        for k in np.flatnonzero((idx != want[1]).any(axis=-1)[0]):
            cent = xyz[labels[0] == k].mean(axis=0)
            slots = np.flatnonzero(idx[0, k] != want[1][0, k])
            d_got = ((xyz[idx[0, k, slots]] - cent) ** 2).sum(-1)
            d_want = ((xyz[want[1][0, k, slots]] - cent) ** 2).sum(-1)
            np.testing.assert_array_equal(np.sort(d_got), np.sort(d_want))
            assert sorted(idx[0, k]) == sorted(want[1][0, k])
            live[k] = False
        np.testing.assert_allclose(sem[live], want[0][live], atol=1e-4, rtol=1e-4)
        compared += int(live.sum())
    assert compared >= 3 * 12


def _jax_fps_npz(tmp_path) -> str:
    """A tiny JAX fps model's variables, BatchNorm state jittered and the
    crop classifier's background bias lowered, written by the JAX package's
    ``save_weights``."""
    task = jax_get_task("tgnet_fps")
    cfg = task.default_config()
    cfg.model_parameter.update(FPS_PARAMS)
    module = task.build_module(cfg)
    vs = jax.jit(module.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), jnp.zeros((1, N_POINTS, 6)), None, train=False,
        labels=jnp.zeros((1, N_POINTS), jnp.int32))
    vs = jittered(vs, np.random.default_rng(3))
    # random crop logits call every point background; this shift lets the
    # engine find foreground and cluster it
    bias = vs["params"]["second"]["cls_head"]["cls"]["bias"]
    vs["params"]["second"]["cls_head"]["cls"]["bias"] = bias.at[0].add(-3.0)
    path = str(tmp_path / "jax_fps.npz")
    jax_save_weights(path, vs)
    return path


def test_jax_saved_npz_drives_the_engine(data, tmp_path):
    """The port's engine on a JAX-saved fps .npz, end to end (frozen model,
    KMeans, purity, FPS) over two cases: the resampled cloud keeps the
    original mesh's rows and labels, and the frozen model folds its
    attention parameters once (the second uncached case refolds none)."""
    ckpt = _jax_fps_npz(tmp_path)
    _, pcfg = _configs(data, ckpt=ckpt)
    engine = BdlDataEngine("cpu")
    batches = _batches(data)[1]
    out = engine(None, batches[0], pcfg)
    layers = [m for m in engine.frozen_model.modules()
              if isinstance(m, PointTransformerLayer)]
    folds = [m._folded for m in layers]
    assert layers and all(f is not None for f in folds)
    out2 = engine(None, batches[1], pcfg)
    assert all(m._folded is f for m, f in zip(layers, folds))
    for o, b in ((out, batches[0]), (out2, batches[1])):
        assert o["feat"].shape == (1, N_POINTS, 6) and o["mask"].all()
        assert np.isfinite(o["feat"]).all()
        case = os.path.basename(b["mesh_path"][0]).split("_")
        org, org_labels = engine._load_original("_".join(case[:2]))
        rows = {tuple(r): int(lab) for r, lab in zip(org, org_labels)}
        assert all(rows[tuple(r)] == lab
                   for r, lab in zip(o["feat"][0], o["gt_seg_label"][0]))
    assert {"frozen_forward", "kmeans", "knn40", "fps"} <= set(engine.seconds)


def test_preset_and_engine_key_match_jax():
    """The tgnet_bdl preset and the engine key equal the JAX package's; the
    engines are kept by config (the analog of the JAX
    ``TestBdlEngineCache``) and device."""
    jcfg, pcfg = jax_get_task("tgnet_bdl").default_config(), get_task("tgnet_bdl").default_config()
    assert pcfg.to_dict() == jcfg.to_dict()
    assert tasks._bdl_engine_key(pcfg) == jax_tasks._bdl_engine_key(jcfg)
    other = get_task("tgnet_bdl").default_config()
    other.model_parameter["fps_model_info"]["load_ckpt_path"] = "/elsewhere.npz"
    cached = get_task("tgnet_bdl").default_config()
    cached.model_parameter["boundary_sampling_info"]["bdl_cache_path"] = "/tmp/x"
    assert len({tasks._bdl_engine_key(c) for c in (pcfg, other, cached)}) == 3
    saved = dict(tasks._BDL_ENGINES)
    try:
        engine = tasks.bdl_engine(pcfg, "cpu")
        assert tasks.bdl_engine(get_task("tgnet_bdl").default_config(), "cpu") is engine
        assert tasks.bdl_engine(other, "cpu") is not engine
        assert tasks.bdl_engine(cached, "cpu") is not engine
        assert engine.device == torch.device("cpu")
    finally:
        tasks._BDL_ENGINES.clear()
        tasks._BDL_ENGINES.update(saved)


@pytest.fixture
def stand_in_engines(data):
    """The tasks' engine caches of both packages for the tiny config, each
    engine's frozen forward the stand-in; restored afterwards."""
    jcfg, pcfg = _configs(data)
    saved = dict(jax_tasks._BDL_ENGINES), dict(tasks._BDL_ENGINES)
    jax_engine = JaxEngine()
    jax_engine._frozen = standin
    jax_tasks._BDL_ENGINES[jax_tasks._bdl_engine_key(jcfg)] = jax_engine
    tasks.bdl_engine(pcfg, "cpu")._frozen = standin
    yield jcfg, pcfg
    for cache, old in zip((jax_tasks._BDL_ENGINES, tasks._BDL_ENGINES), saved):
        cache.clear()
        cache.update(old)


def test_host_stage_and_train_step_match_jax(data, stand_in_engines):
    """The task's host stage through the Trainer's ``host_batch`` equal to
    JAX's on the loader's batch, then one SGD step of the bdl model from the
    same jittered variables: the seven losses within 1e-4 relative, every
    parameter and statistic within rtol 1e-4 + atol 1e-5."""
    jcfg, pcfg = stand_in_engines
    jtask, ptask = jax_get_task("tgnet_bdl"), get_task("tgnet_bdl")
    jb, pb = (b[0] for b in _batches(data))

    module = jtask.build_module(jcfg)
    arrays = {k: v for k, v in jb.items() if isinstance(v, np.ndarray)}
    vs = jax.jit(module.init, static_argnames=("train",))(
        jax.random.PRNGKey(1), jnp.asarray(arrays["feat"]), jnp.asarray(arrays["mask"]),
        train=False, labels=jnp.asarray(arrays["gt_seg_label"]))
    vs = jittered(vs, np.random.default_rng(1))
    tx = jax_make_optimizer(jcfg.optimizer)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=vs["params"],
                       batch_stats=vs["batch_stats"], opt_state=tx.init(vs["params"]),
                       apply_fn=module.apply, tx=tx)
    db = {**arrays, **jtask.host_stage(state, {**jb, **arrays}, jcfg)}

    trainer = Trainer(pcfg, ptask, [], [], log_fn=lambda s: None, device="cpu")
    model = trainer.model
    model.load_state_dict(from_jax_variables(_flat(vs)))
    pbatch = trainer.host_batch(pb)
    for key in ("feat", "gt_seg_label", "mask"):
        np.testing.assert_array_equal(pbatch[key], db[key], err_msg=key)
    assert pbatch["feat"].shape == (1, N_POINTS, 6)

    state, jvals = jax.jit(make_train_step(jtask, jcfg))(
        state, {k: jnp.asarray(v) for k, v in db.items()})
    opt = make_optimizer(pcfg.optimizer, model.parameters())
    pvals = train_step(model, opt, ptask, pcfg,
                       {k: torch.from_numpy(pbatch[k])
                        for k in ("feat", "gt_seg_label", "mask")})
    assert set(pvals) == set(jvals) and len(pvals) == 7
    for key, val in jvals.items():
        assert float(pvals[key]) == pytest.approx(float(val), rel=1e-4), key
    want = from_jax_variables(_flat({"params": state.params,
                                     "batch_stats": state.batch_stats}))
    for name, val in [*model.named_parameters(), *model.named_buffers()]:
        np.testing.assert_allclose(val.detach().numpy(), want[name].numpy(),
                                   err_msg=name, **TOL)


def test_cli_train_bdl_one_epoch(data, tmp_path, capsys):
    """``cli.train --model_name tgnet_bdl --device cpu`` with a config the
    JAX package wrote: the frozen model from a port-saved fps .npz, the
    obj/json roots and a cache dir. One epoch (two train cases, one val);
    every case resampled into the cache; the second epoch runs on cache hits
    only (the frozen forward not called again)."""
    fps_task = get_task("tgnet_fps")
    fps_cfg = fps_task.default_config()
    fps_cfg.model_parameter.update(FPS_PARAMS)
    fps_model = fps_task.build_module(fps_cfg, device="cpu")
    init_like_flax_(fps_model, torch.Generator().manual_seed(0))
    ckpt = str(tmp_path / "fps.npz")
    save_weights(ckpt, fps_model)
    jcfg, _ = _configs(data, cache=tmp_path / "cache", ckpt=ckpt)
    jcfg.save_json(str(tmp_path / "bdl.json"))
    (tmp_path / "train.txt").write_text("CASE01\nCASE02\n")
    (tmp_path / "val.txt").write_text("CASE03\n")
    argv = ["--model_name", "tgnet_bdl", "--config_path", str(tmp_path / "bdl.json"),
            "--input_data_dir_path", str(data / "processed"),
            "--train_data_split_txt_path", str(tmp_path / "train.txt"),
            "--val_data_split_txt_path", str(tmp_path / "val.txt"),
            "--checkpoint_path", str(tmp_path / "ck" / "bdl"), "--max_epochs", "1",
            "--device", "cpu"]
    saved = dict(tasks._BDL_ENGINES)
    try:
        trainer = cli_train.main(argv)
        assert trainer.epoch == 1 and trainer.step == 2
        assert np.isfinite(trainer.best_val)
        assert sorted(os.listdir(tmp_path / "cache")) == [
            f"{c}_{j}.npy" for c, j, _ in CASES]
        engine = tasks.bdl_engine(trainer.config, "cpu")
        engine._frozen = _counted(engine._frozen)
        stats = trainer.train_epoch()
        assert engine._frozen.calls == 0
        assert all(np.isfinite(v) for v in stats.values())
    finally:
        tasks._BDL_ENGINES.clear()
        tasks._BDL_ENGINES.update(saved)
    assert "train scans: 2, val scans: 1" in capsys.readouterr().out
