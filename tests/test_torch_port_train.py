"""The port's training modules against the JAX package's, on the CPU.

Train-mode BatchNorm, the tgnet losses (values and gradients: ``jax.grad``
against autograd), the schedules, the config file, the host data layer and
the flax-like initialisation are held to the JAX package on the same
numpy-seeded inputs; the tolerance of each test is stated in it. The
``Trainer``, its checkpoints and ``cli.train`` run end to end at a tiny
size, and a port-trained ``.npz`` is served by the JAX package. The train
step itself against the JAX ``make_train_step`` is
tests/test_torch_port_train_step.py.
"""

import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from synthetic import make_synthetic_jaw_points, write_processed_npy  # noqa: E402

from toothgroupnetwork_tpu.data import augment as jax_augment
from toothgroupnetwork_tpu.data import dataset as jax_dataset
from toothgroupnetwork_tpu.losses import cbl_loss as jax_cbl
from toothgroupnetwork_tpu.losses import seg_loss as jax_seg
from toothgroupnetwork_tpu.losses import tgn_loss as jax_tgn
from toothgroupnetwork_tpu.models.tgnet import TGNet as JaxTGNet
from toothgroupnetwork_tpu.nn.layers import MaskedBatchNorm as JaxBN
from toothgroupnetwork_tpu.ops import knn_points as jax_knn_points
from toothgroupnetwork_tpu.train import config as jax_config
from toothgroupnetwork_tpu.train import schedule as jax_schedule
from toothgroupnetwork_tpu.train.checkpoints import load_weights as jax_load_weights
from toothgroupnetwork_tpu_torch.cli import train as cli_train
from toothgroupnetwork_tpu_torch.data import augment, dataset
from toothgroupnetwork_tpu_torch.losses import (batch_center_offset_loss,
                                                batch_chamfer_distance_loss,
                                                cbl_loss_per_stage,
                                                feature_transform_regularizer,
                                                tooth_class_loss)
from toothgroupnetwork_tpu_torch.models import TGNet, get_task
from toothgroupnetwork_tpu_torch.nn.layers import MaskedBatchNorm
from toothgroupnetwork_tpu_torch.train import Trainer, config, schedule, train_step
from toothgroupnetwork_tpu_torch.train.train_state import make_optimizer
from toothgroupnetwork_tpu_torch.utils.weights import (from_jax_variables,
                                                       init_like_flax_, load_npz)

ARCH = {"planes": [8, 16], "stride": [1, 4], "nsample": [8, 8], "blocks": [2, 2],
        "block_num": 2, "crop_sample_size": 32}
# float32 values and gradients computed in other orders
TOL = dict(rtol=1e-5, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_grad(fn, *args):
    """(value, gradient w.r.t. the first argument) of a JAX loss."""
    val, grad = jax.value_and_grad(fn)(*[jnp.asarray(a) for a in args])
    return float(val), np.asarray(grad)


def _torch_grad(fn, first, *rest):
    x = _t(first).clone().requires_grad_(True)
    val = fn(x, *[_t(a) if isinstance(a, np.ndarray) else a for a in rest])
    val.backward()
    return float(val.detach()), x.grad.numpy()


# ---------------------------------------------------------------- BatchNorm

class TestTrainBatchNorm:
    """Train-mode MaskedBatchNorm against the JAX module: outputs and the
    running statistics after one update (1e-5 relative)."""

    def _both(self, rng, x, mask):
        c = x.shape[-1]
        jbn = JaxBN()
        vs = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x), None, True)
        vs = {"params": {"scale": jnp.asarray(1 + 0.1 * rng.standard_normal(c), jnp.float32),
                         "bias": jnp.asarray(0.1 * rng.standard_normal(c), jnp.float32)},
              "batch_stats": {"mean": jnp.asarray(0.1 * rng.standard_normal(c), jnp.float32),
                              "var": jnp.asarray(rng.uniform(0.5, 1.5, c), jnp.float32)}}
        jm = None if mask is None else jnp.asarray(mask)
        y, mutated = jbn.apply(vs, jnp.asarray(x), jm, True, mutable=["batch_stats"])
        bn = MaskedBatchNorm(c, device="cpu")
        bn.load_state_dict(from_jax_variables({
            "params/scale": vs["params"]["scale"], "params/bias": vs["params"]["bias"],
            "batch_stats/mean": vs["batch_stats"]["mean"],
            "batch_stats/var": vs["batch_stats"]["var"]}))
        got = bn.train()(_t(x), None if mask is None else _t(mask))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(y), **TOL)
        for key in ("mean", "var"):
            np.testing.assert_allclose(getattr(bn, key).numpy(),
                                       np.asarray(mutated["batch_stats"][key]),
                                       err_msg=key, **TOL)
        return bn, got

    def test_unmasked(self, rng):
        self._both(rng, rng.standard_normal((2, 50, 8)).astype(np.float32), None)

    def test_masked_excludes_padding(self, rng):
        x = rng.standard_normal((2, 40, 4)).astype(np.float32)
        x[:, 30:] = 100.0
        mask = np.zeros((2, 40), bool)
        mask[:, :30] = True
        _, y = self._both(rng, x, mask)
        assert np.isfinite(y.detach().numpy()).all()

    def test_flattened_neighbourhood_mask(self, rng):
        """[B, N, K] rows under a [B, N] query mask broadcast over K."""
        x = rng.standard_normal((1, 12, 5, 8)).astype(np.float32)
        mask = np.broadcast_to(rng.random((1, 12, 1)) > 0.3, (1, 12, 5)).copy()
        self._both(rng, x, mask)

    def test_empty_mask_keeps_running_stats(self, rng):
        x = rng.standard_normal((4, 8, 4)).astype(np.float32) * 100
        bn, y = self._both(rng, x, np.zeros((4, 8), bool))
        assert np.isfinite(y.detach().numpy()).all()

    def test_eval_reads_running_stats(self, rng):
        bn = MaskedBatchNorm(4, device="cpu").eval()
        x = _t(rng.standard_normal((1, 20, 4)).astype(np.float32))
        np.testing.assert_allclose(bn(x * 5, torch.zeros(1, 20, dtype=torch.bool)).detach().numpy(),
                                   (x * 5 / np.sqrt(1 + 1e-5)).numpy(), rtol=1e-6)
        assert torch.equal(bn.mean, torch.zeros(4)) and torch.equal(bn.var, torch.ones(4))


# ---------------------------------------------------------------- losses

def _labels_by_region(rng, xyz, n_regions, lo=-1):
    """Spatially coherent labels: the nearest of ``n_regions`` random centres."""
    centres = xyz[0, rng.choice(xyz.shape[1], n_regions, replace=False)]
    near = np.argmin(((xyz[0, :, None] - centres[None]) ** 2).sum(-1), axis=1)
    return (near + lo).astype(np.int32)[None]


class TestLosses:
    """Values and gradients w.r.t. the predictions: 1e-5 relative."""

    @pytest.mark.parametrize("smoothing,weighted,masked", [
        (None, False, False), (None, False, True), (None, True, True),
        (0.1, False, True), (0.1, False, False)])
    def test_tooth_class_loss(self, rng, smoothing, weighted, masked):
        logits = rng.standard_normal((2, 30, 10)).astype(np.float32) * 2
        labels = rng.integers(-1, 9, (2, 30)).astype(np.int32)
        mask = rng.random((2, 30)) > 0.3 if masked else None
        weight = rng.uniform(0.1, 2.0, 10).astype(np.float32) if weighted else None
        want = _jax_grad(lambda lg: jax_seg.tooth_class_loss(
            lg, jnp.asarray(labels), 10, None if mask is None else jnp.asarray(mask),
            None if weight is None else jnp.asarray(weight), smoothing), logits)
        got = _torch_grad(lambda lg: tooth_class_loss(
            lg, _t(labels), 10, None if mask is None else _t(mask),
            None if weight is None else _t(weight), smoothing), logits)
        assert got[0] == pytest.approx(want[0], rel=1e-5)
        np.testing.assert_allclose(got[1], want[1], **TOL)

    def test_feature_transform_regularizer(self, rng):
        trans = rng.standard_normal((3, 8, 8)).astype(np.float32) * 0.3
        want = _jax_grad(jax_seg.feature_transform_regularizer, trans)
        got = _torch_grad(feature_transform_regularizer, trans)
        assert got[0] == pytest.approx(want[0], rel=1e-5)
        np.testing.assert_allclose(got[1], want[1], rtol=1e-4, atol=1e-6)

    def _offsets(self, rng):
        pts, _, cls = make_synthetic_jaw_points(300, 6, seed=2)
        xyz = pts[None].astype(np.float32)
        labels = (cls - 1)[None].astype(np.int32)
        labels[0, :3] = 9      # a tooth of 3 points: no centroid term
        off = (rng.standard_normal(xyz.shape) * 0.05).astype(np.float32)
        off[0, 10:14] = 1e-5   # below the 2e-4 moving threshold
        mask = np.ones((1, 300), bool)
        mask[0, 290:] = False
        return off, xyz, labels, mask

    @pytest.mark.parametrize("term", [0, 1])
    def test_center_offset_loss(self, rng, term):
        off, xyz, labels, mask = self._offsets(rng)
        want = _jax_grad(lambda o: jax_tgn.batch_center_offset_loss(
            o, jnp.asarray(xyz), jnp.asarray(labels), jnp.asarray(mask))[term], off)
        got = _torch_grad(lambda o: batch_center_offset_loss(
            o, _t(xyz), _t(labels), _t(mask))[term], off)
        assert got[0] == pytest.approx(want[0], rel=1e-5)
        np.testing.assert_allclose(got[1], want[1], rtol=1e-4, atol=1e-6)

    def test_chamfer_loss(self, rng):
        off, xyz, labels, mask = self._offsets(rng)
        want = _jax_grad(lambda o: jax_tgn.batch_chamfer_distance_loss(
            o, jnp.asarray(xyz), jnp.asarray(labels), jnp.asarray(mask)), off)
        got = _torch_grad(lambda o: batch_chamfer_distance_loss(
            o, _t(xyz), _t(labels), _t(mask)), off)
        assert got[0] == pytest.approx(want[0], rel=1e-5)
        np.testing.assert_allclose(got[1], want[1], rtol=1e-4, atol=1e-6)

    # (stride, points a stage): (1, 4, 4) takes the kNN kernel's twin for
    # the sub-scene labels (kr 1 and 4); (70, 1) its any-size kernel's
    # past k = 64 (kr 70)
    @pytest.mark.parametrize("stride,sizes", [((1, 4, 4), (128, 32, 8)),
                                              ((70, 1), (128, 16))])
    def test_cbl_per_stage(self, rng, stride, sizes):
        p0 = rng.uniform(-1, 1, (1, sizes[0], 3)).astype(np.float32)
        target = _labels_by_region(rng, p0, 6)
        stages, latents = [], []
        for i, n in enumerate(sizes):
            p = p0[:, :n] if i == 0 else p0[:, rng.choice(sizes[0], n, replace=False)]
            mask = np.ones((1, n), bool)
            mask[0, -max(1, n // 8):] = False
            idx, _ = jax_knn_points(jnp.asarray(p), jnp.asarray(p), min(8, n),
                                    jnp.asarray(mask), jnp.asarray(mask),
                                    include_self=True, need_dist=False)
            stages.append({"p": p, "mask": mask, "knn_idx": np.asarray(idx)})
            latents.append(rng.standard_normal((1, n, 8)).astype(np.float32))

        def jax_losses(lats):
            st = [{**{k: jnp.asarray(v) for k, v in s.items()}, "latent": lat}
                  for s, lat in zip(stages, lats)]
            return jax_cbl.cbl_loss_per_stage(st, jnp.asarray(target), 7, stride)

        jl = [jnp.asarray(lat) for lat in latents]
        want = [float(v) for v in jax.jit(jax_losses)(jl)]
        want_g = jax.jit(jax.grad(lambda lats: sum(jax_losses(lats))))(jl)
        lats = [_t(lat).requires_grad_(True) for lat in latents]
        got = cbl_loss_per_stage([{**{k: _t(v) for k, v in s.items()}, "latent": lat}
                                  for s, lat in zip(stages, lats)], _t(target), 7, stride)
        assert all(w > 0 for w in want)
        np.testing.assert_allclose([float(g.detach()) for g in got], want, rtol=1e-5)
        sum(got).backward()
        for lat, g in zip(lats, want_g):
            np.testing.assert_allclose(lat.grad.numpy(), np.asarray(g), **TOL)


# ---------------------------------------------------------------- schedules

@pytest.mark.parametrize("sched,extra", [
    ("cosine", {}), ("cosine", {"warmup_epochs": 3}), ("exp", {}), ("constant", {}),
    ("step", {"full_steps": 7}), ("tanh", {}), ("tanh", {"warmup_epochs": 2}),
    ("poly", {"step_decay": 2.0}), ("poly", {"warmup_epochs": 4}),
    ("multistep", {"milestones": (5, 12, 30)})])
def test_schedule_matches_jax(sched, extra):
    """Every variant of make_epoch_lr_fn equal to the JAX lr_fn over 50 epochs."""
    kw = {"sched": sched, "full_steps": 20, "min_lr": 1e-4, **extra}
    want = jax_schedule.make_epoch_lr_fn(jax_config.OptimizerConfig(lr=0.1),
                                         jax_config.SchedulerConfig(**kw))
    got = schedule.make_epoch_lr_fn(config.OptimizerConfig(lr=0.1),
                                    config.SchedulerConfig(**kw))
    assert [got(e) for e in range(50)] == [want(e) for e in range(50)]


def test_plateau_matches_jax():
    kw = dict(sched="plateau", plateau_patience=2, plateau_factor=0.5, min_lr=1e-3)
    want = jax_schedule.make_epoch_lr_fn(jax_config.OptimizerConfig(lr=0.1),
                                         jax_config.SchedulerConfig(**kw))
    got = schedule.make_epoch_lr_fn(config.OptimizerConfig(lr=0.1),
                                    config.SchedulerConfig(**kw))
    metrics = [1.0, 0.9, 0.95, 0.95, 0.97, 0.5, 0.6, None, 0.6, 0.7, 0.8, 0.9] * 3
    assert ([got(e, metric=m) for e, m in enumerate(metrics)]
            == [want(e, metric=m) for e, m in enumerate(metrics)])


# ---------------------------------------------------------------- config

def test_config_json_from_the_jax_package(tmp_path):
    """A TrainConfig the JAX package saves loads in the port, equal field by
    field, and the port writes it back unchanged."""
    from toothgroupnetwork_tpu.models import get_task as jax_get_task

    cfg = jax_get_task("tgnet_fps").default_config()
    cfg.scheduler.milestones = (3, 9)
    cfg.generator.train_batch_size = 2
    cfg.model_parameter.update(ARCH)
    cfg.save_json(str(tmp_path / "jax.json"))
    mine = config.TrainConfig.load_json(str(tmp_path / "jax.json"))
    jd = json.loads((tmp_path / "jax.json").read_text())
    mine.save_json(str(tmp_path / "port.json"))
    assert json.loads((tmp_path / "port.json").read_text()) == jd
    assert mine.optimizer.name == "sgd" and mine.generator.train_batch_size == 2
    assert mine.to_dict() == config.TrainConfig.from_dict(jd).to_dict()
    assert get_task("tgnet_fps").default_config().to_dict() == \
        jax_get_task("tgnet_fps").default_config().to_dict()


# ---------------------------------------------------------------- data

def _processed(tmp_path, n=5, n_points=200, n_file_points=None):
    d = str(tmp_path / "proc")
    for i in range(n):
        write_processed_npy(d, f"C{i:02d}", ("lower", "upper")[i % 2], n_points=n_points,
                            n_teeth=4 + i % 3, seed=i, n_file_points=n_file_points)
    return d


def _equal_batches(a, b):
    assert a.keys() == b.keys()
    for key in a:
        if isinstance(a[key], np.ndarray):
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        elif key == "mesh_path":
            assert a[key] == b[key]


@pytest.mark.parametrize("specs", [
    None,
    [("scaling", [0.85, 1.15]), ("rotation", [-30, 30], "fixed"),
     ("translation", [-0.2, 0.2])],
    [("rotation", [-180, 180], "rand"), ("rotation", [-10, 10], "pca")]])
def test_dataset_and_loader_bit_equal(tmp_path, specs):
    """Items (features, labels, masks after augmentation), the shuffled
    train order over two epochs and the padded val batches are bit-equal."""
    d = _processed(tmp_path, n_file_points=216)
    split = tmp_path / "split.txt"
    split.write_text("C00\nC02\nC03\nC04\n")
    mine = dataset.DentalScanDataset(d, str(split), augment.build_augmenter(specs), seed=3)
    want = jax_dataset.DentalScanDataset(d, str(split),
                                         jax_augment.build_augmenter(specs), seed=3)
    assert mine.mesh_paths == want.mesh_paths and len(mine) == 4
    train = (dataset.BatchLoader(mine, 2, shuffle=True, seed=5),
             jax_dataset.BatchLoader(want, 2, shuffle=True, seed=5))
    for _ in range(2):
        for a, b in zip(*train):
            _equal_batches(a, b)
    val = (dataset.BatchLoader(dataset.DentalScanDataset(d), 3, shuffle=False),
           jax_dataset.BatchLoader(jax_dataset.DentalScanDataset(d), 3, shuffle=False))
    got = list(val[0])
    assert len(got) == 2 and got[1]["batch_valid"].tolist() == [True, True, False]
    for a, b in zip(got, val[1]):
        _equal_batches(a, b)


# ---------------------------------------------------------------- init

def test_init_like_flax():
    """Dense kernels from lecun_normal: flax's bound (2 / 0.8796 / sqrt(fan_in))
    and standard deviation (1 / sqrt(fan_in), within 5 % over 2^16 draws),
    biases 0, BatchNorm (1, 0, 0, 1); the same generator seed gives the same
    weights."""
    import flax.linen as fnn

    model = TGNet(crop_size=32, c=6, device="cpu", **{
        k: v for k, v in ARCH.items() if k != "crop_sample_size"})
    init_like_flax_(model, torch.Generator().manual_seed(0))
    dense = fnn.Dense(256).init(jax.random.PRNGKey(0), jnp.zeros((1, 256)))
    ref = np.asarray(dense["params"]["kernel"])
    layer = torch.nn.Linear(256, 256)
    init_like_flax_(layer, torch.Generator().manual_seed(1))
    w = layer.weight.detach().numpy()
    assert abs(w.std() / ref.std() - 1) < 0.05 and abs(w.std() * 16 - 1) < 0.05
    assert np.abs(w).max() <= 2 / 0.87962566103423978 / 16 * (1 + 1e-6)
    assert abs(np.abs(w).max() / np.abs(ref).max() - 1) < 0.01
    for name, t in model.state_dict().items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("bias", "mean"):
            assert not t.any(), name
        elif leaf in ("scale", "var"):
            assert torch.equal(t, torch.ones_like(t)), name
    again = TGNet(crop_size=32, c=6, device="cpu", **{
        k: v for k, v in ARCH.items() if k != "crop_sample_size"})
    init_like_flax_(again, torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 again.state_dict().values()))


# ---------------------------------------------------------------- trainer

def _tiny_cfg(tmp_path, **over):
    cfg = get_task("tgnet_fps").default_config()
    cfg.model_parameter.update(ARCH)
    cfg.checkpoint_path = str(tmp_path / "ckpt" / "fps")
    for k, v in over.items():
        setattr(cfg, k, v)
    return cfg


def _loaders(tmp_path, n_train=4, n_val=2):
    d = _processed(tmp_path, n=n_train + n_val, n_points=256)
    paths = dataset.DentalScanDataset(d).mesh_paths
    train_ds, val_ds = dataset.DentalScanDataset(d), dataset.DentalScanDataset(d)
    train_ds.mesh_paths, val_ds.mesh_paths = paths[:n_train], paths[n_train:]
    return (dataset.BatchLoader(train_ds, 2, shuffle=True, seed=0),
            dataset.BatchLoader(val_ds, 2, shuffle=False))


def _params(model):
    return {k: v.clone() for k, v in model.state_dict().items()}


class TestTrainer:
    def test_loss_falls_checkpoints_and_resume(self, tmp_path):
        cfg = _tiny_cfg(tmp_path)
        train_loader, val_loader = _loaders(tmp_path)
        trainer = Trainer(cfg, get_task("tgnet_fps"), train_loader, val_loader,
                          log_fn=lambda s: None, device="cpu")
        first = trainer.train_epoch()
        for _ in range(3):
            last = trainer.train_epoch()
        assert last["total_train"] < first["total_train"]
        assert set(first) == {f"{k}_train" for k in cfg.loss_weights} | {"total_train"}
        trainer.run(max_epochs=1)
        for slot in ("", "_val"):
            assert os.path.exists(cfg.checkpoint_path + slot)
            assert os.path.exists(cfg.checkpoint_path + slot + ".meta.json")
        saved = _params(trainer.model)

        again = Trainer(cfg, get_task("tgnet_fps"), train_loader, val_loader,
                        log_fn=lambda s: None, device="cpu")
        assert again.resume() == trainer.epoch == 1
        assert again.step == trainer.step == 10
        for k, v in again.model.state_dict().items():
            assert torch.equal(v, saved[k]), k
        # the optimizer's momentum came back too: the next steps agree
        batch = trainer.device_batch(next(iter(val_loader)))
        a = train_step(trainer.model, trainer.optimizer, trainer.task, cfg, batch)
        b = train_step(again.model, again.optimizer, again.task, cfg, batch)
        assert all(torch.equal(a[k], b[k]) for k in a)

    def test_eval_after_a_step_matches_a_fresh_load(self, tmp_path):
        """The folded attention parameters follow the optimizer's in-place
        updates: the val losses after a step equal those of a fresh model
        loaded from the exported weights."""
        cfg = _tiny_cfg(tmp_path)
        train_loader, val_loader = _loaders(tmp_path)
        trainer = Trainer(cfg, get_task("tgnet_fps"), train_loader, val_loader,
                          log_fn=lambda s: None, device="cpu")
        before = trainer.eval_epoch()
        trainer.train_epoch()
        after = trainer.eval_epoch()
        assert after != before
        path = str(tmp_path / "w.npz")
        from toothgroupnetwork_tpu_torch.train.checkpoints import save_weights

        save_weights(path, trainer.model)
        fresh = Trainer(cfg, get_task("tgnet_fps"), train_loader, val_loader,
                        log_fn=lambda s: None, device="cpu")
        load_npz(path, fresh.model)
        assert fresh.eval_epoch() == after

    class _FlakyLoader:
        """A BatchLoader that raises mid-epoch on the selected passes."""

        def __init__(self, inner, fail_on_pass):
            self.inner, self.fail_on_pass, self.passes = inner, set(fail_on_pass), 0

        def __len__(self):
            return len(self.inner)

        def __iter__(self):
            this_pass = self.passes
            self.passes += 1
            for i, b in enumerate(self.inner):
                if this_pass in self.fail_on_pass and i == 1:
                    raise RuntimeError("injected device failure")
                yield b

    def test_elastic_retry_restores(self, tmp_path):
        cfg = _tiny_cfg(tmp_path, elastic_retries=2)
        train_loader, val_loader = _loaders(tmp_path)
        flaky = self._FlakyLoader(train_loader, fail_on_pass={1})
        logs = []
        trainer = Trainer(cfg, get_task("tgnet_fps"), flaky, val_loader,
                          log_fn=logs.append, device="cpu")
        trainer.run(max_epochs=3)
        assert trainer.epoch == 3 and flaky.passes == 4
        # epoch 1's first step was rolled back to epoch 0's checkpoint
        assert trainer.step == 6
        assert any("restoring last checkpoint" in m for m in logs)

    def test_retry_budget_exhausted_raises(self, tmp_path):
        cfg = _tiny_cfg(tmp_path, elastic_retries=1)
        train_loader, val_loader = _loaders(tmp_path)
        flaky = self._FlakyLoader(train_loader, fail_on_pass={0, 1})
        trainer = Trainer(cfg, get_task("tgnet_fps"), flaky, val_loader,
                          log_fn=lambda s: None, device="cpu")
        with pytest.raises(RuntimeError, match="injected"):
            trainer.run(max_epochs=2)


def test_cli_train_one_epoch(tmp_path, capsys):
    """cli.train on the CPU with a config the JAX package wrote; --resume
    picks the run up at the next epoch."""
    from toothgroupnetwork_tpu.models import get_task as jax_get_task

    d = _processed(tmp_path, n=3, n_points=256)
    jcfg = jax_get_task("tgnet_fps").default_config()
    jcfg.model_parameter.update(ARCH)
    jcfg.save_json(str(tmp_path / "cfg.json"))
    argv = ["--model_name", "tgnet_fps", "--config_path", str(tmp_path / "cfg.json"),
            "--input_data_dir_path", d, "--checkpoint_path", str(tmp_path / "ck" / "fps"),
            "--max_epochs", "1", "--device", "cpu"]
    trainer = cli_train.main(argv)
    assert trainer.epoch == 1 and trainer.device.type == "cpu"
    assert np.isfinite(trainer.best_val)
    assert (tmp_path / "ck" / "fps_val").exists()
    again = cli_train.main(argv + ["--resume"])
    assert again.epoch == 2
    assert "resumed at epoch 1" in capsys.readouterr().out


def test_cli_train_needs_a_card_for_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_train.main(["--model_name", "tgnet_fps", "--input_data_dir_path",
                        str(tmp_path)])


def test_port_trained_weights_serve_in_jax(tmp_path):
    """A port-trained model's .npz loads through the JAX package's
    load_weights, and JAX stage1 equals the port's eval output (1e-4)."""
    cfg = _tiny_cfg(tmp_path)
    train_loader, val_loader = _loaders(tmp_path, n_train=2, n_val=1)
    trainer = Trainer(cfg, get_task("tgnet_fps"), train_loader, val_loader,
                      log_fn=lambda s: None, device="cpu")
    trainer.train_epoch()
    path = str(tmp_path / "fps.npz")
    from toothgroupnetwork_tpu_torch.train.checkpoints import save_weights

    save_weights(path, trainer.model)
    arch = {k: v for k, v in ARCH.items() if k != "crop_sample_size"}
    jmodel = JaxTGNet(crop_size=32, c=6, **{k: tuple(v) if isinstance(v, list) else v
                                            for k, v in arch.items()})
    feat = next(iter(val_loader))["feat"][:1]
    # the variables' structure and shapes, traced (not run)
    template = jax.eval_shape(lambda f, lab: jmodel.init(
        jax.random.PRNGKey(1), f, None, train=False, labels=lab),
        jnp.asarray(feat), jnp.zeros(feat.shape[:2], jnp.int32))
    variables = jax_load_weights(path, dict(template))
    ref = jax.jit(lambda v, f: jmodel.apply(v, f, None, method=JaxTGNet.stage1))(
        variables, jnp.asarray(feat))
    with torch.no_grad():
        got = trainer.model.eval().stage1(_t(feat))
    for key in ("sem_1", "offset_1"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), err_msg=key,
                                   atol=1e-4, rtol=1e-4)
