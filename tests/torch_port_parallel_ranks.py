"""Rank-side jobs of tests/test_torch_port_parallel.py: each runs on every
rank of the test's spawned gloo pool (``parallel.RankPool``, four CPU
ranks) as ``job(mesh, d, ...)`` on the mesh of the first ``d`` ranks, and
returns this rank's result as numpy (None on a rank outside the mesh).
This module imports torch and the port only, never JAX."""

from __future__ import annotations

import contextlib
import multiprocessing

import numpy as np
import torch

from toothgroupnetwork_tpu_torch.models import get_task
from toothgroupnetwork_tpu_torch.models.point_transformer.backbone import (
    PointTransformerBlock, PointTransformerSeg, TransitionDown, TransitionUp)
from toothgroupnetwork_tpu_torch.models.tgnet import TGNet
from toothgroupnetwork_tpu_torch.parallel import (make_data_mesh, shard_rows,
                                                  sharded_square_distance)
from toothgroupnetwork_tpu_torch.parallel.ring import ring_knn
from toothgroupnetwork_tpu_torch.parallel.sharded_backbone import (
    extract_backbone_params, extract_block_params, sharded_backbone_forward,
    sharded_encoder_stage, sharded_point_transformer_block, sharded_transition_down,
    sharded_transition_up)
from toothgroupnetwork_tpu_torch.parallel.sharded_ops import ring_gather, sharded_fps
from toothgroupnetwork_tpu_torch.parallel.mesh import all_gather
from toothgroupnetwork_tpu_torch.ops.kernels.attention import fold_bn
from toothgroupnetwork_tpu_torch.train import Trainer

_MESHES: dict = {}
if multiprocessing.current_process().name != "MainProcess":
    torch.set_num_threads(1)   # four ranks beside the other test workers


def sub(mesh, d: int):
    """The mesh of the pool's first ``d`` ranks (made once per process;
    every rank calls this, in one order, as ``new_group`` requires)."""
    if d == mesh.size:
        return mesh
    if d not in _MESHES:
        _MESHES[d] = make_data_mesh(d, axis="model", device=mesh.device)
    return _MESHES[d]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    return t.detach().cpu().numpy()


def _load(module, state: dict, prefix: str = ""):
    module.load_state_dict({k[len(prefix):]: v for k, v in state.items()
                            if k.startswith(prefix)})
    return module.eval()


# ------------------------------------------------------------ primitives

def ring_knn_job(mesh, d, query, points, k):
    m = sub(mesh, d)
    if m is None:
        return None
    idx, dist = ring_knn(shard_rows(_t(query), m), shard_rows(_t(points), m), k, m)
    return _np(idx), _np(dist)


def sharded_fps_job(mesh, d, xyz, n, mask):
    m = sub(mesh, d)
    if m is None:
        return None
    mk = None if mask is None else shard_rows(_t(mask), m)
    return _np(sharded_fps(shard_rows(_t(xyz), m), n, m, mask=mk))


def ring_gather_job(mesh, d, x, idx):
    m = sub(mesh, d)
    if m is None:
        return None
    return _np(ring_gather(shard_rows(_t(x), m), shard_rows(_t(idx), m), m))


def square_distance_job(mesh, d, src, dst):
    m = sub(mesh, d)
    if m is None:
        return None
    return _np(sharded_square_distance(_t(src), _t(dst), m))


# ------------------------------------------------------------ layers

def transition_down_job(mesh, d, state, p, x, c, cout, k):
    m = sub(mesh, d)
    if m is None:
        return None
    td = _load(TransitionDown(c, cout, 4, k, device="cpu"), state)
    params = {"w": td.linear.weight.detach(), "bn": fold_bn(td.bn)}
    new_p, new_x = sharded_transition_down(shard_rows(_t(p), m), shard_rows(_t(x), m),
                                           len(p) // 4, k, params, m)
    return _np(new_p), _np(new_x)


def block_job(mesh, d, state, p, x, kidx, c):
    m = sub(mesh, d)
    if m is None:
        return None
    blk = _load(PointTransformerBlock(c, device="cpu"), state, "blk.")
    return _np(sharded_point_transformer_block(
        shard_rows(_t(p), m), shard_rows(_t(x), m), shard_rows(_t(kidx), m),
        extract_block_params(blk), m))


def transition_up_job(mesh, d, state, p1, x1, p2, x2, c2, cout):
    m = sub(mesh, d)
    if m is None:
        return None
    tu = _load(TransitionUp(c2, cout, device="cpu"), state)
    params = {"lin1": {"w": tu.linear1.weight.detach(), "b": tu.linear1.bias.detach()},
              "lin2": {"w": tu.linear2.weight.detach(), "b": tu.linear2.bias.detach()},
              "bn1": fold_bn(tu.bn1), "bn2": fold_bn(tu.bn2)}
    return _np(sharded_transition_up(*(shard_rows(_t(a), m) for a in (p1, x1, p2, x2)),
                                     params, m))


def encoder_stage_job(mesh, d, state, p, x, c, cout, k_down, k_attn):
    m = sub(mesh, d)
    if m is None:
        return None
    down = _load(TransitionDown(c, cout, 4, k_down, device="cpu"), state, "down.")
    blocks = [_load(PointTransformerBlock(cout, device="cpu"), state, f"block{j}.")
              for j in (1, 2)]
    new_p, new_x = sharded_encoder_stage(
        shard_rows(_t(p), m), shard_rows(_t(x), m), len(p) // 4, k_down, k_attn,
        {"w": down.linear.weight.detach(), "bn": fold_bn(down.bn)},
        [extract_block_params(b) for b in blocks], m)
    return _np(new_p), _np(new_x)


def backbone_job(mesh, d, state, feat, k_cls, arch):
    m = sub(mesh, d)
    if m is None:
        return None
    model = _load(PointTransformerSeg(k=k_cls, c=feat.shape[-1], **arch, device="cpu"),
                  state)
    out = sharded_backbone_forward(shard_rows(_t(feat), m),
                                   extract_backbone_params(model), m)
    return {"sem_1": _np(out["sem_1"]), "offset_1": _np(out["offset_1"]),
            "embed": _np(out["embed"]), "fps_idx": [_np(i) for i in out["fps_idx"]]}


def crop_stage2_job(mesh, d, state, crops, mask, arch):
    """Stage 2 on this rank's crops, all-gathered (the crop axis sharded)."""
    m = sub(mesh, d)
    if m is None:
        return None
    model = _load(TGNet(c=crops.shape[-1], **arch, device="cpu"), state)
    with torch.no_grad():
        out = model.stage2(shard_rows(_t(crops), m), shard_rows(_t(mask), m))
    return {k: _np(all_gather(out[k], m).flatten(0, 1)) for k in ("sem_1", "offset_1")}


# ------------------------------------------------------------ training

def _trainer(name, mp, d, mesh, batches, state, lr):
    task = get_task(name)
    cfg = task.default_config()
    cfg.model_parameter.update(mp)
    cfg.data_parallel = d
    cfg.optimizer.name, cfg.optimizer.lr, cfg.optimizer.momentum = "sgd", lr, 0.9
    trainer = Trainer(cfg, task, batches, [], log_fn=lambda _s: None, device="cpu",
                      mesh=mesh)
    if state is not None:
        trainer.model.load_state_dict({k: _t(v) for k, v in state.items()})
    return trainer


def _snapshot(trainer_or_model, stats) -> dict:
    model = getattr(trainer_or_model, "model", trainer_or_model)
    return {"stats": stats,
            "state": {k: _np(v).copy() for k, v in model.state_dict().items()}}


def data_parallel_job(mesh, d, name, mp, batches, state=None, lr=1e-4, step=0):
    """``len(batches)`` SGD steps (momentum 0.9, ``lr``) of the ``Trainer``
    at ``data_parallel = d`` over the global batches, from optimizer step
    ``step`` (what a host stage and the dropout seed read), and on rank 0
    the same steps in one process (no mesh). Returns (this rank's snapshot,
    rank 0's one-process one)."""
    m = sub(mesh, d)
    if m is None:
        return None
    dp = _trainer(name, mp, d, m, batches, state, lr)
    dp.step = step
    got = _snapshot(dp, dp.train_epoch())
    if m.rank:
        return got, None
    one = _trainer(name, mp, 1, None, batches, state, lr)
    one.step = step
    return got, _snapshot(one, one.train_epoch())


def trainer_epoch_job(mesh, d, name, mp, data_dir, ckpt):
    """``Trainer(data_parallel=d)`` over a processed directory (batches of
    2, val batches of 1): an epoch of ``train_epoch`` and ``eval_epoch``,
    then one through ``run`` (checkpoints). Returns (train losses, val
    losses, is_main)."""
    from toothgroupnetwork_tpu_torch.data.dataset import BatchLoader, DentalScanDataset

    m = sub(mesh, d)
    if m is None:
        return None
    task = get_task(name)
    cfg = task.default_config()
    cfg.model_parameter.update(mp)
    cfg.data_parallel, cfg.checkpoint_path = d, ckpt
    ds = DentalScanDataset(data_dir)
    trainer = Trainer(cfg, task, BatchLoader(ds, 2, shuffle=True, seed=0),
                      BatchLoader(ds, 1, shuffle=False), log_fn=lambda _s: None,
                      device="cpu", mesh=m)
    train, val = trainer.train_epoch(), trainer.eval_epoch()
    trainer.run(max_epochs=1)
    return train, val, trainer.is_main


def bdl_resample_job(mesh, d, batches, info):
    """tgnet_bdl's boundary resample (``BdlDataEngine``, the ground-truth
    labels standing in for the frozen model's) over ``batches`` in turn: on
    each rank over its rows under the data mesh, and on rank 0 over the
    whole batches in one process. Returns (this rank's outputs and its
    generator's state after them, rank 0's one-process ones)."""
    from toothgroupnetwork_tpu_torch.parallel import data_parallel, shard_batch
    from toothgroupnetwork_tpu_torch.train.bdl_engine import BdlDataEngine

    m = sub(mesh, d)
    if m is None:
        return None
    cfg = get_task("tgnet_bdl").default_config()
    cfg.model_parameter["boundary_sampling_info"].update(info)

    def run(mesh_or_none, rows):
        engine = BdlDataEngine("cpu")
        engine._stage_labels = lambda _cfg, _feat, labels: labels.astype(np.float64)
        outs = []
        with data_parallel.context(mesh_or_none):
            for b in batches:
                outs.append(engine(None, rows(b), cfg))
        return outs, engine.rng.bit_generator.state

    got = run(m, lambda b: shard_batch(b, m))
    return got, (run(None, lambda b: b) if m.rank == 0 else None)


def trainer_retry_job(mesh, d, name, mp, data_dir, ckpt, fail_rank):
    """``Trainer(data_parallel=d, elastic_retries=1)`` for two epochs over
    a processed directory, rank ``fail_rank``'s host stage failing once in
    the second epoch. Returns (epoch, step, the state's bytes, the log)."""
    from toothgroupnetwork_tpu_torch.data.dataset import BatchLoader, DentalScanDataset

    m = sub(mesh, d)
    if m is None:
        return None
    task = get_task(name)
    cfg = task.default_config()
    cfg.model_parameter.update(mp)
    cfg.data_parallel, cfg.checkpoint_path, cfg.elastic_retries = d, ckpt, 1
    ds = DentalScanDataset(data_dir)
    logs = []
    trainer = Trainer(cfg, task, BatchLoader(ds, 2, shuffle=True, seed=0),
                      BatchLoader(ds, 1, shuffle=False), log_fn=logs.append,
                      device="cpu", mesh=m)
    host_batch, failed = trainer.host_batch, []

    def flaky(batch):
        if m.rank == fail_rank and trainer.epoch == 1 and not failed:
            failed.append(True)
            raise OSError("a scan could not be read")
        return host_batch(batch)

    trainer.host_batch = flaky
    trainer.run(max_epochs=2)
    state = b"".join(_np(v).tobytes() for v in trainer.model.state_dict().values())
    return trainer.epoch, trainer.step, state, logs


# ------------------------------------------------------------ point-sharded training

def point_sharded_step_job(mesh, d, mp, batch, state, lr=0.01, name="pointtransformer",
                           dropout=None, seed=None, dense=True):
    """One step of the point-sharded step of task ``name`` (SGD, momentum
    0.9, ``lr``) over the mesh of ``d`` ranks from ``state``, each rank on
    its rows of ``batch``; on rank 0 also the dense one-process step.
    ``dropout``: the model's dropout rate, if not the preset's; ``seed``:
    the dropout generator's seed, the same for both steps; ``dense``:
    False leaves the dense step out. Returns (this rank's snapshot, rank
    0's dense one or None); a DGCNN snapshot also holds the
    step's neighbour lists (``"knn"``: this rank's rows, in call order), a
    crop model's its crops (``"crops"``: ``nn_crop_indexes``, this rank's
    rows of the crop axis as ``[rows, S]``)."""
    from toothgroupnetwork_tpu_torch.parallel.sharded_train import (
        make_point_sharded_train_step, shard_batch_points)
    from toothgroupnetwork_tpu_torch.train import make_optimizer, train_step

    m = sub(mesh, d)
    if m is None:
        return None
    task = get_task(name)
    cfg = task.default_config()
    cfg.model_parameter.update(mp)
    cfg.optimizer.name, cfg.optimizer.lr, cfg.optimizer.momentum = "sgd", lr, 0.9

    def run(sharded):
        model = task.build_module(cfg, device="cpu")
        model.load_state_dict({k: _t(v) for k, v in state.items()})
        if dropout is not None:
            model.drop.p = dropout
        opt = make_optimizer(cfg.optimizer, model.parameters())
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        lists: list = []
        crops: list = []
        model.register_forward_hook(lambda _m, _a, out: crops.append(
            _np(out["nn_crop_indexes"]).reshape(-1, out["nn_crop_indexes"].shape[-1]))
            if "nn_crop_indexes" in out else None)
        with _recorded_selections(lists):
            if sharded:
                values = make_point_sharded_train_step(task, cfg, m)(
                    model, opt, shard_batch_points(batch, m), generator=gen)
            else:
                values = train_step(model, opt, task, cfg,
                                    {k: _t(v) for k, v in batch.items()}, generator=gen)
        got = _snapshot(model, {f"{k}_train": float(v) for k, v in values.items()})
        if lists:
            got["knn"] = lists
        if crops:
            got["crops"] = crops[0]
        return got

    got = run(True)
    return got, (run(False) if dense and m.rank == 0 else None)


@contextlib.contextmanager
def _recorded_selections(lists: list):
    """Every neighbour list the DGCNN's ``knn_points`` returns inside,
    appended to ``lists`` as numpy, in call order."""
    from toothgroupnetwork_tpu_torch.models import dgcnn

    select = dgcnn.knn_points

    def record(*args, **kwargs):
        out = select(*args, **kwargs)
        lists.append(_np(out[0]).copy())
        return out

    dgcnn.knn_points = record
    try:
        yield
    finally:
        dgcnn.knn_points = select


def _rows(a, m, axis=1):
    """This rank's rows of ``a``'s point axis ``axis`` (``points.rows``)."""
    from toothgroupnetwork_tpu_torch.parallel import points

    lo, hi = points.rows(a.shape[axis], m)
    return _t(np.take(a, np.arange(lo, hi), axis=axis))


def ring_gather_grad_job(mesh, d, x, idx, w):
    """``ring_gather`` of this rank's rows of ``idx`` ``[B, M, K]`` (global
    indices) from its rows of ``x`` ``[B, N, C]``, and the gradient of the
    sum of the rows weighted by its rows of ``w``, twice."""
    m = sub(mesh, d)
    if m is None:
        return None
    xl = _rows(x, m).requires_grad_(True)
    il, wl = _rows(idx, m), _rows(w, m)
    out, grads = None, []
    for _ in range(2):
        xl.grad = None
        out = ring_gather(xl, il, m, x.shape[1])
        (out * wl).sum().backward()
        grads.append(_np(xl.grad).copy())
    return {"out": _np(out), "grad": grads[0], "again": grads[1]}


def ring_knn_context_job(mesh, d, xyz, q, mask, k):
    """``ring_knn`` of this rank's query rows of the first cloud, and inside
    the point-sharded context ``knn_self``, ``knn_points`` (re-scored) and
    ``farthest_point_sample`` (n // 4) on this rank's rows of both clouds."""
    from toothgroupnetwork_tpu_torch.ops import farthest_point_sample, knn_points, knn_self
    from toothgroupnetwork_tpu_torch.parallel import points

    m = sub(mesh, d)
    if m is None:
        return None
    n = xyz.shape[1]
    p, qq, mk = _rows(xyz, m), _rows(q, m), _rows(mask, m)
    out = {"ring": tuple(_np(t) for t in ring_knn(qq[0], p[0], k, m, mask=mk[0], n=n))}
    with points.context(m, n):
        out["self"] = tuple(_np(t) for t in knn_self(p, k, mk))
        out["rescored"] = tuple(_np(t) for t in knn_points(qq, p, k, None, mk))
        out["fps"] = _np(farthest_point_sample(p, n // 4, mk))
    return out


def masked_max_job(mesh, d, x, mask, w):
    """``masked_max`` over the point axis inside the point-sharded context
    on this rank's rows of ``x`` ``[B, N, C]`` and ``mask``, and the
    gradient of its sum weighted by ``w`` ``[B, C]`` with respect to the
    rows, divided by D as the step's gradient all-reduce divides it."""
    from toothgroupnetwork_tpu_torch.nn.layers import masked_max
    from toothgroupnetwork_tpu_torch.parallel import points

    m = sub(mesh, d)
    if m is None:
        return None
    xl = _rows(x, m).requires_grad_(True)
    with points.context(m, x.shape[1]):
        out = masked_max(xl, _rows(mask, m), dim=1)
    (out * _t(w)).sum().backward()
    return {"out": _np(out), "grad": _np(xl.grad / m.size)}


def ball_query_job(mesh, d, xyz, mask, centres, radius, k):
    """``ball_query`` inside the point-sharded context: this rank's rows of
    the ``centres`` ``[B, S, 3]`` against its rows of the cloud ``xyz``
    ``[B, N, 3]`` and its ``mask``."""
    from toothgroupnetwork_tpu_torch.ops import ball_query
    from toothgroupnetwork_tpu_torch.parallel import points

    m = sub(mesh, d)
    if m is None:
        return None
    with points.context(m, xyz.shape[1]):
        points.register(centres.shape[1])
        return _np(ball_query(radius, k, _rows(xyz, m), _rows(centres, m),
                              _rows(mask, m)))


def feature_knn_job(mesh, d, x, mask, k):
    """DGCNN's selection, ``knn_points(x, x, k, mask, mask,
    include_self=True, need_dist=False)``, inside the point-sharded context
    on this rank's rows of the features ``x`` ``[B, N, C]``."""
    from toothgroupnetwork_tpu_torch.ops import knn_points
    from toothgroupnetwork_tpu_torch.parallel import points

    m = sub(mesh, d)
    if m is None:
        return None
    xl, ml = _rows(x, m), _rows(mask, m)
    with points.context(m, x.shape[1]):
        idx, dist = knn_points(xl, xl, k, ml, ml, include_self=True, need_dist=False)
    return _np(idx), _np(dist)


def dropout_draw_job(mesh, d, shape, p, seed):
    """A train-mode ``Dropout(p)``'s mask on this rank's rows of a
    ``[B, N, C]`` tensor of ones, inside the point-sharded context and the
    data-parallel one (as in the point-sharded step), from a generator
    seeded with ``seed``."""
    from toothgroupnetwork_tpu_torch.nn.layers import Dropout
    from toothgroupnetwork_tpu_torch.parallel import data_parallel, points

    m = sub(mesh, d)
    if m is None:
        return None
    drop = Dropout(p).train()
    drop.generator = torch.Generator().manual_seed(seed)
    lo, hi = points.rows(shape[1], m)
    with points.context(m, shape[1]), data_parallel.context(m):
        return _np(drop(torch.ones((shape[0], hi - lo) + tuple(shape[2:]))))


def crop_rows_gather_job(mesh, d, x, idx, w):
    """``crop_rows_gather`` of this rank's crop rows of ``idx`` ``[B, K,
    S]`` (global indices, every rank's whole crop set) from its rows of
    ``x`` ``[B, N, C]``, and the gradient of the rows' sum weighted by its
    crop rows of ``w`` ``[B·K, S, C]``."""
    from toothgroupnetwork_tpu_torch.parallel import points
    from toothgroupnetwork_tpu_torch.parallel.sharded_ops import crop_rows_gather

    m = sub(mesh, d)
    if m is None:
        return None
    xl = _rows(x, m).requires_grad_(True)
    lo, hi = points.rows(idx.shape[0] * idx.shape[1], m)
    out = crop_rows_gather(xl, _t(idx), lo, hi, m, x.shape[1])
    (out * _t(w[lo:hi])).sum().backward()
    return {"out": _np(out), "grad": _np(xl.grad)}


def centroid_dist_job(mesh, d, inputs):
    """tsegnet's ``centroid_dist_loss`` inside the point-sharded context
    and the data-parallel one (as in the step) on this rank's rows of the
    l3 points, and the gradient of the loss with respect to its rows of the
    offsets and points, divided by D as the step's all-reduce divides it."""
    from toothgroupnetwork_tpu_torch.losses.tsg_loss import centroid_dist_loss
    from toothgroupnetwork_tpu_torch.parallel import data_parallel, points

    m = sub(mesh, d)
    if m is None:
        return None
    off = _rows(inputs["pred_offset"], m).requires_grad_(True)
    xyz = _rows(inputs["sample_xyz"], m).requires_grad_(True)
    with points.context(m, inputs["sample_xyz"].shape[1]), data_parallel.context(m):
        loss = centroid_dist_loss(off, xyz, _rows(inputs["pred_distance"], m),
                                  _t(inputs["centroids"]), _t(inputs["cent_valid"]),
                                  _rows(inputs["mask"], m))
    loss.backward()
    return {"loss": float(loss), "offset_grad": _np(off.grad / m.size),
            "xyz_grad": _np(xyz.grad / m.size)}


class StandInCentroids(torch.nn.Module):
    """A tsegnet model whose ``centroid_forward`` returns recorded outputs
    (numpy), counting its calls."""

    def __init__(self, outputs):
        super().__init__()
        self.outputs, self.calls = outputs, 0
        self.anchor = torch.nn.Parameter(torch.zeros(1))

    def centroid_forward(self, feat, mask=None):
        self.calls += 1
        return {k: _t(v) for k, v in self.outputs.items()}


def host_stage_job(mesh, d, name, batches, outputs=None, info=None):
    """``host_batch_points`` over ``batches`` in turn (optimizer steps 0,
    1, ...) inside the data-parallel context, as a trainer holds it:
    tsegnet's host stage on a stand-in centroid forward (``outputs``), or
    tgnet_bdl's boundary engine on the CPU (``info``: its
    ``boundary_sampling_info``), the ground-truth labels standing in for
    the frozen model's. Returns this rank's sharded batches (numpy), its
    stage calls and, for tgnet_bdl, its engine's generator state."""
    from toothgroupnetwork_tpu_torch.models import tasks
    from toothgroupnetwork_tpu_torch.parallel import data_parallel
    from toothgroupnetwork_tpu_torch.parallel.sharded_train import host_batch_points

    m = sub(mesh, d)
    if m is None:
        return None
    task = get_task(name)
    cfg = task.default_config()
    calls = []
    if name == "tsegnet":
        model = StandInCentroids(outputs)
    else:
        cfg.model_parameter["boundary_sampling_info"].update(info)
        model = torch.nn.Linear(1, 1)
        engine = tasks.bdl_engine(cfg, "cpu")
        engine.rng = np.random.default_rng(0)

        def labels(_cfg, _feat, lab):
            calls.append(1)
            return lab.astype(np.float64)
        engine._stage_labels = labels
    out = []
    with data_parallel.context(m):
        for step, b in enumerate(batches):
            got = host_batch_points(task, model, b, cfg, step, m)
            out.append({k: _np(v) for k, v in got.items() if isinstance(v, torch.Tensor)})
    if name == "tsegnet":
        return out, model.calls, None
    return out, len(calls), engine.rng.bit_generator.state


class _FailingCentroids(StandInCentroids):
    def centroid_forward(self, feat, mask=None):
        raise OSError("a scan could not be read")


def host_stage_failure_job(mesh, d, batch):
    """``host_batch_points`` with a tsegnet host stage that fails on rank
    0: the exception's type name on each rank."""
    from toothgroupnetwork_tpu_torch.parallel.sharded_train import host_batch_points

    m = sub(mesh, d)
    if m is None:
        return None
    task = get_task("tsegnet")
    try:
        host_batch_points(task, _FailingCentroids({}), batch, None, 0, m)
    except Exception as e:   # noqa: BLE001 -- the test reads its type
        return type(e).__name__
    return None
