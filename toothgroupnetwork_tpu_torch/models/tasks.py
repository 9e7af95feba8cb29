"""Model presets and tasks (counterpart of
toothgroupnetwork_tpu/models/tasks.py): the tgnet models and their training
tasks, and the other families' presets and tasks (pointnet, pointnetpp,
dgcnn and pointtransformer, 17-way CE only; tsegnet, its centroid and seg
losses and the host stage that proposes its crops). The constructors take a
``model_parameter`` dict (or a dict holding one); a task's preset is the
port's ``TrainConfig`` (train/config.py)."""

from __future__ import annotations

import copy

import numpy as np
import torch

from ..losses import (batch_center_offset_loss, batch_chamfer_distance_loss,
                      cbl_loss, centroid_loss, first_seg_loss, id_loss,
                      second_seg_loss, tooth_class_loss)
from ..parallel import data_parallel
from ..parallel import points as point_shards
from ..train.config import OptimizerConfig, SchedulerConfig, TrainConfig
from .dgcnn import DGCNNSeg
from .point_transformer import PointTransformerSeg
from .pointnet import PointNetSeg
from .pointnetpp import PointNetPPSeg
from .registry import ModelTask, register_task
from .tgnet import TGNet, binary_crop_labels, gt_tooth_centroids, half_arch_labels
from .tsegnet import N_CROPS_TRAIN, TSegNetModule, cluster_centres

# model_parameter["dtype"] -> the backbone's compute dtype (tasks.py:
# _pt_backbone_params); parameters, geometry and logits stay float32
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# train_configs/tgnet_fps.py model_parameter (tasks.py:_tgnet_preset)
TGNET_FPS_MODEL_PARAMETER = {
    "input_feat": 6,
    "stride": [1, 4, 4, 4, 4],
    "nsample": [36, 24, 24, 24, 24],
    "blocks": [2, 3, 4, 6, 3],
    "block_num": 5,
    "planes": [32, 64, 128, 256, 512],
    "crop_sample_size": 3072,
}

# the boundary model's arch (train_configs/tgnet_bdl.py, pipelines/tgn.py)
TGNET_BDL_ARCH = dict(planes=(16, 32), stride=(1, 1), nsample=(36, 24),
                      blocks=(2, 3), block_num=2)


def tgnet_fps_config() -> dict:
    return {"model_name": "tgnet_fps",
            "model_parameter": copy.deepcopy(TGNET_FPS_MODEL_PARAMETER)}


def backbone_kwargs(mp: dict) -> dict:
    """model_parameter -> backbone kwargs (tasks.py:_pt_backbone_params)."""
    return dict(
        c=mp.get("input_feat", 6),
        planes=tuple(mp.get("planes", (32, 64, 128, 256, 512))),
        stride=tuple(mp.get("stride", (1, 4, 4, 4, 4))),
        nsample=tuple(mp.get("nsample", (36, 24, 24, 24, 24))),
        blocks=tuple(mp.get("blocks", (2, 3, 4, 6, 3))),
        block_num=mp.get("block_num", 5),
    )


def _dtype(mp: dict) -> torch.dtype:
    name = mp.get("dtype", "float32")
    if name not in DTYPES:
        raise NotImplementedError(f"model_parameter dtype {name!r}: the port "
                                  f"serves {sorted(DTYPES)}")
    return DTYPES[name]


def build_tgnet_fps(cfg: dict, *, device) -> TGNet:
    mp = cfg["model_parameter"]
    return TGNet(crop_size=mp.get("crop_sample_size", 3072),
                 cell_attention=bool(mp.get("cell_attention", False)),
                 **backbone_kwargs(mp), device=device, dtype=_dtype(mp))


def build_tgnet_bdl(crop_size: int, arch: dict | None = None, *, device) -> TGNet:
    """The boundary model: built without the dtype, so float32 (as in the
    JAX pipeline, only the fps model takes ``model_parameter["dtype"]``)."""
    return TGNet(crop_size=crop_size, c=6, **dict(arch or TGNET_BDL_ARCH),
                 device=device)


# ---------------------------------------------------------------------------
# tgnet_fps training (train_configs/tgnet_fps.py)
# ---------------------------------------------------------------------------

def _tgnet_losses(outputs, batch, config: TrainConfig) -> dict:
    """The seven weighted losses of the fps model: half-arch CE of stage 1,
    the crops' FG/BG CE, the offset and direction terms, the chamfer ratio
    and the CBL of both stages."""
    gt = batch["gt_seg_label"]
    mask = batch.get("mask")
    xyz = batch["feat"][..., :3]
    stride = tuple(config.model_parameter.get("stride", (1, 4, 4, 4, 4)))
    w = config.loss_weights

    half = half_arch_labels(gt)
    crop_gt = binary_crop_labels(outputs["cluster_gt_seg_label"])

    # the crop stage's terms (l2, cbl2) run over this rank's crop rows in the
    # point-sharded step, the point-axis hooks off (models/tgnet.py)
    l1 = tooth_class_loss(outputs["sem_1"], half, 10, mask)
    with point_shards.dense():
        l2 = tooth_class_loss(outputs["sem_2"], crop_gt, 2, outputs["crop_mask"])
    off_loss, dir_loss = batch_center_offset_loss(outputs["offset_1"], xyz, gt, mask)
    chamf = batch_chamfer_distance_loss(outputs["offset_1"], xyz, gt, mask)
    cbl1 = cbl_loss(outputs["cbl_stages_1"], half, 10, stride)
    with point_shards.dense():
        cbl2 = cbl_loss(outputs["cbl_stages_2"], crop_gt, 2, stride)

    return {
        "tooth_class_loss_1": (l1, w.get("tooth_class_loss_1", 1.0)),
        "tooth_class_loss_2": (l2, w.get("tooth_class_loss_2", 1.0)),
        "offset_1_loss": (off_loss, w.get("offset_1_loss", 0.03)),
        "offset_1_dir_loss": (dir_loss, w.get("offset_1_dir_loss", 0.03)),
        "chamf_1_loss": (chamf, w.get("chamf_1_loss", 0.15)),
        "cbl_loss_1": (cbl1, w.get("cbl_loss_1", 1.0)),
        "cbl_loss_2": (cbl2, w.get("cbl_loss_2", 1.0)),
    }


def _tgnet_preset(name: str = "tgnet_fps") -> TrainConfig:
    """train_configs/tgnet_fps.py: sgd lr 0.1 momentum 0.9 wd 1e-4, cosine
    40; loss weights cbl 1/1, cls 1/1, offset .03/.03, chamfer .15."""
    return TrainConfig(
        model_name=name,
        optimizer=OptimizerConfig(name="sgd", lr=1e-1, weight_decay=1e-4,
                                  momentum=0.9),
        scheduler=SchedulerConfig(sched="cosine", full_steps=40, min_lr=1e-5),
        loss_weights={
            "cbl_loss_1": 1.0,
            "cbl_loss_2": 1.0,
            "tooth_class_loss_1": 1.0,
            "tooth_class_loss_2": 1.0,
            "offset_1_loss": 0.03,
            "offset_1_dir_loss": 0.03,
            "chamf_1_loss": 0.15,
        },
        model_parameter=copy.deepcopy(TGNET_FPS_MODEL_PARAMETER),
    )


def _build_tgnet(config: TrainConfig, device) -> TGNet:
    return build_tgnet_fps({"model_parameter": config.model_parameter}, device=device)


register_task(ModelTask(
    name="tgnet_fps",
    build_module=_build_tgnet,
    compute_losses=_tgnet_losses,
    default_config=_tgnet_preset,
    forward_kwargs=lambda batch: {"labels": batch["gt_seg_label"]},
))


# ---------------------------------------------------------------------------
# tgnet_bdl: the boundary stage (train_configs/tgnet_bdl.py)
# ---------------------------------------------------------------------------

def _tgnet_bdl_preset() -> TrainConfig:
    """The fps optimizer and losses; the smaller backbone (block_num 2,
    stride [1, 1], planes [16, 32]); the boundary sampling and the frozen
    fps model (its ``load_ckpt_path`` is needed for real training)."""
    cfg = _tgnet_preset("tgnet_bdl")
    cfg.model_parameter = {
        "input_feat": 6,
        "stride": [1, 1],
        "nsample": [36, 24],
        "blocks": [2, 3],
        "block_num": 2,
        "planes": [16, 32],
        "crop_sample_size": 3072,
        "n_points": 24000,
        "boundary_sampling_info": {
            "orginal_data_obj_path": None,
            "orginal_data_json_path": None,
            "bdl_cache_path": None,
            "bdl_ratio": 0.7,
            "num_of_bdl_points": 20000,
            "num_of_all_points": 24000,
        },
        "fps_model_info": {
            "model_parameter": None,  # defaults to the tgnet_fps preset
            "load_ckpt_path": None,
        },
    }
    return cfg


# An engine keeps a frozen tgnet_fps model and the obj/json path maps, both
# derived from the config: engines are kept by that config state (and the
# device), so two configs in one process never share one.
_BDL_ENGINES: dict = {}


def _bdl_engine_key(config) -> str:
    mp = config.model_parameter
    return repr((mp.get("fps_model_info"), mp.get("boundary_sampling_info"),
                 mp.get("n_points")))


def bdl_engine(config, device):
    """The boundary engine of ``config`` on ``device``, made on first use."""
    key = (_bdl_engine_key(config), str(torch.device(device)))
    if key not in _BDL_ENGINES:
        from ..train.bdl_engine import BdlDataEngine

        _BDL_ENGINES[key] = BdlDataEngine(device)
    return _BDL_ENGINES[key]


def _tgnet_bdl_host_stage(model, batch, config, step):
    device = next(model.parameters()).device
    return bdl_engine(config, device)(model, batch, config)


register_task(ModelTask(
    name="tgnet_bdl",
    build_module=_build_tgnet,
    compute_losses=_tgnet_losses,
    default_config=_tgnet_bdl_preset,
    forward_kwargs=lambda batch: {"labels": batch["gt_seg_label"]},
    host_stage=_tgnet_bdl_host_stage,
))


# ---------------------------------------------------------------------------
# the semantic families: pointnet, pointnetpp, dgcnn, pointtransformer
# (17-way CE only; train_configs/pointnet.py etc.)
# ---------------------------------------------------------------------------

def _ce_losses(outputs, batch, config: TrainConfig) -> dict:
    w = config.loss_weights.get("tooth_class_loss_1", 1.0)
    loss = tooth_class_loss(outputs["cls_pred"], batch["gt_seg_label"], 17,
                            batch.get("mask"))
    return {"tooth_class_loss_1": (loss, w)}


def _adam_preset(model_name: str) -> TrainConfig:
    """adam lr 1e-3, wd 1e-4, cosine 40, min_lr 1e-5."""
    return TrainConfig(
        model_name=model_name,
        optimizer=OptimizerConfig(name="adam", lr=1e-3, weight_decay=1e-4),
        scheduler=SchedulerConfig(sched="cosine", full_steps=40, min_lr=1e-5),
        loss_weights={"tooth_class_loss_1": 1.0},
    )


def _pt_backbone_params(mp: dict) -> dict:
    """model_parameter -> PointTransformerSeg kwargs, with the compute
    ``dtype`` and ``cell_attention`` (tasks.py:_pt_backbone_params)."""
    return dict(backbone_kwargs(mp), dtype=_dtype(mp),
                cell_attention=bool(mp.get("cell_attention", False)))


def _pointtransformer_preset() -> TrainConfig:
    """sgd lr 0.1 momentum 0.9 wd 1e-4, cosine 40, min_lr 1e-5; CE only."""
    return TrainConfig(
        model_name="pointtransformer",
        optimizer=OptimizerConfig(name="sgd", lr=1e-1, weight_decay=1e-4,
                                  momentum=0.9),
        scheduler=SchedulerConfig(sched="cosine", full_steps=40, min_lr=1e-5),
        loss_weights={"tooth_class_loss_1": 1.0},
        model_parameter=copy.deepcopy(TGNET_FPS_MODEL_PARAMETER),
    )


# name -> (build(model_parameter, device), preset)
_SEM_FAMILIES = {
    "pointnet": (lambda mp, device: PointNetSeg(
        num_classes=17, scale=mp.get("scale", 2), device=device),
        lambda: _adam_preset("pointnet")),
    "pointnetpp": (lambda mp, device: PointNetPPSeg(
        num_classes=17, scale=mp.get("scale", 4), device=device),
        lambda: _adam_preset("pointnetpp")),
    "dgcnn": (lambda mp, device: DGCNNSeg(
        num_classes=17, k=mp.get("k", 20), device=device),
        lambda: _adam_preset("dgcnn")),
    "pointtransformer": (lambda mp, device: PointTransformerSeg(
        k=17, **_pt_backbone_params(mp), device=device),
        _pointtransformer_preset),
}
SEM_MODELS = tuple(_SEM_FAMILIES)


def build_sem_model(name: str, mp: dict, *, device):
    """The semantic family ``name`` from its ``model_parameter``."""
    return _SEM_FAMILIES[name][0](mp, device)


for _name, (_build, _preset) in _SEM_FAMILIES.items():
    register_task(ModelTask(
        name=_name,
        build_module=(lambda cfg, device, _n=_name:
                      build_sem_model(_n, cfg.model_parameter, device=device)),
        compute_losses=_ce_losses,
        default_config=_preset,
    ))


# ---------------------------------------------------------------------------
# tsegnet (train_configs/tsegnet.py): centroid prediction + crop segmentation
# ---------------------------------------------------------------------------

def _tsegnet_preset(name: str = "tsegnet") -> TrainConfig:
    """adam lr 1e-3, wd 1e-4, cosine 40, min_lr 1e-4."""
    return TrainConfig(
        model_name=name,
        optimizer=OptimizerConfig(name="adam", lr=1e-3, weight_decay=1e-4),
        scheduler=SchedulerConfig(sched="cosine", full_steps=40, min_lr=1e-4),
        loss_weights={"dist_loss": 1.0, "cent_loss": 1.0, "chamf_loss": 0.1,
                      "seg_1_loss": 1.0, "seg_2_loss": 1.0, "id_pred_loss": 1.0},
        model_parameter={
            "crop_sample_size": 3072,
            "run_tooth_segmentation_module": True,
            "pretrained_centroid_model_path": None,
        },
    )


def build_tsegnet(cfg, *, device) -> TSegNetModule:
    """``cfg``: a TrainConfig, or a dict with a ``model_parameter``."""
    mp = cfg["model_parameter"] if isinstance(cfg, dict) else cfg.model_parameter
    return TSegNetModule(
        crop_size=mp.get("crop_sample_size", 3072),
        run_seg_module=mp.get("run_tooth_segmentation_module", True),
        tiny_backbone=mp.get("tiny_backbone", False), device=device)


def _tsegnet_forward_kwargs(batch: dict) -> dict:
    """The host stage's proposals; before it has run (no ``center_points``
    in the batch), ``N_CROPS_TRAIN`` zero centres, all valid, as JAX
    initialises the module."""
    cp = batch.get("center_points")
    if cp is None:
        feat = batch["feat"]
        cp = torch.zeros((feat.shape[0], N_CROPS_TRAIN, 3), dtype=torch.float32,
                         device=feat.device)
        cv = torch.ones((feat.shape[0], N_CROPS_TRAIN), dtype=torch.bool,
                        device=feat.device)
    else:
        cv = batch["center_valid"]
    return {"center_points": cp, "center_valid": cv}


def _tsegnet_host_stage(model, batch, config, step) -> dict:
    """Crop proposals: the centroid module's forward in eval mode (running
    statistics) under ``no_grad``, the model's own mode kept; then, on the
    host, each cloud's DBSCAN cluster centres (``cluster_centres``), at most
    ``N_CROPS_TRAIN`` of them chosen by ``default_rng(step).permutation``
    (``step``: the optimizer steps taken, JAX's ``state.step``), padded
    with the 1e3 sentinel. In a data-parallel step each rank proposes for
    its own rows, after replaying the draws of the earlier ranks' clouds,
    so the proposals are those of the global batch."""
    device = next(model.parameters()).device
    feat = torch.from_numpy(np.ascontiguousarray(batch["feat"])).to(device)
    mask = batch.get("mask")
    if mask is not None:
        mask = torch.from_numpy(np.ascontiguousarray(mask)).to(device)
    with torch.no_grad():
        out = model.centroid_forward(feat, mask)
    l3_xyz, offset, dist = (t.cpu().numpy() for t in (
        out["l3_xyz"], out["offset_result"], out["dist_result"][..., 0]))
    rng = np.random.default_rng(int(step))
    b = l3_xyz.shape[0]
    centers = np.full((b, N_CROPS_TRAIN, 3), 1e3, np.float32)
    valid = np.zeros((b, N_CROPS_TRAIN), bool)
    found = [cluster_centres(l3_xyz[i], offset[i], dist[i]) for i in range(b)]
    # in a data-parallel step the clouds of earlier ranks drew first
    for n in data_parallel.around([len(c) for c in found])[0]:
        if n:
            rng.permutation(n)
    for i, cents in enumerate(found):
        if not len(cents):
            continue
        cents = cents[rng.permutation(len(cents))[:N_CROPS_TRAIN]]
        centers[i, :len(cents)] = cents
        valid[i, :len(cents)] = True
    return {"center_points": centers, "center_valid": valid}


def _tsegnet_losses(outputs, batch, config: TrainConfig) -> dict:
    """The centroid losses (dist 1, cent 1, chamfer 0.1) and, when the seg
    module ran, the confidence-weighted seg losses and the 17-way id loss
    against the labels of each proposal's nearest ground-truth centroid."""
    # the whole clouds' inputs (gathered once in the point-sharded step)
    xyz, gt, mask = (point_shards.whole(t) for t in (
        batch["feat"][..., :3], batch["gt_seg_label"], batch.get("mask")))
    w = config.loss_weights

    cents, cvalid = gt_tooth_centroids(xyz, gt, mask)                 # [B,16,3]
    d_loss, c_loss, ch_loss = centroid_loss(
        outputs["offset_result"], outputs["l3_xyz"], outputs["dist_result"],
        cents, cvalid, outputs.get("l3_mask"))
    losses = {
        "dist_loss": (d_loss, w.get("dist_loss", 1.0)),
        "cent_loss": (c_loss, w.get("cent_loss", 1.0)),
        "chamf_loss": (ch_loss, w.get("chamf_loss", 0.1)),
    }
    if "pd_1" not in outputs:
        return losses

    centers = outputs["center_points"]                                # [B,K,3]
    b, k = centers.shape[:2]
    # the crop terms run over this rank's crop rows [lo, hi) in the
    # point-sharded step (models/tsegnet.py), the point-axis hooks off
    lo, hi = point_shards.crop_rows(b * k)
    with point_shards.dense():
        # each proposal's nearest valid ground-truth centroid -> its 1..16 id
        d2 = ((centers[:, :, None, :] - cents[:, None, :, :]) ** 2).sum(-1)
        d2 = torch.where(cvalid[:, None, :], d2, 1e9)
        matched = (d2.argmin(dim=-1) + 1).reshape(b * k)[lo:hi]       # [rows]
        crop_idx = outputs["nn_crop_indexes"].reshape(hi - lo, -1)
        cloud = torch.arange(lo, hi, device=crop_idx.device) // k
        crop_gt = gt[cloud[:, None], crop_idx.long()].to(torch.int32)  # -1..15
        bin_label = (crop_gt + 1 == matched[:, None]).to(torch.int32)

        crop_mask = outputs["crop_mask"]
        seg_1 = first_seg_loss(outputs["pd_1"], outputs["weight_1"], bin_label, crop_mask)
        seg_2 = second_seg_loss(outputs["pd_2"], outputs["weight_1"], bin_label, crop_mask)
        idl = id_loss(outputs["id_pred"], matched,
                      outputs["center_valid"].reshape(b * k)[lo:hi])
    losses.update({
        "seg_1_loss": (seg_1, w.get("seg_1_loss", 1.0)),
        "seg_2_loss": (seg_2, w.get("seg_2_loss", 1.0)),
        "id_pred_loss": (idl, w.get("id_pred_loss", 1.0)),
    })
    return losses


register_task(ModelTask(
    name="tsegnet",
    build_module=build_tsegnet,
    compute_losses=_tsegnet_losses,
    default_config=_tsegnet_preset,
    forward_kwargs=_tsegnet_forward_kwargs,
    host_stage=_tsegnet_host_stage,
))
