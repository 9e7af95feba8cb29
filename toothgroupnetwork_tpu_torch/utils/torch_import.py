"""Original PyTorch checkpoints -> the port's modules (counterpart of
toothgroupnetwork_tpu/utils/torch_import.py, whose numpy name maps it keeps
a copy of).

The reference releases torch ``state_dict`` checkpoints (``.h5``). Each
``convert_*`` maps one onto the flax parameter tree of the JAX package's
module of that family, as the JAX converter does, and returns the port
module's ``state_dict`` from it (``utils/weights.py:from_jax_variables``:
the port's submodule names are the flax names), so that it loads into the
port's module with strict keys::

    module.load_state_dict(_tgnet_variables(torch.load(path)))

Conversion rules:

  * ``Conv1d(k=1).weight [out, in, 1]`` → Dense kernel ``[in, out]``,
  * ``Linear.weight [out, in]``        → Dense kernel ``[in, out]``,
  * BatchNorm ``weight/bias``          → MaskedBatchNorm ``scale/bias`` params,
    ``running_mean/running_var``       → batch_stats ``mean/var``,
  * LayerNorm ``weight/bias``          → LayerNorm ``scale/bias``.

Families: pointnet, the cbl point-transformer backbone (PointTransformerSeg),
tgnet (two prefixed backbones), dgcnn, pointnet++ and tsegnet's centroid
module.
"""

from __future__ import annotations

import numpy as np
import torch

from .weights import from_jax_variables


def _dense(sd, prefix):
    w = np.asarray(sd[prefix + ".weight"])
    out = {"kernel": (w[..., 0] if w.ndim == 3 else w).T}
    if prefix + ".bias" in sd:
        out["bias"] = np.asarray(sd[prefix + ".bias"])
    return out


def _bn(sd, prefix):
    return (
        {"scale": np.asarray(sd[prefix + ".weight"]),
         "bias": np.asarray(sd[prefix + ".bias"])},
        {"mean": np.asarray(sd[prefix + ".running_mean"]),
         "var": np.asarray(sd[prefix + ".running_var"])},
    )


def _ln(sd, prefix):
    return {"scale": np.asarray(sd[prefix + ".weight"]),
            "bias": np.asarray(sd[prefix + ".bias"])}


def _stn(sd, prefix):
    """SpatialTransformer ← reference STN3d/STNkd (pointnet_utils.py:10-85)."""
    params, stats = {}, {}
    mlp_p, mlp_s = {}, {}
    for i in range(3):
        mlp_p[f"dense_{i}"] = _dense(sd, f"{prefix}.conv{i + 1}")
        bn_p, bn_s = _bn(sd, f"{prefix}.bn{i + 1}")
        mlp_p[f"bn_{i}"] = bn_p
        mlp_s[f"bn_{i}"] = bn_s
    params["PointMLP_0"] = mlp_p
    stats["PointMLP_0"] = mlp_s
    params["Dense_0"] = _dense(sd, f"{prefix}.fc1")
    params["LayerNorm_0"] = _ln(sd, f"{prefix}.bn4")
    params["Dense_1"] = _dense(sd, f"{prefix}.fc2")
    params["LayerNorm_1"] = _ln(sd, f"{prefix}.bn5")
    params["Dense_2"] = _dense(sd, f"{prefix}.fc3")
    return params, stats


def _point_mlp(sd, conv_keys, bn_keys):
    params, stats = {}, {}
    for i, (ck, bk) in enumerate(zip(conv_keys, bn_keys)):
        params[f"dense_{i}"] = _dense(sd, ck)
        if bk is not None:
            bn_p, bn_s = _bn(sd, bk)
            params[f"bn_{i}"] = bn_p
            stats[f"bn_{i}"] = bn_s
    return params, stats


def _pointnet_variables(state_dict: dict) -> dict:
    """Reference pointnet ``get_model`` state_dict → flax variables for
    the JAX package's ``PointNetSeg``.

    Reference layout (models/modules/pointnet.py + pointnet_utils.py); keys may be
    prefixed ``first_sem_model.`` (the PointFirstModule wrapper) — stripped here.
    """
    sd = {}
    for k, v in state_dict.items():
        sd[k[len("first_sem_model."):] if k.startswith("first_sem_model.") else k] \
            = np.asarray(v)

    params, stats = {}, {}

    feat_p, feat_s = {}, {}
    feat_p["stn"], feat_s["stn"] = _stn(sd, "feat.stn")
    feat_p["fstn"], feat_s["fstn"] = _stn(sd, "feat.fstn")
    for name, conv, bn, last_act in (
        ("mlp1", ["feat.conv1"], ["feat.bn1"], True),
        ("mlp2", ["feat.conv2"], ["feat.bn2"], True),
        ("mlp3", ["feat.conv3"], ["feat.bn3"], False),
    ):
        p, s = _point_mlp(sd, conv, bn)
        feat_p[name], feat_s[name] = p, s
    params["feat"], stats["feat"] = feat_p, feat_s

    head_p, head_s = _point_mlp(sd, ["conv1", "conv2", "conv3"],
                                ["bn1", "bn2", "bn3"])
    params["head"], stats["head"] = head_p, head_s
    params["cls"] = _dense(sd, "conv4")

    return {"params": params, "batch_stats": stats}


# ---------------------------------------------------------------------------
# cbl point-transformer backbone + tgnet
# ---------------------------------------------------------------------------

def _strip_prefix(state_dict: dict, prefix: str) -> dict:
    out = {}
    for k, v in state_dict.items():
        if not prefix or k.startswith(prefix):
            out[k[len(prefix):]] = np.asarray(v)
    return out


def _pt_layer(sd, pre):
    """PointTransformerLayer (reference blocks.py:14-29) → flax ``transformer``
    submodule of PointTransformerBlock."""
    p, s = {}, {}
    p["linear_q"] = _dense(sd, pre + ".linear_q")
    p["linear_k"] = _dense(sd, pre + ".linear_k")
    p["linear_v"] = _dense(sd, pre + ".linear_v")
    p["linear_p0"] = _dense(sd, pre + ".linear_p.0")
    p["linear_p_bn"], s["linear_p_bn"] = _bn(sd, pre + ".linear_p.1")
    p["linear_p1"] = _dense(sd, pre + ".linear_p.3")
    p["linear_w_bn0"], s["linear_w_bn0"] = _bn(sd, pre + ".linear_w.0")
    p["linear_w0"] = _dense(sd, pre + ".linear_w.2")
    p["linear_w_bn1"], s["linear_w_bn1"] = _bn(sd, pre + ".linear_w.3")
    p["linear_w1"] = _dense(sd, pre + ".linear_w.5")
    return p, s


def _pt_block(sd, pre):
    """PointTransformerBlock (blocks.py:114-135)."""
    p, s = {}, {}
    p["linear1"] = _dense(sd, pre + ".linear1")
    p["bn1"], s["bn1"] = _bn(sd, pre + ".bn1")
    p["transformer"], s["transformer"] = _pt_layer(sd, pre + ".transformer2")
    p["bn2"], s["bn2"] = _bn(sd, pre + ".bn2")
    p["linear3"] = _dense(sd, pre + ".linear3")
    p["bn3"], s["bn3"] = _bn(sd, pre + ".bn3")
    return p, s


def _multi_head(sd, pre, n_stages):
    """MultiHead (heads.py:13-61): per-stage latent MLPs + concat linear cls.
    parse_stage('Ua') orders infer_list by ascending up-stage index."""
    p, s = {}, {}
    for i in range(n_stages):
        sp, ss = {}, {}
        sp["dense"] = _dense(sd, f"{pre}.infer_list.{i}.infer.0")
        sp["bn"], ss["bn"] = _bn(sd, f"{pre}.infer_list.{i}.infer.1")
        p[f"stage_{i}"], s[f"stage_{i}"] = sp, ss
    p["cls"] = _dense(sd, pre + ".cls")
    return p, s


def _point_transformer_variables(state_dict: dict, block_num: int = 5,
                              blocks=(2, 3, 4, 6, 3), prefix: str = "") -> dict:
    """Reference ``PointTransformerSeg`` state_dict
    (cbl_point_transformer_module.py:28-216) → flax variables for
    the JAX package's ``PointTransformerSeg``.

    ``prefix``: torch key prefix to strip (e.g. ``first_ins_cent_model.`` inside a
    tgnet checkpoint). The constructed-but-unused ``mask_head`` keys and the
    parameter-free ``criterion`` are ignored.
    """
    sd = _strip_prefix(state_dict, prefix)
    params, stats = {}, {}

    for i in range(block_num):
        # enc{i}.0 = TransitionDown (blocks.py:47-79)
        dp, ds = {}, {}
        dp["linear"] = _dense(sd, f"enc{i + 1}.0.linear")
        dp["bn"], ds["bn"] = _bn(sd, f"enc{i + 1}.0.bn")
        params[f"enc{i + 1}_down"], stats[f"enc{i + 1}_down"] = dp, ds
        for j in range(1, blocks[i]):
            bp, bs = _pt_block(sd, f"enc{i + 1}.{j}")
            params[f"enc{i + 1}_block{j}"] = bp
            stats[f"enc{i + 1}_block{j}"] = bs

    for i in range(block_num, 0, -1):
        # dec{i}.0 = TransitionUp; dec{i}.1 = block
        up_p, up_s = {}, {}
        up_p["linear1"] = _dense(sd, f"dec{i}.0.linear1.0")
        up_p["bn1"], up_s["bn1"] = _bn(sd, f"dec{i}.0.linear1.1")
        up_p["linear2"] = _dense(sd, f"dec{i}.0.linear2.0")
        if f"dec{i}.0.linear2.1.weight" in sd:  # non-head variant has BN
            up_p["bn2"], up_s["bn2"] = _bn(sd, f"dec{i}.0.linear2.1")
        params[f"dec{i}_up"], stats[f"dec{i}_up"] = up_p, up_s
        bp, bs = _pt_block(sd, f"dec{i}.1")
        params[f"dec{i}_block1"] = bp
        stats[f"dec{i}_block1"] = bs

    for head in ("cls_head", "offset_head"):
        hp, hs = _multi_head(sd, head, block_num)
        params[head], stats[head] = hp, hs

    return {"params": params, "batch_stats": stats}


def _tgnet_variables(state_dict: dict, block_num: int = 5,
                  blocks=(2, 3, 4, 6, 3)) -> dict:
    """Reference ``GroupingNetworkModule`` state_dict (two cascaded backbones,
    grouping_network_module.py:13-14) → flax variables for
    the JAX package's ``TGNet``."""
    first = _point_transformer_variables(state_dict, block_num, blocks,
                                      prefix="first_ins_cent_model.")
    second = _point_transformer_variables(state_dict, block_num, blocks,
                                       prefix="second_ins_cent_model.")
    return {
        "params": {"first": first["params"], "second": second["params"]},
        "batch_stats": {"first": first["batch_stats"],
                        "second": second["batch_stats"]},
    }


def _dgcnn_variables(state_dict: dict) -> dict:
    """Reference ``DGCnnModule`` state_dict (models/modules/dgcnn.py:44-134) →
    flax variables for the JAX package's ``DGCNNSeg``.

    Conv2d(k=1)/Conv1d(k=1) weights ``[out, in, 1(, 1)]`` become Dense kernels
    ``[in, out]``; BatchNorm2d/1d map onto MaskedBatchNorm scale/bias +
    running stats.
    """
    sd = state_dict

    def conv(prefix):
        w = np.asarray(sd[prefix + ".weight"])
        while w.ndim > 2:
            w = w[..., 0]
        return {"kernel": w.T}

    params, stats = {}, {}

    def block(name, convs, bns):
        p, s = {}, {}
        for i, (cpre, bpre) in enumerate(zip(convs, bns)):
            p[f"dense_{i}"] = conv(cpre)
            bp, bs = _bn(sd, bpre)
            p[f"bn_{i}"], s[f"bn_{i}"] = bp, bs
        params[name], stats[name] = p, s

    block("ec1", ["conv1.0", "conv2.0"], ["bn1", "bn2"])
    block("ec2", ["conv3.0", "conv4.0"], ["bn3", "bn4"])
    block("ec3", ["conv5.0"], ["bn5"])

    params["emb"] = conv("conv6.0")
    params["emb_bn"], stats["emb_bn"] = _bn(sd, "bn6")
    params["head1"] = conv("conv7.0")
    params["head1_bn"], stats["head1_bn"] = _bn(sd, "bn7")
    params["head2"] = conv("conv8.0")
    params["head2_bn"], stats["head2_bn"] = _bn(sd, "bn8")
    params["cls"] = conv("cls_conv")
    params["offset"] = conv("offset_conv")
    params["dist"] = conv("dist_conv")
    return {"params": params, "batch_stats": stats}


def _convert_pn2_backbone(sd: dict):
    """Shared SA-MSG + FP conversion for the pointnet++ family backbones
    (pointnet_pp.py and tsg_centroid_module.py use identical structure):
    ``sa{n}.conv_blocks.{i}.{j}`` → ``sa{n}/scale_{i}/dense_{j}``,
    ``fp{n}.mlp_convs.{j}`` → ``fp{n}/dense_{j}``."""
    params, stats = {}, {}

    def conv(prefix):
        w = np.asarray(sd[prefix + ".weight"])
        while w.ndim > 2:
            w = w[..., 0]
        out = {"kernel": w.T}
        if prefix + ".bias" in sd:
            out["bias"] = np.asarray(sd[prefix + ".bias"])
        return out

    n_scales = {"sa1": 2, "sa2": 2, "sa3": 2}
    depth = {"sa1": 2, "sa2": 2, "sa3": 2}
    for sa, ns in n_scales.items():
        p, s = {}, {}
        for i in range(ns):
            sp, ss = {}, {}
            for j in range(depth[sa]):
                sp[f"dense_{j}"] = conv(f"{sa}.conv_blocks.{i}.{j}")
                bp, bs = _bn(sd, f"{sa}.bn_blocks.{i}.{j}")
                sp[f"bn_{j}"], ss[f"bn_{j}"] = bp, bs
            p[f"scale_{i}"], s[f"scale_{i}"] = sp, ss
        params[sa], stats[sa] = p, s

    for fp, depth_fp in [("fp1", 2), ("fp2", 2), ("fp3", 2)]:
        p, s = {}, {}
        for j in range(depth_fp):
            p[f"dense_{j}"] = conv(f"{fp}.mlp_convs.{j}")
            bp, bs = _bn(sd, f"{fp}.mlp_bns.{j}")
            p[f"bn_{j}"], s[f"bn_{j}"] = bp, bs
        params[fp], stats[fp] = p, s
    return params, stats, conv


def _pointnetpp_variables(state_dict: dict) -> dict:
    """Reference pointnet_pp ``get_model`` state_dict
    (models/modules/pointnet_pp.py:6-71) → flax variables for
    the JAX package's ``PointNetPPSeg``."""
    sd = state_dict
    params, stats, conv = _convert_pn2_backbone(sd)

    for ours, ref_conv, ref_bn in [
            ("offset_1", "offset_conv_1", "offset_bn_1"),
            ("dist_1", "dist_conv_1", "dist_bn_1"),
            ("cls_1", "cls_conv_1", "cls_bn_1")]:
        params[ours] = conv(ref_conv)
        bn_name = ours.replace("_1", "_bn")
        params[bn_name], stats[bn_name] = _bn(sd, ref_bn)
    params["offset_2"] = conv("offset_conv_2")
    params["dist_2"] = conv("dist_conv_2")
    params["cls_2"] = conv("cls_conv_2")
    return {"params": params, "batch_stats": stats}


def _tsg_centroid_variables(state_dict: dict) -> dict:
    """Reference tsegnet centroid module state_dict
    (models/modules/tsg_centroid_module.py:5-46) → flax variables for
    the JAX package's ``TsgCentroidModule`` (the
    scale-1 pointnet++ backbone under ``backbone/`` + 515-ch offset/dist
    heads with zero-initialized output layers)."""
    sd = state_dict
    bb_params, bb_stats, conv = _convert_pn2_backbone(sd)
    params = {"backbone": bb_params}
    stats = {"backbone": bb_stats}
    for ours, ref_conv, ref_bn in [
            ("offset_1", "offset_conv_1", "offset_bn_1"),
            ("dist_1", "dist_conv_1", "dist_bn_1")]:
        params[ours] = conv(ref_conv)
        bn_name = ours.replace("_1", "_bn")
        params[bn_name], stats[bn_name] = _bn(sd, ref_bn)
    params["offset_2"] = conv("offset_conv_2")
    params["dist_2"] = conv("dist_conv_2")
    return {"params": params, "batch_stats": stats}


# ---------------------------------------------------------------------------
# the port's state dicts
# ---------------------------------------------------------------------------

def to_port_state(variables: dict) -> dict[str, torch.Tensor]:
    """Nested flax-layout ``{"params": ..., "batch_stats": ...}`` -> the
    port module's ``state_dict``."""
    flat = {}

    def walk(path, node):
        for key, value in node.items():
            if isinstance(value, dict):
                walk(f"{path}/{key}", value)
            else:
                flat[f"{path}/{key}"] = value

    for collection, tree in variables.items():
        walk(collection, tree)
    return from_jax_variables(flat)


def convert_pointnet(state_dict: dict) -> dict[str, torch.Tensor]:
    """Reference pointnet ``get_model`` -> ``models/pointnet.py:PointNetSeg``."""
    return to_port_state(_pointnet_variables(state_dict))


def convert_point_transformer(state_dict: dict, block_num: int = 5,
                              blocks=(2, 3, 4, 6, 3),
                              prefix: str = "") -> dict[str, torch.Tensor]:
    """Reference ``PointTransformerSeg`` -> the port's
    ``models/point_transformer/backbone.py:PointTransformerSeg``."""
    return to_port_state(_point_transformer_variables(state_dict, block_num,
                                                      blocks, prefix))


def convert_tgnet(state_dict: dict, block_num: int = 5,
                  blocks=(2, 3, 4, 6, 3)) -> dict[str, torch.Tensor]:
    """Reference ``GroupingNetworkModule`` -> ``models/tgnet.py:TGNet``."""
    return to_port_state(_tgnet_variables(state_dict, block_num, blocks))


def convert_dgcnn(state_dict: dict) -> dict[str, torch.Tensor]:
    """Reference ``DGCnnModule`` -> ``models/dgcnn.py:DGCNNSeg``."""
    return to_port_state(_dgcnn_variables(state_dict))


def convert_pointnetpp(state_dict: dict) -> dict[str, torch.Tensor]:
    """Reference pointnet_pp ``get_model`` -> ``models/pointnetpp.py:PointNetPPSeg``."""
    return to_port_state(_pointnetpp_variables(state_dict))


def convert_tsg_centroid(state_dict: dict) -> dict[str, torch.Tensor]:
    """Reference tsegnet centroid module -> ``models/tsegnet.py:TsgCentroidModule``."""
    return to_port_state(_tsg_centroid_variables(state_dict))
