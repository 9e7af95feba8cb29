"""The point-sharded eval forward of the point-transformer U-Net
(counterpart of toothgroupnetwork_tpu/parallel/sharded_backbone.py).

Every rank holds ``N/D`` points of one cloud from end to end: FPS with an
all-gathered winner (``sharded_ops.sharded_fps``), kNN through K2 over the
all-gathered coordinates (``ring.ring_knn``), the neighbourhood gathers
over the ring (``sharded_ops.ring_gather``), and the layers' local work on
the rank's rows. The attention of a block after its ring gather is what K6 computes
(``ops/kernels/attention.py:fused_vector_attention`` on the gathered rows,
with the layer's ``fold_attention_params``), where the JAX file runs the
XLA graph (``_attention_local``). The exchanges are the FPS steps' gathers,
each kNN's gather of the coordinates, the ring passes and the bottleneck
mean's all-reduce.

The parameters are read from the port's ``PointTransformerSeg``
(``models/point_transformer/backbone.py``) by :func:`extract_backbone_params`,
every eval BatchNorm folded to an affine pair (``fold_bn``). The forward
takes a fully valid float32 cloud; N must divide by D times every
cumulative stride product (a stage's k may pass its shard: ``ring_knn``
selects over the whole cloud).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.nn import functional as F

from ..ops.distance import _dot_fixed
from ..ops.kernels.attention import (fold_attention_params, fold_bn,
                                     fused_vector_attention)
from .mesh import Mesh
from .ring import ring_knn
from .sharded_ops import ring_gather, sharded_fps


def _bn_relu(h, bn):
    a, b = bn
    return torch.relu(h * a + b)


# ----------------------------------------------------------------- params

def extract_block_params(block) -> dict:
    """A ``PointTransformerBlock``'s eval parameters: the Dense weights
    (torch's ``[out, in]``), the BatchNorms folded, and the attention
    layer's ``fold_attention_params`` (what K6 reads)."""
    with torch.no_grad():
        t = block.transformer
        return {"w_lin1": block.linear1.weight.detach(), "bn1": fold_bn(block.bn1),
                "bn2": fold_bn(block.bn2), "w_lin3": block.linear3.weight.detach(),
                "bn3": fold_bn(block.bn3), "wq": t.linear_q.weight.detach(),
                "bq": t.linear_q.bias.detach(), "attn": fold_attention_params(t)}


def _lin(dense) -> dict:
    return {"w": dense.weight.detach(), "b": dense.bias.detach()}


def extract_backbone_params(model) -> dict:
    """A float32 ``PointTransformerSeg``'s eval parameters, by the dense
    module names (``enc{i}_down``, ``enc{i}_block{j}``, ``dec{i}_up``,
    ``dec{i}_block1``, ``cls_head``/``offset_head``), with its arch under
    ``"arch"``."""
    if model.dtype != torch.float32:
        raise NotImplementedError("the point-sharded forward computes in float32")
    bn_ct = model.block_num
    out = {"arch": dict(stride=model.stride, nsample=model.nsample,
                        blocks=model.blocks, block_num=bn_ct)}
    with torch.no_grad():
        for i in range(bn_ct):
            td = getattr(model, f"enc{i + 1}_down")
            out[f"enc{i + 1}_down"] = {"w": td.linear.weight.detach(),
                                       "bn": fold_bn(td.bn)}
            for j in range(1, model.blocks[i]):
                name = f"enc{i + 1}_block{j}"
                out[name] = extract_block_params(getattr(model, name))
        for i in range(bn_ct - 1, -1, -1):
            up = getattr(model, f"dec{i + 1}_up")
            out[f"dec{i + 1}_up"] = {"lin1": _lin(up.linear1), "lin2": _lin(up.linear2),
                                     "bn1": fold_bn(up.bn1)}
            if not up.is_head:
                out[f"dec{i + 1}_up"]["bn2"] = fold_bn(up.bn2)
            name = f"dec{i + 1}_block1"
            out[name] = extract_block_params(getattr(model, name))
        for head in ("cls_head", "offset_head"):
            h = getattr(model, head)
            out[head] = {"cls": _lin(h.cls)}
            for i in range(bn_ct):
                st = getattr(h, f"stage_{i}")
                out[head][f"stage_{i}"] = {**_lin(st.dense), "bn": fold_bn(st.bn)}
    return out


# ----------------------------------------------------------------- layers

def _down(p, x, fps_idx, k: int, params: dict, mesh: Mesh):
    """TransitionDown on the rank's rows of the FPS sample ``fps_idx``
    (global): the new points, ring kNN into the old ones, the ring-gathered
    neighbourhood (relative xyz, features), Dense + BN + ReLU, max over k.
    Returns (new_p, new_x, the kNN indices)."""
    shard_m = fps_idx.shape[0] // mesh.size
    mine = fps_idx[mesh.rank * shard_m:(mesh.rank + 1) * shard_m]
    new_p = ring_gather(p, mine[:, None], mesh)[:, 0]
    kidx, _ = ring_knn(new_p, p, k, mesh)
    grouped = ring_gather(torch.cat([p, x], dim=-1), kidx, mesh)
    feats = torch.cat([grouped[..., :3] - new_p[:, None, :], grouped[..., 3:]], dim=-1)
    h = _bn_relu(F.linear(feats, params["w"]), params["bn"])
    return new_p, h.amax(dim=1), kidx


def sharded_transition_down(p, x, n_samples: int, k: int, params: dict, mesh: Mesh):
    """Eval-mode strided TransitionDown of the cloud whose rows ``p``
    ``[N/D, 3]`` / ``x`` ``[N/D, C]`` this rank holds; ``params``
    ``{"w", "bn"}`` (``extract_backbone_params``'s ``enc{i}_down``).
    Returns this rank's ``(new_p [n_samples/D, 3], new_x [n_samples/D, C'])``."""
    fps_idx = sharded_fps(p, n_samples, mesh)
    new_p, new_x, _ = _down(p, x, fps_idx, k, params, mesh)
    return new_p, new_x


def sharded_point_transformer_block(p, x, knn_idx, params: dict, mesh: Mesh):
    """Eval-mode residual PointTransformerBlock on this rank's rows ``p``,
    ``x`` with their global neighbour indices ``knn_idx`` ``[N/D, K]``; the
    neighbour rows ride the ring, the attention is K6."""
    m, k = knn_idx.shape
    h = _bn_relu(F.linear(x, params["w_lin1"]), params["bn1"])
    q = F.linear(h, params["wq"], params["bq"])
    grouped = ring_gather(torch.cat([p, h], dim=-1), knn_idx, mesh)
    p_r = (grouped[..., :3] - p[:, None, :]).reshape(m * k, 3).contiguous()
    x_g = grouped[..., 3:].reshape(m * k, -1).contiguous()
    agg = fused_vector_attention(q.contiguous(), x_g, p_r, params["attn"], k=k)
    h = _bn_relu(agg, params["bn2"])
    a, b = params["bn3"]
    return torch.relu(F.linear(h, params["w_lin3"]) * a + b + x)


def sharded_transition_up(p1, x1, p2, x2, params: dict, mesh: Mesh):
    """Eval-mode decoder TransitionUp with both resolutions sharded: the
    laterals on the rank's rows, then the 3-NN inverse-distance
    interpolation of the coarse features onto the fine points (ring kNN at
    k = 3, the rows over the ring, re-scored and re-sorted as
    ``ops.knn_interpolate`` re-scores them). Returns ``[N1/D, C]``."""
    a = _bn_relu(F.linear(x1, params["lin1"]["w"], params["lin1"]["b"]), params["bn1"])
    b = _bn_relu(F.linear(x2, params["lin2"]["w"], params["lin2"]["b"]), params["bn2"])
    kidx, _ = ring_knn(p1, p2, 3, mesh)
    neigh = ring_gather(torch.cat([p2, b], dim=-1), kidx, mesh)
    delta = p1[:, None, :] - neigh[..., :3]
    d2, order = torch.sort(_dot_fixed(delta, delta), dim=-1, stable=True)
    neigh = neigh.gather(1, order[..., None].expand(neigh.shape))
    pos = d2 > 0
    dist = torch.where(pos, torch.sqrt(torch.where(pos, d2, 1.0)), 0.0)
    recip = 1.0 / (dist + 1e-8)
    weight = recip / recip.sum(dim=-1, keepdim=True)
    return a + (neigh[..., 3:] * weight[..., None]).sum(dim=-2)


def sharded_encoder_stage(p, x, n_samples: int, k_down: int, k_attn: int,
                          down_params: dict, block_params: list, mesh: Mesh):
    """One encoder stage: TransitionDown, the stage's ring kNN once, and
    the attention blocks sharing it. Returns this rank's ``(new_p, new_x)``."""
    new_p, new_x = sharded_transition_down(p, x, n_samples, k_down, down_params, mesh)
    kidx, _ = ring_knn(new_p, new_p, k_attn, mesh)
    for bp in block_params:
        new_x = sharded_point_transformer_block(new_p, new_x, kidx, bp, mesh)
    return new_p, new_x


def check_shapes(n: int, stride, mesh: Mesh) -> list[int]:
    """The stage sizes of an ``n``-point cloud; raises unless ``n`` divides
    by D times every cumulative stride product."""
    sizes, prod = [], 1
    for s in stride:
        prod *= s
        if n % (mesh.size * prod):
            raise ValueError(f"N = {n} does not divide by D x stride product "
                             f"{mesh.size} x {prod}")
        sizes.append(n // prod)
    return sizes


def sharded_backbone_forward(feat: torch.Tensor, params: dict, mesh: Mesh) -> dict:
    """The point-sharded eval forward of ``PointTransformerSeg``: this
    rank's rows ``feat`` ``[N/D, c]`` (xyz first) of a fully valid cloud of
    N points, ``params`` from :func:`extract_backbone_params`.

    Returns this rank's rows of ``sem_1`` ``[N/D, k]``, ``offset_1``
    ``[N/D, 3]`` and ``embed`` ``[N/D, planes[0]]``, the dense module's eval
    outputs, and what the path chose: ``fps_idx`` (one global index tensor
    per strided stage, the same on every rank) and ``knn_idx`` (each
    stage's global neighbour lists of this rank's rows)."""
    arch = params["arch"]
    stride, nsample, blocks = arch["stride"], arch["nsample"], arch["blocks"]
    bn_ct = arch["block_num"]
    sizes = check_shapes(feat.shape[0] * mesh.size, stride, mesh)
    p = feat[:, :3].to(torch.float32).contiguous()
    x = feat.to(torch.float32)

    stages, fps_list = [], []
    full_res = True
    for i in range(bn_ct):
        dp = params[f"enc{i + 1}_down"]
        if stride[i] == 1:
            x = _bn_relu(F.linear(x, dp["w"]), dp["bn"])
        else:
            fps_idx = sharded_fps(p, sizes[i], mesh)
            fps_list.append(fps_idx)
            p, x, _ = _down(p, x, fps_idx, nsample[i], dp, mesh)
            full_res = False
        if i > 0 and stride[i] == 1 and nsample[i] <= nsample[i - 1]:
            kidx = stages[i - 1]["kidx"][:, :nsample[i]]   # exact lists: a prefix
        else:
            kidx, _ = ring_knn(p, p, nsample[i], mesh)
        for j in range(1, blocks[i]):
            x = sharded_point_transformer_block(p, x, kidx,
                                                params[f"enc{i + 1}_block{j}"], mesh)
        stages.append({"p": p, "x": x, "kidx": kidx, "full_res": full_res,
                       "same_p": stride[i] == 1 and i > 0})

    # the bottleneck: the cloud's mean (an all-reduce), Dense + ReLU,
    # concat, Dense + BN + ReLU, one block on the summit points
    top = stages[-1]
    hp = params[f"dec{bn_ct}_up"]
    total = top["x"].sum(dim=0)
    dist.all_reduce(total, group=mesh.group)
    mean = total / sizes[-1]
    g = torch.relu(F.linear(mean, hp["lin2"]["w"], hp["lin2"]["b"]))
    h = torch.cat([top["x"], g[None, :].expand(top["x"].shape[0], -1)], dim=-1)
    h = _bn_relu(F.linear(h, hp["lin1"]["w"], hp["lin1"]["b"]), hp["bn1"])
    up_x = [None] * bn_ct
    up_x[-1] = sharded_point_transformer_block(top["p"], h, top["kidx"],
                                               params[f"dec{bn_ct}_block1"], mesh)
    for i in range(bn_ct - 2, -1, -1):
        lo, hi = stages[i], stages[i + 1]
        up = params[f"dec{i + 1}_up"]
        if hi["same_p"]:   # a stride-1 lateral: the interpolation is the identity
            a = _bn_relu(F.linear(lo["x"], up["lin1"]["w"], up["lin1"]["b"]), up["bn1"])
            x = a + _bn_relu(F.linear(up_x[i + 1], up["lin2"]["w"], up["lin2"]["b"]),
                             up["bn2"])
        else:
            x = sharded_transition_up(lo["p"], lo["x"], hi["p"], up_x[i + 1], up, mesh)
        up_x[i] = sharded_point_transformer_block(lo["p"], x, lo["kidx"],
                                                  params[f"dec{i + 1}_block1"], mesh)

    # 1-NN upsample indices shared by both heads (identity at full resolution)
    p0 = stages[0]["p"]
    up1 = [None] + [None if st["full_res"] else ring_knn(p0, st["p"], 1, mesh)[0]
                    for st in stages[1:]]

    def multi_head(hp):
        collect = []
        for i in range(bn_ct):
            sp = hp[f"stage_{i}"]
            lat = _bn_relu(F.linear(up_x[i], sp["w"], sp["b"]), sp["bn"])
            if up1[i] is not None:
                lat = ring_gather(lat, up1[i], mesh)[:, 0]
            collect.append(lat)
        return F.linear(torch.cat(collect, dim=-1), hp["cls"]["w"], hp["cls"]["b"])

    return {"sem_1": multi_head(params["cls_head"]),
            "offset_1": multi_head(params["offset_head"]),
            "embed": up_x[0], "fps_idx": fps_list,
            "knn_idx": [st["kidx"] for st in stages]}

