"""Point-Transformer segmentation backbone (counterpart of
toothgroupnetwork_tpu/models/point_transformer/backbone.py).

Dense padded ``[B, N, C]`` tensors with per-stage static sizes (24000 -> 6000
-> 1500 -> 375 -> 93 at stride (1,4,4,4,4)). Submodule attribute names are
the flax module names, so a flax checkpoint maps onto ``state_dict`` keys
mechanically (utils/weights.py). Structure kept from the JAX package:
  * one kNN neighbourhood per stage, shared by every block of the stage,
  * a stride-1 stage with a no-larger k reuses the previous stage's kNN
    k-prefix (exact kNN lists are ascending),
  * a stride-1 TransitionUp and a stride-1 head upsample are the identity,
  * in eval mode every attention layer runs the fused kernel K3
    (ops/kernels/attention.py), which computes the relative positions from
    ``p`` and the kNN indices itself (the JAX package hoists that gather per
    stage),
  * in train mode every BatchNorm takes batch statistics over the points
    its mask keeps (the neighbourhood BNs over the flattened ``[B*N*K]``
    mask) and each attention layer runs the JAX package's unfused graph
    (its ``xla`` mode, the one it always trains through) in torch ops under
    autograd, over relative positions gathered once per stage; no kernel
    has a backward, as no Pallas kernel has one. The modules are built in
    eval mode (the serving path); ``train()`` selects the train forward,
  * with ``cell_attention`` (eval, B == 1, N % 8 == 0, points still in the
    caller's spatially sorted order; ``TGN_TPU_CELLS=off`` turns it off, as
    in the JAX package) a stage builds a super-row candidate context instead
    (ops/cells.py): the relative positions are selected once per stage
    through K5, each layer selects its neighbour rows through K4 and runs K6
    on the gathered rows,
  * ``dtype`` is the compute dtype of the body (float32, or bfloat16 for
    the serving configuration), with the JAX package's casts: geometry
    ``p`` stays float32, the features, every Dense and BatchNorm and the
    relative positions run in ``dtype``, the attention kernels compute in
    float32 from ``dtype`` inputs, and the two heads' last Dense (``cls``)
    runs in float32, so logits and offsets come back float32.
"""

from __future__ import annotations

import os
import threading
from collections.abc import Sequence

import torch
from torch import nn

from ...nn.layers import Dense, MaskedBatchNorm, masked_mean
from ...ops import (farthest_point_sample, index_points, knn_interpolate,
                    knn_points, knn_self)
from ...ops.cells import (build_cell_candidates, gather_candidate_blocks,
                          pos_with_self_fallback)
from ...ops.kernels._launch import settle
from ...ops.kernels.attention import (fold_attention_params,
                                      fused_vector_attention,
                                      fused_vector_attention_packed_x,
                                      prepare_layouts)
from ...ops.kernels.cell_select import cell_select_p, cell_select_x
from ...parallel import points as point_shards

# guards every layer's folded parameters (PointTransformerLayer.kernel_params)
_FOLD_LOCK = threading.Lock()


class PointTransformerLayer(nn.Module):
    """Vector self-attention over a precomputed kNN neighbourhood."""

    def __init__(self, planes: int, share_planes: int = 8, *, device,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        mid = out = planes
        cs = out // share_planes
        kw = dict(device=device, dtype=dtype)
        self.linear_q = Dense(planes, mid, **kw)
        self.linear_k = Dense(planes, mid, **kw)
        self.linear_v = Dense(planes, out, **kw)
        self.linear_p0 = Dense(3, 3, **kw)
        self.linear_p_bn = MaskedBatchNorm(3, **kw)
        self.linear_p1 = Dense(3, out, **kw)
        self.linear_w_bn0 = MaskedBatchNorm(mid, **kw)
        self.linear_w0 = Dense(mid, mid // share_planes, **kw)
        self.linear_w_bn1 = MaskedBatchNorm(cs, **kw)
        self.linear_w1 = Dense(cs, cs, **kw)
        self._folded, self._folded_key = None, None
        self.eval()

    def kernel_params(self) -> dict:
        """``fold_attention_params(self, self.dtype)``, folded once and kept
        (with the kernel layouts the wrappers add to it) until a parameter
        or buffer of the layer changes: in place (its version counter moves;
        ``load_state_dict``, ``load_npz`` and ``copy_`` all count) or
        replaced. A layer whose tensors were made under
        ``torch.inference_mode`` has no version counters and folds anew each
        call. The fold itself is made outside inference mode, so its tensors
        keep version counters and the kernel layouts kept in the dict
        (``attention.cached_layout``) last across calls of an
        inference-mode pipeline."""
        state = [*self.parameters(), *self.buffers()]
        if any(t.is_inference() for t in state):
            return fold_attention_params(self, self.dtype)
        key = (self.dtype, *((id(t), t.data_ptr(), t.device, t._version) for t in state))
        # scans in flight on several streams share the fold: it is made
        # under a lock and kept only once its stream has finished it
        with _FOLD_LOCK:
            if key != self._folded_key:
                with torch.inference_mode(False), torch.no_grad():
                    folded = fold_attention_params(self, self.dtype)
                settle(folded)
                self._folded, self._folded_key = folded, key
            return self._folded

    def forward(self, p, x, knn_idx, cell=None, mask=None, p_r=None):
        """``cell``: the stage's ``(cand, pos, p_r)`` candidate context
        (B == 1, p_r in the model dtype), or None for the fused-gather
        kernel K3. In train mode: ``mask`` ``[B, N]`` (or None) and the
        stage's relative positions ``p_r`` ``[B*N*K, 3]``, and the unfused
        graph runs (:meth:`train_forward`)."""
        if self.training:
            return self.train_forward(x, knn_idx, mask, p_r)
        b, n, kk = knn_idx.shape
        q = self.linear_q(x).reshape(b * n, -1).contiguous()
        params = self.kernel_params()
        if cell is None:
            # out in the model dtype (the JAX backbone's out_dtype)
            agg = fused_vector_attention_packed_x(
                x.contiguous(), p.contiguous(), knn_idx.contiguous(), q, params)
        else:
            # q and out float32; the caller casts (backbone.py:192-194)
            cand, pos, p_r = cell
            x_g = cell_select_x(gather_candidate_blocks(x[0], cand), pos)
            agg = fused_vector_attention(q.float(), x_g.reshape(b * n * kk, -1),
                                         p_r, params, k=kk).to(self.dtype)
        return agg.reshape(b, n, -1)

    def train_forward(self, x, knn_idx, mask, p_r):
        """The JAX layer's ``xla`` branch (backbone.py:196-230): gather the
        raw rows, project k/v after the gather, the positional and weight
        MLPs with their BatchNorms over the flattened neighbourhood mask, a
        softmax over the K neighbours per channel group, and the weighted
        sum over K in float32."""
        b, n, kk = knn_idx.shape
        bn_, bnk = b * n, b * n * kk
        q = self.linear_q(x)
        x_g = index_points(x, knn_idx).reshape(bnk, -1)
        k_g, v_g = self.linear_k(x_g), self.linear_v(x_g)
        flat_mask = None
        if mask is not None:
            flat_mask = mask[..., None].expand(b, n, kk).reshape(-1)
        pe = self.linear_p0(p_r)
        pe = self.linear_p1(torch.relu(self.linear_p_bn(pe, flat_mask)))
        w = (k_g.reshape(bn_, kk, -1) - q.reshape(bn_, 1, -1)
             + pe.reshape(bn_, kk, -1)).reshape(bnk, -1)
        w = self.linear_w0(torch.relu(self.linear_w_bn0(w, flat_mask)))
        w = self.linear_w1(torch.relu(self.linear_w_bn1(w, flat_mask)))
        # the softmax step by step in the model dtype, each step rounded as
        # the JAX graph rounds it (one fused softmax rounds only its output)
        w3 = w.reshape(bn_, kk, -1)
        ex = torch.exp(w3 - w3.amax(dim=1, keepdim=True))
        w3 = ex / ex.sum(dim=1, keepdim=True)
        # channel c takes the weight of its group c % (C / share_planes)
        w_full = w3.repeat(1, 1, v_g.shape[-1] // w3.shape[-1])
        prod = (v_g + pe).reshape(bn_, kk, -1) * w_full
        return prod.float().sum(dim=1).reshape(b, n, -1).to(self.dtype)


class PointTransformerBlock(nn.Module):
    """linear+BN+ReLU -> attention+BN+ReLU -> linear+BN, + skip, ReLU."""

    def __init__(self, planes: int, share_planes: int = 8, *, device,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        kw = dict(device=device, dtype=dtype)
        self.linear1 = Dense(planes, planes, bias=False, **kw)
        self.bn1 = MaskedBatchNorm(planes, **kw)
        self.transformer = PointTransformerLayer(planes, share_planes, **kw)
        self.bn2 = MaskedBatchNorm(planes, **kw)
        self.linear3 = Dense(planes, planes, bias=False, **kw)
        self.bn3 = MaskedBatchNorm(planes, **kw)

    def forward(self, p, x, knn_idx, cell=None, mask=None, p_r=None):
        h = torch.relu(self.bn1(self.linear1(x), mask))
        h = torch.relu(self.bn2(self.transformer(p, h, knn_idx, cell, mask, p_r),
                                mask))
        h = self.bn3(self.linear3(h), mask)
        return torch.relu(h + x.to(self.dtype))


class TransitionDown(nn.Module):
    """stride > 1: FPS to N/stride, kNN-group with relative xyz,
    linear+BN+ReLU, max-pool; stride 1: linear+BN+ReLU."""

    def __init__(self, in_planes: int, out_planes: int, stride: int = 1,
                 nsample: int = 16, *, device, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride, self.nsample = stride, nsample
        din = in_planes if stride == 1 else 3 + in_planes
        self.linear = Dense(din, out_planes, bias=False, device=device, dtype=dtype)
        self.bn = MaskedBatchNorm(out_planes, device=device, dtype=dtype)

    def forward(self, p, x, mask=None):
        if self.stride == 1:
            return p, torch.relu(self.bn(self.linear(x), mask)), mask
        # the cloud's size, not a point shard's (parallel/points.py)
        m = point_shards.global_size(x.shape[1]) // self.stride
        fps_idx = farthest_point_sample(p, m, mask)
        new_p = index_points(p, fps_idx)
        new_mask = None
        if mask is not None:
            new_mask = index_points(mask[..., None], fps_idx)[..., 0]
        idx, _ = knn_points(new_p, p, self.nsample, new_mask, mask,
                            need_dist=False)
        # float32 positions beside model-dtype features: the concat is
        # float32 and the Dense casts it, as in the JAX package
        grouped = torch.cat([index_points(p, idx) - new_p[:, :, None, :],
                             index_points(x, idx)], dim=-1)
        flat_mask = None
        if new_mask is not None:
            flat_mask = new_mask[..., None].expand(idx.shape)
        h = torch.relu(self.bn(self.linear(grouped), flat_mask))
        return new_p, h.amax(dim=2), new_mask


class TransitionUp(nn.Module):
    """Decoder lateral + upsample; ``out_planes=None`` is the bottleneck head
    (concat a per-cloud mean embedding instead of upsampling)."""

    def __init__(self, in_planes: int, out_planes: int | None = None, *, device,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.is_head = out_planes is None
        self.dtype = dtype
        kw = dict(device=device, dtype=dtype)
        if self.is_head:
            self.linear2 = Dense(in_planes, in_planes, **kw)
            self.linear1 = Dense(2 * in_planes, in_planes, **kw)
            self.bn1 = MaskedBatchNorm(in_planes, **kw)
        else:
            self.linear1 = Dense(out_planes, out_planes, **kw)
            self.bn1 = MaskedBatchNorm(out_planes, **kw)
            self.linear2 = Dense(in_planes, out_planes, **kw)
            self.bn2 = MaskedBatchNorm(out_planes, **kw)

    def forward(self, p1, x1, mask1=None, p2=None, x2=None, mask2=None):
        if self.is_head:
            g = torch.relu(self.linear2(masked_mean(x1, mask1, dim=1)))
            h = torch.cat([x1.to(self.dtype),
                           g[:, None, :].expand(-1, x1.shape[1], -1)], dim=-1)
            return torch.relu(self.bn1(self.linear1(h), mask1))
        a = torch.relu(self.bn1(self.linear1(x1), mask1))
        b = torch.relu(self.bn2(self.linear2(x2), mask2))
        # stride-1 lateral: 3-NN inverse-distance interpolation onto the same
        # point set is the identity; the interpolation itself is float32
        up = b if p1 is p2 else knn_interpolate(p1, p2, b, 3, mask1, mask2)
        return (a + up).to(self.dtype)


class StageMLP(nn.Module):
    """MultiHead per-stage latent MLP: Linear + BN + ReLU."""

    def __init__(self, din: int, base_fdim: int, *, device,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dense = Dense(din, base_fdim, device=device, dtype=dtype)
        self.bn = MaskedBatchNorm(base_fdim, device=device, dtype=dtype)

    def forward(self, x, mask=None):
        return torch.relu(self.bn(self.dense(x), mask))


class MultiHead(nn.Module):
    """Per-stage latent MLPs -> 1-NN upsample to full resolution -> concat ->
    Linear(k), the last in float32 whatever the model dtype. Returns the
    logits and the per-stage latents."""

    def __init__(self, k: int, planes: Sequence[int], base_fdim: int = 32, *,
                 device, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_stages = len(planes)
        for i, c in enumerate(planes):
            self.add_module(f"stage_{i}", StageMLP(c, base_fdim, device=device,
                                                   dtype=dtype))
        self.cls = Dense(base_fdim * len(planes), k, device=device)

    def forward(self, stage_x, up1_idx, masks):
        collect, latents = [], []
        for i, (x, mask) in enumerate(zip(stage_x, masks)):
            lat = getattr(self, f"stage_{i}")(x, mask)
            latents.append(lat)
            collect.append(lat if up1_idx[i] is None else index_points(lat, up1_idx[i]))
        return self.cls(torch.cat(collect, dim=-1)), latents


class PointTransformerSeg(nn.Module):
    """The U-Net. ``forward`` returns the JAX module's dict: ``sem_1`` (and
    the same tensor as ``cls_pred``) ``[B, N, k]``, ``offset_1`` ``[B, N, 3]``,
    ``embed`` (the full-resolution decoder features ``[B, N, planes[0]]``)
    and ``cbl_stages``, one dict per up-stage with its points ``p``, the
    offset head's float32 ``latent``, ``mask`` and ``knn_idx`` (what the CBL
    loss reads)."""

    def __init__(self, k: int, c: int = 6,
                 planes: Sequence[int] = (32, 64, 128, 256, 512),
                 stride: Sequence[int] = (1, 4, 4, 4, 4),
                 nsample: Sequence[int] = (36, 24, 24, 24, 24),
                 blocks: Sequence[int] = (2, 3, 4, 6, 3),
                 block_num: int = 5, share_planes: int = 8,
                 base_fdim: int = 32, cell_attention: bool = False,
                 cell_slots: int = 32, *, device, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        # cell_attention needs the caller to feed a spatially sorted cloud
        # (ops/cells.py:spatial_sort_perm); an unsorted one loses neighbours
        # to slot overflow
        self.cell_attention, self.cell_slots = cell_attention, cell_slots
        self.planes, self.stride = tuple(planes), tuple(stride)
        self.nsample, self.blocks = tuple(nsample), tuple(blocks)
        self.block_num = bn = block_num
        kw = dict(device=device, dtype=dtype)
        for i in range(bn):
            din = c if i == 0 else planes[i - 1]
            self.add_module(f"enc{i + 1}_down", TransitionDown(
                din, planes[i], stride[i], nsample[i], **kw))
            for j in range(1, blocks[i]):
                self.add_module(f"enc{i + 1}_block{j}", PointTransformerBlock(
                    planes[i], share_planes, **kw))
        self.add_module(f"dec{bn}_up", TransitionUp(planes[bn - 1], None, **kw))
        self.add_module(f"dec{bn}_block1", PointTransformerBlock(
            planes[bn - 1], share_planes, **kw))
        for i in range(bn - 2, -1, -1):
            self.add_module(f"dec{i + 1}_up", TransitionUp(
                planes[i + 1], planes[i], **kw))
            self.add_module(f"dec{i + 1}_block1", PointTransformerBlock(
                planes[i], share_planes, **kw))
        self.cls_head = MultiHead(k, planes[:bn], base_fdim, **kw)
        self.offset_head = MultiHead(3, planes[:bn], base_fdim, **kw)
        self.eval()

    def prepare_kernel_state(self) -> None:
        """Fold every attention layer's parameters and, on a CUDA device,
        build the kernel layouts its forward reads (K3's; with
        ``cell_attention`` K6's too) on the calling thread, so that scans
        served from several threads only read them. The caller waits for
        the card before those threads start."""
        for m in self.modules():
            if isinstance(m, PointTransformerLayer):
                params = m.kernel_params()
                dev = m.linear_q.weight.device
                if dev.type == "cuda":
                    prepare_layouts(params, m.dtype, dev,
                                    gathered=self.cell_attention)

    def _cells_apply(self, b: int, n: int) -> bool:
        """Whether a stage of ``b`` clouds of ``n`` points in the caller's
        order takes the cell path: not in train mode, B == 1, N a multiple
        of 8, and not ``TGN_TPU_CELLS=off`` in the environment (the JAX
        package's switch)."""
        return (self.cell_attention and not self.training and b == 1
                and n % 8 == 0
                and os.environ.get("TGN_TPU_CELLS", "on") != "off")

    def attention_entry(self, b: int, n: int) -> str:
        """The attention entry of the first stage's layers on ``b`` clouds of
        ``n`` points: ``"unfused"`` in train mode, ``"K6"`` where the cell
        path applies, else ``"K3"``."""
        if self.training:
            return "unfused"
        return "K6" if self.stride[0] == 1 and self._cells_apply(b, n) else "K3"

    def _cell_ctx(self, p, knn_idx):
        """The stage's ``(cand, pos)`` candidate context, or None where the
        path does not apply (:meth:`_cells_apply`)."""
        b, n, _ = knn_idx.shape
        if not self._cells_apply(b, n):
            return None
        cand, pos, _ = build_cell_candidates(knn_idx[0], self.cell_slots)
        return cand, pos_with_self_fallback(pos, self.cell_slots * 8)

    def forward(self, feat, mask=None):
        bn = self.block_num
        p = feat[..., :3].to(torch.float32).contiguous()  # geometry stays f32
        x = feat.to(self.dtype)

        stages = []
        sorted_chain = True  # points still in the caller's (sorted) order?
        for i in range(bn):
            p, x, mask = getattr(self, f"enc{i + 1}_down")(p, x, mask)
            if self.stride[i] != 1:
                sorted_chain = False  # FPS subset: selection order
            reuse = (i > 0 and self.stride[i] == 1
                     and self.nsample[i] <= self.nsample[i - 1])
            if reuse:
                knn_idx = stages[i - 1]["knn_idx"][..., :self.nsample[i]].contiguous()
            else:
                knn_idx, _ = knn_self(p, self.nsample[i], mask)
            ctx = self._cell_ctx(p, knn_idx) if sorted_chain else None
            cell = p_r = None
            if self.training:
                # relative positions gathered once per stage, for every
                # block of it (encoder and decoder)
                p_r = ((index_points(p, knn_idx) - p[:, :, None, :])
                       .reshape(-1, 3).to(self.dtype))
            if ctx is not None:
                prev = stages[i - 1]["cell"] if reuse else None
                if prev is not None:
                    # the previous stage's relative positions, k-prefix (only
                    # the candidate context is rebuilt for the smaller k)
                    k0 = self.nsample[i - 1]
                    p_r = (prev[2].reshape(-1, k0, 3)[:, :self.nsample[i]]
                           .reshape(-1, 3).contiguous())
                else:
                    p_r = cell_select_p(gather_candidate_blocks(p[0], ctx[0]),
                                        ctx[1], p[0]).reshape(-1, 3).to(self.dtype)
                cell = (*ctx, p_r)
            for j in range(1, self.blocks[i]):
                x = getattr(self, f"enc{i + 1}_block{j}")(p, x, knn_idx, cell,
                                                          mask, p_r)
            stages.append({"p": p, "x": x, "mask": mask, "knn_idx": knn_idx,
                           "cell": cell, "p_r": p_r})

        top = stages[bn - 1]
        x = getattr(self, f"dec{bn}_up")(top["p"], top["x"], top["mask"])
        x = getattr(self, f"dec{bn}_block1")(top["p"], x, top["knn_idx"],
                                             top["cell"], top["mask"], top["p_r"])
        up_x = [None] * bn
        up_x[bn - 1] = x
        for i in range(bn - 2, -1, -1):
            lo, hi = stages[i], stages[i + 1]
            x = getattr(self, f"dec{i + 1}_up")(lo["p"], lo["x"], lo["mask"],
                                                hi["p"], up_x[i + 1], hi["mask"])
            x = getattr(self, f"dec{i + 1}_block1")(lo["p"], x, lo["knn_idx"],
                                                    lo["cell"], lo["mask"],
                                                    lo["p_r"])
            up_x[i] = x

        # 1-NN upsample indices shared by both heads; a stage that kept the
        # full-resolution points (all strides so far 1) maps by identity
        # (None: no gather)
        p0, m0 = stages[0]["p"], stages[0]["mask"]
        up1_idx = [None]
        for i in range(1, bn):
            if stages[i]["p"] is p0:
                up1_idx.append(None)
            else:
                idx, _ = knn_points(p0, stages[i]["p"], 1, m0, stages[i]["mask"],
                                    need_dist=False)
                up1_idx.append(idx[..., 0])
        masks = [st["mask"] for st in stages]
        sem, _ = self.cls_head(up_x, up1_idx, masks)
        offset, latents = self.offset_head(up_x, up1_idx, masks)
        cbl_stages = [{"p": st["p"], "latent": lat.float(), "mask": st["mask"],
                       "knn_idx": st["knn_idx"]} for st, lat in zip(stages, latents)]
        return {"sem_1": sem, "cls_pred": sem, "offset_1": offset,
                "embed": up_x[0], "cbl_stages": cbl_stages}
