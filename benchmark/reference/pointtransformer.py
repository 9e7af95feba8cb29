"""Plain eval-mode forward of the point-transformer segmentation U-Net
(Zhao et al., Point Transformer, arXiv:2012.09164, as the tgnet models use
it), from a flat dict of weights named as in the JAX ``.npz`` layout with
``/`` read as ``.`` (``params/.../kernel`` as ``....weight`` ``[out, in]``).

Per stage: FPS to N / stride and a max-pooled kNN grouping (stride > 1) or a
Dense (stride 1), one self-kNN shared by the stage's blocks, blocks of
Dense + vector attention + Dense with residuals; the decoder concatenates a
per-cloud mean at the bottleneck and adds 3-NN interpolations on the way
up; the two heads take a 32-wide MLP of every stage, upsampled to full
resolution by the 1-NN, and a last Dense. The attention projects k and v
per point and gathers them after (a Dense acts row by row, so this is the
gathered rows' projection), which is also the work the FLOP count assumes.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops import (Precision, batchnorm_eval, fps, index_points, interpolate3,
                  knn_points, linear, masked_mean)

SHARE_PLANES = 8


def load_npz(path: str, device) -> dict:
    """Flat ``name -> float32 tensor`` of a JAX-layout ``.npz``."""
    out = {}
    with np.load(path) as data:
        for key in data.files:
            parts = key.split("/")[1:]
            arr = data[key]
            if parts[-1] == "kernel":
                parts[-1], arr = "weight", arr.T
            out[".".join(parts)] = torch.from_numpy(
                np.ascontiguousarray(arr, np.float32)).to(device)
    return out


class Backbone:
    """One ``PointTransformerSeg`` of the weights under ``prefix``."""

    def __init__(self, w: dict, prefix: str, arch: dict, prec: Precision):
        self.w, self.pre, self.prec = w, prefix + ".", prec
        self.stride = tuple(arch["stride"])
        self.nsample = tuple(arch["nsample"])
        self.blocks = tuple(arch["blocks"])
        self.bn = arch["block_num"]

    def dense(self, x, name):
        w = self.w[self.pre + name + ".weight"]
        return linear(x, w, self.w.get(self.pre + name + ".bias"), self.prec)

    def norm(self, x, name):
        return batchnorm_eval(x, self.w, self.pre + name)

    def attention(self, name, p, x, idx):
        b, n, kk = idx.shape
        q = self.dense(x, name + ".linear_q")
        k_g = index_points(self.dense(x, name + ".linear_k"), idx)
        v_g = index_points(self.dense(x, name + ".linear_v"), idx)
        p_r = index_points(p, idx) - p[:, :, None, :]
        pe = self.dense(p_r, name + ".linear_p0")
        pe = self.dense(torch.relu(self.norm(pe, name + ".linear_p_bn")),
                        name + ".linear_p1")
        w = k_g - q[:, :, None, :] + pe
        w = self.dense(torch.relu(self.norm(w, name + ".linear_w_bn0")),
                       name + ".linear_w0")
        w = self.dense(torch.relu(self.norm(w, name + ".linear_w_bn1")),
                       name + ".linear_w1")
        ex = torch.exp(w - w.amax(dim=2, keepdim=True))
        w = ex / ex.sum(dim=2, keepdim=True)
        w_full = w.repeat(1, 1, 1, v_g.shape[-1] // w.shape[-1])
        return ((v_g + pe) * w_full).sum(dim=2)

    def block(self, name, p, x, idx):
        h = torch.relu(self.norm(self.dense(x, name + ".linear1"), name + ".bn1"))
        h = torch.relu(self.norm(self.attention(name + ".transformer", p, h, idx),
                                 name + ".bn2"))
        h = self.norm(self.dense(h, name + ".linear3"), name + ".bn3")
        return torch.relu(h + x)

    def down(self, i, p, x, mask):
        name = f"enc{i + 1}_down"
        if self.stride[i] == 1:
            return p, torch.relu(self.norm(self.dense(x, name + ".linear"),
                                           name + ".bn")), mask
        m = x.shape[1] // self.stride[i]
        sel = fps(p, m, mask)
        new_p = index_points(p, sel)
        new_mask = None if mask is None else index_points(mask[..., None], sel)[..., 0]
        idx, _ = knn_points(new_p, p, self.nsample[i], mask, need_dist=False)
        grouped = torch.cat([index_points(p, idx) - new_p[:, :, None, :],
                             index_points(x, idx)], dim=-1)
        h = torch.relu(self.norm(self.dense(grouped, name + ".linear"), name + ".bn"))
        return new_p, h.amax(dim=2), new_mask

    def up(self, i, p1, x1, mask1, p2=None, x2=None, mask2=None):
        name = f"dec{i + 1}_up"
        if x2 is None:
            g = torch.relu(self.dense(masked_mean(x1, mask1, 1), name + ".linear2"))
            h = torch.cat([x1, g[:, None, :].expand(-1, x1.shape[1], -1)], dim=-1)
            return torch.relu(self.norm(self.dense(h, name + ".linear1"), name + ".bn1"))
        a = torch.relu(self.norm(self.dense(x1, name + ".linear1"), name + ".bn1"))
        b = torch.relu(self.norm(self.dense(x2, name + ".linear2"), name + ".bn2"))
        return a + (b if p1 is p2 else interpolate3(p1, p2, b, mask1, mask2))

    def head_input(self, name, xs, up1, masks):
        """What the head's last Dense takes: each stage's 32-wide MLP at
        full resolution, concatenated."""
        cols = []
        for i, (x, mask) in enumerate(zip(xs, masks)):
            lat = torch.relu(self.norm(self.dense(x, f"{name}.stage_{i}.dense"),
                                       f"{name}.stage_{i}.bn"))
            cols.append(lat if up1[i] is None else index_points(lat, up1[i]))
        return torch.cat(cols, dim=-1)

    def __call__(self, feat, mask=None):
        h = self.head_inputs(feat, mask)
        return {"sem_1": self.dense(h["cls_head"], "cls_head.cls"),
                "offset_1": self.dense(h["offset_head"], "offset_head.cls")}

    def head_inputs(self, feat, mask=None):
        p, x = feat[..., :3].float().contiguous(), feat.float()
        stages = []
        for i in range(self.bn):
            p, x, mask = self.down(i, p, x, mask)
            if i > 0 and self.stride[i] == 1 and self.nsample[i] <= self.nsample[i - 1]:
                idx = stages[i - 1]["idx"][..., :self.nsample[i]]
            else:
                idx, _ = knn_points(p, p, self.nsample[i], mask, include_self=True,
                                    need_dist=False)
            for j in range(1, self.blocks[i]):
                x = self.block(f"enc{i + 1}_block{j}", p, x, idx)
            stages.append({"p": p, "x": x, "mask": mask, "idx": idx})
        bn = self.bn
        top = stages[-1]
        x = self.up(bn - 1, top["p"], top["x"], top["mask"])
        x = self.block(f"dec{bn}_block1", top["p"], x, top["idx"])
        ups = [None] * bn
        ups[-1] = x
        for i in range(bn - 2, -1, -1):
            lo, hi = stages[i], stages[i + 1]
            x = self.up(i, lo["p"], lo["x"], lo["mask"], hi["p"], ups[i + 1], hi["mask"])
            ups[i] = self.block(f"dec{i + 1}_block1", lo["p"], x, lo["idx"])
        p0, m0 = stages[0]["p"], stages[0]["mask"]
        up1 = [None]
        for st in stages[1:]:
            if st["p"] is p0:
                up1.append(None)
            else:
                up1.append(knn_points(p0, st["p"], 1, st["mask"],
                                      need_dist=False)[0][..., 0])
        masks = [st["mask"] for st in stages]
        return {name: self.head_input(name, ups, up1, masks)
                for name in ("cls_head", "offset_head")}
