"""A training reference of the ``pointnet`` task, written as a later model's
``reference/pointnet.py`` would be: the tests copy it into a copy of the
benchmark to show that a training cell of another task comes in as new
files alone.

PointNet segmentation at ``scale`` s (the port's ``models/pointnet.py``):
an input transformer (per-point 64-128-1024, the masked max, 512 and 256
with LayerNorms, a 3 x 3 identity plus delta) on xyz, a 64s MLP, a
64s x 64s feature transformer, 128s and 1024s MLPs, the masked max joined
to the per-point features, a 512s-256s-128s head and 17 logits; every MLP
Dense + masked batch statistics + ReLU, the 1024s one without the ReLU.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from counts import dense_flops

from .ops import Precision, linear
from .training import batches, batchnorm_train, dropout_seed, seg_loss  # noqa: F401


class TrainReference:
    def __init__(self, params: dict, buffers: dict, config: dict,
                 prec: Precision = Precision()):
        self.p = {n: t.detach().clone().float() for n, t in params.items()}
        self.b = {n: t.detach().clone().float() for n, t in buffers.items()}
        self.prec = prec

    def dense(self, w, x, name):
        return linear(x, w[name + ".weight"], w.get(name + ".bias"), self.prec)

    def mlp(self, w, x, name, layers, mask, last_relu=True):
        for i in range(layers):
            x = batchnorm_train(self.dense(w, x, f"{name}.dense_{i}"), w, f"{name}.bn_{i}",
                                mask, self.b)
            x = F.relu(x) if i < layers - 1 or last_relu else x
        return x

    def layer_norm(self, w, x, name):
        mean = x.mean(dim=-1, keepdim=True)
        var = torch.clamp_min((x * x).mean(dim=-1, keepdim=True) - mean * mean, 0.0)
        return (x - mean) * (torch.rsqrt(var + 1e-6) * w[name + ".scale"]) + w[name + ".bias"]

    def masked_max(self, x, mask):
        return torch.where(mask[..., None], x, torch.tensor(-1e30, device=x.device)).amax(1)

    def transformer(self, w, x, name, k, mask):
        g = self.masked_max(self.mlp(w, x, name + ".PointMLP_0", 3, mask), mask)
        g = F.relu(self.layer_norm(w, self.dense(w, g, name + ".Dense_0"), name + ".LayerNorm_0"))
        g = F.relu(self.layer_norm(w, self.dense(w, g, name + ".Dense_1"), name + ".LayerNorm_1"))
        delta = self.dense(w, g, name + ".Dense_2")
        return (delta + torch.eye(k, device=x.device).reshape(1, -1)).reshape(-1, k, k)

    def forward(self, w, feat, mask):
        x = feat.float()
        trans = self.transformer(w, x, "feat.stn", 3, mask)
        x = torch.cat([torch.bmm(x[..., :3], trans), x[..., 3:]], dim=-1)
        x = self.mlp(w, x, "feat.mlp1", 1, mask)
        x = torch.bmm(x, self.transformer(w, x, "feat.fstn", x.shape[-1], mask))
        g = self.masked_max(self.mlp(w, self.mlp(w, x, "feat.mlp2", 1, mask), "feat.mlp3", 1,
                                     mask, last_relu=False), mask)
        x = torch.cat([g[:, None, :].expand(-1, x.shape[1], -1), x], dim=-1)
        return self.dense(w, self.mlp(w, x, "head", 3, mask), "cls")

    def gradients(self, batch: dict, generator) -> tuple[float, dict]:
        w = {n: t.clone().requires_grad_(True) for n, t in self.p.items()}
        logits = self.forward(w, batch["feat"], batch["mask"])
        loss = seg_loss(logits, batch["gt_seg_label"], batch["mask"])
        grads = torch.autograd.grad(loss, list(w.values()), allow_unused=True)
        return float(loss.detach()), dict(zip(w, grads))


def train_flops(config: dict) -> float:
    """Three times the forward's Dense and transform products."""
    s, rows = config["model_parameter"]["scale"], config["batch_size"] * config["n_points"]
    b, f = config["batch_size"], 64 * s

    def transformer(din, k):
        return (dense_flops(rows, din, 64) + dense_flops(rows, 64, 128)
                + dense_flops(rows, 128, 1024) + dense_flops(b, 1024, 512)
                + dense_flops(b, 512, 256) + dense_flops(b, 256, k * k)
                + dense_flops(rows, k, k))

    forward = (transformer(6, 3) + dense_flops(rows, 6, f) + transformer(f, f)
               + dense_flops(rows, f, 2 * f) + dense_flops(rows, 2 * f, 16 * f)
               + dense_flops(rows, 17 * f, 8 * f) + dense_flops(rows, 8 * f, 4 * f)
               + dense_flops(rows, 4 * f, 2 * f) + dense_flops(rows, 2 * f, 17))
    return 3.0 * forward


def kernel_bounds_s(config: dict) -> dict:
    """PointNet's step calls none of the port's kernels."""
    return {}
