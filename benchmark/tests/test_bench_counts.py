"""The yardstick: the kernel bounds pinned to the port's kernel table, and
the FLOP functions held to ``FlopCounterMode`` over the plain references."""

from __future__ import annotations

import json
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import BENCH

sys.path.insert(0, str(BENCH))

import counts  # noqa: E402
from reference import dgcnn  # noqa: E402
from reference.ops import Precision  # noqa: E402
from reference.pointtransformer import Backbone  # noqa: E402


@pytest.mark.parametrize("c, ms", [(6, 0.082), (64, 0.580)])
def test_k2_bound_pinned(c, ms):
    # PERF.md's kernel table: K2 self [1,24000] k 20 at C = 6 and 64
    assert round(counts.knn_bound_s(c, 1, 24000, 24000, 20, True) * 1e3, 3) == ms


def test_k1_bound_pinned():
    # PERF.md's kernel table: K1 [1,24000] -> 6000
    assert round(counts.fps_bound_s(1, 24000, 6000) * 1e3, 4) == 0.0215


def random_weights(arch: dict, k: int, gen) -> dict:
    """The reference's weights of one backbone, named as the counts read
    them, drawn at random."""
    from toothgroupnetwork_tpu_torch.models.point_transformer import PointTransformerSeg

    model = PointTransformerSeg(k=k, **arch, device="cpu")
    return {"m." + n: torch.randn(t.shape, generator=gen) * 0.1 + (1.0 if n.endswith(".var")
                                                                   else 0.0)
            for n, t in model.state_dict().items()}


@pytest.mark.parametrize("arch, b, n", [
    (dict(planes=(8, 16, 16, 24, 32), stride=(1, 4, 4, 4, 4), nsample=(8, 6, 6, 6, 6),
          blocks=(2, 3, 2, 2, 2), block_num=5), 1, 1024),
    (dict(planes=(16, 32), stride=(1, 1), nsample=(12, 8), blocks=(2, 3), block_num=2),
     3, 256),
])
def test_backbone_flops(arch, b, n):
    gen = torch.Generator().manual_seed(0)
    k = 10 if b == 1 else 2
    net = Backbone(random_weights(arch, k, gen), "m", arch, Precision())
    feat = torch.randn(b, n, 6, generator=gen)
    with FlopCounterMode(display=False) as fc:
        net(feat)
    assert fc.get_total_flops() == counts.backbone_flops(arch, k, b, n)


def test_dgcnn_flops():
    from toothgroupnetwork_tpu_torch.models.dgcnn import DGCNNSeg

    gen = torch.Generator().manual_seed(0)
    model = DGCNNSeg(num_classes=17, k=5, device="cpu")
    params = {n: torch.randn(p.shape, generator=gen) * 0.1
              for n, p in model.named_parameters()}
    buffers = {n: b.clone() for n, b in model.named_buffers()}
    cfg = {"batch_size": 1, "n_points": 300, "model_parameter": {"k": 5}}
    ref = dgcnn.TrainReference(params, buffers, cfg)
    feat = torch.randn(1, 300, 6, generator=gen)
    with FlopCounterMode(display=False) as fc:
        ref.forward(ref.p, feat, None, torch.Generator().manual_seed(1))
    assert fc.get_total_flops() == dgcnn.forward_flops(1, 300, 5)
    assert dgcnn.train_flops(cfg) == 3 * dgcnn.forward_flops(1, 300, 5)


def test_dgcnn_yardstick_pinned():
    # the dgcnn configuration's step FLOPs and K2 bound, which train.mfu and
    # k2_roofline read: held bit-equal so that a move of the yardstick
    # cannot move the metrics
    cfg = json.loads((BENCH / "configs" / "dgcnn.json").read_text())
    assert dgcnn.train_flops(cfg) == 210456576000.0
    assert dgcnn.kernel_bounds_s(cfg) == {"k2": 0.0012423161194029851}
