"""The port's CUDA kernels against their plain PyTorch twins, on the card.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_port_kernels.py -m cuda -q

Without a card every test skips (the kernels have no CPU mode); the twins are
held to the JAX package by tests/test_torch_port_ops.py.
"""

import numpy as np
import pytest
import torch

from toothgroupnetwork_tpu_torch.models.point_transformer.backbone import (
    PointTransformerLayer)
from toothgroupnetwork_tpu_torch.ops.kernels import attention, fps, knn
from toothgroupnetwork_tpu_torch.utils.weights import randomize_


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture
def gen():
    return np.random.default_rng(0)


def _cloud(gen, *shape, device):
    return torch.from_numpy(gen.standard_normal(shape).astype(np.float32)).to(device)


@pytest.mark.cuda
class TestKernelsOnCard:
    @pytest.mark.parametrize("b,n,m", [(3, 2000, 300), (1, 24000, 600),
                                       (16, 3072, 768)])
    def test_fps(self, cuda_device, gen, b, n, m):
        xyz = _cloud(gen, b, n, 3, device=cuda_device)
        mask = torch.from_numpy(gen.random((b, n)) > 0.1).to(cuda_device)
        got = fps.fps(xyz, m, mask)
        torch.cuda.synchronize()
        ref = fps.fps_reference(xyz, m, mask)
        assert torch.equal(got, ref)
        got = fps.fps(xyz, m)
        ref = fps.fps_reference(xyz, m)
        assert torch.equal(got, ref)

    def test_fps_exhausted(self, cuda_device, gen):
        xyz = _cloud(gen, 2, 64, 3, device=cuda_device)
        mask = torch.zeros((2, 64), dtype=torch.bool, device=cuda_device)
        mask[0, :10] = True
        got = fps.fps(xyz, 16, mask.contiguous())
        assert torch.equal(got, fps.fps_reference(xyz, 16, mask))
        assert (got[1] == 0).all()

    @pytest.mark.parametrize("k", [1, 3, 24, 36, 64])
    def test_knn(self, cuda_device, gen, k):
        pts = _cloud(gen, 2, 3000, 3, device=cuda_device)
        bias = torch.where(torch.from_numpy(gen.random((2, 3000)) > 0.2),
                           0.0, 1e10).to(torch.float32).to(cuda_device)
        gi, gd = knn.knn_select(pts, pts, k, bias)
        ri, rd = knn.knn_select_reference(pts, pts, k, bias)
        torch.cuda.synchronize()
        assert torch.equal(gi, ri) and torch.equal(gd, rd)

    def test_knn_tail(self, cuda_device, gen):
        pts = _cloud(gen, 2, 10, 3, device=cuda_device)
        q = _cloud(gen, 2, 50, 3, device=cuda_device)
        gi, gd = knn.knn_select(q, pts, 24)
        ri, rd = knn.knn_select_reference(q, pts, 24)
        assert torch.equal(gi, ri) and torch.equal(gd, rd)
        assert (gi[..., 10:] == 0).all() and (gd[..., 10:] == 1e10).all()

    @pytest.mark.parametrize("b,n,kk,c", [(2, 300, 16, 32), (1, 500, 36, 16),
                                          (1, 93, 24, 512), (2, 64, 36, 512)])
    def test_attention(self, cuda_device, gen, b, n, kk, c):
        port = PointTransformerLayer(c, device=cuda_device)
        randomize_(port, torch.Generator().manual_seed(0))
        p = _cloud(gen, b, n, 3, device=cuda_device) * 0.2
        x = _cloud(gen, b, n, c, device=cuda_device) * 0.2
        idx = torch.from_numpy(gen.integers(0, n, (b, n, kk)).astype(np.int32)
                               ).to(cuda_device)
        idx[..., -1] = 0                     # the k > n tail repeats index 0
        with torch.no_grad():
            params = attention.fold_attention_params(port)
            q = port.linear_q(x).reshape(-1, c).contiguous()
            got = attention.fused_vector_attention(x, p, idx, q, params)
            ref = attention.fused_vector_attention_reference(x, p, idx, q, params)
        torch.cuda.synchronize()
        assert (got - ref).abs().max().item() <= 1e-4
