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
from toothgroupnetwork_tpu_torch.ops import cells, knn_self
from toothgroupnetwork_tpu_torch.ops.kernels import (attention, cell_select, fps,
                                                     knn)
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
                                          (1, 93, 24, 512), (2, 64, 36, 512),
                                          (2, 300, 10, 16)])
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
            got = attention.fused_vector_attention_packed_x(x, p, idx, q, params)
            ref = attention.fused_vector_attention_packed_x_reference(
                x, p, idx, q, params)
        torch.cuda.synchronize()
        assert (got - ref).abs().max().item() <= 1e-4


def _cell_inputs(gen, n, kk, c, n_slots, device):
    """A spatially sorted sheet, its self-kNN and candidate context."""
    u = gen.uniform(-1, 1, (n, 2))
    xyz = np.stack([u[:, 0], 0.3 * u[:, 0] ** 2 + 0.2 * u[:, 1] ** 2, u[:, 1]], 1)
    xyz = xyz.astype(np.float32)
    xyz = torch.from_numpy(xyz[cells.spatial_sort_perm(xyz, slab=256)]).to(device)
    x = _cloud(gen, n, c, device=device)
    idx, _ = knn_self(xyz[None], kk)
    cand, pos, _ = cells.build_cell_candidates(idx[0], n_slots)
    return xyz, x, idx[0], cand, pos


@pytest.mark.cuda
class TestCellKernelsOnCard:
    @pytest.mark.parametrize("n,kk,c", [(2048, 36, 32), (2048, 36, 16),
                                        (1024, 24, 32), (512, 12, 6)])
    @pytest.mark.parametrize("fallback", [True, False])
    def test_cell_select(self, cuda_device, gen, n, kk, c, fallback):
        """K4 and K5 bit-equal to their twins; dump positions (no fallback)
        select zeros in both."""
        xyz, x, _, cand, pos = _cell_inputs(gen, n, kk, c, 8, cuda_device)
        if fallback:
            pos = cells.pos_with_self_fallback(pos, 64)
        else:
            pos = pos.clone()
            pos[::5, -1] = 64
        blk_x = cells.gather_candidate_blocks(x, cand)
        blk_p = cells.gather_candidate_blocks(xyz, cand)
        got = cell_select.cell_select_x(blk_x, pos)
        got_p = cell_select.cell_select_p(blk_p, pos, xyz)
        torch.cuda.synchronize()
        assert torch.equal(got, cell_select.cell_select_x_reference(blk_x, pos))
        assert torch.equal(got_p,
                           cell_select.cell_select_p_reference(blk_p, pos, xyz))

    @pytest.mark.parametrize("n,kk,c", [(2048, 36, 32), (2048, 36, 16),
                                        (1024, 24, 32), (64, 24, 512),
                                        (512, 13, 16)])
    def test_gathered_attention(self, cuda_device, gen, n, kk, c):
        """K6 within 1e-4 of its twin, on the rows K4/K5 select."""
        port = PointTransformerLayer(c, device=cuda_device)
        randomize_(port, torch.Generator().manual_seed(0))
        xyz, x, _, cand, pos = _cell_inputs(gen, n, kk, c, 32, cuda_device)
        pos = cells.pos_with_self_fallback(pos, 256)
        x_g = cell_select.cell_select_x(cells.gather_candidate_blocks(x, cand),
                                        pos).reshape(n * kk, c)
        p_r = cell_select.cell_select_p(cells.gather_candidate_blocks(xyz, cand),
                                        pos, xyz).reshape(n * kk, 3)
        with torch.no_grad():
            params = attention.fold_attention_params(port)
            q = port.linear_q(x).contiguous()
            got = attention.fused_vector_attention(q, x_g, p_r, params, k=kk)
            ref = attention.fused_vector_attention_reference(q, x_g, p_r, params,
                                                             k=kk)
        torch.cuda.synchronize()
        assert (got - ref).abs().max().item() <= 1e-4
