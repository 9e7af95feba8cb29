"""The port's CUDA kernels against their plain PyTorch twins, on the card.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_port_kernels.py -m cuda -q

Without a card every test skips (the kernels have no CPU mode); the twins are
held to the JAX package by tests/test_torch_port_ops.py.
"""

import os

import numpy as np
import pytest
import torch

from toothgroupnetwork_tpu_torch.models.point_transformer.backbone import (
    PointTransformerLayer)
from toothgroupnetwork_tpu_torch.ops import cells, knn_self
from toothgroupnetwork_tpu_torch.ops.kernels import (attention, cell_select, fps,
                                                     gather, knn)
from toothgroupnetwork_tpu_torch.utils.weights import randomize_

# the deterministic train steps of TestTrainingOnCard need a fixed cuBLAS
# workspace before the test run's first cuBLAS call (the size torch picks on
# Hopper anyway, so the other tests run as before)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")


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


def _within_one_bf16_ulp(got, ref, atol: float = 1e-4) -> bool:
    """|got - ref| <= one bf16 ulp (8 significant bits) at max(|got|, |ref|)
    + atol: two float32 results within atol (the kernels' float32
    tolerance) round to bf16 values at most that far apart; near zero,
    where a sum cancels, atol is many ulps."""
    got, ref = got.float(), ref.float()
    mag = torch.maximum(got.abs(), ref.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return bool(((got - ref).abs() <= ulp + atol).all())


# K3 at the widths of the main path (B, N, K, C): the fps model's deeper
# stages and crops, cut in N; 12 points with K = 24 is the deepest crop
# level's k > n tail; 601, 301 and 155 rows are not multiples of R
MAIN_PATH_K3 = [(1, 601, 24, 64), (1, 301, 24, 128), (1, 155, 24, 256),
                (16, 48, 24, 256), (16, 12, 24, 512), (16, 192, 24, 128)]


def _knn_idx(gen, b, n, kk, device):
    """Random in-cloud indices; where K > N the tail repeats index 0, as the
    kNN's k > n tail does, and the last neighbour is index 0 anyway."""
    idx = gen.integers(0, n, (b, n, kk)).astype(np.int32)
    idx[..., min(n, kk - 1):] = 0
    return torch.from_numpy(idx).to(device)


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

    @pytest.mark.parametrize("case", ["unmasked_100489", "beyond_smem",
                                      "duplicates", "invalid_and_exhausted",
                                      "crops_masked"])
    def test_fps_cluster(self, cuda_device, gen, case):
        """K1's cluster partitions equal to the twin: an N that is not a
        multiple of the cluster size (the mesh-prep launch), slices beyond
        16 CTAs' shared memory (the global range), exact ties across CTA
        boundaries, an all-invalid cloud beside an exhausted one across
        CTAs, and the 16 crops with a mask."""
        valid = None
        if case == "unmasked_100489":
            xyz, m = _cloud(gen, 1, 100489, 3, device=cuda_device), 24000
        elif case == "beyond_smem":
            xyz, m = _cloud(gen, 1, 300000, 3, device=cuda_device), 2000
        elif case == "duplicates":
            uniq = _cloud(gen, 1, 500, 3, device=cuda_device)
            pick = torch.from_numpy(gen.integers(0, 500, 40000)).to(cuda_device)
            xyz, m = uniq[:, pick].contiguous(), 3000
        elif case == "invalid_and_exhausted":
            xyz, m = _cloud(gen, 2, 40000, 3, device=cuda_device), 400
            valid = torch.zeros((2, 40000), dtype=torch.bool, device=cuda_device)
            valid[1, ::211] = True             # 190 valid points over 16 CTAs
        else:
            xyz, m = _cloud(gen, 16, 3072, 3, device=cuda_device), 768
            valid = torch.from_numpy(gen.random((16, 3072)) > 0.2).to(cuda_device)
        got = fps.fps(xyz, m, valid)
        torch.cuda.synchronize()
        assert torch.equal(got, fps.fps_reference(xyz, m, valid))
        if case == "invalid_and_exhausted":
            assert (got[0] == 0).all()
            assert valid[1, got[1].long()].all()

    def test_fps_chain_floor(self, cuda_device):
        """The chain-only launches run at every cluster size, both ways."""
        for c in (1, 7, 16):
            for pull in (False, True):
                out = fps.chain_floor(50, c, cuda_device, pull=pull)
                torch.cuda.synchronize()
                assert ((out >= 0) & (out < c)).all()

    @pytest.mark.parametrize("k", [1, 24, 36, 63, 64])
    @pytest.mark.parametrize("case", ["duplicates", "sorted_self", "m_ne_n",
                                      "bias"])
    def test_knn_warp_select(self, cuda_device, gen, case, k):
        """K2 equal to its twin: exact ties across lanes, warps and tiles
        (300 points, each ~17 times), a spatially sorted self-query (the
        seed window is its own neighbourhood), M != N, and masked points."""
        bias = None
        if case == "duplicates":
            uniq = _cloud(gen, 2, 300, 3, device=cuda_device)
            pick = torch.from_numpy(gen.integers(0, 300, 5000)).to(cuda_device)
            pts = uniq[:, pick].contiguous()
            qry = pts
        elif case == "sorted_self":
            u = gen.uniform(-1, 1, (6000, 2))
            xyz = np.stack([u[:, 0], 0.3 * u[:, 0] ** 2 + 0.2 * u[:, 1] ** 2,
                            u[:, 1]], 1).astype(np.float32)
            xyz = xyz[cells.spatial_sort_perm(xyz)]
            pts = torch.from_numpy(np.ascontiguousarray(xyz)).to(cuda_device)[None]
            qry = pts
        elif case == "m_ne_n":
            pts = _cloud(gen, 2, 5000, 3, device=cuda_device)
            qry = _cloud(gen, 2, 700, 3, device=cuda_device)
        else:
            pts = _cloud(gen, 2, 3000, 3, device=cuda_device)
            qry = pts
            bias = torch.where(torch.from_numpy(gen.random((2, 3000)) > 0.5),
                               0.0, 1e10).to(torch.float32).to(cuda_device)
        gi, gd = knn.knn_select(qry, pts, k, bias)
        ri, rd = knn.knn_select_reference(qry, pts, k, bias)
        torch.cuda.synchronize()
        assert torch.equal(gi, ri) and torch.equal(gd, rd)

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

    @pytest.mark.parametrize("k", [24, 64])
    def test_knn_tail_bias(self, cuda_device, gen, k):
        """The k > n tail beside masked points, both list banks."""
        pts = _cloud(gen, 2, 10, 3, device=cuda_device)
        q = _cloud(gen, 2, 50, 3, device=cuda_device)
        bias = torch.zeros((2, 10), device=cuda_device)
        bias[:, ::3] = 1e10
        gi, gd = knn.knn_select(q, pts, k, bias)
        ri, rd = knn.knn_select_reference(q, pts, k, bias)
        assert torch.equal(gi, ri) and torch.equal(gd, rd)
        assert (gi[..., 10:] == 0).all() and (gd[..., 10:] == 1e10).all()

    @staticmethod
    def _hold_to_twin(cases, k, twin_on_cpu=False):
        """Each (query, points, bias) through ``knn_select``, one launch a
        call, indices and d2 ``torch.equal`` to the twin's (on the card, or
        on the CPU). Returns the last call's output."""
        for qry, p, b in cases:
            launches = knn.knn_select.launches
            gi, gd = knn.knn_select(qry, p, k, b)
            assert knn.knn_select.launches == launches + 1
            if twin_on_cpu:
                qry, p, b = qry.cpu(), p.cpu(), None if b is None else b.cpu()
            ri, rd = knn.knn_select_reference(qry, p, k, b)
            gi, gd = gi.to(ri.device), gd.to(rd.device)
            assert torch.equal(gi, ri) and torch.equal(gd, rd), (
                tuple(qry.shape), tuple(p.shape), b is not None,
                int(((gi != ri) | (gd != rd)).any(dim=-1).sum()))
        return gi, gd

    @staticmethod
    def _tail_case(gen, m, c, device):
        """M queries over 10 points, every third masked: the k > n tail
        beside masked points."""
        few = _cloud(gen, 2, 10, c, device=device)
        few_bias = torch.zeros((2, 10), device=device)
        few_bias[:, ::3] = 1e10
        return _cloud(gen, 2, m, c, device=device), few, few_bias

    @pytest.mark.parametrize("k", [1, 20, 33, 64])
    @pytest.mark.parametrize("c", [1, 2, 5, 6, 17, 33, 35, 64, 100, 256])
    def test_knn_general_c(self, cuda_device, gen, c, k):
        """K2's general-C route (``tgn_knn_c``; DGCNN's feature space, on
        the register-tiled stage) equal to its twin, indices and d2 bit for
        bit, one launch a call: a masked self-query over several candidate
        tiles, M != N, exact duplicate rows spanning tiles and splits, every
        M != N of 1, 31, 129 and 2500 (B = 2: ragged query tiles, candidate
        tiles, channel chunks and splits), a fully masked cloud (every d2
        ties at 1e10: the lower index wins), the k > n tail beside masked
        points, and at C = 64, k = 20 DGCNN's EdgeConv self-query at full
        size ([1,24000]). Each launch counts under its C."""
        assert knn.knn_route(c, k) == "tgn_knn_c"
        before = knn.knn_select.launches_by_shape.get(c, 0)
        pts = _cloud(gen, 2, 2500, c, device=cuda_device)
        bias = torch.where(torch.from_numpy(gen.random((2, 2500)) > 0.3),
                           0.0, 1e10).to(torch.float32).to(cuda_device)
        uniq = _cloud(gen, 1, 200, c, device=cuda_device)
        dup = uniq[:, torch.from_numpy(gen.integers(0, 200, 1500)).to(
            cuda_device)].contiguous()
        sizes = (1, 31, 129, 2500)
        cases = [(pts, pts, bias), (_cloud(gen, 2, 300, c, device=cuda_device), pts,
                                    None),
                 (dup, dup, None), (pts, pts, torch.full_like(bias, 1e10))]
        cases += [(_cloud(gen, 2, m, c, device=cuda_device),
                   _cloud(gen, 2, n, c, device=cuda_device), None)
                  for m in sizes for n in sizes if m != n]
        if (c, k) == (64, 20):
            x = _cloud(gen, 1, 24000, c, device=cuda_device)
            cases.append((x, x, None))
        cases.append(self._tail_case(gen, 129, c, cuda_device))
        gi, gd = self._hold_to_twin(cases, k)
        if k > 10:
            assert (gi[..., 10:] == 0).all() and (gd[..., 10:] == 1e10).all()
        assert knn.knn_select.launches_by_shape[c] == before + len(cases)

    @pytest.mark.parametrize("c,k", [(3, 65), (300, 20), (300, 65), (64, 100),
                                     (3, 300), (17, 100)])
    def test_knn_size_route(self, cuda_device, gen, c, k):
        """Beyond the warp kernels' limits (k > 64 or C > 256) ``knn_select``
        launches ``tgn_knn_any`` on the card, equal to the plain version on
        the CPU, indices and d2 bit for bit: a masked self-query, M != N,
        M over several 64-query tiles plus a partial one (3 x 64 + 17),
        duplicated points (ties to the lower index), a fully masked cloud
        and the k > n tail beside masked points; each call one launch.
        Through ``knn_points`` too, as a DGCNN with k > 64 calls it."""
        assert knn.knn_route(c, k) == "tgn_knn_any"
        launches = knn.knn_select.launches
        pts = _cloud(gen, 2, 3000, c, device=cuda_device)
        bias = torch.where(torch.from_numpy(gen.random((2, 3000)) > 0.3),
                           0.0, 1e10).to(torch.float32).to(cuda_device)
        dup = pts[:, :1500].repeat(1, 2, 1).contiguous()   # ties: lower index
        cases = ((pts, pts, bias), (_cloud(gen, 2, 700, c, device=cuda_device),
                                    pts, None),
                 (_cloud(gen, 2, 3 * 64 + 17, c, device=cuda_device), pts, None),
                 (dup, dup, None), (pts, pts, torch.full_like(bias, 1e10)),
                 self._tail_case(gen, 50, c, cuda_device))
        gi, gd = self._hold_to_twin(cases, k, twin_on_cpu=True)
        assert (gi[..., 10:] == 0).all() and (gd[..., 10:] == 1e10).all()
        idx, _ = knn_self(pts, k, bias == 0)
        ref, _ = knn_self(pts.cpu(), k, (bias == 0).cpu())
        assert torch.equal(idx.cpu(), ref)
        assert knn.knn_select.launches == launches + len(cases) + 1

    @pytest.mark.parametrize("b,n,kk,c", [(2, 300, 16, 32), (1, 500, 36, 16),
                                          (1, 93, 24, 512), (2, 64, 36, 512),
                                          (2, 300, 10, 16)] + MAIN_PATH_K3)
    def test_attention(self, cuda_device, gen, b, n, kk, c):
        """K3 (projection + attention over the gathered projections) within
        1e-4 of its twin, at the main path's widths, with a k > n tail and
        row counts that R (rows a CTA) does not divide."""
        port = PointTransformerLayer(c, device=cuda_device)
        randomize_(port, torch.Generator().manual_seed(0))
        p = _cloud(gen, b, n, 3, device=cuda_device) * 0.2
        x = _cloud(gen, b, n, c, device=cuda_device) * 0.2
        idx = _knn_idx(gen, b, n, kk, cuda_device)
        with torch.no_grad():
            params = attention.fold_attention_params(port)
            q = port.linear_q(x).reshape(-1, c).contiguous()
            got = attention.fused_vector_attention_packed_x(x, p, idx, q, params)
            ref = attention.fused_vector_attention_packed_x_reference(
                x, p, idx, q, params)
        torch.cuda.synchronize()
        assert (got - ref).abs().max().item() <= 1e-4


    @pytest.mark.parametrize("b,n,kk,c", [(2, 300, 16, 32), (1, 93, 24, 512),
                                          (2, 64, 36, 512)] + MAIN_PATH_K3)
    def test_attention_bf16(self, cuda_device, gen, b, n, kk, c):
        """K3 on bf16 x and q (bf16 out) within one bf16 ulp (+ 1e-4) of its
        twin."""
        port = PointTransformerLayer(c, device=cuda_device)
        randomize_(port, torch.Generator().manual_seed(0))
        p = _cloud(gen, b, n, 3, device=cuda_device) * 0.2
        x = (_cloud(gen, b, n, c, device=cuda_device) * 0.2).bfloat16()
        idx = _knn_idx(gen, b, n, kk, cuda_device)
        with torch.no_grad():
            params = attention.fold_attention_params(port, torch.bfloat16)
            q = port.linear_q(x.float()).reshape(-1, c).bfloat16().contiguous()
            got = attention.fused_vector_attention_packed_x(x, p, idx, q, params)
            ref = attention.fused_vector_attention_packed_x_reference(
                x, p, idx, q, params)
        torch.cuda.synchronize()
        assert got.dtype == torch.bfloat16 and _within_one_bf16_ulp(got, ref)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("m,cin,c", [(24000, 32, 32), (6000, 64, 64),
                                         (1500, 128, 128), (375, 256, 256),
                                         (93, 512, 512), (1000, 16, 16),
                                         (77, 40, 24)])
    def test_project_kv(self, cuda_device, gen, m, cin, c, dtype):
        """tgn_project_kv within 1e-5 of project_kv_reference: float32 rows
        on the FMA units, bf16 rows on the tensor cores (exact products of
        bf16-rounded weights); ragged rows, columns and depths padded with
        zeros."""
        port = PointTransformerLayer(c, device=cuda_device)
        randomize_(port, torch.Generator().manual_seed(0))
        params = attention.fold_attention_params(port)
        if cin != c:
            params["wk"] = _cloud(gen, cin, c, device=cuda_device) / cin ** 0.5
            params["wv"] = _cloud(gen, cin, c, device=cuda_device) / cin ** 0.5
        x = (_cloud(gen, m, cin, device=cuda_device) * 0.5).to(dtype)
        before = attention.project_kv.launches
        got = attention.project_kv(x, params)
        torch.cuda.synchronize()
        assert attention.project_kv.launches == before + 1
        ref = attention.project_kv_reference(x, params)
        assert got.dtype == torch.float32 and got.shape == (m, 2 * c)
        assert (got - ref).abs().max().item() <= 1e-5

    def test_attention_counts_one_call(self, cuda_device, gen):
        """K3's wrapper counts one call for its two kernels, project_kv one."""
        port = PointTransformerLayer(32, device=cuda_device)
        randomize_(port, torch.Generator().manual_seed(0))
        x = _cloud(gen, 1, 100, 32, device=cuda_device)
        idx = _knn_idx(gen, 1, 100, 8, cuda_device)
        counts = (attention.fused_vector_attention_packed_x.launches,
                  attention.project_kv.launches)
        with torch.no_grad():
            q = port.linear_q(x).reshape(-1, 32).contiguous()
            attention.fused_vector_attention_packed_x(
                x, _cloud(gen, 1, 100, 3, device=cuda_device), idx, q,
                port.kernel_params())
        assert (attention.fused_vector_attention_packed_x.launches,
                attention.project_kv.launches) == (counts[0] + 1, counts[1] + 1)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_attention_sees_edited_params(self, cuda_device, gen, dtype):
        """A parameter dict edited after a call (a weight scaled in place, a
        bias and a matrix replaced) reaches the next call of K3, K6 and K7:
        each within its tolerance of its twin on the edited dict."""
        b, n, kk, c = 1, 200, 16, 32
        port = PointTransformerLayer(c, device=cuda_device)
        randomize_(port, torch.Generator().manual_seed(0))
        p = _cloud(gen, b, n, 3, device=cuda_device) * 0.2
        x = (_cloud(gen, b, n, c, device=cuda_device) * 0.2).to(dtype)
        idx = _knn_idx(gen, b, n, kk, cuda_device)
        x_g = x.reshape(n, c)[idx.reshape(-1).long()].contiguous()
        p_r = (p.reshape(n, 3)[idx.reshape(-1).long()]
               - p.reshape(n, 1, 3).expand(n, kk, 3).reshape(-1, 3)).to(dtype)
        k_g, v_g = (_cloud(gen, n * kk, c, device=cuda_device).to(dtype)
                    for _ in range(2))
        with torch.no_grad():
            params = attention.fold_attention_params(port, dtype)
            q = port.linear_q(x.float()).reshape(-1, c).to(dtype).contiguous()

            def check():
                got = attention.fused_vector_attention_packed_x(x, p, idx, q, params)
                ref = attention.fused_vector_attention_packed_x_reference(
                    x, p, idx, q, params)
                if dtype == torch.bfloat16:
                    assert _within_one_bf16_ulp(got, ref)
                else:
                    assert (got - ref).abs().max().item() <= 1e-4
                for got, ref in (
                        (attention.fused_vector_attention(q.float(), x_g, p_r, params,
                                                          k=kk),
                         attention.fused_vector_attention_reference(
                             q.float(), x_g, p_r, params, k=kk)),
                        (attention.fused_vector_attention_packed(q, k_g, v_g, p_r,
                                                                 params, k=kk),
                         attention.fused_vector_attention_packed_reference(
                             q, k_g, v_g, p_r, params, k=kk))):
                    assert (got - ref).abs().max().item() <= 1e-4
                return got

            before = check()
            params["wk"].mul_(3.0)
            params["wv"].mul_(-1.0)
            check()
            params["bv"] = params["bv"] + 0.5
            check()
            params["w0"] = params["w0"] * 2.0
            assert not torch.equal(check(), before)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("b,n,kk,c", [(2, 300, 16, 32), (1, 93, 24, 512),
                                          (2, 64, 36, 512), (2, 100, 13, 16)])
    def test_pre_projected_attention(self, cuda_device, gen, b, n, kk, c, dtype):
        """K7 within 1e-4 of its twin (float32 out) on rows of either dtype."""
        port = PointTransformerLayer(c, device=cuda_device)
        randomize_(port, torch.Generator().manual_seed(0))
        rows = b * n * kk
        k_g, v_g = (_cloud(gen, rows, c, device=cuda_device).to(dtype)
                    for _ in range(2))
        p_r = (_cloud(gen, rows, 3, device=cuda_device) * 0.2).to(dtype)
        q = _cloud(gen, b * n, c, device=cuda_device).to(dtype)
        with torch.no_grad():
            params = attention.fold_attention_params(port)
            got = attention.fused_vector_attention_packed(q, k_g, v_g, p_r, params,
                                                          k=kk)
            ref = attention.fused_vector_attention_packed_reference(
                q, k_g, v_g, p_r, params, k=kk)
        torch.cuda.synchronize()
        assert got.dtype == torch.float32
        assert (got - ref).abs().max().item() <= 1e-4

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("b,n,m,kk,c", [(2, 200, 57, 9, 32),
                                            (16, 3072, 300, 36, 32),
                                            (1, 500, 100, 36, 3), (2, 64, 10, 4, 16),
                                            (1, 300, 50, 5, 12)])
    def test_row_gather(self, cuda_device, gen, b, n, m, kk, c, dtype):
        """K8 bit-equal to its twin (16-byte units and the narrower ones of
        rows that are not a multiple of 16 bytes)."""
        x = _cloud(gen, b, n, c, device=cuda_device).to(dtype)
        idx = torch.from_numpy(gen.integers(0, n, (b, m, kk)).astype(np.int32)
                               ).to(cuda_device)
        got = gather.onehot_gather_packed(x, idx)
        torch.cuda.synchronize()
        assert got.dtype == dtype
        assert torch.equal(got, gather.onehot_gather_packed_reference(x, idx))
        assert torch.equal(gather.onehot_gather(x, idx), got.reshape(b, m, kk, c))

    def test_other_dtypes_raise(self, cuda_device, gen):
        """A dtype outside a kernel's set raises; it is never converted."""
        x = _cloud(gen, 1, 64, 16, device=cuda_device).half()
        idx = torch.zeros((1, 8, 4), dtype=torch.int32, device=cuda_device)
        with pytest.raises(TypeError):
            gather.onehot_gather_packed(x, idx)
        with pytest.raises(TypeError):
            gather.onehot_gather_packed(x.float(), idx.long())


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
                                        (512, 12, 6)])
    def test_cell_select_bf16(self, cuda_device, gen, n, kk, c):
        """K4 on bf16 rows bit-equal to its twin, dump positions included."""
        _, x, _, cand, pos = _cell_inputs(gen, n, kk, c, 8, cuda_device)
        pos = pos.clone()
        pos[::5, -1] = 64
        blk_x = cells.gather_candidate_blocks(x.bfloat16(), cand)
        got = cell_select.cell_select_x(blk_x, pos)
        torch.cuda.synchronize()
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, cell_select.cell_select_x_reference(blk_x, pos))

    @pytest.mark.parametrize("n,kk,c", [(2048, 36, 32), (1024, 24, 32),
                                        (2048, 36, 16), (1000, 36, 32),
                                        (600, 24, 64), (296, 24, 128), (64, 24, 512)])
    def test_gathered_attention_bf16(self, cuda_device, gen, n, kk, c):
        """K6 on bf16 x_g and p_r (float32 q, weights and out) within 1e-4
        of its twin."""
        port = PointTransformerLayer(c, device=cuda_device)
        randomize_(port, torch.Generator().manual_seed(0))
        xyz, x, _, cand, pos = _cell_inputs(gen, n, kk, c, 32, cuda_device)
        pos = cells.pos_with_self_fallback(pos, 256)
        x_g = cell_select.cell_select_x(
            cells.gather_candidate_blocks(x.bfloat16(), cand), pos).reshape(n * kk, c)
        p_r = cell_select.cell_select_p(cells.gather_candidate_blocks(xyz, cand),
                                        pos, xyz).reshape(n * kk, 3).bfloat16()
        with torch.no_grad():
            params = attention.fold_attention_params(port, torch.bfloat16)
            q = port.linear_q(x).contiguous()
            got = attention.fused_vector_attention(q, x_g, p_r, params, k=kk)
            ref = attention.fused_vector_attention_reference(q, x_g, p_r, params,
                                                             k=kk)
        torch.cuda.synchronize()
        assert got.dtype == torch.float32
        assert (got - ref).abs().max().item() <= 1e-4

    @pytest.mark.parametrize("n,kk,c", [(2048, 36, 32), (2048, 36, 16),
                                        (1024, 24, 32), (64, 24, 512),
                                        (512, 13, 16), (1000, 36, 32), (600, 24, 64),
                                        (296, 24, 128), (152, 24, 256)])
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


@pytest.mark.cuda
class TestConcurrentLaunchesOnCard:
    """Scans served from several threads (``TgnInferencePipeline.run_many``)
    launch the kernels at once, each thread on its own CUDA stream."""

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_threads_on_their_own_streams(self, cuda_device, gen, dtype):
        """Four threads, each on its own stream, released together by a
        barrier, launch K1, K2 and K3 (one shared layer, its fold and
        kernel layout not made beforehand, so the threads race to make
        them) on inputs of their own: every output equals its twin's (K3
        within its tolerance), the launch counts and K3's by-shape counts
        are exact, and the kernel library is loaded once."""
        from concurrent.futures import ThreadPoolExecutor
        from threading import Barrier

        from toothgroupnetwork_tpu_torch.ops.kernels import build

        n_threads, reps, b, n, m, kk, c = 4, 3, 1, 3000, 600, 24, 32
        layer = PointTransformerLayer(c, device=cuda_device, dtype=dtype)
        randomize_(layer, torch.Generator().manual_seed(1))
        inputs = []
        for _ in range(n_threads):
            p = _cloud(gen, b, n, 3, device=cuda_device)
            x = (_cloud(gen, b, n, c, device=cuda_device) * 0.5).to(dtype)
            with torch.no_grad():
                q = layer.linear_q(x).reshape(b * n, c).contiguous()
            inputs.append((p, x, q, _knn_idx(gen, b, n, kk, cuda_device)))
        torch.cuda.synchronize()
        kernels = (fps.fps, knn.knn_select, attention.fused_vector_attention_packed_x)
        for k in kernels:
            k.launches = 0
        attention.fused_vector_attention_packed_x.launches_by_shape.clear()
        barrier = Barrier(n_threads)

        def work(i):
            p, x, q, idx = inputs[i]
            stream = torch.cuda.Stream(cuda_device)
            with torch.cuda.stream(stream), torch.no_grad():
                barrier.wait()
                outs = [(fps.fps(p, m), knn.knn_select(p, p, kk),
                         attention.fused_vector_attention_packed_x(
                             x, p, idx, q, layer.kernel_params()))
                        for _ in range(reps)]
            stream.synchronize()
            return outs

        with ThreadPoolExecutor(n_threads) as ex:
            results = list(ex.map(work, range(n_threads)))
        torch.cuda.synchronize()
        assert [k.launches for k in kernels] == [n_threads * reps] * 3
        assert attention.fused_vector_attention_packed_x.launches_by_shape == {
            (b, n, kk, c, dtype): n_threads * reps}
        assert build.build_info["loads"] == 1
        params = layer.kernel_params()
        for (p, x, q, idx), outs in zip(inputs, results):
            ref_i, ref_d = knn.knn_select_reference(p, p, kk)
            with torch.no_grad():
                ref_a = attention.fused_vector_attention_packed_x_reference(
                    x, p, idx, q, params)
            for got_f, (got_i, got_d), got_a in outs:
                assert torch.equal(got_f, fps.fps_reference(p, m))
                assert torch.equal(got_i, ref_i) and torch.equal(got_d, ref_d)
                if dtype == torch.bfloat16:
                    assert _within_one_bf16_ulp(got_a, ref_a)
                else:
                    assert (got_a - ref_a).abs().max().item() <= 1e-4

    def test_threads_at_different_shared_memory_sizes(self, cuda_device, gen):
        """Scans in flight are at different layers at once, so one kernel is
        launched with different dynamic shared memory from several threads:
        four threads, each at a K3 width of the main path and a K1 cloud
        size of its own, launch many times, released together. Every launch
        succeeds and equals its twin, and the counts are exact."""
        from concurrent.futures import ThreadPoolExecutor
        from threading import Barrier

        reps = 40
        cases = [MAIN_PATH_K3[i] for i in (0, 2, 3, 4)]
        clouds = [(1, 24000, 600), (16, 3072, 768), (1, 6000, 1500), (3, 2000, 300)]
        inputs = []
        for (b, n, kk, c), (fb, fn, fm) in zip(cases, clouds):
            layer = PointTransformerLayer(c, device=cuda_device)
            randomize_(layer, torch.Generator().manual_seed(c))
            p = _cloud(gen, b, n, 3, device=cuda_device)
            x = _cloud(gen, b, n, c, device=cuda_device) * 0.5
            with torch.no_grad():
                q = layer.linear_q(x).reshape(b * n, c).contiguous()
            params = layer.kernel_params()
            attention.prepare_layouts(params, torch.float32, cuda_device)
            inputs.append((p, x, q, _knn_idx(gen, b, n, kk, cuda_device), params,
                           _cloud(gen, fb, fn, 3, device=cuda_device), fm))
        torch.cuda.synchronize()
        kernels = (fps.fps, attention.fused_vector_attention_packed_x)
        for k in kernels:
            k.launches = 0
        barrier = Barrier(len(inputs))

        def work(i):
            p, x, q, idx, params, xyz, m = inputs[i]
            stream = torch.cuda.Stream(cuda_device)
            with torch.cuda.stream(stream), torch.no_grad():
                barrier.wait()
                outs = [(fps.fps(xyz, m),
                         attention.fused_vector_attention_packed_x(x, p, idx, q, params))
                        for _ in range(reps)]
            stream.synchronize()
            return outs

        with ThreadPoolExecutor(len(inputs)) as ex:
            results = list(ex.map(work, range(len(inputs))))
        torch.cuda.synchronize()
        assert [k.launches for k in kernels] == [len(inputs) * reps] * 2
        for (p, x, q, idx, params, xyz, m), outs in zip(inputs, results):
            ref_f = fps.fps_reference(xyz, m)
            with torch.no_grad():
                ref_a = attention.fused_vector_attention_packed_x_reference(
                    x, p, idx, q, params)
            for got_f, got_a in outs:
                assert torch.equal(got_f, ref_f)
                assert (got_a - ref_a).abs().max().item() <= 1e-4


@pytest.mark.cuda
class TestTrainingOnCard:
    """The tgnet_fps train step on the card at the tiny config of
    tests/test_torch_port_train_step.py (planes [8, 16], stride [1, 4], 16
    crops of 32 over 256 points)."""

    ARCH = {"planes": [8, 16], "stride": [1, 4], "nsample": [8, 8],
            "blocks": [2, 2], "block_num": 2, "crop_sample_size": 32}

    def _run(self, device, batch, steps=3, dtype="float32"):
        from toothgroupnetwork_tpu_torch.models import get_task
        from toothgroupnetwork_tpu_torch.train import make_optimizer, train_step
        from toothgroupnetwork_tpu_torch.utils.weights import init_like_flax_

        task = get_task("tgnet_fps")
        cfg = task.default_config()
        cfg.model_parameter.update(self.ARCH, dtype=dtype)
        cfg.optimizer.lr = 1e-2
        model = task.build_module(cfg, device=device)
        init_like_flax_(model, torch.Generator().manual_seed(0))
        opt = make_optimizer(cfg.optimizer, model.parameters())
        on = {k: v.to(device) for k, v in batch.items()}
        losses = [{k: float(v) for k, v in train_step(model, opt, task, cfg, on).items()}
                  for _ in range(steps)]
        return model, losses

    @staticmethod
    def _batch():
        from synthetic import make_synthetic_jaw_points

        pts, _, cls = make_synthetic_jaw_points(240, 6, seed=1)
        feat = np.zeros((1, 256, 6), np.float32)
        feat[0, :240, :3] = pts
        feat[0, :240, 5] = 1.0
        labels = np.full((1, 256), -1, np.int32)
        labels[0, :240] = cls - 1
        return {"feat": torch.from_numpy(feat),
                "gt_seg_label": torch.from_numpy(labels),
                "mask": torch.from_numpy(np.arange(256)[None] < 240)}

    def test_steps_match_the_cpu_and_repeat(self, cuda_device, gen):
        """Three steps on the card: each loss within 1e-4 relative of the CPU
        port's, K1 and K2 launched and K3 not (training runs the unfused
        attention), and a second seeded run bit-identical (losses,
        parameters, BatchNorm statistics)."""
        batch = self._batch()
        kernels = (fps.fps, knn.knn_select, attention.fused_vector_attention_packed_x)
        for k in kernels:
            k.launches = 0
        model_a, card = self._run(cuda_device, batch)
        assert [k.launches > 0 for k in kernels] == [True, True, False]
        _, cpu = self._run(torch.device("cpu"), batch)
        for got, want in zip(card, cpu):
            for key, val in want.items():
                assert got[key] == pytest.approx(val, rel=1e-4), key
        model_b, again = self._run(cuda_device, batch)
        assert again == card
        for (name, a), b in zip(model_a.state_dict().items(),
                                model_b.state_dict().values()):
            assert torch.equal(a, b), name

    def test_bf16_steps(self, cuda_device):
        """Three steps with ``"dtype": "bfloat16"`` on the card: every loss
        finite, K1 and K2 launched, step 1 within 8 bf16 ulps (2^-5
        relative) of the CPU port's bf16 step (two bf16 roundings of sums
        taken in other orders, as tests/test_torch_port_train_bf16.py
        derives), a second seeded run bit-identical, and every parameter
        and statistic float32."""
        batch = self._batch()
        for k in (fps.fps, knn.knn_select):
            k.launches = 0
        model_a, card = self._run(cuda_device, batch, dtype="bfloat16")
        assert fps.fps.launches > 0 and knn.knn_select.launches > 0
        assert all(np.isfinite(list(step.values())).all() for step in card)
        _, cpu = self._run(torch.device("cpu"), batch, steps=1, dtype="bfloat16")
        for key, val in cpu[0].items():
            assert card[0][key] == pytest.approx(val, rel=2.0 ** -5), key
        model_b, again = self._run(cuda_device, batch, dtype="bfloat16")
        assert again == card
        for (name, a), b in zip(model_a.state_dict().items(),
                                model_b.state_dict().values()):
            assert a.dtype == torch.float32 and torch.equal(a, b), name


@pytest.mark.cuda
class TestBdlOnCard:
    """The tgnet_bdl boundary engine on the card at a tiny size: three
    labelled 900-vertex synthetic cases preprocessed on the card (K1) to 512
    points, 300 boundary points, the tiny fps model of TestTrainingOnCard
    with crops of 64 as the frozen model."""

    FPS = {"planes": [8, 16], "stride": [1, 4], "nsample": [8, 8], "blocks": [2, 2],
           "block_num": 2, "crop_sample_size": 64}

    def _setup(self, tmp_path, device):
        from synthetic import write_synthetic_case

        from toothgroupnetwork_tpu_torch.data import DentalScanDataset, collate_batch
        from toothgroupnetwork_tpu_torch.data import preprocess
        from toothgroupnetwork_tpu_torch.models import get_task

        for i, (case, jaw) in enumerate((("CASE01", "lower"), ("CASE02", "upper"))):
            write_synthetic_case(str(tmp_path), case, jaw, n_side=30, seed=i)
        fps.fps.launches = 0
        saved = preprocess.N_POINTS
        preprocess.N_POINTS = 512
        try:
            preprocess.preprocess_dir(str(tmp_path / "objs"), str(tmp_path / "jsons"),
                                      str(tmp_path / "processed"), verbose=False,
                                      device=device)
        finally:
            preprocess.N_POINTS = saved
        assert fps.fps.launches == 2
        cfg = get_task("tgnet_bdl").default_config()
        cfg.model_parameter["boundary_sampling_info"].update(
            num_of_bdl_points=300, num_of_all_points=512,
            orginal_data_obj_path=str(tmp_path / "objs"),
            orginal_data_json_path=str(tmp_path / "jsons"))
        cfg.model_parameter["fps_model_info"]["model_parameter"] = dict(self.FPS)
        ds = DentalScanDataset(str(tmp_path / "processed"))
        return cfg, [collate_batch([ds[i]]) for i in range(len(ds))]

    def test_engine_equals_the_plain_version(self, cuda_device, tmp_path):
        """Given the same frozen outputs (the card's frozen forward, run once
        per case), the engine on the card (K1 resampling the non-boundary
        vertices) and on the CPU (K1's plain version) give identical clouds;
        the frozen forward launches K1, K2 and K3, the resample K1."""
        from toothgroupnetwork_tpu_torch.train.bdl_engine import BdlDataEngine

        cfg, batches = self._setup(tmp_path, cuda_device)
        card = BdlDataEngine(cuda_device)
        kernels = (fps.fps, knn.knn_select, attention.fused_vector_attention_packed_x)
        frozen = card._ensure_frozen(cfg)
        outputs = {}
        for b in batches:
            for k in kernels:
                k.launches = 0
            feat = b["feat"]
            outputs[feat.tobytes()] = frozen(feat, b["gt_seg_label"])
            assert all(k.launches > 0 for k in kernels), [k.launches for k in kernels]

        def recorded(feat, labels):
            return outputs[feat.tobytes()]

        plain = BdlDataEngine("cpu")
        card._frozen = plain._frozen = recorded
        for b in batches:
            fps.fps.launches = 0
            got = card(None, b, cfg)
            assert fps.fps.launches == 1
            want = plain(None, b, cfg)
            for key in want:
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.cuda
class TestFamilyTrainingOnCard:
    """The other five families' train steps on the card at the small sizes
    of tests/test_torch_port_train_families.py (pointnet and pointnetpp at
    scale 1, dgcnn at k = 8, a narrow pointtransformer, tsegnet's tiny
    backbone with crops of 64 and its host stage before each step) over one
    synthetic jaw of 512 points (448 valid): two seeded runs of two steps
    bit-identical (DGCNN at the preset's dropout 0.5, the generator seeded
    as the Trainer seeds it), step 1 within 1e-3 relative of the CPU port's
    (DGCNN at dropout 0: the card's and the CPU's generators draw other
    masks), and the kernels the steps launch: none for pointnet, K1 and K2
    for pointnetpp and tsegnet, K2 at C = 6 once and 64 twice a step for
    dgcnn, K1 and K2 but not K3 for pointtransformer; none of K4-K8."""

    SMALL = {"pointnet": {"scale": 1}, "pointnetpp": {"scale": 1}, "dgcnn": {"k": 8},
             "pointtransformer": {"input_feat": 6, "planes": [8, 16, 16],
                                  "stride": [1, 4, 4], "nsample": [8, 8, 8],
                                  "blocks": [1, 2, 1], "block_num": 3},
             "tsegnet": {"tiny_backbone": True, "crop_sample_size": 64}}
    LAUNCHED = {"pointnet": (), "pointnetpp": ("fps", "knn_select"),
                "dgcnn": ("knn_select",), "pointtransformer": ("fps", "knn_select"),
                "tsegnet": ("fps", "knn_select")}

    @staticmethod
    def _batch() -> dict:
        from synthetic import make_synthetic_jaw_points

        pts, _, cls = make_synthetic_jaw_points(448, 8, seed=7)
        feat = np.zeros((1, 512, 6), np.float32)
        feat[0, :448, :3] = pts
        feat[0, :448, 5] = 1.0
        labels = np.full((1, 512), -1, np.int32)
        labels[0, :448] = cls - 1
        return {"feat": feat, "gt_seg_label": labels, "mask": np.arange(512)[None] < 448}

    def _run(self, name, device, steps, dropout=None):
        from toothgroupnetwork_tpu_torch.models import get_task
        from toothgroupnetwork_tpu_torch.train import make_optimizer, train_step
        from toothgroupnetwork_tpu_torch.train.trainer import dropout_seed
        from toothgroupnetwork_tpu_torch.utils.weights import init_like_flax_

        task = get_task(name)
        cfg = task.default_config()
        cfg.model_parameter.update(self.SMALL[name])
        if cfg.optimizer.name == "sgd":
            cfg.optimizer.lr = 1e-2
        model = task.build_module(cfg, device=device)
        init_like_flax_(model, torch.Generator().manual_seed(0))
        if dropout is not None:
            model.drop.p = dropout
        opt = make_optimizer(cfg.optimizer, model.parameters())
        gen = torch.Generator(device=device)
        losses = []
        for step in range(steps):
            batch = self._batch()
            if task.host_stage is not None:
                batch.update(task.host_stage(model, batch, cfg, step=step))
            gen.manual_seed(dropout_seed(cfg.seed, step))
            vals = train_step(model, opt, task, cfg,
                              {k: torch.from_numpy(v).to(device) for k, v in batch.items()},
                              generator=gen)
            losses.append({k: float(v) for k, v in vals.items()})
        return model, losses

    @pytest.mark.parametrize("name", ["pointnet", "pointnetpp", "dgcnn",
                                      "pointtransformer", "tsegnet"])
    def test_steps_repeat_and_match_the_cpu(self, cuda_device, name):
        counted = (fps.fps, knn.knn_select, attention.fused_vector_attention_packed_x,
                   attention.project_kv, cell_select.cell_select_x,
                   cell_select.cell_select_p, attention.fused_vector_attention,
                   attention.fused_vector_attention_packed, gather.onehot_gather_packed)
        for k in counted:
            k.launches = 0
        knn.knn_select.launches_by_shape.clear()
        model_a, card = self._run(name, cuda_device, 2)
        launched = {k.__name__ for k in counted if k.launches}
        assert launched == set(self.LAUNCHED[name]), launched
        if name == "dgcnn":
            assert knn.knn_select.launches_by_shape == {6: 2, 64: 4}
        assert all(np.isfinite(list(step.values())).all() for step in card)
        model_b, again = self._run(name, cuda_device, 2)
        assert again == card
        for (key, a), b in zip(model_a.state_dict().items(),
                               model_b.state_dict().values()):
            assert torch.equal(a, b), key
        dropout = 0.0 if name == "dgcnn" else None
        _, card1 = self._run(name, cuda_device, 1, dropout)
        _, cpu1 = self._run(name, torch.device("cpu"), 1, dropout)
        assert set(card1[0]) == set(cpu1[0])
        for key, val in cpu1[0].items():
            assert card1[0][key] == pytest.approx(val, rel=1e-3, abs=1e-6), key
