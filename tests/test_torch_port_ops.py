"""Ops of the PyTorch port against the JAX package, on the CPU.

The port's kernel wrappers take their plain PyTorch twins for CPU tensors, so
these tests hold the twins (and the torch code around them) to the JAX
functions on the same numpy inputs. The JAX side runs as its own tests run
it: the jnp paths, and the Pallas kernels called directly in interpret mode.
The kernels themselves run only on the card: tests/test_torch_port_kernels.py.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toothgroupnetwork_tpu.models.point_transformer.backbone import (
    PointTransformerLayer as JaxLayer)
from toothgroupnetwork_tpu.ops import farthest_point_sample as jax_fps
from toothgroupnetwork_tpu.ops import knn_interpolate as jax_interp
from toothgroupnetwork_tpu.ops import knn_points as jax_knn
from toothgroupnetwork_tpu.ops.gather import gather_neighbors as jax_gather_neighbors
from toothgroupnetwork_tpu.ops.pallas.attention_kernel import (
    fold_attention_params as jax_fold, fused_vector_attention_packed,
    fused_vector_attention_packed_x)
from toothgroupnetwork_tpu.ops.pallas.fps_kernel import (
    fps_pallas, fps_pallas_multicloud)
from toothgroupnetwork_tpu.ops.pallas.gather_kernel import (
    onehot_gather as jax_onehot_gather, onehot_gather_packed as jax_onehot_packed)
from toothgroupnetwork_tpu_torch.models.point_transformer.backbone import (
    PointTransformerLayer)
from toothgroupnetwork_tpu_torch.ops import (farthest_point_sample, index_points,
                                             knn_interpolate, knn_points)
from toothgroupnetwork_tpu_torch.ops.gather import gather_neighbors
from toothgroupnetwork_tpu_torch.ops.kernels import attention, fps, gather, knn
from toothgroupnetwork_tpu_torch.utils.weights import from_jax_variables

REPO = Path(__file__).resolve().parents[1]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cloud(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


class TestFps:
    def test_single_cloud(self, rng):
        xyz = _cloud(rng, 300, 3)
        ref = np.asarray(jax_fps(jnp.asarray(xyz), 64))
        got = farthest_point_sample(_t(xyz), 64).numpy()
        np.testing.assert_array_equal(got, ref)

    def test_batched(self, rng):
        xyz = _cloud(rng, 4, 200, 3)
        ref = np.asarray(jax_fps(jnp.asarray(xyz), 50))
        got = farthest_point_sample(_t(xyz), 50).numpy()
        np.testing.assert_array_equal(got, ref)

    @pytest.mark.parametrize("batched", [False, True])
    def test_masked(self, rng, batched):
        xyz = _cloud(rng, 3, 256, 3)
        mask = rng.random((3, 256)) > 0.3
        mask[1, :5] = False                       # seed is not point 0
        if not batched:
            xyz, mask = xyz[1], mask[1]
        ref = np.asarray(jax_fps(jnp.asarray(xyz), 40, jnp.asarray(mask)))
        got = farthest_point_sample(_t(xyz), 40, _t(mask)).numpy()
        np.testing.assert_array_equal(got, ref)
        assert np.take_along_axis(mask, got.astype(np.int64), -1).all()

    def test_exhausted(self, rng):
        xyz = _cloud(rng, 2, 64, 3)
        mask = np.zeros((2, 64), bool)
        mask[0, :10] = True
        mask[1, 20:27] = True
        ref = np.asarray(jax_fps(jnp.asarray(xyz), 16, jnp.asarray(mask)))
        got = farthest_point_sample(_t(xyz), 16, _t(mask)).numpy()
        np.testing.assert_array_equal(got, ref)

    def test_dead_cloud_returns_zeros(self, rng):
        xyz = _cloud(rng, 2, 32, 3)
        mask = np.zeros((2, 32), bool)
        mask[0] = True
        got = farthest_point_sample(_t(xyz), 8, _t(mask)).numpy()
        ref = np.asarray(jax_fps(jnp.asarray(xyz), 8, jnp.asarray(mask)))
        np.testing.assert_array_equal(got, ref)
        assert (got[1] == 0).all()

    def test_pallas_single(self, rng):
        xyz = _cloud(rng, 300, 3)
        mask = rng.random(300) > 0.2
        ref = np.asarray(fps_pallas(jnp.asarray(xyz), 48, jnp.asarray(mask)))
        got = farthest_point_sample(_t(xyz), 48, _t(mask)).numpy()
        np.testing.assert_array_equal(got, ref)

    def test_pallas_multicloud(self, rng):
        xyz = _cloud(rng, 3, 256, 3)
        mask = np.ones((3, 256), bool)
        mask[2, 200:] = False                     # valid points stored first
        ref = np.asarray(fps_pallas_multicloud(jnp.asarray(xyz), 32,
                                               jnp.asarray(mask)))
        got = farthest_point_sample(_t(xyz), 32, _t(mask)).numpy()
        np.testing.assert_array_equal(got, ref)

    @pytest.mark.parametrize("masked", [False, True])
    def test_twin_on_duplicates(self, rng, masked):
        """The plain twin against the JAX package on a cloud of exact
        duplicates (80 points, each ~5 times, shuffled): every step's
        argmax is an exact tie, broken to the lowest index, and past the
        80th sample the running minimum is 0 everywhere (repeats). The
        kernel is held to this twin on the card (test_torch_port_kernels)."""
        uniq = _cloud(rng, 2, 80, 3)
        xyz = np.take_along_axis(uniq, rng.integers(0, 80, (2, 400, 1)), axis=1)
        mask = rng.random((2, 400)) > 0.3 if masked else None
        jm = None if mask is None else jnp.asarray(mask)
        ref = np.asarray(jax_fps(jnp.asarray(xyz), 120, jm))
        got = fps.fps_reference(_t(xyz), 120,
                                None if mask is None else _t(mask)).numpy()
        np.testing.assert_array_equal(got, ref)


def _assert_expansion_d2_close(query, pts, idx, got_d, ref_d):
    """Selection-precision distances (``need_dist=False``) come from the
    float32 expansion |q|^2 - 2 q.p + |p|^2, whose rounding error is
    bounded by a few float32 epsilons times |q|^2 + |p|^2 (five for the
    three-term dots, the doubling and the two sums), not by the distance:
    each package sits within that bound of the float64 value, by its own
    order of operations (the port's fixed channel order, XLA's dot). An
    absolute tolerance on the square roots fails at small distances, where
    a root multiplies the expansion's rounding, so the two packages are
    held to each other on d^2, within the two bounds together."""
    q = np.asarray(query, np.float64)
    pg = np.take_along_axis(np.asarray(pts, np.float64)[:, None],
                            idx[..., None].astype(np.int64), axis=2)
    scale = (q ** 2).sum(-1)[..., None] + (pg ** 2).sum(-1)
    tol = 10 * np.finfo(np.float32).eps * scale
    diff = np.abs(got_d.astype(np.float64) ** 2 - ref_d.astype(np.float64) ** 2)
    assert (diff <= tol).all(), f"max d2 diff / bound {(diff / tol).max()}"


class TestKnn:
    @pytest.mark.parametrize("masked", [False, True])
    @pytest.mark.parametrize("include_self", [False, True])
    @pytest.mark.parametrize("need_dist", [False, True])
    def test_matches_jax(self, rng, masked, include_self, need_dist):
        pts = _cloud(rng, 2, 150, 3)
        query = pts if include_self else _cloud(rng, 2, 90, 3)
        mask = (rng.random((2, 150)) > 0.25) if masked else None
        jm = None if mask is None else jnp.asarray(mask)
        ref_i, ref_d = jax_knn(jnp.asarray(query), jnp.asarray(pts), 12,
                               jm if include_self else None, jm,
                               include_self=include_self, need_dist=need_dist)
        got_i, got_d = knn_points(_t(query), _t(pts), 12,
                                  None if mask is None else _t(mask),
                                  None if mask is None else _t(mask),
                                  include_self=include_self, need_dist=need_dist)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
        if need_dist:
            # re-scored by direct subtraction in both packages
            np.testing.assert_allclose(got_d.numpy(), np.asarray(ref_d), atol=1e-5)
        else:
            _assert_expansion_d2_close(query, pts, got_i.numpy(), got_d.numpy(),
                                       np.asarray(ref_d))

    @pytest.mark.parametrize("include_self", [False, True])
    @pytest.mark.parametrize("need_dist", [False, True])
    def test_k_exceeds_n_tail(self, rng, include_self, need_dist):
        pts = _cloud(rng, 2, 10, 3)
        query = pts if include_self else _cloud(rng, 2, 7, 3)
        ref_i, ref_d = jax_knn(jnp.asarray(query), jnp.asarray(pts), 16,
                               include_self=include_self, need_dist=need_dist)
        got_i, got_d = knn_points(_t(query), _t(pts), 16,
                                  include_self=include_self, need_dist=need_dist)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
        np.testing.assert_allclose(got_d.numpy(), np.asarray(ref_d), atol=1e-5)
        if not include_self:
            assert (got_i.numpy()[..., 10:] == 0).all()

    def test_unbatched(self, rng):
        pts, query = _cloud(rng, 120, 3), _cloud(rng, 40, 3)
        ref_i, ref_d = jax_knn(jnp.asarray(query), jnp.asarray(pts), 5)
        got_i, got_d = knn_points(_t(query), _t(pts), 5)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
        np.testing.assert_allclose(got_d.numpy(), np.asarray(ref_d), atol=1e-5)

    @pytest.mark.parametrize("self_query", [False, True])
    def test_select_twin_on_duplicates(self, rng, self_query):
        """knn_select_reference against the JAX package's knn_points on a
        cloud of exact duplicates (60 points, each ~5 times) with a mask:
        ties at and across the k-th place go to the lower index in both."""
        uniq = _cloud(rng, 2, 60, 3)
        pts = np.take_along_axis(uniq, rng.integers(0, 60, (2, 300, 1)), axis=1)
        query = pts if self_query else np.take_along_axis(
            uniq, rng.integers(0, 60, (2, 90, 1)), axis=1)
        mask = rng.random((2, 300)) > 0.25
        ref_i, _ = jax_knn(jnp.asarray(query), jnp.asarray(pts), 12, None,
                           jnp.asarray(mask), need_dist=False)
        bias = torch.where(_t(mask), 0.0, 1e10).to(torch.float32)
        got_i, got_d = knn.knn_select_reference(_t(query), _t(pts), 12, bias)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
        assert (got_d[..., 1:] >= got_d[..., :-1]).all()

    def test_select_chunks_agree(self, rng):
        q, p = _cloud(rng, 1, 300, 3), _cloud(rng, 1, 200, 3)
        a = knn.knn_select_reference(_t(q), _t(p), 9, chunk=64)
        b = knn.knn_select_reference(_t(q), _t(p), 9, chunk=1024)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.numpy(), y.numpy())

    def test_knn_interpolate(self, rng):
        tgt, src = _cloud(rng, 2, 80, 3), _cloud(rng, 2, 30, 3)
        feat = _cloud(rng, 2, 30, 16)
        mask = rng.random((2, 30)) > 0.2
        ref = jax_interp(jnp.asarray(tgt), jnp.asarray(src), jnp.asarray(feat), 3,
                         None, jnp.asarray(mask))
        got = knn_interpolate(_t(tgt), _t(src), _t(feat), 3, None, _t(mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)

    def test_index_points(self, rng):
        pts = _cloud(rng, 2, 10, 4)
        idx = rng.integers(0, 10, (2, 5, 3))
        got = index_points(_t(pts), _t(idx)).numpy()
        ref = np.stack([pts[b][idx[b]] for b in range(2)])
        np.testing.assert_array_equal(got, ref)


def _attention_setup(rng, b, n, kk, cc):
    """tests/test_fused_attention.py:_setup: a flax layer with randomised
    batch_stats, plus the same weights in the port's layer."""
    lay = JaxLayer(planes=cc)
    pp = jnp.asarray(rng.standard_normal((b, n, 3)) * 0.2, jnp.float32)
    xx = jnp.asarray(rng.standard_normal((b, n, cc)) * 0.2, jnp.float32)
    kidx, _ = jax_knn(pp, pp, kk, include_self=True)
    vs = lay.init(jax.random.PRNGKey(0), pp, xx, kidx, None, train=True)
    stats = jax.tree_util.tree_map(
        lambda a: a + jnp.asarray(rng.standard_normal(a.shape) * 0.1 + 0.5,
                                  a.dtype), vs["batch_stats"])
    vs = {"params": vs["params"], "batch_stats": stats}
    flat = {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(vs)[0]}
    port = PointTransformerLayer(cc, device="cpu")
    port.load_state_dict(from_jax_variables(flat))
    return lay, vs, port, pp, xx, kidx


class TestAttention:
    def test_layer_matches_xla_path(self, rng, monkeypatch):
        lay, vs, port, pp, xx, kidx = _attention_setup(rng, 2, 200, 12, 32)
        monkeypatch.setenv("TGN_TPU_ATTENTION", "xla")
        ref = lay.apply(vs, pp, xx, kidx, None, False)
        with torch.no_grad():
            got = port(_t(np.asarray(pp)), _t(np.asarray(xx)),
                       _t(np.asarray(kidx)))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)

    def test_matches_packed_x_kernel(self, rng):
        lay, vs, port, pp, xx, kidx = _attention_setup(rng, 3, 160, 12, 32)
        b, n, kk = kidx.shape
        p = vs["params"]
        q = (xx.reshape(b * n, -1) @ p["linear_q"]["kernel"]
             + p["linear_q"]["bias"])
        from toothgroupnetwork_tpu.ops.gather import index_points as jax_gather

        x_g = jax_gather(xx, kidx).reshape(b * n * kk, -1)
        p_r = (jax_gather(pp, kidx) - pp[:, :, None, :]).reshape(-1, 3)
        ref = fused_vector_attention_packed_x(q, x_g, p_r, jax_fold(vs), k=kk)
        with torch.no_grad():
            got = attention.fused_vector_attention_packed_x(
                _t(np.asarray(xx)), _t(np.asarray(pp)), _t(np.asarray(kidx)),
                _t(np.asarray(q)), attention.fold_attention_params(port))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)

    @pytest.mark.parametrize("b,n,kk,c", [(1, 60, 24, 128), (1, 60, 24, 256),
                                          (2, 12, 24, 64)])
    def test_projection_then_gathered_twin(self, rng, b, n, kk, c):
        """K3's two kernels' twins in turn, project_kv_reference (every
        point) then gathered_kv_attention_reference, against the JAX
        ``fused_vector_attention_packed_x`` (interpret mode) at the main
        path's wide layers (K = 24 on 60 points) and, with 12 points, on the
        kNN's k > n tail (indices repeated, the last index 0): within 2e-5 in float32."""
        lay, vs, port, pp, xx, kidx = _attention_setup(rng, b, n, kk, c)
        pw = vs["params"]
        q = xx.reshape(b * n, -1) @ pw["linear_q"]["kernel"] + pw["linear_q"]["bias"]
        from toothgroupnetwork_tpu.ops.gather import index_points as jax_gather

        if kk > n:   # the tail repeats an index; its last entries are index 0
            assert (np.asarray(kidx)[..., -1] == 0).all()
        x_g = jax_gather(xx, kidx).reshape(b * n * kk, -1)
        p_r = (jax_gather(pp, kidx) - pp[:, :, None, :]).reshape(-1, 3)
        ref = fused_vector_attention_packed_x(q, x_g, p_r, jax_fold(vs), k=kk)
        with torch.no_grad():
            params = attention.fold_attention_params(port)
            kv = attention.project_kv_reference(_t(np.asarray(xx)).reshape(b * n, c),
                                                params)
            got = attention.gathered_kv_attention_reference(
                kv, _t(np.asarray(pp)), _t(np.asarray(kidx)), _t(np.asarray(q)), params)
        assert kv.shape == (b * n, 2 * c) and kv.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)

    def test_folded_parameters_follow_the_layer(self, rng):
        """The layer folds its parameters once and keeps them (with the
        kernel layouts) between forwards; an in-place change of a weight or
        a buffer, or weights loaded after a forward, is seen by the next
        forward, whose output equals a freshly built layer's."""
        _, _, port, pp, xx, kidx = _attention_setup(rng, 1, 64, 8, 16)
        _, _, other, *_ = _attention_setup(rng, 1, 64, 8, 16)
        p, x, idx = (_t(np.asarray(a)) for a in (pp, xx, kidx))

        def fresh_output():
            fresh = PointTransformerLayer(16, device="cpu")
            fresh.load_state_dict(port.state_dict())
            return fresh(p, x, idx)

        with torch.no_grad():
            port(p, x, idx)
            folded = port.kernel_params()
            assert port.kernel_params() is folded
            port.linear_k.weight.mul_(2.0)
            port.linear_w_bn0.var.add_(0.5)
            assert port.kernel_params() is not folded
            assert torch.equal(port(p, x, idx), fresh_output())
            port.load_state_dict(other.state_dict())
            assert torch.equal(port(p, x, idx), fresh_output())

    def test_kernel_layout_follows_the_dict(self, rng):
        """The kernel layout a wrapper keeps in a parameter dict is made
        once, and made anew after a tensor of the dict is changed in place
        or replaced; a dict of inference tensors keeps none."""
        _, _, port, *_ = _attention_setup(rng, 1, 40, 8, 16)
        with torch.no_grad():
            params = attention.fold_attention_params(port)
        made = []

        def layout(d=params):
            return attention.cached_layout(
                d, "key", lambda: made.append(d["wk"] + d["bv"][:16]) or made[-1])

        with torch.no_grad():
            first = layout()
            assert layout() is first and len(made) == 1
            params["wk"].mul_(2.0)
            assert torch.equal(layout(), params["wk"] + params["bv"][:16])
            params["bv"] = params["bv"] + 1.0
            assert torch.equal(layout(), params["wk"] + params["bv"][:16])
            assert layout() is made[-1] and len(made) == 3
        with torch.inference_mode():
            frozen = attention.fold_attention_params(port)
            layout(frozen)
            layout(frozen)
        assert len(made) == 5

    def test_layer_keeps_its_layout_under_inference_mode(self, rng):
        """An inference-mode pipeline (``TgnInferencePipeline.__call__``)
        gets the same folded dict from a layer call after call, with tensors
        that keep version counters, so a kernel layout kept in it is made
        once."""
        _, _, port, pp, xx, kidx = _attention_setup(rng, 1, 40, 8, 16)
        made = []
        for _ in range(3):
            with torch.inference_mode():
                port(*(_t(np.asarray(a)) for a in (pp, xx, kidx)))
                folded = port.kernel_params()
                attention.cached_layout(folded, "key", lambda: made.append(1))
        assert not any(t.is_inference() for k, t in folded.items()
                       if k != attention.LAYOUT_KEY)
        assert port.kernel_params() is folded and len(made) == 1

    def test_fold_matches_jax_fold(self, rng):
        _, vs, port, *_ = _attention_setup(rng, 1, 40, 8, 16)
        ref = jax_fold(vs)
        with torch.no_grad():
            got = attention.fold_attention_params(port)
        for key, val in ref.items():
            np.testing.assert_allclose(got[key].detach().numpy(), np.asarray(val),
                                       rtol=1e-6, atol=1e-7, err_msg=key)


class TestPreProjectedAttention:
    """K7's twin (``fused_vector_attention_packed``: k and v projected ahead
    of the kernel)."""

    def _inputs(self, rng, b, n, kk, c):
        lay, vs, port, pp, xx, kidx = _attention_setup(rng, b, n, kk, c)
        p = vs["params"]
        q = xx.reshape(b * n, -1) @ p["linear_q"]["kernel"] + p["linear_q"]["bias"]
        from toothgroupnetwork_tpu.ops.gather import index_points as jax_gather

        x_g = jax_gather(xx, kidx).reshape(b * n * kk, c)
        p_r = (jax_gather(pp, kidx) - pp[:, :, None, :]).reshape(-1, 3)
        params = jax_fold(vs)
        k_g = x_g @ params["wk"] + params["bk"]
        v_g = x_g @ params["wv"] + params["bv"]
        return q, x_g, k_g, v_g, p_r, params, port

    @pytest.mark.parametrize("c", [16, 32])
    def test_matches_jax_kernel(self, rng, c):
        """tests/test_fused_attention.py:60-84's inputs through the JAX entry
        (interpret mode) and the twin: atol 1e-5 in float32."""
        q, _, k_g, v_g, p_r, params, _ = self._inputs(rng, 2, 96, 8, c)
        ref = fused_vector_attention_packed(q, k_g, v_g, p_r, params, k=8)
        got = attention.fused_vector_attention_packed(
            *(_t(np.asarray(a)) for a in (q, k_g, v_g, p_r)),
            {k: _t(np.asarray(v)) for k, v in params.items()}, k=8)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)

    def test_twin_equals_k6_twin_on_projected_rows(self, rng):
        """K7's twin on rows projected as K6's twin projects them is K6's
        twin (the in-kernel projection is the only difference)."""
        q, x_g, _, _, p_r, _, port = self._inputs(rng, 1, 64, 12, 32)
        with torch.no_grad():
            params = attention.fold_attention_params(port)
            xg, pr, qq = _t(np.asarray(x_g)), _t(np.asarray(p_r)), _t(np.asarray(q))
            k_g = xg @ params["wk"] + params["bk"]
            v_g = xg @ params["wv"] + params["bv"]
            a = attention.fused_vector_attention_packed(qq, k_g, v_g, pr, params, k=12)
            b = attention.fused_vector_attention(qq, xg, pr, params, k=12)
        assert torch.equal(a, b)


class TestRowGather:
    """K8's twin against ``onehot_gather_packed`` / ``onehot_gather``
    (interpret mode) and the port's ``gather_neighbors`` switch."""

    @pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
    def test_bit_equal_to_onehot_gather(self, rng, dtype):
        b, n, c, m, k = 2, 200, 32, 57, 9   # tests/test_ops.py:598
        x = jnp.asarray(rng.standard_normal((b, n, c)), dtype=dtype)
        idx = jnp.asarray(rng.integers(0, n, (b, m, k)), dtype=jnp.int32)
        xt = _t(np.asarray(x, dtype=np.float32)).to(
            torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
        it = _t(np.asarray(idx))
        packed = gather.onehot_gather_packed(xt, it)
        assert packed.dtype == xt.dtype and packed.shape == (b, m, k * c)
        np.testing.assert_array_equal(packed.float().numpy(),
                                      np.asarray(jax_onehot_packed(x, idx), np.float32))
        view = gather.onehot_gather(xt, it)
        np.testing.assert_array_equal(view.float().numpy(),
                                      np.asarray(jax_onehot_gather(x, idx), np.float32))
        assert torch.equal(view, index_points(xt, it))

    @pytest.mark.parametrize("mode", ["mxu", "auto"])
    def test_gather_neighbors_switch(self, rng, monkeypatch, mode):
        """tests/test_ops.py:613-627 with the port beside the JAX function:
        both switch values give ``index_points``; ``mxu`` reaches K8's
        wrapper (its twin here)."""
        x = rng.standard_normal((1, 160, 16)).astype(np.float32)
        idx = rng.integers(0, 160, (1, 40, 5)).astype(np.int32)
        xb = jnp.asarray(x, dtype=jnp.bfloat16)
        monkeypatch.setenv("TGN_TPU_GATHER", mode)
        calls = []
        monkeypatch.setattr(gather, "onehot_gather_packed_reference",
                            lambda *a: calls.append(1) or index_points(*a).reshape(
                                1, 40, 5 * 16))
        want = np.asarray(jax_gather_neighbors(xb, jnp.asarray(idx), train=False),
                          np.float32)
        got = gather_neighbors(_t(np.asarray(xb, np.float32)).to(torch.bfloat16),
                               _t(idx))
        assert got.shape == (1, 40, 5, 16) and got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), want)
        assert len(calls) == (mode == "mxu")


class TestWrappers:
    def test_counters_untouched_by_twins(self, rng):
        before = (fps.fps.launches, knn.knn_select.launches,
                  attention.fused_vector_attention_packed_x.launches)
        xyz = _t(_cloud(rng, 1, 50, 3))
        fps.fps(xyz, 5)
        knn.knn_select(xyz, xyz, 4)
        assert (fps.fps.launches, knn.knn_select.launches,
                attention.fused_vector_attention_packed_x.launches) == before

    @pytest.mark.parametrize("n,size", [(93, 1), (2048, 1), (2049, 2), (3072, 2),
                                        (24000, 12), (100489, 16), (300000, 16)])
    def test_fps_cluster_size(self, n, size):
        """K1's cluster follows N, from 1 CTA to 16."""
        assert fps.cluster_size(n) == size

    def test_other_devices_raise(self):
        meta = torch.empty((1, 8, 3), device="meta")
        with pytest.raises(ValueError):
            fps.fps(meta, 2)

    # after the imports: no JAX, no flax and no module of the JAX package
    # (the name itself or one under it) in sys.modules
    _CLEAN = (
        "jax_pkg = [m for m in sys.modules if m == 'toothgroupnetwork_tpu'\n"
        "           or m.startswith('toothgroupnetwork_tpu.')]\n"
        "assert not jax_pkg, f'JAX package imported: {sorted(jax_pkg)[:5]}'\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert 'flax' not in sys.modules, 'flax imported'\n"
        "print('clean')\n")

    @pytest.mark.parametrize("what", ["package", "chip_smoke"])
    def test_import_hygiene(self, what):
        """Every module of the port, and ``chip_smoke.py`` (imported, its
        ``main`` not run), imports without JAX, flax or the JAX package,
        not even its numpy-only modules (and without nvcc or a card:
        nothing is built at import)."""
        if what == "package":
            code = ("import importlib, pkgutil, sys\n"
                    "import toothgroupnetwork_tpu_torch as pkg\n"
                    "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
                    "    importlib.import_module(m.name)\n")
        else:
            code = "import sys\nimport chip_smoke\n"
        out = subprocess.run([sys.executable, "-c", code + self._CLEAN], cwd=REPO,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert "clean" in out.stdout

