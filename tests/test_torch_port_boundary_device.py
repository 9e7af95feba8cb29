"""The device boundary route of the port (the route a CUDA pipeline takes)
against the JAX package's device route functions and its CPU pipeline, on
the CPU, where K2 and K1 take their plain versions.

* ``boundary_purity_device`` against ``_purity_device_fn`` and the host
  KD-tree, on the inputs and with the tolerances of
  tests/test_tgn_pipeline.py:86-141: the 1-NN index and label equal, its d2
  within rtol 1e-4, the mask equal outside the 2.5/40 band around
  ``bdl_ratio`` (the 40-set may differ at its 40th place) and on at least
  0.99 of the vertices;
* the masked fill (one K1 call over the whole cloud with ``mask =
  ~boundary``) bit-identical to ``_masked_fps``, to FPS of the compacted
  subset and to the host route's cloud;
* ``boundary_nn1`` against ``_bdl_nn1_fn``: indices equal except between
  points at equal distance, d2 within rtol 1e-4;
* ``final_transfer`` bit-identical to ``_final_transfer_fns``, ties
  included;
* the whole pipeline on the device route and the structured
  stand-in predictors of tests/test_torch_port_serving.py against the JAX
  CPU pipeline (host KD-trees): the boundary clouds identical, and every
  vertex whose labels differ shown to sit at an equal-distance tie of the
  final 1-NN (the KD-tree ranks in float64, K2 in float32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from test_torch_port_serving import (PARITY_BOUNDARY, PARITY_CROP, PARITY_SAMPLE,
                                     JaxStandIn, TorchStandIn, _stand_in_scan)
from toothgroupnetwork_tpu.models import get_task
from toothgroupnetwork_tpu.ops import farthest_point_sample as jax_fps
from toothgroupnetwork_tpu.pipelines.tgn import (
    TgnInferencePipeline as JaxPipeline, _bdl_nn1_fn, _final_transfer_fns)
from toothgroupnetwork_tpu.postprocess.boundary import (
    _masked_fps, _purity_device_fn)
from toothgroupnetwork_tpu.postprocess.boundary import (
    boundary_sampled_feats as jax_boundary_sampled_feats)
from toothgroupnetwork_tpu.postprocess.clustering import first_label_ratio
from toothgroupnetwork_tpu_torch.ops import farthest_point_sample
from toothgroupnetwork_tpu_torch.pipelines import tgn
from toothgroupnetwork_tpu_torch.pipelines.base import class_logits_to_fdi
from toothgroupnetwork_tpu_torch.pipelines.tgn import TgnInferencePipeline
from toothgroupnetwork_tpu_torch.postprocess import boundary

K, BDL_RATIO = 40, 0.7


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _blob_cloud(rng):
    """tests/test_tgn_pipeline.py:101-108: 14 gaussian blobs of 1500
    points, the 4000-point sample FPS-ordered as in the pipeline."""
    centers = rng.uniform(-0.6, 0.6, (14, 3)).astype(np.float32)
    org = np.concatenate([c + rng.normal(0, 0.05, (1500, 3)) for c in centers],
                         0).astype(np.float32)
    order = np.asarray(jax_fps(jnp.asarray(org), 4000))
    return org, org[order]


def test_purity_matches_jax_and_the_kdtree(rng):
    org, sampled = _blob_cloud(rng)
    labels = rng.integers(0, 17, 4000).astype(np.int64)
    bd, lab, nn1, nn1_d2 = (t.numpy() for t in boundary.boundary_purity_device(
        _t(org), _t(sampled), _t(labels), K, BDL_RATIO))
    bd_j, lab_j, nn1_j, d2_j, _ = (np.asarray(a) for a in _purity_device_fn(
        jnp.asarray(org), jnp.asarray(sampled),
        jnp.asarray(labels.astype(np.uint8)), K, BDL_RATIO))
    dist, nn = cKDTree(sampled).query(org, k=K, workers=-1)
    ratio_h = first_label_ratio(labels[nn])
    near = np.abs(ratio_h - BDL_RATIO) <= 2.5 / K
    for want_nn1, want_lab, want_bd in ((nn1_j, lab_j, bd_j),
                                        (nn[:, 0], labels[nn[:, 0]],
                                         ratio_h < BDL_RATIO)):
        np.testing.assert_array_equal(nn1, want_nn1)
        np.testing.assert_array_equal(lab, want_lab)
        agree = bd == want_bd
        assert agree[~near].all() and agree.mean() > 0.99
    np.testing.assert_allclose(nn1_d2, d2_j, rtol=1e-4, atol=1e-9)
    np.testing.assert_allclose(nn1_d2, dist[:, 0] ** 2, rtol=1e-4, atol=1e-9)


def test_masked_fill_matches_jax_and_the_compacted_subset(rng):
    """tests/test_tgn_pipeline.py:206-240: 3000 points, 35 % boundary,
    512 fill points; and on the half-space field of :91-141, the fill of
    the port's own mask."""
    n0, need = 3000, 512
    org = rng.uniform(-1, 1, (n0, 3)).astype(np.float32)
    bd = rng.random(n0) < 0.35
    got = farthest_point_sample(_t(org), need, _t(~bd)).numpy()
    pad = np.zeros((4096, 3), np.float32)
    pad[:n0] = org
    bd_pad = np.zeros(4096, bool)
    bd_pad[:n0] = bd
    np.testing.assert_array_equal(
        got, np.asarray(_masked_fps(jnp.asarray(pad), jnp.asarray(bd_pad), n0,
                                    need)))
    local = np.asarray(jax_fps(jnp.asarray(org[~bd]), need))
    np.testing.assert_array_equal(got, np.flatnonzero(~bd)[local])

    org, sampled = _blob_cloud(rng)
    labels_hs = (sampled[:, 0] > 0).astype(np.int64) + 1
    bd_hs = boundary.boundary_purity_device(_t(org), _t(sampled), _t(labels_hs),
                                            K, BDL_RATIO)[0].numpy()
    m = 512
    assert np.count_nonzero(~bd_hs) > m
    got = farthest_point_sample(_t(org), m, _t(~bd_hs)).numpy()
    local = np.asarray(jax_fps(jnp.asarray(org[~bd_hs]), m))
    np.testing.assert_array_equal(got, np.flatnonzero(~bd_hs)[local])


@pytest.mark.parametrize("spatial_sort", [False, True])
@pytest.mark.parametrize("num_bdl", [500, 100])
def test_device_route_cloud_equals_the_host_route(rng, spatial_sort, num_bdl):
    """tests/test_tgn_pipeline.py:242-266: two half-planes, the boundary at
    x = 0: the device route's cloud (K2 purity, masked K1 fill) identical
    to the host route's and to the JAX package's; with 100 boundary points
    the fill takes 900 of the rest."""
    n = 3000
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    labels = (pts[:, 0] > 0).astype(np.int64) + 1
    feats = np.concatenate([pts, np.zeros_like(pts)], -1)
    kw = dict(bdl_ratio=BDL_RATIO, num_bdl_points=num_bdl, num_all_points=1000,
              spatial_sort=spatial_sort)
    host = boundary.boundary_sampled_feats(labels, feats, feats, device="cpu", **kw)
    dev = boundary.boundary_sampled_feats(labels, feats, feats,
                                          org_dev=_t(pts), device="cpu", **kw)
    assert 0 < dev[2] == host[2] <= num_bdl
    for i in (0, 1, 5):
        np.testing.assert_array_equal(dev[i], host[i])
    np.testing.assert_array_equal(dev[3].numpy(), host[3])
    np.testing.assert_allclose(dev[4].numpy(), host[4], rtol=1e-4, atol=1e-9)
    ref = jax_boundary_sampled_feats(labels, feats, feats, **kw)
    np.testing.assert_array_equal(dev[0], ref[0])
    np.testing.assert_array_equal(dev[1], ref[1])


def test_boundary_nn1_matches_jax(rng):
    """Every vertex of the blob cloud into a 3000-point boundary cloud: the
    JAX function re-scores its top 4 exactly, the port K2's 4 nearest;
    indices equal except between points at equal distance."""
    org, _ = _blob_cloud(rng)
    bdl = org[rng.choice(org.shape[0], 3000, replace=False)]
    idx, d2 = (t.numpy() for t in tgn.boundary_nn1(_t(org), _t(bdl)))
    n_pad = -(-org.shape[0] // 4096) * 4096
    pad = np.zeros((n_pad, 3), np.float32)
    pad[:org.shape[0]] = org
    idx_j, d2_j = (np.asarray(a)[:org.shape[0]]
                   for a in _bdl_nn1_fn(jnp.asarray(pad), jnp.asarray(bdl)))
    np.testing.assert_allclose(d2, d2_j, rtol=1e-4, atol=1e-9)
    swap = idx != idx_j
    assert swap.mean() < 1e-3
    np.testing.assert_allclose(d2[swap], d2_j[swap], rtol=1e-6)
    dist, nn = cKDTree(bdl).query(org, k=1, workers=-1)
    np.testing.assert_allclose(d2, dist ** 2, rtol=1e-4, atol=1e-9)
    assert (idx != nn).mean() < 1e-3


def test_final_transfer_matches_jax(rng):
    """tests/test_tgn_pipeline.py:303-335: a third of the boundary
    distances exactly tied with the sampled ones (ties go to the sampled
    side), and the no-boundary case."""
    n_q, n_s, n_b = 4096, 512, 128
    nn1 = rng.integers(0, n_s, n_q).astype(np.int32)
    nn_b = rng.integers(0, n_b, n_q).astype(np.int32)
    nn1_d2 = rng.uniform(0, 1, n_q).astype(np.float32)
    d_b2 = np.where(rng.uniform(size=n_q) < 0.3, nn1_d2,
                    rng.uniform(0, 1, n_q)).astype(np.float32)
    ins = rng.integers(0, 20, n_s + n_b).astype(np.uint8)
    sem = rng.integers(0, 17, n_s + n_b).astype(np.uint8)
    full_fn, nob_fn = _final_transfer_fns()
    want = jax.device_get(full_fn(jnp.asarray(nn1), jnp.asarray(nn1_d2),
                                  jnp.asarray(nn_b), jnp.asarray(d_b2),
                                  jnp.asarray(ins), jnp.asarray(sem),
                                  jnp.int32(n_s)))
    got = tgn.final_transfer(_t(nn1).long(), _t(nn1_d2), _t(nn_b).long(),
                             _t(d_b2), np.stack([ins, sem]), n_s)
    np.testing.assert_array_equal(got, np.stack(want))
    want0 = jax.device_get(nob_fn(jnp.asarray(nn1), jnp.asarray(ins),
                                  jnp.asarray(sem)))
    got0 = tgn.final_transfer(_t(nn1).long(), _t(nn1_d2), None, None,
                              np.stack([ins, sem]), n_s)
    np.testing.assert_array_equal(got0, np.stack(want0))


def _record(monkeypatch, name):
    """Wrap ``tgn.<name>`` so that each call's arguments and result are kept."""
    calls = []
    fn = getattr(tgn, name)

    def wrapped(*args, **kw):
        out = fn(*args, **kw)
        calls.append((args, kw, out))
        return out

    monkeypatch.setattr(tgn, name, wrapped)
    return calls


def test_pipeline_device_route_matches_jax(tmp_path, monkeypatch):
    """A 150^2-vertex scan (the FPS route at mesh prep and at the fill),
    the stand-ins injected into both packages' pipelines, the port on the
    device route (the route of a CUDA pipeline, set on this CPU one so
    that it runs through the plain versions). The JAX CPU pipeline takes
    its host KD-trees."""
    obj = tmp_path / "scan_lower.obj"
    centers = _stand_in_scan(obj, n_side=150)
    cfg = get_task("tgnet_fps").default_config()
    cfg.model_parameter.update(crop_sample_size=PARITY_CROP)
    stand_in = JaxStandIn(centers)
    ref = JaxPipeline(None, None, cfg, n_sample=PARITY_SAMPLE,
                      boundary_info=PARITY_BOUNDARY,
                      inject_modules=(stand_in, {"params": {}},
                                      stand_in, {"params": {}}))(str(obj))

    clouds = _record(monkeypatch, "boundary_sampled_feats")
    transfers = _record(monkeypatch, "final_transfer")
    torch_in = TorchStandIn(centers)
    pipe = TgnInferencePipeline(
        None, None, {"model_parameter": {"crop_sample_size": PARITY_CROP}},
        n_sample=PARITY_SAMPLE, boundary_info=PARITY_BOUNDARY,
        inject_modules=(torch_in, torch_in), device="cpu")
    pipe._boundary_on_device = True
    got = pipe(str(obj))
    assert len(np.unique(ref["ins"])) >= 5 and len(np.unique(ref["sem"])) >= 5

    # the boundary cloud equals the host route's on the same stage-1 labels
    (args, kw, dev_out), = clouds
    host_out = boundary.boundary_sampled_feats(*args, **dict(kw, org_dev=None))
    assert dev_out[2] == host_out[2] > 0
    for i in (0, 1, 5):
        np.testing.assert_array_equal(dev_out[i], host_out[i])

    # a vertex whose labels differ sits at an equal-distance tie: among the
    # sampled and boundary points nearest to it within float32 rounding
    # (rtol 1e-6 of d2) lie the points of both labels
    differ = np.flatnonzero((got["sem"] != ref["sem"]) | (got["ins"] != ref["ins"]))
    print(f"{differ.size} of {got['sem'].size} vertices differ")
    assert differ.size <= 1e-3 * got["sem"].size
    (targs, _, _), = transfers
    labels, n_sampled = targs[4], targs[5]
    n_bd = dev_out[2]
    cand = np.concatenate([args[2][:, :3], dev_out[0][:n_bd, :3]]).astype(np.float64)
    org = args[1][:, :3].astype(np.float64)
    for v in differ:
        d2 = np.sum((cand - org[v]) ** 2, axis=1)
        tied = d2 <= d2.min() * (1 + 1e-6)
        pairs = set(zip(labels[0][tied].tolist(),
                        class_logits_to_fdi(labels[1][tied]).tolist()))
        assert (got["ins"][v], got["sem"][v]) in pairs, v
        assert (ref["ins"][v], ref["sem"][v]) in pairs, v
        assert tied.sum() >= 2
    assert n_sampled == PARITY_SAMPLE


def test_route_follows_the_device():
    """The boundary stage takes the device route on a CUDA pipeline and the
    host KD-trees on a CPU one, as the JAX package picks its route from
    its backend; no option chooses it."""
    stand_in = TorchStandIn(np.zeros((9, 3), np.float32))
    info = {"bdl_ratio": 0.7, "num_of_bdl_points": 32, "num_of_all_points": 64}
    pipe = TgnInferencePipeline(None, None, None, n_sample=64, boundary_info=info,
                                inject_modules=(stand_in, stand_in), device="cpu")
    assert pipe._boundary_on_device is False
    assert pipe.variants()["boundary_route"] == "host"
    with pytest.raises(TypeError):
        TgnInferencePipeline(None, None, None, n_sample=64, boundary_info=info,
                             inject_modules=(stand_in, stand_in),
                             boundary_route="device", device="cpu")
