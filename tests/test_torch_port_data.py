"""The port's host data layer (``toothgroupnetwork_tpu_torch/data``) against
the JAX package's, on the CPU.

The port keeps its own copies of the scan prep, the .obj parsers, the vertex
normals and the midpoint subdivision, so that it imports nothing of the JAX
package. On the same synthetic .obj the two give bit-equal arrays: the tgn
scan prep with and without the subdivision branch and with duplicated
vertices, the numpy parser on every face form, and the native parser where
``native/libfast_obj.so`` loads.
"""

import numpy as np
import pytest

from synthetic import write_synthetic_obj
from toothgroupnetwork_tpu.data import fast_obj as jax_fast_obj
from toothgroupnetwork_tpu.data import mesh_io as jax_mesh_io
from toothgroupnetwork_tpu.data import scan_prep as jax_scan_prep
from toothgroupnetwork_tpu_torch.data import fast_obj, mesh_io, scan_prep


def _equal(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _with_duplicates(src: str, dst: str, rng) -> None:
    """``src`` with 50 vertex lines repeated at the end and the faces of the
    first 100 re-pointed at the copies (the dedup path then remaps them)."""
    lines = open(src).read().splitlines()
    verts = [ln for ln in lines if ln.startswith("v ")]
    faces = [ln for ln in lines if ln.startswith("f ")]
    picks = rng.choice(len(verts), 50, replace=False)
    copy_of = {int(p) + 1: len(verts) + i + 1 for i, p in enumerate(picks)}
    out = verts + [verts[p] for p in picks]
    for i, ln in enumerate(faces):
        ids = [int(t) for t in ln.split()[1:]]
        if i < 100:
            ids = [copy_of.get(v, v) for v in ids]
        out.append("f " + " ".join(map(str, ids)))
    open(dst, "w").write("\n".join(out) + "\n")


@pytest.mark.parametrize("case,n_sample", [("subdivided", 2000), ("as_is", 500),
                                           ("duplicates", 2000)])
def test_prep_scan_host_tgn_matches_jax(tmp_path, rng, case, n_sample):
    """A 900-vertex sheet: below ``n_sample`` the bdl features come from the
    midpoint-subdivided mesh, at or above it they copy the vertex features."""
    path = str(tmp_path / "scan.obj")
    write_synthetic_obj(path, n_side=30, seed=2)
    if case == "duplicates":
        _with_duplicates(path, str(tmp_path / "dup.obj"), rng)
        path = str(tmp_path / "dup.obj")
    got = scan_prep.prep_scan_host_tgn(path, n_sample)
    want = jax_scan_prep.prep_scan_host_tgn(path, n_sample)
    for g, w in zip(got, want):
        _equal(g, w)
    org, bdl = got
    assert org.shape == (900, 6)
    assert bdl.shape[0] == (900 if case == "as_is" else 900 + 29 * 29 * 3 + 2 * 29)
    assert scan_prep.N_SAMPLE == jax_scan_prep.N_SAMPLE


def test_dedup_matches_jax(rng):
    verts = rng.integers(0, 5, (300, 3)).astype(np.float64)
    verts[::7] *= -0.0                     # -0.0 equal to 0.0
    faces = rng.integers(0, 300, (200, 3))
    for g, w in zip(scan_prep.dedup_vertices(verts, faces),
                    jax_scan_prep.dedup_vertices(verts, faces)):
        _equal(g, w)


def test_numpy_parser_matches_jax(tmp_path):
    """Every face form the parser takes: ``f a b c``, ``f a//n ...`` and
    ``f a/t/n ...``, blank lines and other tags skipped."""
    path = tmp_path / "forms.obj"
    path.write_text("# comment\nv 0 0 0\nv 1 0 0\nv 0 1 0\n\nv 1 1 0.5\n"
                    "vn 0 0 1\nvt 0 0\nf 1 2 3\nf 2//1 4//1 3//1\n"
                    "f 1/1/1 2/1/1 4/1/1\n")
    verts, faces = mesh_io.parse_obj_numpy(str(path))
    jax_fast_obj._LIB, jax_fast_obj._TRIED = None, True    # the numpy parser
    try:
        want = jax_mesh_io.parse_obj(str(path))
    finally:
        jax_fast_obj._TRIED = False
    _equal(verts, want[0])
    _equal(faces, want[1])
    _equal(faces, np.array([[0, 1, 2], [1, 3, 2], [0, 1, 3]], np.int64))


def test_parse_obj_matches_jax(tmp_path):
    """``parse_obj`` takes the native library where it loads, as the JAX
    package's loader does, and gives the JAX package's arrays bit for bit.
    The native and the numpy parser round a decimal apart by at most an
    ulp (strtod against Python's float), in both packages."""
    path = str(tmp_path / "scan.obj")
    write_synthetic_obj(path, n_side=20, seed=3)
    fast = fast_obj.parse_obj_fast(path)
    assert (fast is None) == (jax_fast_obj.parse_obj_fast(path) is None)
    for g, w in zip(mesh_io.parse_obj(path), jax_mesh_io.parse_obj(path)):
        _equal(g, w)
    if fast is not None:
        verts, faces = mesh_io.parse_obj_numpy(path)
        np.testing.assert_allclose(fast[0], verts, rtol=1e-15, atol=0)
        _equal(fast[1], faces)


def test_normals_and_subdivision_match_jax(rng):
    verts = rng.standard_normal((60, 3))
    faces = rng.integers(0, 50, (80, 3))       # vertices 50.. are unreferenced
    _equal(mesh_io.compute_vertex_normals(verts, faces),
           jax_mesh_io.compute_vertex_normals(verts, faces))
    for g, w in zip(mesh_io.subdivide_midpoint(verts, faces, 2),
                    jax_mesh_io.subdivide_midpoint(verts, faces, 2)):
        _equal(g, w)
