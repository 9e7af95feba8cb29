"""The port's ``clustering_points`` (toothgroupnetwork_tpu_torch/
postprocess/clustering.py, numpy and scipy only) against the JAX
package's, which calls scikit-learn, on the CPU: every method the JAX
function dispatches over (``dbscan``, ``aggl``, ``kmeans``,
``mean_shift`` and, for any other name, a Gaussian mixture) on
well-separated clusters, the point labels ``array_equal`` (each method's
numbering is scikit-learn's: DBSCAN's discovery order, ``_hc_cut``'s heap
order, the k-means++ draws, the modes' intensity order, the mixture's
k-means initialisation), the centroids and their labels alike.
"""

import numpy as np
import pytest

from toothgroupnetwork_tpu.postprocess import clustering as jax_clustering
from toothgroupnetwork_tpu_torch.postprocess import clustering

CENTRES = np.array([[0.0, 0.0, 0.0], [0.5, 0.1, 0.0], [0.1, 0.6, 0.2], [0.6, 0.6, -0.4]])


def blobs(rng, sizes, spread, noise: int = 0) -> np.ndarray:
    """float32 blobs of ``sizes`` points around ``CENTRES`` (shuffled), and
    ``noise`` scattered far points."""
    pts = [rng.normal(CENTRES[i], spread, (s, 3)) for i, s in enumerate(sizes)]
    pts.append(rng.uniform(2.0, 4.0, (noise, 3)))
    out = np.concatenate(pts).astype(np.float32)
    return out[rng.permutation(len(out))]


CASES = {
    # method: (sizes, spread, noise, clusters)
    "dbscan": ((150, 120, 90), 0.004, 12, None),
    "aggl": ((40, 70, 25, 55), 0.02, 0, 4),
    "kmeans": ((40, 70, 25, 55), 0.02, 0, 4),
    "mean_shift": ((60, 45, 30), 0.006, 0, None),
    "gmm": ((40, 70, 25, 55), 0.02, 0, 4),
}


@pytest.mark.parametrize("method", sorted(CASES))
def test_clustering_points_matches_jax(rng, method):
    """Two clouds through both packages' ``clustering_points``: the labels
    ``array_equal``, the centroid labels equal and the centroids within
    float32 rounding; each method finds the blobs (DBSCAN its noise as
    -1, left out of the centroids)."""
    sizes, spread, noise, k = CASES[method]
    clouds = [blobs(rng, sizes, spread, noise), blobs(rng, sizes[::-1], spread, noise)]
    ks = None if k is None else [k, k]
    want = jax_clustering.clustering_points(clouds, method, ks)
    got = clustering.clustering_points(clouds, method, ks)
    for g_cents, g_labs, g_pts, w_cents, w_labs, w_pts in zip(*got, *want):
        np.testing.assert_array_equal(np.asarray(g_pts), np.asarray(w_pts))
        assert [int(v) for v in g_labs] == [int(v) for v in w_labs]
        np.testing.assert_allclose(np.array(g_cents), np.array(w_cents), rtol=0, atol=1e-6)
        assert len(g_labs) == len(sizes)
        if method == "dbscan":
            assert (np.asarray(g_pts) == -1).sum() == noise


def test_every_method_name_is_taken(rng):
    """No method raises: an unknown name takes the Gaussian mixture, as in
    the JAX function."""
    pts = [blobs(rng, (30, 30), 0.01)]
    _, _, mixture = clustering.clustering_points(pts, "gmm", [2])
    _, _, other = clustering.clustering_points(pts, "no_such_method", [2])
    np.testing.assert_array_equal(mixture[0], other[0])
    assert len(set(mixture[0].tolist())) == 2


@pytest.mark.parametrize("k", [1, 2, 5])
def test_ward_cut_numbering(rng, k):
    """``ward`` against ``AgglomerativeClustering(k)`` on scattered points
    (no blobs: every merge of the tree decides the cut), the labels
    ``array_equal``."""
    from sklearn.cluster import AgglomerativeClustering

    x = rng.uniform(-1, 1, (60, 3)).astype(np.float32)
    np.testing.assert_array_equal(clustering.ward(x, k),
                                  AgglomerativeClustering(k).fit(x).labels_)
