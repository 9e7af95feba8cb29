"""Instance clustering, numpy and scipy on the host (counterpart of
toothgroupnetwork_tpu/postprocess/clustering.py); the tgnet instancing
(:func:`get_clustering_labels`) runs its DBSCAN and MeanShift climbs on the
card when handed its points' CUDA copy (K9 / K10), with the same labels.

The JAX package calls scikit-learn here; the GPU machine the port serves on
has no scikit-learn, so the estimators it uses are written out below, each
following scikit-learn's algorithm step for step so that the partitions
agree with the JAX package's:

  * :func:`dbscan` — labels and core samples of ``sklearn.cluster.DBSCAN``
    (clusters numbered in the order of their lowest core index, a border
    point joins the first cluster that reaches it, as ``dbscan_inner`` does),
  * :func:`pca_explained_variance` / :func:`pca_components` — the spectrum
    of ``sklearn.decomposition.PCA`` (covariance with ddof=1),
  * :func:`mean_shift` — ``MeanShift(bin_seeding=True)`` (binned seeds), or
    from given seeds (every point: ``MeanShift()``): flat-kernel climbs,
    intensity-ordered de-duplication, 1-NN labels,
  * :func:`kmeans` — ``KMeans(init="k-means++", random_state=seed)``: the
    same ``RandomState`` draws for the greedy k-means++ seeding, then Lloyd
    iterations with scikit-learn's convergence test and empty-cluster
    relocation,
  * :func:`ward` — ``AgglomerativeClustering(k)``: scipy's Ward tree (which
    scikit-learn builds without a connectivity graph) cut into k clusters
    numbered as ``_hc_cut`` numbers them,
  * :func:`gaussian_mixture` — ``GaussianMixture(k, random_state=seed)``:
    full covariances, responsibilities initialised from :func:`kmeans`, EM
    until the mean log-likelihood moves by less than ``tol``, labels the
    most likely component.

:func:`clustering_points` dispatches over them as the JAX function does.
"""

from __future__ import annotations

import heapq

import numpy as np
import torch
from scipy import linalg
from scipy.cluster import hierarchy
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components
from scipy.spatial import cKDTree
from scipy.special import logsumexp

from ..ops.kernels import cluster as cluster_kernels
from ..utils import profiling


def dbscan(x: np.ndarray, eps: float, min_samples: int):
    """Returns (labels [N] int64 with -1 = noise, core_sample_indices)."""
    n = x.shape[0]
    tree = cKDTree(x)
    pairs = tree.query_pairs(eps, output_type="ndarray")        # i < j, d <= eps
    i, j = pairs[:, 0], pairs[:, 1]
    counts = 1 + np.bincount(i, minlength=n) + np.bincount(j, minlength=n)
    core = counts >= min_samples
    labels = np.full(n, -1, np.int64)
    core_idx = np.flatnonzero(core)
    if core_idx.size == 0:
        return labels, core_idx
    # clusters = connected components of the core points' eps-graph
    cc = core[i] & core[j]
    graph = coo_matrix((np.ones(int(cc.sum()), np.int8), (i[cc], j[cc])),
                       shape=(n, n))
    _, comp = connected_components(graph, directed=False)
    # numbered in discovery order: by the lowest core index of each component
    first = np.full(n, n, np.int64)
    np.minimum.at(first, comp[core_idx], core_idx)
    order = np.argsort(first, kind="stable")
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n)
    labels[core_idx] = rank[comp[core_idx]]
    # a border point takes the earliest-discovered cluster among its core
    # neighbours (that cluster's depth-first expansion reaches it first)
    big = np.iinfo(np.int64).max
    border = np.full(n, big, np.int64)
    for a, b in ((i, j), (j, i)):
        sel = core[a] & ~core[b]
        np.minimum.at(border, b[sel], labels[a[sel]])
    has = (~core) & (border != big)
    labels[has] = border[has]
    return labels, core_idx


def pca_explained_variance(x: np.ndarray) -> np.ndarray:
    """Eigenvalues of the ddof=1 covariance, descending (``explained_variance_``)."""
    return np.linalg.eigvalsh(np.cov(np.asarray(x, np.float64), rowvar=False))[::-1]


def pca_components(x: np.ndarray) -> np.ndarray:
    """Principal axes as rows, by descending variance (``components_`` up to the
    sign of each row, which the callers normalise)."""
    _, vecs = np.linalg.eigh(np.cov(np.asarray(x, np.float64), rowvar=False))
    return vecs[:, ::-1].T


def _bin_seeds(x: np.ndarray, bin_size: float) -> np.ndarray:
    """sklearn.cluster.get_bin_seeds with min_bin_freq=1: one seed per occupied
    grid cell, in order of first occupation."""
    cells = np.round(x / bin_size) + 0.0                   # -0.0 -> 0.0
    _, first = np.unique(cells, axis=0, return_index=True)
    seeds = cells[np.sort(first)].astype(np.float32)
    if len(seeds) == len(x):
        return x
    return seeds * bin_size


def mean_shift(x: np.ndarray, bandwidth: float, max_iter: int = 300,
               seeds: np.ndarray | None = None) -> np.ndarray:
    """Flat-kernel mean shift from ``seeds`` (by default the binned seeds);
    returns labels [N] (index of the nearest surviving mode, modes ordered
    by decreasing intensity)."""
    seeds = _bin_seeds(x, bandwidth) if seeds is None else seeds
    return _mean_shift_labels(x, _climbs(x, bandwidth, seeds, max_iter), bandwidth)


def _climbs(x: np.ndarray, bandwidth: float, seeds, max_iter: int) -> dict:
    """Each seed's climb to the mean of its ball until it moves by at most
    ``1e-3 * bandwidth``: {final mean: size of its last ball}, a seed whose
    ball empties left out."""
    tree = cKDTree(x)
    stop = 1e-3 * bandwidth
    intensity: dict[tuple, int] = {}
    for seed in seeds:
        mean, it = seed, 0
        while True:
            nb = np.sort(np.asarray(tree.query_ball_point(mean, bandwidth), np.int64))
            if nb.size == 0:
                break
            old, mean = mean, x[nb].mean(axis=0)
            if np.linalg.norm(mean - old) <= stop or it == max_iter:
                break
            it += 1
        if nb.size:
            intensity[tuple(mean)] = nb.size
    return intensity


def _mean_shift_labels(x: np.ndarray, intensity: dict, bandwidth: float) -> np.ndarray:
    """MeanShift's labels from its climbs' ``intensity`` (final mean ->
    size of its last ball): the modes by decreasing intensity, each
    dropped within ``bandwidth`` of a stronger one, then every point's
    nearest surviving mode."""
    if not intensity:
        raise ValueError(f"no point within bandwidth={bandwidth} of any seed")
    ranked = sorted(intensity.items(), key=lambda t: (t[1], t[0]), reverse=True)
    centers = np.array([c for c, _ in ranked])
    unique = np.ones(len(centers), bool)
    ctree = cKDTree(centers)
    for i, c in enumerate(centers):
        if unique[i]:
            unique[ctree.query_ball_point(c, bandwidth)] = False
            unique[i] = True
    _, labels = cKDTree(centers[unique]).query(x, k=1)
    return labels.astype(np.int64)


def _sq_dists(a: np.ndarray, b: np.ndarray, b2: np.ndarray) -> np.ndarray:
    """sklearn's ``_euclidean_distances`` for float32 data: the expansion in
    float64, stored as float32, clipped at 0."""
    a64 = a.astype(np.float64)
    d = -2.0 * (a64 @ b.astype(np.float64).T)
    d += np.einsum("ij,ij->i", a64, a64)[:, None]
    d += b2[None, :]
    return np.maximum(d.astype(np.float32), 0)


def _kmeans_plusplus(x, k, rs):
    n = x.shape[0]
    w = np.ones(n, x.dtype)
    x2 = np.einsum("ij,ij->i", x.astype(np.float64), x.astype(np.float64))
    trials = 2 + int(np.log(k))
    centers = np.empty((k, x.shape[1]), x.dtype)
    centers[0] = x[rs.choice(n, p=w / w.sum())]
    closest = _sq_dists(centers[:1], x, x2)
    pot = closest @ w
    for c in range(1, k):
        r = rs.uniform(size=trials) * pot
        cand = np.searchsorted(np.cumsum(w * closest), r)
        np.clip(cand, None, closest.size - 1, out=cand)
        d = np.minimum(closest, _sq_dists(x[cand], x, x2))
        pots = d @ w.reshape(-1, 1)
        best = int(np.argmin(pots))
        pot, closest = pots[best], d[best]
        centers[c] = x[cand[best]]
    return centers


def _assign(x, centers):
    d = np.einsum("ij,ij->i", centers, centers)[None, :] - 2.0 * (x @ centers.T)
    return np.argmin(d, axis=1)


def kmeans(x: np.ndarray, k: int, seed: int = 0, max_iter: int = 300,
           tol: float = 1e-4) -> np.ndarray:
    """Lloyd k-means of float32 points with k-means++ seeding from
    ``RandomState(seed)``; returns labels [N]."""
    x = np.array(x, np.float32)
    n = x.shape[0]
    if n < k:
        raise ValueError(f"n_samples={n} should be >= n_clusters={k}")
    rs = np.random.RandomState(seed)
    tol = np.mean(np.var(x, axis=0)) * tol
    x -= x.mean(axis=0)
    centers = _kmeans_plusplus(x, k, rs)
    labels_old = np.full(n, -1)
    strict = False
    for _ in range(max_iter):
        labels = _assign(x, centers)
        counts = np.bincount(labels, minlength=k).astype(x.dtype)
        sums = np.zeros_like(centers)
        np.add.at(sums, labels, x)
        empty = np.flatnonzero(counts == 0)
        if empty.size:
            # relocate each empty cluster onto a point far from its centre
            dist = ((x - centers[labels]) ** 2).sum(axis=1)
            far = np.argpartition(dist, -empty.size)[:-empty.size - 1:-1]
            for new, f in zip(empty, far):
                old = labels[f]
                sums[old] -= x[f]
                sums[new] = x[f]
                counts[new] = 1
                counts[old] -= 1
        new_centers = sums / np.maximum(counts, 1)[:, None]
        new_centers[counts == 0] = centers[counts == 0]
        shift = ((new_centers - centers) ** 2).sum()
        centers = new_centers
        if np.array_equal(labels, labels_old):
            strict = True
            break
        if shift <= tol:
            break
        labels_old = labels
    if not strict:
        labels = _assign(x, centers)
    return labels.astype(np.int64)


def ward(x: np.ndarray, k: int) -> np.ndarray:
    """Labels [N] of ``AgglomerativeClustering(k)`` (Ward linkage): the
    merge tree of ``scipy.cluster.hierarchy.ward`` cut at its k - 1 last
    merges, clusters numbered in the order of ``_hc_cut``'s heap of the
    cut's nodes."""
    n = x.shape[0]
    if not 1 <= k <= n:
        raise ValueError(f"cannot cut {n} samples into {k} clusters")
    if n == 1:
        return np.zeros(1, np.intp)
    children = hierarchy.ward(np.asarray(x))[:, :2].astype(np.intp)
    nodes = [-(int(children[-1].max()) + 1)]
    for _ in range(k - 1):
        these = children[-nodes[0] - n]
        heapq.heappush(nodes, -these[0])
        heapq.heappushpop(nodes, -these[1])
    labels = np.zeros(n, np.intp)
    for i, node in enumerate(nodes):
        todo, leaves = [-node], []
        while todo:
            j = todo.pop()
            if j < n:
                leaves.append(j)
            else:
                todo.extend(children[j - n])
        labels[leaves] = i
    return labels


def _gaussian_parameters(x, resp, reg_covar):
    """The M step: (weights unnormalised, means, precision Cholesky factors)
    of full-covariance components from responsibilities ``resp`` [N, k]."""
    nk = resp.sum(axis=0) + 10 * np.finfo(resp.dtype).eps
    means = resp.T @ x / nk[:, None]
    d = x.shape[1]
    prec_chol = np.empty((len(nk), d, d), x.dtype)
    for c in range(len(nk)):
        diff = x - means[c]
        cov = (resp[:, c] * diff.T) @ diff / nk[c]
        cov.flat[::d + 1] += reg_covar
        chol = linalg.cholesky(cov, lower=True)
        prec_chol[c] = linalg.solve_triangular(chol, np.eye(d, dtype=x.dtype), lower=True).T
    return nk, means, prec_chol


def _weighted_log_prob(x, weights, means, prec_chol):
    """log(weight_c) + log N(x | mean_c, cov_c), [N, k]."""
    d = x.shape[1]
    log_det = np.sum(np.log(prec_chol.reshape(len(means), -1)[:, ::d + 1]), axis=1)
    log_prob = np.empty((x.shape[0], len(means)), x.dtype)
    for c, (mu, pc) in enumerate(zip(means, prec_chol)):
        y = x @ pc - mu @ pc
        log_prob[:, c] = np.sum(np.square(y), axis=1)
    return (-0.5 * (d * np.log(2 * np.pi).astype(x.dtype) + log_prob) + log_det
            + np.log(weights))


def gaussian_mixture(x: np.ndarray, k: int, seed: int = 0, tol: float = 1e-3,
                     reg_covar: float = 1e-6, max_iter: int = 100) -> np.ndarray:
    """Labels [N] of ``GaussianMixture(k, random_state=seed).fit(x)``'s
    ``predict(x)``: full covariances, the responsibilities initialised
    one-hot from ``kmeans(x, k, seed)``, EM steps until the mean
    log-likelihood moves by less than ``tol``, each point's most likely
    component."""
    x = np.asarray(x)
    n = x.shape[0]
    resp = np.zeros((n, k), x.dtype)
    resp[np.arange(n), kmeans(x, k, seed=seed)] = 1
    nk, means, prec_chol = _gaussian_parameters(x, resp, reg_covar)
    weights = nk / n
    lower = -np.inf
    for _ in range(max_iter):
        prev = lower
        weighted = _weighted_log_prob(x, weights, means, prec_chol)
        norm = logsumexp(weighted, axis=1)
        nk, means, prec_chol = _gaussian_parameters(x, np.exp(weighted - norm[:, None]),
                                                    reg_covar)
        weights = nk / nk.sum()
        lower = np.mean(norm)
        if abs(lower - prev) < tol:
            break
    return _weighted_log_prob(x, weights, means, prec_chol).argmax(axis=1)


def clustering_points(moved_points_list, method: str, num_of_clusters=None):
    """Returns (cluster_centroids, cluster_centroid_labels, point_labels_list),
    one entry per input cloud: ``"dbscan"`` (eps 0.03, 60 samples),
    ``"aggl"`` (Ward, ``num_of_clusters``), ``"kmeans"``, ``"mean_shift"``
    (bandwidth 0.05, seeded from every point) and, for any other name, a
    Gaussian mixture of ``num_of_clusters`` components, as the JAX function
    dispatches; the centroids leave out DBSCAN's noise label -1. A
    ``cluster`` span on a thread that traces, counting the ``points``
    clustered (``utils/profiling.py``)."""
    cluster_centroids, cluster_centroid_labels, point_labels_list = [], [], []
    with profiling.span("cluster") as span:
        for b, pts in enumerate(moved_points_list):
            span.count("points", len(pts))
            if method == "dbscan":
                labels = dbscan(pts, 0.03, 60)[0]
            elif method == "mean_shift":
                labels = mean_shift(pts, 0.05, seeds=pts)
            else:
                k = max(1, int(num_of_clusters[b]))
                fit = {"aggl": ward, "kmeans": kmeans}.get(method, gaussian_mixture)
                labels = fit(pts, k)
            point_labels_list.append(labels)
            cents, cent_labels = [], []
            for lab in np.unique(labels):
                if lab != -1:
                    cents.append(pts[labels == lab].mean(axis=0))
                    cent_labels.append(lab)
            cluster_centroids.append(cents)
            cluster_centroid_labels.append(cent_labels)
    return cluster_centroids, cluster_centroid_labels, point_labels_list


def _pca_eigenvalues(points: np.ndarray) -> np.ndarray:
    if points.shape[0] < 3:
        return np.zeros(3)
    return pca_explained_variance(points)


def get_clustering_labels(moved_points: np.ndarray, labels: np.ndarray,
                          device_copy=None) -> np.ndarray:
    """The tgnet instance algorithm: DBSCAN(eps=.03, min_samples=30) on the
    foreground moved points, PCA first-eigenvalue test on each cluster's core
    points, MeanShift(bandwidth=.07, binned seeds) re-split of merged
    clusters, then 10-NN majority absorption of the noise points.

    ``device_copy``: the same points and labels as the tensors they were
    fetched from, ``(points [N, 3] f32, labels [N])``. On a CUDA device the
    DBSCAN runs there as K9 and the re-splits' climbs as K10
    (``ops/kernels/cluster.py``), with the host functions' labels; without
    one, or on any other device, the host functions run. The PCA test, the
    seeds, the modes' de-duplication and labelling, and the 10-NN vote stay
    on the host either way.

    Returns instance labels for the FOREGROUND points only (same order as
    ``moved_points[labels != 0]``). A ``cluster`` span on a thread that
    traces, fetches included, counting the foreground ``points``, those
    instanced on a CUDA device (``card_points``) and the seeds K10 climbed
    (``climbs``) (``utils/profiling.py``)."""
    with profiling.span("cluster") as span:
        fg = moved_points[labels != 0, :]
        fg_dev = None
        if device_copy is not None and device_copy[0].is_cuda:
            points, dev_labels = device_copy
            fg_dev = points[dev_labels != 0]
        span.count("points", fg.shape[0])
        out, climbs = _foreground_instances(fg, fg_dev)
        span.count("card_points", 0 if fg_dev is None else fg.shape[0])
        span.count("climbs", climbs)
        return out


def _foreground_instances(fg: np.ndarray, fg_dev=None) -> tuple[np.ndarray, int]:
    """Instance labels of the foreground ``fg`` and the number of seeds K10
    climbed: on the host, or through K9 / K10 where ``fg_dev`` holds the
    same points as a tensor (on the CPU, their plain twins)."""
    if fg.shape[0] == 0:
        return np.zeros((0,), dtype=np.int64), 0

    if fg_dev is None:
        db_labels, core_idx = dbscan(fg, 0.03, 30)
        core_mask = np.zeros(len(db_labels), dtype=bool)
        core_mask[core_idx] = True
    else:
        db = profiling.fetch(cluster_kernels.dbscan(fg_dev, 0.03, 30)).numpy()
        db_labels, core_mask = db[0], db[1].astype(bool)
    clustering_labels = db_labels.copy()

    merged = _merged_clusters(fg, db_labels, core_mask)
    if fg_dev is None:
        parts, climbs = [mean_shift(fg[db_labels == l], 0.07) for l in merged], 0
    else:
        parts, climbs = _mean_shift_climbed(fg, fg_dev, db_labels, merged, 0.07)
    for idx, (label, part) in enumerate(zip(merged, parts)):
        clustering_labels[clustering_labels == label] = part + 100 * (idx + 1)

    noise = clustering_labels == -1
    if noise.any() and (~noise).any():
        # absorb each noise point into the majority label of its 10 nearest
        # non-noise neighbours (first-occurrence argmax tie-break, as
        # np.unique + argmax in the JAX package)
        k = min(10, int((~noise).sum()))
        _, nn = cKDTree(fg[~noise]).query(fg[noise], k=k)
        nn = nn.reshape(int(noise.sum()), k)
        clustering_labels[noise] = _row_modes(clustering_labels[~noise][nn])
    elif noise.all():
        clustering_labels[:] = 0
    return clustering_labels, climbs


def _merged_clusters(fg: np.ndarray, db_labels: np.ndarray,
                     core_mask: np.ndarray) -> list:
    """The DBSCAN clusters to re-split, in order: of the three whose core
    points have the largest first PCA eigenvalue, those whose eigenvalue
    passes 8 times the mean of the others' (4 clusters or more)."""
    uniq = [l for l in np.unique(db_labels) if l != -1]
    core_points = [fg[core_mask & (db_labels == l)] for l in uniq]
    eg = (np.array([_pca_eigenvalues(cp) for cp in core_points])
          if core_points else np.zeros((0, 3)))

    # merged-cluster test: first-axis variance of the top 3 vs the mean of
    # the 4th and later; needs >= 4 clusters
    resplit = []
    if eg.shape[0] >= 4:
        first_axis = eg[:, 0]
        order = np.argsort(-first_axis)
        sorted_first = first_axis[order]
        tail_mean = sorted_first[3:].mean()
        for i in range(3):
            if tail_mean > 0 and sorted_first[i] / tail_mean > 8:
                resplit.append(uniq[order[i]])
    return resplit


def _climb_inputs(fg: np.ndarray, fg_dev: torch.Tensor, db_labels: np.ndarray,
                  merged: list, bandwidth: float):
    """K10's arguments for re-splitting the clusters ``merged`` of ``fg``
    (the same points on the device: ``fg_dev``): their points one cluster
    after another, taken on the device, the clusters' row offsets, their
    binned seeds and each seed's cluster; with the seeds' clusters and the
    clusters' points on the host."""
    rows = [np.flatnonzero(db_labels == l) for l in merged]
    clouds = [fg[r] for r in rows]
    seeds = [_bin_seeds(x, bandwidth) for x in clouds]
    offsets = np.cumsum([0] + [len(r) for r in rows]).astype(np.int32)
    owner = np.repeat(np.arange(len(rows), dtype=np.int32), [len(s) for s in seeds])

    def up(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(fg_dev.device)

    args = (fg_dev.index_select(0, up(np.concatenate(rows), np.int64)),
            up(offsets, np.int32), up(np.concatenate(seeds), np.float32),
            up(owner, np.int32))
    return args, owner, clouds


def _mean_shift_climbed(fg: np.ndarray, fg_dev: torch.Tensor, db_labels: np.ndarray,
                        merged: list, bandwidth: float) -> tuple[list, int]:
    """``[mean_shift(fg[db_labels == l], bandwidth) for l in merged]`` with
    every cluster's binned seeds climbed in one K10 launch; returns the
    labels and the number of seeds."""
    if not merged:
        return [], 0
    args, owner, clouds = _climb_inputs(fg, fg_dev, db_labels, merged, bandwidth)
    means, counts = cluster_kernels.mean_shift(*args, bandwidth)
    # one fetch: the counts ride as a fourth float32 column, bit for bit
    both = profiling.fetch(torch.cat([means, counts.view(torch.float32)[:, None]],
                                     dim=1)).numpy()
    means, counts = both[:, :3], both[:, 3].view(np.int32)
    labels = [_mean_shift_labels(x, _intensity(means[owner == c], counts[owner == c]),
                                 bandwidth) for c, x in enumerate(clouds)]
    return labels, len(owner)


def _intensity(means: np.ndarray, counts: np.ndarray) -> dict:
    """K10's climbs in :func:`_climbs`'s form."""
    return {tuple(m): int(c) for m, c in zip(means, counts) if c}


def _row_modes(votes: np.ndarray) -> np.ndarray:
    """Each row's most frequent value, the smallest one among ties
    (``u[argmax(c)]`` of ``np.unique(row, return_counts=True)``), for all
    rows at once: a per-row loop holds the GIL for each of ~10^4 noise
    points, which stalls the other scans of ``run_many``."""
    counts = (votes[:, :, None] == votes[:, None, :]).sum(axis=2)
    top = counts == counts.max(axis=1, keepdims=True)
    return np.where(top, votes, np.iinfo(votes.dtype).max).min(axis=1)


def first_label_ratio(labels_arr: np.ndarray) -> np.ndarray:
    """Fraction of each row sharing the first column's label (the 1-NN label's
    share among the k-NN: the boundary purity score)."""
    return (labels_arr == labels_arr[:, :1]).mean(axis=1)
