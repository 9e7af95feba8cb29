"""K2's share of its roofline in training: the bound of the K2 calls the
window's steps made (``counts.knn_bound_s`` of each call's shape, as the
task's ``kernel_bounds_s`` counts them) over the device time of K2's kernels
(``csrc/knn.cu``: the norms pre-pass, the tiles, the merge) in the trace."""

KERNELS = ("knn_norms_kernel", "knn_tile_kernel", "knn_merge_kernel", "knn_kernel")


def read(records):
    tr = records.get("trace")
    if not tr or not records.get("k2_bound_s"):
        return None
    t = sum(tr["kernels"].get(k, (0.0, 0))[0] for k in KERNELS)
    return 100.0 * records["k2_bound_s"] / t if t else None
