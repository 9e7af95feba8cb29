// K9 / K10: the tgnet instancing's neighbourhood work on the card.
//
//   K9  tgn_dbscan:     DBSCAN(eps, min_samples) of a foreground cloud
//                       [n, 3] -> labels int64 [n] (-1 noise) and the core
//                       mask, as one int64 [2, n] buffer;
//   K10 tgn_mean_shift: the flat-kernel MeanShift climbs of every seed of
//                       several clusters -> each seed's final mean and the
//                       member count of its last ball.
//
// Replace no TPU kernel: the JAX package runs this clustering on the host
// (scikit-learn), and so did the port (postprocess/clustering.py, numpy and
// scipy). They were added because the host clustering held the card idle
// for a third of a served scan while the moved points were already on it.
//
// Both are exact twins of the host functions (clustering.py: dbscan and
// the climbs of mean_shift), labels and numbering included, with no atomic
// whose order reaches the output:
//
// * The pair test is the KD-tree's: the float32 coordinates widened to
//   float64, the differences squared and summed in the order x, y, z with
//   each product and sum rounded apart (no FMA), compared <= r * r in
//   float64 (scipy's cKDTree computes exactly that for p = 2).
// * K9's components: union-find over the core-core edges, a root always
//   hooked under the smaller root (atomicCAS), so every parent is <= its
//   child and each root is its component's lowest core index, whatever
//   order the hooks run in. Clusters are numbered by the rank of that
//   index (dbscan's discovery order); a border point takes the smallest
//   cluster number among its core neighbours (an atomicMin: its result
//   does not depend on the order).
// * K10's new mean is numpy's x[nb].mean(axis=0) of a float32 [m, 3]: the
//   members' float32 sum in ascending index order from -0.0 (the additive
//   identity, so the sum starts as numpy's does, at the first member), over
//   the count in float32. The stop test is numpy's norm of the float32
//   difference (float32 squares summed in float64, OpenBLAS's sdot, the
//   root in float32), against the threshold the wrapper hands in as numpy
//   would compare it.
//
// What bounds them: K9 needs each of the n(n-1)/2 pairs tested once, 8
// float64 operations a pair (n = 12000: 0.58 GFLOP, 17 us at 34 TFLOP/s);
// its bytes (the cloud, 12 bytes a point) stay in L2. It makes three
// all-pairs passes over the n^2 ordered pairs (counts, unions, border
// points), six times that need, because each pass needs the one before it
// and a pass over ordered pairs writes only its own point's result. Each
// block takes 128 points i against a slice of 2048 points j staged through
// shared memory in float64, so a 12k cloud runs as ~560 blocks. K10 is
// bound by its chain: every climb step sums its members one after another
// (m float32 adds a step), so a seed climbs in one warp — the warp tests
// 32 points at once in float64, its members' coordinates are compacted
// into shared memory and lane 0 adds them in order — and all seeds climb
// in parallel.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;      // K9: points i of a block
constexpr int kSlice = 2048;       // K9: points j of a block (blockIdx.y)
constexpr int kWarps = 4;          // K10: seeds of a block, one a warp
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNone = INT_MAX;

// The KD-tree's squared distance in float64 (source note).
__device__ __forceinline__ double d2_exact(double ax, double ay, double az,
                                           double bx, double by, double bz) {
    const double dx = __dsub_rn(ax, bx), dy = __dsub_rn(ay, by), dz = __dsub_rn(az, bz);
    return __dadd_rn(__dadd_rn(__dmul_rn(dx, dx), __dmul_rn(dy, dy)), __dmul_rn(dz, dz));
}

// Calls visit(j) for each point j of this block's slice within eps of
// point i (the caller's, live only where it has one); the whole block
// stages the slice's tiles, so every thread calls this.
template <typename Visit>
__device__ __forceinline__ void within_eps(const float* __restrict__ xyz, int n, int i,
                                           bool live, double eps2, Visit&& visit) {
    __shared__ double sx[kThreads], sy[kThreads], sz[kThreads];
    double qx = 0.0, qy = 0.0, qz = 0.0;
    if (live) {
        qx = xyz[3 * (size_t)i];
        qy = xyz[3 * (size_t)i + 1];
        qz = xyz[3 * (size_t)i + 2];
    }
    const int j0 = blockIdx.y * kSlice;
    const int j1 = min(n, j0 + kSlice);
    for (int t = j0; t < j1; t += kThreads) {
        const int j = t + threadIdx.x;
        __syncthreads();
        if (j < j1) {
            sx[threadIdx.x] = xyz[3 * (size_t)j];
            sy[threadIdx.x] = xyz[3 * (size_t)j + 1];
            sz[threadIdx.x] = xyz[3 * (size_t)j + 2];
        }
        __syncthreads();
        if (!live) continue;
        const int m = min(kThreads, j1 - t);
        for (int k = 0; k < m; ++k) {
            if (d2_exact(qx, qy, qz, sx[k], sy[k], sz[k]) <= eps2) visit(t + k);
        }
    }
}

__global__ void dbscan_init(int n, int* __restrict__ count, int* __restrict__ parent) {
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
        count[i] = 0;
        parent[i] = i;
    }
}

// Neighbours within eps, the point itself included.
__global__ void dbscan_count(const float* __restrict__ xyz, int n, double eps2,
                             int* __restrict__ count) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    int c = 0;
    within_eps(xyz, n, i, i < n, eps2, [&](int) { ++c; });
    if (i < n && c) atomicAdd(&count[i], c);
}

// The root of x, halving the path on the way (a non-root stays a non-root,
// and an ancestor is always a valid parent, so the stores may race).
__device__ int find_root(volatile int* parent, int x) {
    int p = parent[x];
    while (p != x) {
        const int g = parent[p];
        if (g != p) parent[x] = g;
        x = p;
        p = g;
    }
    return x;
}

__device__ void unite(int* parent, int a, int b) {
    volatile int* par = parent;
    while (true) {
        a = find_root(par, a);
        b = find_root(par, b);
        if (a == b) return;
        if (a > b) {
            const int t = a;
            a = b;
            b = t;
        }
        // hook the larger root under the smaller; another thread hooked it
        // first where the swap fails, and the loop goes on from there
        const int old = atomicCAS(&parent[b], b, a);
        if (old == b) return;
        b = old;
    }
}

__global__ void dbscan_union(const float* __restrict__ xyz, int n, double eps2,
                             int min_samples, const int* __restrict__ count,
                             int* parent) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    const bool live = i < n && count[i] >= min_samples;
    within_eps(xyz, n, i, live, eps2, [&](int j) {
        if (j < i && count[j] >= min_samples) unite(parent, i, j);
    });
}

// One block: each core point's root into `label` (the walk writes
// nothing, so no store races a finished one), the roots ranked in index
// order into their `parent` slot (the tree is no longer needed), then every
// core point's cluster number, its root's rank, in `label` (non-core:
// kNone).
__global__ void dbscan_number(int n, int min_samples, const int* __restrict__ count,
                              int* __restrict__ parent, int* __restrict__ label) {
    __shared__ int part[1024];
    const int tid = threadIdx.x, nt = blockDim.x;
    for (int i = tid; i < n; i += nt) {
        int r = i;
        if (count[i] >= min_samples) {
            while (parent[r] != r) r = parent[r];
        }
        label[i] = count[i] >= min_samples ? r : kNone;
    }
    __syncthreads();
    // thread tid ranks the roots of the contiguous run [lo, hi)
    const int per = (n + nt - 1) / nt;
    const int lo = min(n, tid * per), hi = min(n, lo + per);
    int roots = 0;
    for (int i = lo; i < hi; ++i) roots += label[i] == i;
    part[tid] = roots;
    __syncthreads();
    for (int s = 1; s < nt; s *= 2) {      // inclusive scan of the runs' roots
        const int v = tid >= s ? part[tid - s] : 0;
        __syncthreads();
        part[tid] += v;
        __syncthreads();
    }
    int rank = part[tid] - roots;
    for (int i = lo; i < hi; ++i) {
        if (label[i] == i) parent[i] = rank++;
    }
    __syncthreads();
    for (int i = tid; i < n; i += nt) {
        if (label[i] != kNone) label[i] = parent[label[i]];
    }
}

// A border point's smallest cluster number among its core neighbours
// (the core points' labels are final and only non-core ones change).
__global__ void dbscan_border(const float* __restrict__ xyz, int n, double eps2,
                              int min_samples, const int* __restrict__ count,
                              int* label) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    const bool live = i < n && count[i] < min_samples;
    int best = kNone;
    within_eps(xyz, n, i, live, eps2, [&](int j) {
        if (count[j] >= min_samples) best = min(best, label[j]);
    });
    if (live && best != kNone) atomicMin(&label[i], best);
}

__global__ void dbscan_out(int n, int min_samples, const int* __restrict__ count,
                           const int* __restrict__ label, long long* __restrict__ out) {
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
        out[i] = label[i] == kNone ? -1 : label[i];
        out[(size_t)n + i] = count[i] >= min_samples;
    }
}

// One warp a seed (source note). pts [P, 3] holds the clusters one after
// another, cluster c in rows [offsets[c], offsets[c + 1]).
__global__ void mean_shift_kernel(const float* __restrict__ pts,
                                  const int* __restrict__ offsets,
                                  const float* __restrict__ seeds,
                                  const int* __restrict__ seed_cluster, int s,
                                  double bw2, double stop, int max_iter,
                                  float* __restrict__ means, int* __restrict__ counts) {
    __shared__ float buf[kWarps][3][32];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int seed = blockIdx.x * kWarps + warp;
    if (seed >= s) return;                  // whole warps only: no block barrier
    const int c = seed_cluster[seed];
    const int p0 = offsets[c], p1 = offsets[c + 1];
    float mx = seeds[3 * (size_t)seed], my = seeds[3 * (size_t)seed + 1],
          mz = seeds[3 * (size_t)seed + 2];
    int members = 0;
    for (int it = 0;; ++it) {
        const double qx = mx, qy = my, qz = mz;
        float sx = -0.0f, sy = -0.0f, sz = -0.0f;
        int cnt = 0;
        for (int base = p0; base < p1; base += 32) {
            const int p = base + lane;
            float px = 0.0f, py = 0.0f, pz = 0.0f;
            bool in = false;
            if (p < p1) {
                px = pts[3 * (size_t)p];
                py = pts[3 * (size_t)p + 1];
                pz = pts[3 * (size_t)p + 2];
                in = d2_exact(px, py, pz, qx, qy, qz) <= bw2;
            }
            const unsigned mask = __ballot_sync(kFull, in);
            if (in) {
                const int slot = __popc(mask & ((1u << lane) - 1u));
                buf[warp][0][slot] = px;
                buf[warp][1][slot] = py;
                buf[warp][2][slot] = pz;
            }
            __syncwarp();
            const int m = __popc(mask);
            if (lane == 0) {
                for (int k = 0; k < m; ++k) {
                    sx = __fadd_rn(sx, buf[warp][0][k]);
                    sy = __fadd_rn(sy, buf[warp][1][k]);
                    sz = __fadd_rn(sz, buf[warp][2][k]);
                }
            }
            __syncwarp();
            cnt += m;
        }
        members = cnt;
        if (cnt == 0) break;                // an empty ball: the seed is dropped
        sx = __shfl_sync(kFull, sx, 0);
        sy = __shfl_sync(kFull, sy, 0);
        sz = __shfl_sync(kFull, sz, 0);
        const float fc = (float)cnt;
        const float nx = __fdiv_rn(sx, fc), ny = __fdiv_rn(sy, fc), nz = __fdiv_rn(sz, fc);
        const float dx = __fsub_rn(nx, mx), dy = __fsub_rn(ny, my), dz = __fsub_rn(nz, mz);
        const double sq = __dadd_rn(__dadd_rn((double)__fmul_rn(dx, dx),
                                              (double)__fmul_rn(dy, dy)),
                                    (double)__fmul_rn(dz, dz));
        const float norm = __fsqrt_rn(__double2float_rn(sq));
        mx = nx;
        my = ny;
        mz = nz;
        if ((double)norm <= stop || it == max_iter) break;
    }
    if (lane == 0) {
        means[3 * (size_t)seed] = mx;
        means[3 * (size_t)seed + 1] = my;
        means[3 * (size_t)seed + 2] = mz;
        counts[seed] = members;
    }
}

}  // namespace

// K9. xyz [n, 3] f32, eps2 = eps * eps in float64; scratch int32 [3n];
// out int64 [2, n]: labels (-1 noise), then 1 for a core point.
extern "C" int tgn_dbscan(const float* xyz, int n, double eps2, int min_samples,
                          int* scratch, long long* out, cudaStream_t stream) {
    if (n < 1) return 0;
    int* count = scratch;
    int* parent = scratch + n;
    int* label = scratch + 2 * (size_t)n;
    const dim3 pairs((n + kThreads - 1) / kThreads, (n + kSlice - 1) / kSlice);
    dbscan_init<<<grid_for(n, 256), 256, 0, stream>>>(n, count, parent);
    dbscan_count<<<pairs, kThreads, 0, stream>>>(xyz, n, eps2, count);
    dbscan_union<<<pairs, kThreads, 0, stream>>>(xyz, n, eps2, min_samples, count, parent);
    dbscan_number<<<1, 1024, 0, stream>>>(n, min_samples, count, parent, label);
    dbscan_border<<<pairs, kThreads, 0, stream>>>(xyz, n, eps2, min_samples, count, label);
    dbscan_out<<<grid_for(n, 256), 256, 0, stream>>>(n, min_samples, count, label, out);
    return (int)cudaGetLastError();
}

// K10. pts [P, 3] f32 (cluster c in rows offsets[c]..offsets[c + 1]),
// seeds [s, 3] f32 of clusters seed_cluster [s] int32; bw2 = bandwidth^2
// and stop in float64 -> means [s, 3] f32, counts [s] int32 (0: dropped).
extern "C" int tgn_mean_shift(const float* pts, const int* offsets, const float* seeds,
                              const int* seed_cluster, int s, double bw2, double stop,
                              int max_iter, float* means, int* counts,
                              cudaStream_t stream) {
    if (s < 1) return 0;
    mean_shift_kernel<<<(s + kWarps - 1) / kWarps, 32 * kWarps, 0, stream>>>(
        pts, offsets, seeds, seed_cluster, s, bw2, stop, max_iter, means, counts);
    return (int)cudaGetLastError();
}
