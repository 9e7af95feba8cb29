// K2: exact k-nearest-neighbour selection, k <= 64, one thread per query.
//
// Replaces toothgroupnetwork_tpu/ops/pallas/knn_kernel.py:knn_pallas_select
// (_knn_kernel). On the TPU that kernel is opt-in and the default selection is
// XLA's approx_max_k; PyTorch has no such primitive, so on Hopper this exact
// kernel serves every k <= 64 query of the inference path.
//
// Contract (toothgroupnetwork_tpu/ops/knn.py:knn_points on CPU, not
// knn_pallas_select):
//   * d2 = max((|q|^2 - 2 q.p) + |p|^2, 0) + bias, bias = 1e10 on masked points
//     (a bias, not an exclusion: fully masked clouds still return indices),
//   * output sorted ascending by (d2, index): ties go to the lower index,
//   * when k > n the tail is index 0 at d2 = 1e10 (the CUDA knnquery
//     unfilled-heap semantics), NOT a repeat of the last neighbour.
//
// What bounds it on the H100: the M x N distance stream (24000 x 24000 at the
// stage-0 self-kNN). It never materialises [M, N] (2.3 GB there): points are
// streamed through shared-memory tiles that every thread of the block reads as
// broadcasts, and each thread keeps its running best-k as a sorted list
// (insertion sort, per-thread local memory that stays in L1). Most candidates
// are rejected by one compare against the current k-th distance, so the cost
// is ~N compares per query. Distances use the _rn intrinsics in the plain
// twin's order, so the kernel and the twin select identically.

#include "common.cuh"

namespace {

constexpr int kMaxK = 64;
constexpr int kThreads = 128;
constexpr int kTile = 1024;

__global__ void knn_kernel(const float* __restrict__ q,
                           const float* __restrict__ p,
                           const float* __restrict__ bias,
                           int m, int n, int k,
                           int* __restrict__ out_idx,
                           float* __restrict__ out_d2) {
    __shared__ float s_x[kTile], s_y[kTile], s_z[kTile], s_p2[kTile], s_b[kTile];
    const size_t b = blockIdx.y;
    const int row = blockIdx.x * blockDim.x + threadIdx.x;
    q += b * (size_t)m * 3;
    p += b * (size_t)n * 3;
    if (bias != nullptr) bias += b * (size_t)n;

    float qx = 0.f, qy = 0.f, qz = 0.f;
    if (row < m) {
        qx = q[3 * (size_t)row];
        qy = q[3 * (size_t)row + 1];
        qz = q[3 * (size_t)row + 2];
    }
    const float q2 = sq3_rn(qx, qy, qz);

    float best_d[kMaxK];
    int best_i[kMaxK];
    for (int j = 0; j < k; ++j) {
        best_d[j] = CUDART_INF_F;
        best_i[j] = 0;
    }

    for (int base = 0; base < n; base += kTile) {
        const int len = min(kTile, n - base);
        __syncthreads();
        for (int t = threadIdx.x; t < len; t += blockDim.x) {
            const float x = p[3 * (size_t)(base + t)];
            const float y = p[3 * (size_t)(base + t) + 1];
            const float z = p[3 * (size_t)(base + t) + 2];
            s_x[t] = x;
            s_y[t] = y;
            s_z[t] = z;
            s_p2[t] = sq3_rn(x, y, z);
            s_b[t] = bias != nullptr ? bias[base + t] : 0.f;
        }
        __syncthreads();
        if (row >= m) continue;
        for (int t = 0; t < len; ++t) {
            const float cross = __fadd_rn(
                __fadd_rn(__fmul_rn(qx, s_x[t]), __fmul_rn(qy, s_y[t])),
                __fmul_rn(qz, s_z[t]));
            const float e = __fadd_rn(__fsub_rn(q2, __fmul_rn(2.f, cross)), s_p2[t]);
            const float d = __fadd_rn(fmaxf(e, 0.f), s_b[t]);
            if (d < best_d[k - 1]) {
                // strict compares keep earlier (lower) indices ahead on ties
                int j = k - 1;
                while (j > 0 && best_d[j - 1] > d) {
                    best_d[j] = best_d[j - 1];
                    best_i[j] = best_i[j - 1];
                    --j;
                }
                best_d[j] = d;
                best_i[j] = base + t;
            }
        }
    }
    if (row >= m) return;
    int* oi = out_idx + (b * (size_t)m + row) * k;
    float* od = out_d2 + (b * (size_t)m + row) * k;
    for (int j = 0; j < k; ++j) {
        const bool filled = j < n;  // k > n: index 0 at 1e10
        oi[j] = filled ? best_i[j] : 0;
        od[j] = filled ? best_d[j] : 1e10f;
    }
}

}  // namespace

// q [B, M, 3], p [B, N, 3] f32; bias [B, N] f32 or null; out_idx [B, M, k]
// int32, out_d2 [B, M, k] f32. Returns cudaGetLastError() after the launch.
extern "C" int tgn_knn(const float* q, const float* p, const float* bias, int b,
                       int m, int n, int k, int* out_idx, float* out_d2,
                       cudaStream_t stream) {
    if (k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
    dim3 grid((m + kThreads - 1) / kThreads, b);
    knn_kernel<<<grid, kThreads, 0, stream>>>(q, p, bias, m, n, k, out_idx, out_d2);
    return (int)cudaGetLastError();
}
