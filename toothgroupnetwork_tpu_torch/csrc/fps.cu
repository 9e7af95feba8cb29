// K1: farthest point sampling, one thread block per cloud.
//
// Replaces toothgroupnetwork_tpu/ops/pallas/fps_kernel.py:fps_pallas
// (_fps_folded_kernel and the legacy _fps_kernel), fps_pallas_multicloud
// (_fps_multicloud_kernel) and fps_pallas_batched: one kernel covers the single
// cloud (B = 1), the lockstep crop batch and the per-cloud grid.
//
// Contract (toothgroupnetwork_tpu/ops/fps.py:farthest_point_sample):
//   * seed = first valid point (0 when the cloud has none),
//   * running min distance starts at +inf on valid points, -inf on invalid ones,
//   * each step: dist = min(dist, d2) on valid points, next = argmax(dist) with
//     ties to the lowest index; once the valid points are exhausted the argmax
//     lands on already-selected valid points (distance 0), so repeats are valid.
//
// What bounds it on the H100: latency. The M steps are a sequential chain and
// each step ends in a block-wide argmax (two barriers), so a 24000-sample run
// is 24000 dependent block reductions; the arithmetic (N distance updates per
// step) is small. The mesh-prep cloud (~100k points padded to a multiple of
// 8192, 1.2 MB of xyz) does not fit the 227 KB of shared memory, so nothing is
// sized by N: xyz is read through L2 (50 MB, it stays resident across steps)
// and the running min lives in a global scratch row per cloud that the same
// thread re-reads each step (L1/L2 hits). Distances use the _rn intrinsics in
// the plain twin's order so both pick the same winner on near-ties.

#include "common.cuh"

namespace {

constexpr int kMaxWarps = 32;

// Block-wide argmax (ties to the lowest index); every thread gets the winner.
__device__ int block_argmax(float v, int i, float* s_v, int* s_i) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    warp_argmax(v, i);
    if (lane == 0) {
        s_v[warp] = v;
        s_i[warp] = i;
    }
    __syncthreads();
    if (warp == 0) {
        v = lane < nwarps ? s_v[lane] : -CUDART_INF_F;
        i = lane < nwarps ? s_i[lane] : INT_MAX;
        warp_argmax(v, i);
        if (lane == 0) s_i[0] = i;
    }
    __syncthreads();
    const int winner = s_i[0];
    __syncthreads();  // s_i is reused by the next call
    return winner;
}

__global__ void fps_kernel(const float* __restrict__ xyz,
                           const unsigned char* __restrict__ valid,
                           int n, int m,
                           float* __restrict__ dist,
                           int* __restrict__ out) {
    __shared__ float s_v[kMaxWarps];
    __shared__ int s_i[kMaxWarps];
    const size_t b = blockIdx.x;
    xyz += b * (size_t)n * 3;
    dist += b * (size_t)n;
    out += b * (size_t)m;
    if (valid != nullptr) valid += b * (size_t)n;

    // init the running min and find the first valid point
    int first = INT_MAX;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const bool ok = valid == nullptr || valid[i] != 0;
        dist[i] = ok ? CUDART_INF_F : -CUDART_INF_F;
        if (ok && i < first) first = i;
    }
    first = warp_min_int(first);
    if ((threadIdx.x & 31) == 0) s_i[threadIdx.x >> 5] = first;
    __syncthreads();
    if (threadIdx.x < 32) {
        int v = threadIdx.x < (blockDim.x >> 5) ? s_i[threadIdx.x] : INT_MAX;
        v = warp_min_int(v);
        if (threadIdx.x == 0) s_i[0] = v == INT_MAX ? 0 : v;
    }
    __syncthreads();
    int last = s_i[0];
    __syncthreads();
    if (threadIdx.x == 0) out[0] = last;

    for (int s = 1; s < m; ++s) {
        const float lx = xyz[3 * (size_t)last];
        const float ly = xyz[3 * (size_t)last + 1];
        const float lz = xyz[3 * (size_t)last + 2];
        float best = -CUDART_INF_F;
        int best_i = INT_MAX;
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
            float d = dist[i];
            if (valid == nullptr || valid[i] != 0) {
                const float nd = sq3_rn(__fsub_rn(xyz[3 * (size_t)i], lx),
                                        __fsub_rn(xyz[3 * (size_t)i + 1], ly),
                                        __fsub_rn(xyz[3 * (size_t)i + 2], lz));
                if (nd < d) {
                    d = nd;
                    dist[i] = d;
                }
            }
            argmax_merge(best, best_i, d, i);
        }
        last = block_argmax(best, best_i, s_v, s_i);
        if (threadIdx.x == 0) out[s] = last;
    }
}

}  // namespace

// xyz [B, N, 3] f32, valid [B, N] bool bytes or null, dist scratch [B, N] f32,
// out [B, M] int32. Returns cudaGetLastError() after the launch.
extern "C" int tgn_fps(const float* xyz, const unsigned char* valid, int b,
                       int n, int m, float* dist, int* out,
                       cudaStream_t stream) {
    int threads = 1024;
    while (threads > 32 && threads / 2 >= n) threads /= 2;
    fps_kernel<<<b, threads, 0, stream>>>(xyz, valid, n, m, dist, out);
    return (int)cudaGetLastError();
}
