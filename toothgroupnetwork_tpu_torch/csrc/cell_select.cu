// K4 / K5: per-query neighbour selection from dense 8-query candidate blocks.
//
// Replaces toothgroupnetwork_tpu/ops/pallas/cell_select_kernel.py:
//   K4 cell_select_x (_x_kernel):  x_g[q, k, :] = blk_x[q / 8, pos[q, k], :]
//   K5 cell_select_p (_p_kernel):  p_r[q, k, :] = blk_p[q / 8, pos[q, k], :] - p_q[q, :]
// blk_* [G, L8, C] (G = N / 8) come from ops/cells.py:gather_candidate_blocks;
// pos [N, K] int32. A position outside [0, L8) selects zeros, as the TPU
// kernel's one-hot row with no hit does.
//
// The TPU kernels do the selection as a one-hot MXU contraction, because a
// per-row gather there reads a whole (8, 128) tile per row. On the H100 a
// row gather is an ordinary indexed load, so both kernels are plain indexed
// copies and are bit-equal to their PyTorch twins. What bounds them is
// memory traffic: K4 at N=24000/K=36/C=32 writes 111 MB and reads the
// 98 MB candidate block (through L2, each cell's block is read by its 8
// queries). Consecutive threads take consecutive channels (16-byte float4
// loads and stores when C % 4 == 0), so every warp reads and writes whole
// 128-byte lines.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <int VEC>
__global__ void cell_select_x_kernel(const float* __restrict__ blk,
                                     const int* __restrict__ pos,
                                     size_t rows, int kk, int l8, int c,
                                     float* __restrict__ out) {
    using V = typename std::conditional<VEC == 4, float4, float>::type;
    const int cv = c / VEC;                       // vectors per row
    const size_t total = rows * (size_t)cv;
    const V* src = reinterpret_cast<const V*>(blk);
    V* dst = reinterpret_cast<V*>(out);
    for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < total;
         e += (size_t)gridDim.x * blockDim.x) {
        const size_t row = e / cv;                // q * K + k
        const int ch = (int)(e - row * cv);
        const size_t q = row / kk;
        const int pp = pos[row];
        V v;
        if (pp >= 0 && pp < l8) {
            v = src[((q >> 3) * l8 + pp) * cv + ch];
        } else {
            if constexpr (VEC == 4) {
                v = make_float4(0.f, 0.f, 0.f, 0.f);
            } else {
                v = 0.f;
            }
        }
        dst[e] = v;
    }
}

__global__ void cell_select_p_kernel(const float* __restrict__ blk,
                                     const int* __restrict__ pos,
                                     const float* __restrict__ p_q,
                                     size_t rows, int kk, int l8,
                                     float* __restrict__ out) {
    for (size_t row = blockIdx.x * (size_t)blockDim.x + threadIdx.x; row < rows;
         row += (size_t)gridDim.x * blockDim.x) {
        const size_t q = row / kk;
        const int pp = pos[row];
        const bool hit = pp >= 0 && pp < l8;
        const float* s = blk + ((q >> 3) * l8 + (hit ? pp : 0)) * 3;
        for (int o = 0; o < 3; ++o) {
            const float sel = hit ? s[o] : 0.f;
            out[row * 3 + o] = __fsub_rn(sel, p_q[q * 3 + o]);
        }
    }
}

unsigned grid_for(size_t work) {
    const size_t blocks = (work + kThreads - 1) / kThreads;
    return (unsigned)(blocks < 65535u * 16u ? (blocks > 0 ? blocks : 1) : 65535u * 16u);
}

}  // namespace

// blk [G, L8, C] f32, pos [N, K] int32 (N = 8 G) -> out [N, K, C] f32.
// Returns cudaGetLastError().
extern "C" int tgn_cell_select_x(const float* blk, const int* pos, int n, int kk,
                                 int l8, int c, float* out, cudaStream_t stream) {
    const size_t rows = (size_t)n * kk;
    if (c % 4 == 0) {
        cell_select_x_kernel<4><<<grid_for(rows * (c / 4)), kThreads, 0, stream>>>(
            blk, pos, rows, kk, l8, c, out);
    } else {
        cell_select_x_kernel<1><<<grid_for(rows * c), kThreads, 0, stream>>>(
            blk, pos, rows, kk, l8, c, out);
    }
    return (int)cudaGetLastError();
}

// blk [G, L8, 3] f32, pos [N, K] int32, p_q [N, 3] f32 -> out [N, K, 3] f32.
// Returns cudaGetLastError().
extern "C" int tgn_cell_select_p(const float* blk, const int* pos, const float* p_q,
                                 int n, int kk, int l8, float* out,
                                 cudaStream_t stream) {
    const size_t rows = (size_t)n * kk;
    cell_select_p_kernel<<<grid_for(rows), kThreads, 0, stream>>>(
        blk, pos, p_q, rows, kk, l8, out);
    return (int)cudaGetLastError();
}
