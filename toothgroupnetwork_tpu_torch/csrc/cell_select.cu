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
// 98 MB candidate block in float32 (half of each in bfloat16; through L2,
// each cell's block is read by its 8 queries). K4 copies rows of either
// dtype as bytes: one thread per 16-byte unit where a row is a multiple of
// 16 bytes (4 float32 or 8 bfloat16 channels), else the widest of 8/4/2
// bytes that divides it; consecutive threads take consecutive units, so
// every warp reads and writes whole 128-byte lines. A zero unit is +0.0 in
// both dtypes.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename U>
__global__ void cell_select_x_kernel(const U* __restrict__ blk,
                                     const int* __restrict__ pos,
                                     size_t rows, int kk, int l8, int upr,
                                     U* __restrict__ out) {
    const size_t total = rows * (size_t)upr;
    for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < total;
         e += (size_t)gridDim.x * blockDim.x) {
        const size_t row = e / upr;               // q * K + k
        const int u = (int)(e - row * upr);
        const size_t q = row / kk;
        const int pp = pos[row];
        out[e] = (pp >= 0 && pp < l8) ? blk[((q >> 3) * l8 + pp) * upr + u] : U{};
    }
}

template <typename U>
int launch_x(const void* blk, const int* pos, size_t rows, int kk, int l8,
             int row_bytes, void* out, cudaStream_t stream) {
    const int upr = row_bytes / (int)sizeof(U);
    cell_select_x_kernel<U><<<grid_for(rows * upr, kThreads), kThreads, 0, stream>>>(
        static_cast<const U*>(blk), pos, rows, kk, l8, upr, static_cast<U*>(out));
    return (int)cudaGetLastError();
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

}  // namespace

// blk [G, L8, C] (row_bytes = C * itemsize, float32 or bfloat16), pos
// [N, K] int32 (N = 8 G) -> out [N, K, C] in blk's dtype. Returns
// cudaGetLastError().
extern "C" int tgn_cell_select_x(const void* blk, const int* pos, int n, int kk,
                                 int l8, int row_bytes, void* out,
                                 cudaStream_t stream) {
    const size_t rows = (size_t)n * kk;
    switch (copy_unit((size_t)row_bytes, blk, out)) {
        case 16: return launch_x<uint4>(blk, pos, rows, kk, l8, row_bytes, out, stream);
        case 8: return launch_x<uint2>(blk, pos, rows, kk, l8, row_bytes, out, stream);
        case 4: return launch_x<unsigned>(blk, pos, rows, kk, l8, row_bytes, out,
                                          stream);
        default: return launch_x<unsigned short>(blk, pos, rows, kk, l8, row_bytes,
                                                 out, stream);
    }
}

// blk [G, L8, 3] f32, pos [N, K] int32, p_q [N, 3] f32 -> out [N, K, 3] f32.
// Returns cudaGetLastError().
extern "C" int tgn_cell_select_p(const float* blk, const int* pos, const float* p_q,
                                 int n, int kk, int l8, float* out,
                                 cudaStream_t stream) {
    const size_t rows = (size_t)n * kk;
    cell_select_p_kernel<<<grid_for(rows, kThreads), kThreads, 0, stream>>>(
        blk, pos, p_q, rows, kk, l8, out);
    return (int)cudaGetLastError();
}
