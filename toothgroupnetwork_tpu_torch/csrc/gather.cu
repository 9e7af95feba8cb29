// K8: row gather into the lane-packed layout,
//   out[b, m, k*C:(k+1)*C] = x[b, idx[b, m, k], :]
// x [B, N, C], idx [B, M, K] int32 in [0, N), out [B, M, K*C] in x's dtype.
//
// Replaces toothgroupnetwork_tpu/ops/pallas/gather_kernel.py:
// onehot_gather_packed (_gather_kernel) and its [B, M, K, C] view
// onehot_gather. The TPU kernel factors each index into hi * 128 + lo and
// selects rows with one-hot MXU products, because XLA's row gather read a
// whole (8, 128) tile per row there. On Hopper a row gather is an ordinary
// indexed load, so K8 is an indexed copy: bit-equal to index_points for any
// dtype (the one-hot form is exact only for bf16).
//
// What bounds it: bytes. Row r = (b*M + m)*K + k of the output is row
// b*N + idx[r] of x, so the kernel reads B*M*K*C elements through L2 (the
// whole source of a 24000-point cloud, 1.5 MB at C32 bf16, stays resident)
// and writes as many; the writes are the compulsory HBM traffic. One thread
// copies one unit of a row (16 bytes where the row is a multiple of 16
// bytes, else the widest of 8/4/2 that divides it) and neighbouring threads
// take neighbouring units, so a warp reads and writes whole 128-byte lines.
// Indices outside [0, N) are not checked, as in the JAX contract.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename U>
__global__ void gather_rows_kernel(const U* __restrict__ x, const int* __restrict__ idx,
                                   size_t rows, size_t mk, int n, int upr,
                                   U* __restrict__ out) {
    const size_t total = rows * (size_t)upr;
    for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < total;
         e += (size_t)gridDim.x * blockDim.x) {
        const size_t r = e / upr;                 // output row (b*M + m)*K + k
        const int u = (int)(e - r * upr);
        const size_t src = (r / mk) * (size_t)n + idx[r];
        out[e] = x[src * upr + u];
    }
}

template <typename U>
int launch(const void* x, const int* idx, size_t rows, size_t mk, int n,
           size_t row_bytes, void* out, cudaStream_t stream) {
    const int upr = (int)(row_bytes / sizeof(U));
    gather_rows_kernel<U><<<grid_for(rows * upr, kThreads), kThreads, 0, stream>>>(
        static_cast<const U*>(x), idx, rows, mk, n, upr, static_cast<U*>(out));
    return (int)cudaGetLastError();
}

}  // namespace

// x [B, N, C] (row_bytes = C * itemsize), idx [B, M*K] int32 -> out
// [B, M*K, C]. Returns cudaGetLastError().
extern "C" int tgn_gather_rows(const void* x, const int* idx, int b, int n, int mk,
                               int row_bytes, void* out, cudaStream_t stream) {
    const size_t rows = (size_t)b * mk;
    switch (copy_unit((size_t)row_bytes, x, out)) {
        case 16: return launch<uint4>(x, idx, rows, mk, n, row_bytes, out, stream);
        case 8: return launch<uint2>(x, idx, rows, mk, n, row_bytes, out, stream);
        case 4: return launch<unsigned>(x, idx, rows, mk, n, row_bytes, out, stream);
        default: return launch<unsigned short>(x, idx, rows, mk, n, row_bytes, out,
                                               stream);
    }
}
