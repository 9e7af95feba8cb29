// K3 / K6 / K7: fused eval-mode point-transformer vector attention, and
// tgn_project_kv, the per-point k/v projection that K3 runs first.
//
// K3 (tgn_project_kv, then tgn_attention) replaces toothgroupnetwork_tpu/
// ops/pallas/attention_kernel.py: fused_vector_attention_packed_x
// (_packed_x_kernel + _packed_body) and fuses the neighbour gather as well.
// K6 (tgn_attention_gathered) replaces attention_kernel.py:
// fused_vector_attention (_attn_kernel): it takes the gathered rows x_g and
// the relative positions p_r, as the cell-attention path produces them
// (K4/K5, csrc/cell_select.cu). K7 (tgn_attention_projected) replaces
// attention_kernel.py: fused_vector_attention_packed (_packed_kernel): it
// takes k and v already projected, k_g and v_g, with p_r. The three share
// one kernel body; only the loader (a template parameter) differs.
// BatchNorms folded as in fold_bn / fold_attention_params. For one query
// row (b, n) with neighbours k < K:
//   (0) load: K3 reads rows j = knn_idx[b, n, k] of the projection kv
//       [B*N, 2C] and forms p[b, j] - p[b, n]; K6 reads rows (b*N + n)*K + k
//       of x_g and p_r; K7 reads those rows of k_g, v_g and p_r
//   (1) k = x Wk + bk, v = x Wv + bv: K3 once per point (tgn_project_kv),
//       K6 per gathered row inside the CTA, K7 not at all
//   (2) pe = relu(p_r A0 + b0) A1 + b1        (A0/b0 carry the folded BN)
//   (3) w = relu(s1 * (relu(s0 * (k - q + pe) + t0) W0 + c0) + t1) W1 + c1
//   (4) softmax of w over the K neighbours, per channel group
//   (5) out[c] = sum_k (v + pe)[k, c] * w[k, c mod cs]
//
// Element types (template T, float or bfloat16), as the JAX entries'
// contracts give them; every sum runs in float32:
//   K3: x, q and out in T; p float32; p_r rounded to T after the f32
//       subtraction (the JAX backbone casts p_r to the model dtype); with
//       T = bf16 the caller rounds Wk/Wv to bf16 (the bf16 kron weights)
//   K6: x_g and p_r in T, q, weights and out float32
//   K7: q, k_g, v_g and p_r in T, out float32
// Reads in T are widened to float exactly; a bf16 store rounds to nearest.
// The projection's bias is a float32 add after the float32 sum, as the JAX
// body adds it after its dot; k and v stay float32 (preferred_element_type).
//
// What bounds it on the H100, and what the design does about it:
// * The k/v projection: 4 Cin C operations a point (K3) or a gathered row
//   (K6). K3 projects each point once, since k_g[j] = (x Wk + bk)[idx[j]]:
//   tgn_project_kv is a 64 x 64 tile product into a float32 scratch kv
//   [B*N, 2C] (6.1 MB at B1/24000/C32, L2 resident for the attention launch
//   that follows). The TPU kernel paid the K-fold work with its
//   kron(I_K, W) dot, free on the MXU; on CUDA cores it was 4.4x (C32) to
//   9x (C512) the function's operations. K6's contract hands it K distinct
//   rows, so its K-fold product is real: a CTA runs it as 64 x 64 tiles over
//   its R*K rows, Wk|Wv staged in shared memory once when Cin <= 32.
//   bf16 rows run the tile product on the tensor cores (mma.sync m16n8k16,
//   float32 accumulators). K3's weights are the bf16-rounded Wk/Wv of its
//   contract, so each product is exact. K6's weights are float32: each is
//   split into three bf16 pieces (hi + mid + lo, exact to float32's 24
//   bits), three products a tile, so no float32 weight is rounded.
//   float32 rows: K3's projection, once per point, runs on the FMA units
//   (4 x 4 sums a thread, each in order with float32 rounding at every
//   step, as a plain loop sums); K6's K-fold product, 36 times larger, runs
//   as three TF32 products on the tensor cores (each operand split into a
//   TF32 high part and the TF32 of its remainder, about 21 of float32's 24
//   bits; the tensor cores' float32 sums truncate, about 1e-5 off at C512
//   on an H100, inside K6's 1e-4), never plain TF32. Each staging pass
//   issues all its loads before it stores any: 8 loads in flight a thread.
// * After the projection the layer is a chain of small steps per row, bound
//   by latency and by shared-memory traffic, not by operations. A CTA takes
//   R query rows (R*K neighbour rows; R from the shapes, smaller when the
//   launch would leave SMs idle) and stages the folded parameters of its
//   channels in shared memory with one float4 pass (laid out per CTA once
//   per parameter set, tgn_attention_param_map); each step is one pass of all 256
//   threads over the CTA's rows, so a row costs no barrier of its own.
//   Steps (2)+(3a) and (5) give each thread a fixed channel (its parameters
//   in registers) and walk the neighbour rows, four rows' loads in flight;
//   (2)+(3a) keeps u and v + pe side by side in shared memory (K6 writes
//   them over its projected k and v). (3b) and (3c) give a thread one
//   neighbour row and four output groups (one float4 weight read a step).
//   (4) is one warp per (row, group) with shuffle max and sum.
//   (3b) stays float32 on the CUDA cores: its input u is a float32
//   intermediate, and rounding it to bf16 for the tensor cores would break
//   the float32 compute of the contract (2 K C cs operations a row, K/16
//   times the projection's 4 C^2 a point).
// * At C >= 256 a row alone fills a CTA, and B1/93/K24/C512 had 93 CTAs for
//   132 SMs. The channels are split over a cluster of S = C/128 CTAs (<= 4):
//   each projects, gathers and aggregates its C/S channels and sums its part
//   of (3b); the parts are added in rank order through distributed shared
//   memory (the same order in every CTA: deterministic, no atomics), and
//   every CTA then runs (3c)-(4) for the whole row.

#include <cooperative_groups.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;   // rows and columns of a projection tile
constexpr int kDepth = 32;  // input channels staged at a time
constexpr int kPadF = 4;    // float padding of a staged row (16-byte aligned)
constexpr int kPadH = 8;    // bf16 padding: conflict-free fragment reads
constexpr int kStaged = kTile * kDepth / kThreads;  // elements a thread stages
constexpr int kStageF32 = 2 * 4 * kDepth * (kTile + kPadF);
constexpr int kStageBf16 = 2 * 4 * kTile * (kDepth + kPadH);  // x + 3 weight pieces
constexpr int kStageBytes = kStageF32 > kStageBf16 ? kStageF32 : kStageBf16;

// Column n of a CTA's slice of [k | v] (its cw channels of k, then the same
// channels of v) -> column of Wk|Wv [Cin, 2C]; {c, c, 0} is the identity.
struct Cols {
    int c, cw, g0;
    __device__ int operator()(int n) const { return n < cw ? g0 + n : c + g0 + n - cw; }
};

// Read-only loads through the non-coherent path: the compiler may issue
// them ahead of the shared-memory stores between them.
__device__ __forceinline__ float ldg(const float* p, size_t i) { return __ldg(p + i); }
__device__ __forceinline__ float ldg(const __nv_bfloat16* p, size_t i) {
    return __bfloat162float(
        __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p) + i)));
}
__device__ __forceinline__ __nv_bfloat16 ldg_raw(const __nv_bfloat16* p, size_t i) {
    return __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p) + i));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

// d += a b on the tensor cores: A 16x16 (row), B 16x8 (col), bf16, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
    return r;
}

// v = hi + lo + (about 2^-22 |v|), both parts TF32
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
    hi = to_tf32(v);
    lo = to_tf32(v - __uint_as_float(hi));
}

// d += a b on the tensor cores: A 16x8 (row), B 8x8 (col), tf32, f32 sums
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The projection of `rows` rows of x (row-major [rows, cin]), float32 rows
// on the FMA units: out[m * ldo + n] = sum_i x[m, i] W[i, cols(n)] +
// bias[cols(n)] for n < ncols, in 64 x 64 tiles; wt is Wk|Wv transposed,
// [2C, Cin]. Each thread keeps 4 x 4 sums, each over i in order as a plain
// loop runs it, with float32 rounding at every step; both operands are
// staged with i outermost so they are float4 reads. Every thread of the
// CTA calls it.
__device__ void project_fma(const float* x, int rows, int cin, const float* wt,
                            Cols cols, const float* bias, float* out, int ldo, int ncols,
                            unsigned char* stage) {
    constexpr int ld = kTile + kPadF;
    float* xs = reinterpret_cast<float*>(stage);  // [kDepth][ld], x transposed
    float* ws = xs + kDepth * ld;                 // [kDepth][ld], W [i][n]
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    for (int n0 = 0; n0 < ncols; n0 += kTile) {
        for (int m0 = 0; m0 < rows; m0 += kTile) {
            float acc[4][4] = {};
            for (int i0 = 0; i0 < cin; i0 += kDepth) {
                float xv[kStaged], wv[kStaged];
#pragma unroll
                for (int u = 0; u < kStaged; ++u) {
                    const int e = threadIdx.x + u * kThreads;
                    const int r = e / kDepth, i = e % kDepth;
                    xv[u] = (m0 + r < rows && i0 + i < cin)
                                ? ldg(x, (size_t)(m0 + r) * cin + i0 + i) : 0.f;
                    wv[u] = (n0 + r < ncols && i0 + i < cin)
                                ? ldg(wt, (size_t)cols(n0 + r) * cin + i0 + i) : 0.f;
                }
                __syncthreads();  // the previous tile is consumed
#pragma unroll
                for (int u = 0; u < kStaged; ++u) {
                    const int e = threadIdx.x + u * kThreads;
                    xs[(e % kDepth) * ld + e / kDepth] = xv[u];
                    ws[(e % kDepth) * ld + e / kDepth] = wv[u];
                }
                __syncthreads();
#pragma unroll 4
                for (int i = 0; i < kDepth; ++i) {
                    const float4 a4 = *reinterpret_cast<const float4*>(xs + i * ld + 4 * ty);
                    const float4 b4 = *reinterpret_cast<const float4*>(ws + i * ld + 4 * tx);
                    const float av[4] = {a4.x, a4.y, a4.z, a4.w};
                    const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
                    for (int r = 0; r < 4; ++r) {
#pragma unroll
                        for (int q = 0; q < 4; ++q) {
                            acc[r][q] = fmaf(av[r], bv[q], acc[r][q]);
                        }
                    }
                }
            }
#pragma unroll
            for (int r = 0; r < 4; ++r) {
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const int m = m0 + ty * 4 + r, n = n0 + tx * 4 + q;
                    if (m < rows && n < ncols) {
                        out[(size_t)m * ldo + n] = acc[r][q] + bias[cols(n)];
                    }
                }
            }
        }
    }
}

// The projection of `rows` rows of x (row-major [rows, cin]), float32 rows:
// out[m * ldo + n] = sum_i x[m, i] W[i, cols(n)] + bias[cols(n)] for
// n < ncols, in 64 x 64 tiles; wt is Wk|Wv transposed, [2C, Cin] float32.
// Each product is three TF32 products on the tensor cores, x_lo W_hi +
// x_hi W_lo + x_hi W_hi, every operand split into a TF32 high part and the
// TF32 of its remainder: about 21 of float32's 24 bits, never plain TF32
// (which keeps 10). Warp w computes rows 16 (w % 4) .. + 16 and columns
// 32 (w / 4) .. + 32 of a tile. With one chunk of depth (cin <= 32) a column
// tile's W is staged once for all row tiles. Every thread of the CTA calls
// it.
__device__ void project_tf32x3(const float* x, int rows, int cin, const float* wt, int c2,
                            Cols cols, const float* bias, float* out, int ldo, int ncols,
                            unsigned char* stage) {
    constexpr int ld = kDepth + kPadF;  // conflict-free fragment reads
    float* xs = reinterpret_cast<float*>(stage);  // [kTile][ld]
    float* ws = xs + kTile * ld;                  // [kTile][ld], n-major
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int wm = (warp % 4) * 16, wn = (warp / 4) * 32;
    const bool one_chunk = cin <= kDepth;
    for (int n0 = 0; n0 < ncols; n0 += kTile) {
        for (int m0 = 0; m0 < rows; m0 += kTile) {
            float acc[4][4] = {};
            for (int i0 = 0; i0 < cin; i0 += kDepth) {
                float xv[kStaged];
#pragma unroll
                for (int u = 0; u < kStaged; ++u) {
                    const int e = threadIdx.x + u * kThreads;
                    const int m = e / kDepth, i = e % kDepth;
                    xv[u] = (m0 + m < rows && i0 + i < cin)
                                ? ldg(x, (size_t)(m0 + m) * cin + i0 + i) : 0.f;
                }
                __syncthreads();  // the previous tile is consumed
#pragma unroll
                for (int u = 0; u < kStaged; ++u) {
                    const int e = threadIdx.x + u * kThreads;
                    xs[(e / kDepth) * ld + e % kDepth] = xv[u];
                }
                if (!one_chunk || m0 == 0) {
                    float wv[kStaged];
#pragma unroll
                    for (int u = 0; u < kStaged; ++u) {
                        const int e = threadIdx.x + u * kThreads;
                        const int n = e / kDepth, i = e % kDepth;
                        wv[u] = (n0 + n < ncols && i0 + i < cin)
                                    ? ldg(wt, (size_t)cols(n0 + n) * cin + i0 + i) : 0.f;
                    }
#pragma unroll
                    for (int u = 0; u < kStaged; ++u) {
                        const int e = threadIdx.x + u * kThreads;
                        ws[(e / kDepth) * ld + e % kDepth] = wv[u];
                    }
                }
                __syncthreads();
#pragma unroll
                for (int k0 = 0; k0 < kDepth; k0 += 8) {
                    const float* xa = xs + (wm + g) * ld + k0 + t;
                    uint32_t ah[4], al[4];
                    split_tf32(xa[0], ah[0], al[0]);
                    split_tf32(xa[8 * ld], ah[1], al[1]);
                    split_tf32(xa[4], ah[2], al[2]);
                    split_tf32(xa[8 * ld + 4], ah[3], al[3]);
#pragma unroll
                    for (int nt = 0; nt < 4; ++nt) {
                        const float* wb = ws + (wn + nt * 8 + g) * ld + k0 + t;
                        uint32_t bh0, bl0, bh1, bl1;
                        split_tf32(wb[0], bh0, bl0);
                        split_tf32(wb[4], bh1, bl1);
                        mma_tf32(acc[nt], al, bh0, bh1);
                        mma_tf32(acc[nt], ah, bl0, bl1);
                        mma_tf32(acc[nt], ah, bh0, bh1);
                    }
                }
            }
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
                for (int h = 0; h < 4; ++h) {
                    const int m = m0 + wm + g + 8 * (h / 2);
                    const int n = n0 + wn + nt * 8 + 2 * t + h % 2;
                    if (m < rows && n < ncols) {
                        out[(size_t)m * ldo + n] = acc[nt][h] + bias[cols(n)];
                    }
                }
            }
        }
    }
}

// The same from bf16 rows on the tensor cores: wt holds kPieces bf16
// pieces of W transposed, [kPieces, 2C, Cin], whose products are summed
// (1: the bf16 weights of K3; 3: float32 weights split hi + mid + lo). Warp
// w computes rows 16 (w % 4) .. + 16 and columns 32 (w / 4) .. + 32 of a
// tile as four m16n8k16 products (times the pieces) a 16-deep step.
template <int kPieces>
__device__ void project_bf16(const __nv_bfloat16* x, int rows, int cin,
                             const __nv_bfloat16* wt, int c2, Cols cols,
                             const float* bias, float* out, int ldo, int ncols,
                             unsigned char* stage) {
    constexpr int ld = kDepth + kPadH;
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(stage);  // [kTile][ld]
    __nv_bfloat16* ws = xs + kTile * ld;                          // [kPieces][kTile][ld]
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int wm = (warp % 4) * 16, wn = (warp / 4) * 32;
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
    const bool one_chunk = cin <= kDepth;
    for (int n0 = 0; n0 < ncols; n0 += kTile) {
        for (int m0 = 0; m0 < rows; m0 += kTile) {
            float acc[4][4] = {};
            for (int i0 = 0; i0 < cin; i0 += kDepth) {
                __nv_bfloat16 xv[kStaged];
#pragma unroll
                for (int u = 0; u < kStaged; ++u) {
                    const int e = threadIdx.x + u * kThreads;
                    const int m = e / kDepth, i = e % kDepth;
                    xv[u] = (m0 + m < rows && i0 + i < cin)
                                ? ldg_raw(x, (size_t)(m0 + m) * cin + i0 + i) : zero;
                }
                __syncthreads();  // the previous tile is consumed
#pragma unroll
                for (int u = 0; u < kStaged; ++u) {
                    const int e = threadIdx.x + u * kThreads;
                    xs[(e / kDepth) * ld + e % kDepth] = xv[u];
                }
                for (int pc = 0; pc < kPieces && (!one_chunk || m0 == 0); ++pc) {
                    __nv_bfloat16 wv[kStaged];  // one piece at a time: fewer registers
#pragma unroll
                    for (int u = 0; u < kStaged; ++u) {
                        const int e = threadIdx.x + u * kThreads;
                        const int i = e % kDepth, n = e / kDepth;
                        wv[u] = (n0 + n < ncols && i0 + i < cin)
                                    ? ldg_raw(wt, ((size_t)pc * c2 + cols(n0 + n)) * cin
                                                      + i0 + i)
                                    : zero;
                    }
#pragma unroll
                    for (int u = 0; u < kStaged; ++u) {
                        const int e = threadIdx.x + u * kThreads;
                        ws[(pc * kTile + e / kDepth) * ld + e % kDepth] = wv[u];
                    }
                }
                __syncthreads();
#pragma unroll
                for (int k0 = 0; k0 < kDepth; k0 += 16) {
                    const __nv_bfloat16* xa = xs + (wm + g) * ld + k0 + 2 * t;
                    const uint32_t a[4] = {ld32(xa), ld32(xa + 8 * ld), ld32(xa + 8),
                                           ld32(xa + 8 * ld + 8)};
#pragma unroll
                    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
                        for (int pc = 0; pc < kPieces; ++pc) {
                            const __nv_bfloat16* wb =
                                ws + (pc * kTile + wn + nt * 8 + g) * ld + k0 + 2 * t;
                            mma_bf16(acc[nt], a, ld32(wb), ld32(wb + 8));
                        }
                    }
                }
            }
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
                for (int h = 0; h < 4; ++h) {
                    const int m = m0 + wm + g + 8 * (h / 2);
                    const int n = n0 + wn + nt * 8 + 2 * t + h % 2;
                    if (m < rows && n < ncols) {
                        out[(size_t)m * ldo + n] = acc[nt][h] + bias[cols(n)];
                    }
                }
            }
        }
    }
}

// kPieces: bf16 rows, the bf16 weight pieces (1 or 3); float32 rows, 0 for
// the FMA units, 3 for three TF32 products on the tensor cores
template <typename T, int kPieces>
__device__ void project(const T* x, int rows, int cin, const void* w, int c2, Cols cols,
                        const float* bias, float* out, int ldo, int ncols,
                        unsigned char* stage) {
    if constexpr (std::is_same_v<T, float> && kPieces == 0) {
        project_fma(x, rows, cin, static_cast<const float*>(w), cols, bias, out, ldo, ncols,
                    stage);
    } else if constexpr (std::is_same_v<T, float>) {
        project_tf32x3(x, rows, cin, static_cast<const float*>(w), c2, cols, bias, out, ldo,
                       ncols, stage);
    } else {
        project_bf16<kPieces>(x, rows, cin, static_cast<const __nv_bfloat16*>(w), c2, cols,
                              bias, out, ldo, ncols, stage);
    }
}

// K3 step (1): kv [M, 2C] = x [M, Cin] [Wk | Wv] + [bk | bv], one 64 x 64
// tile a CTA. Cols{c, c, n0} maps the tile's column n to n0 + n (n0 > 0
// only where 64 <= c or 2c - n0 <= c).
template <typename T, int kPieces>
__global__ void __launch_bounds__(kThreads)
project_kv_kernel(const T* x, const void* w, const float* bias, int m, int cin, int c,
                  float* kv) {
    __shared__ __align__(16) unsigned char stage[kStageBytes];
    const size_t row0 = (size_t)blockIdx.x * kTile;
    const int n0 = (int)blockIdx.y * kTile;
    project<T, kPieces>(x + row0 * cin, min(kTile, m - (int)row0), cin, w, 2 * c,
                        Cols{c, c, n0}, bias, kv + row0 * 2 * c + n0, 2 * c,
                        min(kTile, 2 * c - n0), stage);
}

// The loader of step (0), and with it what step (1) does.
enum Loader : int {
    kFusedGather = 0,  // K3: rows of kv [B*N, 2C] and p [B, N, 3] by knn_idx
    kGathered = 1,     // K6: rows of x_g [B*N*K, Cin] (projected here) and p_r
    kProjected = 2,    // K7: rows of k_g, v_g [B*N*K, C] and p_r
};

__host__ __device__ inline int align4(int v) { return (v + 3) & ~3; }

// Shared memory of a CTA, in floats: the parameters of its cw channels
// (a0 b0 a1 b1 s0 t0 | w0 | w1 | c0 s1 t1 c1), q [R, cw], pe0 [R*K, 4]
// (float4 rows), the neighbour rows (K3), kv [R*K, ldu] (u in columns
// [0, cw), v + pe in [cw, 2cw); K6 first projects k and v there), then
// t and w [R*K, cs] (K6: also the staging of its projection).
struct Layout {
    int ldu, w0, w1, vec, q, pe0, nbr, kv, t, w, end;
};

__host__ __device__ inline Layout make_layout(int loader, int kk, int cw, int cs,
                                              int rows) {
    Layout l;
    const int rk = rows * kk;
    l.ldu = 2 * cw + 1;  // odd: no bank conflicts across neighbour rows
    l.w0 = align4(12 + 6 * cw);
    l.w1 = align4(l.w0 + cw * cs);
    l.vec = l.w1 + cs * cs;
    l.q = align4(l.vec + 4 * cs);
    l.pe0 = align4(l.q + rows * cw);
    l.nbr = l.pe0 + 4 * rk;
    l.kv = align4(l.nbr + (loader == kFusedGather ? rk : 0));
    l.t = align4(l.kv + rk * l.ldu);
    l.w = l.t + rk * cs;
    const int end = l.w + rk * cs, stage_end = l.t + kStageBytes / 4;
    l.end = loader == kGathered && stage_end > end ? stage_end : end;
    return l;
}

// The packed parameter buffer (all matrices [in, out] row-major): a0 [9]
// b0 [3] a1 [3, C] b1 [C] s0 [C] t0 [C] w0 [C, cs] c0 [cs] s1 [cs] t1 [cs]
// w1 [cs, cs] c1 [cs]. Element e of a CTA's shared parameters (channels
// g0 .. g0 + cw) -> its index there, or -1 for alignment padding.
__host__ __device__ inline int param_source(int e, const Layout& L, int c, int cw, int cs,
                                   int g0) {
    if (e < 12) return e;
    if (e < 12 + 6 * cw) {  // rows of a1, then b1, s0, t0: six blocks of C
        const int i = e - 12, blk = i / cw;
        return 12 + blk * c + g0 + (i - blk * cw);
    }
    const int w0 = 12 + 6 * c, c0 = w0 + c * cs, w1 = c0 + 3 * cs;
    if (e >= L.w0 && e < L.w0 + cw * cs) return w0 + g0 * cs + (e - L.w0);
    if (e >= L.w1 && e < L.w1 + cs * cs) return w1 + (e - L.w1);
    if (e >= L.vec && e < L.vec + 4 * cs) {  // c0, s1, t1, c1
        const int i = e - L.vec, blk = i / cs;
        return (blk < 3 ? c0 + blk * cs : w1 + cs * cs) + (i - blk * cs);
    }
    return -1;
}

template <typename T>
struct Args {
    const void* rows;    // K3 kv [B*N, 2C] float; K6 x_g [BN*K, Cin], K7 k_g, in T
    const T* v_rows;     // K7 v_g
    const void* p;       // K3 p [B, N, 3] float; K6/K7 p_r [BN*K, 3] in T
    const int* knn_idx;  // K3 [B, N, K]
    const void* q;       // [BN, C]: float for K6, else T
    const float* params;
    const void* w;       // K6: Wk|Wv transposed, float [2C, Cin] or bf16 [3, 2C, Cin]
    const float* bias;   // K6: bk|bv [2C]
    void* out;           // [BN, C]: T for K3, else float
    int n, n_rows, kk, cin, c, cs, rows_per_cta, split;
};

// dst[rk * ncols + j] = epi(rk, j, sum_i a[rk * lda + i] w[i * ncols + j])
// for rk < nrows, j < ncols: a thread takes one row of a and kJ columns
// (one float4 of w a step when kJ = 4, w 16-byte aligned).
template <int kJ, typename Epi>
__device__ void row_products(const float* a, int lda, int depth, const float* w,
                             int ncols, int nrows, Epi epi) {
    const int groups = ncols / kJ;
    const int tc = min(groups, 32), tr = kThreads / tc;
    if ((int)threadIdx.x >= tc * tr) return;
    for (int j0 = (threadIdx.x % tc) * kJ; j0 < ncols; j0 += tc * kJ) {
        for (int rk = threadIdx.x / tc; rk < nrows; rk += tr) {
            const float* ar = a + (size_t)rk * lda;
            float acc[kJ] = {};
#pragma unroll 4
            for (int i = 0; i < depth; ++i) {
                const float ai = ar[i];
                if constexpr (kJ == 4) {
                    const float4 w4 = *reinterpret_cast<const float4*>(w + i * ncols + j0);
                    acc[0] = fmaf(ai, w4.x, acc[0]);
                    acc[1] = fmaf(ai, w4.y, acc[1]);
                    acc[2] = fmaf(ai, w4.z, acc[2]);
                    acc[3] = fmaf(ai, w4.w, acc[3]);
                } else {
                    acc[0] = fmaf(ai, w[i * ncols + j0], acc[0]);
                }
            }
#pragma unroll
            for (int q = 0; q < kJ; ++q) epi(rk, j0 + q, acc[q]);
        }
    }
}

template <typename Epi>
__device__ void row_products(const float* a, int lda, int depth, const float* w,
                             int ncols, int nrows, Epi epi) {
    if (ncols % 4 == 0) {
        row_products<4>(a, lda, depth, w, ncols, nrows, epi);
    } else {
        row_products<1>(a, lda, depth, w, ncols, nrows, epi);
    }
}

template <int kLoader, typename T, int kPieces>
__global__ void __launch_bounds__(kThreads) attention_kernel(const Args<T> a) {
    using TQ = std::conditional_t<kLoader == kGathered, float, T>;
    using TO = std::conditional_t<kLoader == kFusedGather, T, float>;
    extern __shared__ __align__(16) float smem[];
    const int kk = a.kk, c = a.c, cs = a.cs, split = a.split;
    const int rank = split > 1 ? (int)cg::this_cluster().block_rank() : 0;
    const int cw = c / split, g0 = rank * cw;
    const size_t row0 = (size_t)(blockIdx.x / split) * a.rows_per_cta;
    const int nr = min(a.rows_per_cta, (int)(a.n_rows - row0));
    const int nrk = nr * kk;
    const Layout L = make_layout(kLoader, kk, cw, cs, a.rows_per_cta);
    float* s_a0 = smem;
    float* s_b0 = smem + 9;
    float* s_a1 = smem + 12;
    float* s_b1 = s_a1 + 3 * cw;
    float* s_s0 = s_b1 + cw;
    float* s_t0 = s_s0 + cw;
    float* s_w0 = smem + L.w0;
    float* s_w1 = smem + L.w1;
    float* s_c0 = smem + L.vec;
    float* s_s1 = s_c0 + cs;
    float* s_t1 = s_s1 + cs;
    float* s_c1 = s_t1 + cs;
    float* s_q = smem + L.q;
    float* s_pe0 = smem + L.pe0;
    int* s_nbr = reinterpret_cast<int*>(smem + L.nbr);
    float* s_kv = smem + L.kv;
    float* s_t = smem + L.t;
    float* s_w = smem + L.w;
    const int ldu = L.ldu;

    // (0) the parameters of this CTA's channels, q, and the neighbour rows
    // with their relative positions: every load of a pass issued before its
    // stores, so the CTA waits a few memory latencies, not one a loop
    {
        // the parameters come laid out as shared memory wants them, one slice
        // a cluster rank (tgn_attention_param_map)
        const float4* src = reinterpret_cast<const float4*>(a.params + (size_t)rank * L.q);
        for (int e = threadIdx.x; e < L.q / 4; e += kThreads) {
            reinterpret_cast<float4*>(smem)[e] = __ldg(src + e);
        }
    }
    const TQ* q = static_cast<const TQ*>(a.q);
#pragma unroll 4
    for (int e = threadIdx.x; e < nr * cw; e += kThreads) {
        const int r = e / cw;
        s_q[e] = ldg(q, (row0 + r) * c + g0 + (e - r * cw));
    }
    for (int rk = threadIdx.x; rk < nrk; rk += kThreads) {
        float r0, r1, r2;
        if constexpr (kLoader == kFusedGather) {
            const size_t row = row0 + rk / kk;
            const int nb = (int)(row / a.n) * a.n + __ldg(a.knn_idx + row0 * kk + rk);
            s_nbr[rk] = nb;
            const float* p = static_cast<const float*>(a.p);
            r0 = round_to<T>(__ldg(p + (size_t)nb * 3) - __ldg(p + row * 3));
            r1 = round_to<T>(__ldg(p + (size_t)nb * 3 + 1) - __ldg(p + row * 3 + 1));
            r2 = round_to<T>(__ldg(p + (size_t)nb * 3 + 2) - __ldg(p + row * 3 + 2));
        } else {
            const T* pr = static_cast<const T*>(a.p) + (row0 * kk + rk) * 3;
            r0 = ldg(pr, 0);
            r1 = ldg(pr, 1);
            r2 = ldg(pr, 2);
        }
        s_pe0[rk * 4] = r0;
        s_pe0[rk * 4 + 1] = r1;
        s_pe0[rk * 4 + 2] = r2;
        s_pe0[rk * 4 + 3] = __int_as_float(rk / kk);  // the neighbour row's query row
    }
    __syncthreads();

    // (2) first half: pe0 = relu(p_r A0 + b0) [R*K, 3 (+1)], over p_r
    for (int rk = threadIdx.x; rk < nrk; rk += kThreads) {
        float* pe = s_pe0 + rk * 4;
        const float r0 = pe[0], r1 = pe[1], r2 = pe[2];
#pragma unroll
        for (int o = 0; o < 3; ++o) {
            pe[o] = fmaxf(s_b0[o] + r0 * s_a0[o] + r1 * s_a0[3 + o] + r2 * s_a0[6 + o],
                          0.f);
        }
    }

    // (1) K6: k|v of this CTA's channels for its R*K gathered rows
    if constexpr (kLoader == kGathered) {
        project<T, kPieces>(static_cast<const T*>(a.rows) + row0 * kk * (size_t)a.cin, nrk,
                            a.cin, a.w, 2 * c, Cols{c, cw, g0}, a.bias, s_kv, ldu, 2 * cw,
                            reinterpret_cast<unsigned char*>(s_t));
    }
    __syncthreads();

    // (2) second half + (3a): u = relu(s0 (k - q + pe) + t0) and v + pe, a
    // thread per channel walking the neighbour rows, 4 rows' loads at once
    {
        constexpr int kB = 4;
        const int tc = min(cw, 32), tr = kThreads / tc;
        const float* kv = static_cast<const float*>(a.rows);  // K3
        if ((int)threadIdx.x < tc * tr) {
            for (int ch = threadIdx.x % tc; ch < cw; ch += tc) {
                const float a10 = s_a1[ch], a11 = s_a1[cw + ch], a12 = s_a1[2 * cw + ch];
                const float b1 = s_b1[ch], s0 = s_s0[ch], t0 = s_t0[ch];
                for (int rk0 = threadIdx.x / tc; rk0 < nrk; rk0 += kB * tr) {
                    float kval[kB], vval[kB];
#pragma unroll
                    for (int u = 0; u < kB; ++u) {
                        const int rk = min(rk0 + u * tr, nrk - 1);
                        if constexpr (kLoader == kFusedGather) {
                            const size_t base = (size_t)s_nbr[rk] * 2 * c + g0 + ch;
                            kval[u] = ldg(kv, base);
                            vval[u] = ldg(kv, base + c);
                        } else if constexpr (kLoader == kGathered) {
                            kval[u] = s_kv[(size_t)rk * ldu + ch];
                            vval[u] = s_kv[(size_t)rk * ldu + cw + ch];
                        } else {
                            const size_t base = (row0 * kk + rk) * (size_t)c + g0 + ch;
                            kval[u] = ldg(static_cast<const T*>(a.rows), base);
                            vval[u] = ldg(a.v_rows, base);
                        }
                    }
#pragma unroll
                    for (int u = 0; u < kB; ++u) {
                        const int rk = rk0 + u * tr;
                        if (rk >= nrk) break;
                        float* row = s_kv + (size_t)rk * ldu;
                        const float4 p0 = *reinterpret_cast<const float4*>(s_pe0 + rk * 4);
                        const float pe = b1 + p0.x * a10 + p0.y * a11 + p0.z * a12;
                        const float qv = s_q[__float_as_int(p0.w) * cw + ch];
                        row[ch] = fmaxf((kval[u] - qv + pe) * s0 + t0, 0.f);
                        row[cw + ch] = vval[u] + pe;
                    }
                }
            }
        }
    }
    __syncthreads();

    // (3b) t = relu(s1 (u W0 + c0) + t1) [R*K, cs]; with a split each CTA
    // sums its cw channels into w, and the parts are added in rank order
    if (split == 1) {
        row_products(s_kv, ldu, cw, s_w0, cs, nrk, [&](int rk, int j, float acc) {
            s_t[rk * cs + j] = fmaxf((acc + s_c0[j]) * s_s1[j] + s_t1[j], 0.f);
        });
        __syncthreads();
    } else {
        row_products(s_kv, ldu, cw, s_w0, cs, nrk,
                     [&](int rk, int j, float acc) { s_w[rk * cs + j] = acc; });
        cg::cluster_group cluster = cg::this_cluster();
        cluster.sync();
        for (int e = threadIdx.x; e < nrk * cs; e += kThreads) {
            const int j = e % cs;
            float acc = 0.f;
            for (int r = 0; r < split; ++r) acc += cluster.map_shared_rank(s_w, r)[e];
            s_t[e] = fmaxf((acc + s_c0[j]) * s_s1[j] + s_t1[j], 0.f);
        }
        cluster.sync();  // no CTA writes its w while a partner may read it
    }

    // (3c) w = t W1 + c1 [R*K, cs]
    row_products(s_t, cs, cs, s_w1, cs, nrk, [&](int rk, int j, float acc) {
        s_w[rk * cs + j] = acc + s_c1[j];
    });
    __syncthreads();

    // (4) softmax over K: one warp per (row, group), lanes over neighbours
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int task = warp; task < nr * cs; task += kWarps) {
        const int r = task / cs, j = task - r * cs;
        float* w = s_w + (size_t)r * kk * cs + j;
        float mx = -CUDART_INF_F;
        for (int k = lane; k < kk; k += 32) mx = fmaxf(mx, w[k * cs]);
        for (int o = 16; o > 0; o /= 2) mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, o));
        float sum = 0.f;
        for (int k = lane; k < kk; k += 32) {
            const float ex = expf(w[k * cs] - mx);
            w[k * cs] = ex;
            sum += ex;
        }
        // a butterfly: every lane adds the same pairs, so all hold one sum
        for (int o = 16; o > 0; o /= 2) sum += __shfl_xor_sync(~0u, sum, o);
        for (int k = lane; k < kk; k += 32) w[k * cs] /= sum;
    }
    __syncthreads();

    // (5) out = sum_k (v + pe) w, a thread per channel walking the rows
    {
        TO* out = static_cast<TO*>(a.out);
        const int tc = min(cw, 32), tr = kThreads / tc;
        if ((int)threadIdx.x < tc * tr) {
            for (int ch = threadIdx.x % tc; ch < cw; ch += tc) {
                const int j = (g0 + ch) % cs;
                for (int r = threadIdx.x / tc; r < nr; r += tr) {
                    const float* vpe = s_kv + (size_t)r * kk * ldu + cw + ch;
                    const float* w = s_w + r * kk * cs + j;
                    float acc = 0.f;
#pragma unroll 4
                    for (int k = 0; k < kk; ++k) acc = fmaf(vpe[k * ldu], w[k * cs], acc);
                    st(out, (row0 + r) * c + g0 + ch, acc);
                }
            }
        }
    }
}

// The CTA plan of a launch: R rows a CTA, S CTAs a row, shared memory.
struct Plan {
    int rows, split;
    size_t smem;
};

Plan plan(int loader, size_t n_rows, int kk, int c, int cs) {
    Plan p;
    p.split = (c >= 256 && c % 128 == 0) ? std::min(4, c / 128) : 1;
    const int cw = c / p.split;
    // about 9216 floats (36 KB) of k|v rows a CTA, at most 8 rows; then
    // halve R while the launch would have fewer than two CTAs an SM (132)
    p.rows = std::max(1, std::min(8, 9216 / std::max(1, kk * (2 * cw + 1))));
    while (p.rows > 1 && (n_rows + p.rows - 1) / p.rows * p.split < 264) p.rows /= 2;
    p.smem = sizeof(float) * (size_t)make_layout(loader, kk, cw, cs, p.rows).end;
    return p;
}

template <int kLoader, typename T, int kPieces>
int launch(Args<T> a, cudaStream_t stream) {
    if (a.n_rows < 1) return 0;
    if (a.c < 1 || a.cs < 1 || a.c % a.cs || a.kk < 1) return (int)cudaErrorInvalidValue;
    const Plan p = plan(kLoader, (size_t)a.n_rows, a.kk, a.c, a.cs);
    a.rows_per_cta = p.rows;
    a.split = p.split;
    return launch_clusters(attention_kernel<kLoader, T, kPieces>,
                           (a.n_rows + p.rows - 1) / p.rows, p.split, kThreads, p.smem,
                           stream, a);
}

}  // namespace

// Shared memory of one CTA of loader `loader` (0 K3, 1 K6, 2 K7) over
// `n_rows` query rows.
extern "C" size_t tgn_attention_smem_bytes(int loader, int n_rows, int kk, int c, int cs) {
    return plan(loader, (size_t)std::max(n_rows, 1), kk, c, cs).smem;
}

// The parameter layout the attention kernels read: for each of the S CTAs
// of a cluster (S = 1 below C = 256), its slice in the order of its shared
// memory. Writes into idx (when not null) the index in the packed buffer
// (a0 .. c1 as above) of each element, -1 for padding; returns the count.
extern "C" int tgn_attention_param_map(int c, int cs, int* idx) {
    const int split = plan(kFusedGather, 1, 1, c, cs).split, cw = c / split;
    const Layout L = make_layout(kFusedGather, 1, cw, cs, 1);
    if (idx != nullptr) {
        for (int r = 0; r < split; ++r) {
            for (int e = 0; e < L.q; ++e) {
                idx[r * L.q + e] = param_source(e, L, c, cw, cs, r * cw);
            }
        }
    }
    return split * L.q;
}

// K3 step (1). x [M, Cin], w Wk|Wv transposed [P, 2C, Cin] and bias [2C]
// float32 (bf16 != 0: x bfloat16 and w the bf16-rounded weights, P = 1;
// else both float32); kv [M, 2C] float32. Returns cudaGetLastError().
extern "C" int tgn_project_kv(const void* x, const void* w, const float* bias, int m,
                              int cin, int c, float* kv, int bf16, cudaStream_t stream) {
    if (m < 1) return 0;
    if (cin < 1 || c < 1) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)((m + kTile - 1) / kTile),
                    (unsigned)((2 * c + kTile - 1) / kTile));
    if (bf16) {
        project_kv_kernel<__nv_bfloat16, 1><<<grid, kThreads, 0, stream>>>(
            static_cast<const __nv_bfloat16*>(x), w, bias, m, cin, c, kv);
    } else {
        project_kv_kernel<float, 0><<<grid, kThreads, 0, stream>>>(
            static_cast<const float*>(x), w, bias, m, cin, c, kv);
    }
    return (int)cudaGetLastError();
}

// K3 steps (0), (2)-(5). kv [B*N, 2C] float32 from tgn_project_kv, p
// [B, N, 3] float32, knn_idx [B, N, K] int32 (within-cloud), q [B*N, C]
// (bf16 != 0: bfloat16, else float32), params laid out by
// tgn_attention_param_map; out [B*N, C] in q's dtype. Returns the launch's CUDA status.
extern "C" int tgn_attention(const float* kv, const float* p, const int* knn_idx,
                             const void* q, const float* params, int b, int n, int kk,
                             int c, int cs, void* out, int bf16, cudaStream_t stream) {
    const int rows = b * n;
    if (bf16) {
        using T = __nv_bfloat16;
        return launch<kFusedGather, T, 0>(
            Args<T>{kv, nullptr, p, knn_idx, q, params, nullptr, nullptr, out, n, rows, kk,
                    0, c, cs, 0, 0}, stream);
    }
    return launch<kFusedGather, float, 0>(
        Args<float>{kv, nullptr, p, knn_idx, q, params, nullptr, nullptr, out, n, rows, kk,
                    0, c, cs, 0, 0}, stream);
}

// K6. q [BN, C] float32, x_g [BN*K, Cin] and p_r [BN*K, 3] (bf16 != 0:
// bfloat16 and w the three bf16 pieces [3, 2C, Cin] of Wk|Wv transposed;
// else float32 and w Wk|Wv transposed [2C, Cin]), bias = bk|bv [2C]
// float32, params laid out by tgn_attention_param_map; out [BN, C]
// float32. Returns the launch's CUDA status.
extern "C" int tgn_attention_gathered(const float* q, const void* x_g, const void* p_r,
                                      const float* params, const void* w,
                                      const float* bias, int bn, int kk, int cin, int c,
                                      int cs, float* out, int bf16, cudaStream_t stream) {
    if (bf16) {
        using T = __nv_bfloat16;
        return launch<kGathered, T, 3>(
            Args<T>{x_g, nullptr, p_r, nullptr, q, params, w, bias, out, bn, bn, kk, cin,
                    c, cs, 0, 0}, stream);
    }
    return launch<kGathered, float, 3>(
        Args<float>{x_g, nullptr, p_r, nullptr, q, params, w, bias, out, bn, bn, kk, cin,
                    c, cs, 0, 0}, stream);
}

// K7. q [BN, C], k_g and v_g [BN*K, C], p_r [BN*K, 3] (bf16 != 0: all
// bfloat16, else float32), params laid out by tgn_attention_param_map;
// out [BN, C] float32.
// Returns the launch's CUDA status.
extern "C" int tgn_attention_projected(const void* q, const void* k_g, const void* v_g,
                                       const void* p_r, const float* params, int bn,
                                       int kk, int c, int cs, float* out, int bf16,
                                       cudaStream_t stream) {
    if (bf16) {
        using T = __nv_bfloat16;
        return launch<kProjected, T, 0>(
            Args<T>{k_g, static_cast<const T*>(v_g), p_r, nullptr, q, params, nullptr,
                    nullptr, out, bn, bn, kk, 0, c, cs, 0, 0}, stream);
    }
    return launch<kProjected, float, 0>(
        Args<float>{k_g, static_cast<const float*>(v_g), p_r, nullptr, q, params, nullptr,
                    nullptr, out, bn, bn, kk, 0, c, cs, 0, 0}, stream);
}
