// K3 / K6 / K7: fused eval-mode point-transformer vector attention, one
// block per row.
//
// K3 (tgn_attention) replaces toothgroupnetwork_tpu/ops/pallas/
// attention_kernel.py: fused_vector_attention_packed_x (_packed_x_kernel +
// _packed_body) and fuses the neighbour gather as well. K6
// (tgn_attention_gathered) replaces attention_kernel.py:
// fused_vector_attention (_attn_kernel): it takes the gathered rows x_g and
// the relative positions p_r, as the cell-attention path produces them
// (K4/K5, csrc/cell_select.cu). K7 (tgn_attention_projected) replaces
// attention_kernel.py: fused_vector_attention_packed (_packed_kernel): it
// takes k and v already projected, k_g and v_g, with p_r. The three share
// one kernel body; only the loader (a template parameter) differs.
// BatchNorms folded as in fold_bn / fold_attention_params. For one query
// row (b, n) with neighbours k < K:
//   (0) load: K3 gathers x[b, j] and forms p[b, j] - p[b, n] for
//       j = knn_idx[b, n, k]; K6 reads rows (b*N + n)*K + k of x_g and p_r;
//       K7 reads those rows of k_g, v_g and p_r
//   (1) k = x_g Wk + bk, v = x_g Wv + bv           (in-kernel; not in K7)
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
//
// What bounds it on the H100: the neighbour rows and the K-fold k/v
// projection (2 K Cin C multiply-adds per row). The TPU kernel took the raw
// gather x_g [B*N*K, Cin] from HBM; K3 fuses the gather, so the
// [B*N*K, Cin] tensor (110 MB at B1/24000/K36/C32 in f32, 226 MB for 16
// crops) and the relative positions are never written: each block reads K
// rows of x (L2 hits: the whole x fits in L2) into shared memory and keeps
// every per-neighbour intermediate there. K6 reads its K contiguous x_g rows
// (K*Cin elements per block, streamed once from HBM); K7 reads K rows of
// k_g and of v_g and does no projection, so it is bound by those 2*K*C
// elements a row. The weights are read from global memory with consecutive
// threads on consecutive output channels (coalesced, L1/L2 resident); at
// C = 512 Wk + Wv are 2 MB and are not staged in shared memory. In the k/v
// loop each thread keeps kKB = 4 neighbours' sums in registers, so one
// weight load serves four multiply-adds (at B1/93/K24/C512 on an H100 that
// took K3 from 5.3 to 1.5 ms; one neighbour per thread is latency-bound on
// the weight loads). Shared memory per block is (C + K*Cin + 2*K*C + 3*K)
// floats for K3/K6, 218 KB at the worst case K=36/C=512, and
// (C + 2*K*cs + 2*K*C + 3*K) floats for K7; the launcher opts in above
// 48 KB.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kKB = 4;  // neighbours per thread in the k/v loop

// Offsets of the packed parameter buffer (all matrices [in, out] row-major):
// a0 [9] b0 [3] a1 [3*C] b1 [C] s0 [C] t0 [C] w0 [C*cs] c0 [cs] s1 [cs]
// t1 [cs] w1 [cs*cs] c1 [cs], then (K3/K6 only) wk [Cin*C] bk [C]
// wv [Cin*C] bv [C]
struct Params {
    const float *a0, *b0, *a1, *b1, *s0, *t0, *w0, *c0, *s1, *t1, *w1, *c1, *wk,
        *bk, *wv, *bv;
};

__device__ Params unpack(const float* base, int cin, int c, int cs) {
    Params r;
    r.a0 = base; base += 9;
    r.b0 = base; base += 3;
    r.a1 = base; base += 3 * c;
    r.b1 = base; base += c;
    r.s0 = base; base += c;
    r.t0 = base; base += c;
    r.w0 = base; base += (size_t)c * cs;
    r.c0 = base; base += cs;
    r.s1 = base; base += cs;
    r.t1 = base; base += cs;
    r.w1 = base; base += (size_t)cs * cs;
    r.c1 = base; base += cs;
    r.wk = base; base += (size_t)cin * c;
    r.bk = base; base += c;
    r.wv = base; base += (size_t)cin * c;
    r.bv = base;
    return r;
}

// The loader of step (0), and with it what step (1) does.
enum Loader : int {
    kFusedGather = 0,  // K3: gather x [B, N, Cin] and p [B, N, 3] by knn_idx
    kGathered = 1,     // K6: rows of x_g [B*N*K, Cin] and p_r [B*N*K, 3]
    kProjected = 2,    // K7: rows of k_g, v_g [B*N*K, C] and p_r; no projection
};

template <typename T>
struct Args {
    const T* rows;       // K3 x, K6 x_g, K7 k_g
    const T* v_rows;     // K7 v_g
    const void* p;       // K3 p [B, N, 3] float; K6/K7 p_r [B*N*K, 3] in T
    const int* knn_idx;  // K3 [B, N, K]
    const void* q;       // [B*N, C]: float for K6, else T
    const float* params;
    void* out;           // [B*N, C]: T for K3, else float
    int n, kk, cin, c, cs;
};

template <int kLoader, typename T>
__global__ void attention_kernel(const Args<T> a) {
    using TQ = std::conditional_t<kLoader == kGathered, float, T>;
    using TO = std::conditional_t<kLoader == kFusedGather, T, float>;
    constexpr bool kProject = kLoader != kProjected;
    extern __shared__ float smem[];
    const size_t row = blockIdx.x;        // b * n + i
    const int kk = a.kk, cin = a.cin, c = a.c, cs = a.cs;
    const Params w = unpack(a.params, kProject ? cin : 0, c, cs);

    // q [C] | scratch | u [K, C] pre-softmax weight input | vpe [K, C] v + pe
    // | pe0 [K, 3]. The scratch holds x_g [K, Cin] (K3/K6), later t [K, cs]
    // and w [K, cs]; K7 needs only t and w there.
    float* s_q = smem;
    float* s_xg = s_q + c;
    float* s_u = s_xg + (kProject ? (size_t)kk * cin : 2 * (size_t)kk * cs);
    float* s_vpe = s_u + (size_t)kk * c;
    float* s_pe0 = s_vpe + (size_t)kk * c;
    float* s_t = s_xg;
    float* s_w = s_xg + (size_t)kk * cs;

    const TQ* q = static_cast<const TQ*>(a.q);
    for (int e = threadIdx.x; e < c; e += blockDim.x) s_q[e] = ld(q, row * c + e);
    if constexpr (kLoader == kFusedGather) {
        const size_t b = row / a.n;
        const int* nb = a.knn_idx + row * kk;
        const T* xb = a.rows + b * (size_t)a.n * cin;
        const float* p = static_cast<const float*>(a.p);
        const float* pb = p + b * (size_t)a.n * 3;
        const float* prow = p + row * 3;
        for (int e = threadIdx.x; e < kk * cin; e += blockDim.x) {
            const int k = e / cin;
            s_xg[e] = ld(xb, (size_t)nb[k] * cin + (e - k * cin));
        }
        for (int e = threadIdx.x; e < kk * 3; e += blockDim.x) {
            const int k = e / 3, o = e - k * 3;
            const float* pj = pb + (size_t)nb[k] * 3;
            const float r0 = round_to<T>(pj[0] - prow[0]),
                        r1 = round_to<T>(pj[1] - prow[1]),
                        r2 = round_to<T>(pj[2] - prow[2]);
            const float h = w.b0[o] + r0 * w.a0[o] + r1 * w.a0[3 + o] + r2 * w.a0[6 + o];
            s_pe0[e] = fmaxf(h, 0.f);
        }
    } else {
        if constexpr (kLoader == kGathered) {
            const T* xg = a.rows + row * kk * (size_t)cin;
            for (int e = threadIdx.x; e < kk * cin; e += blockDim.x) s_xg[e] = ld(xg, e);
        }
        const T* pr = static_cast<const T*>(a.p) + row * kk * 3;
        for (int e = threadIdx.x; e < kk * 3; e += blockDim.x) {
            const int k = e / 3, o = e - k * 3;
            const float h = w.b0[o] + ld(pr, k * 3) * w.a0[o]
                            + ld(pr, k * 3 + 1) * w.a0[3 + o]
                            + ld(pr, k * 3 + 2) * w.a0[6 + o];
            s_pe0[e] = fmaxf(h, 0.f);
        }
    }
    __syncthreads();

    // (1)-(3a): per (group of kKB neighbours, channel): in K3/K6 each weight
    // loaded from global memory serves kKB neighbours, and each (k, ch) sum
    // runs over i in order, as a plain loop per neighbour would; K7 reads
    // the kKB neighbours' k and v
    const int n_kb = (kk + kKB - 1) / kKB;
    for (int e = threadIdx.x; e < n_kb * c; e += blockDim.x) {
        const int k0 = (e / c) * kKB, ch = e - (e / c) * c;
        float kv[kKB], vv[kKB];
        if constexpr (kProject) {
            const float* xg[kKB];
#pragma unroll
            for (int j = 0; j < kKB; ++j) {
                xg[j] = s_xg + (size_t)min(k0 + j, kk - 1) * cin;  // tail: recomputed
                kv[j] = w.bk[ch];
                vv[j] = w.bv[ch];
            }
            for (int i = 0; i < cin; ++i) {
                const float wk = w.wk[(size_t)i * c + ch], wv = w.wv[(size_t)i * c + ch];
#pragma unroll
                for (int j = 0; j < kKB; ++j) {
                    kv[j] += xg[j][i] * wk;
                    vv[j] += xg[j][i] * wv;
                }
            }
        } else {
            const size_t base = row * kk * (size_t)c + ch;
#pragma unroll
            for (int j = 0; j < kKB; ++j) {
                const size_t off = base + (size_t)min(k0 + j, kk - 1) * c;
                kv[j] = ld(a.rows, off);
                vv[j] = ld(a.v_rows, off);
            }
        }
#pragma unroll
        for (int j = 0; j < kKB; ++j) {
            const int k = k0 + j;
            if (k >= kk) break;
            const float* pe0 = s_pe0 + k * 3;
            const float pe = w.b1[ch] + pe0[0] * w.a1[ch] + pe0[1] * w.a1[c + ch]
                             + pe0[2] * w.a1[2 * c + ch];
            s_u[(size_t)k * c + ch] = fmaxf((kv[j] - s_q[ch] + pe) * w.s0[ch] + w.t0[ch],
                                            0.f);
            s_vpe[(size_t)k * c + ch] = vv[j] + pe;
        }
    }
    __syncthreads();

    // (3b): first weight Dense + folded BN + relu -> t [K, cs], stored over x_g
    for (int e = threadIdx.x; e < kk * cs; e += blockDim.x) {
        const int k = e / cs, j = e - k * cs;
        const float* u = s_u + (size_t)k * c;
        float acc = w.c0[j];
        for (int i = 0; i < c; ++i) acc += u[i] * w.w0[(size_t)i * cs + j];
        s_t[e] = fmaxf(acc * w.s1[j] + w.t1[j], 0.f);
    }
    __syncthreads();

    // (3c): second weight Dense -> w [K, cs]
    for (int e = threadIdx.x; e < kk * cs; e += blockDim.x) {
        const int k = e / cs, j = e - k * cs;
        const float* t = s_t + (size_t)k * cs;
        float acc = w.c1[j];
        for (int i = 0; i < cs; ++i) acc += t[i] * w.w1[(size_t)i * cs + j];
        s_w[e] = acc;
    }
    __syncthreads();

    // (4) softmax over K per channel group
    for (int j = threadIdx.x; j < cs; j += blockDim.x) {
        float mx = -CUDART_INF_F;
        for (int k = 0; k < kk; ++k) mx = fmaxf(mx, s_w[k * cs + j]);
        float sum = 0.f;
        for (int k = 0; k < kk; ++k) {
            const float ex = expf(s_w[k * cs + j] - mx);
            s_w[k * cs + j] = ex;
            sum += ex;
        }
        for (int k = 0; k < kk; ++k) s_w[k * cs + j] /= sum;
    }
    __syncthreads();

    // (5) aggregate
    TO* out = static_cast<TO*>(a.out);
    for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
        const int j = ch % cs;
        float acc = 0.f;
        for (int k = 0; k < kk; ++k) acc += s_vpe[(size_t)k * c + ch] * s_w[k * cs + j];
        st(out, row * c + ch, acc);
    }
}

template <int kLoader, typename T>
int launch(const Args<T>& a, size_t rows, size_t smem, cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(attention_kernel<kLoader, T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    attention_kernel<kLoader, T><<<(unsigned)rows, kThreads, smem, stream>>>(a);
    return (int)cudaGetLastError();
}

template <int kLoader>
int dispatch(const void* rows, const void* v_rows, const void* p, const int* knn_idx,
             const void* q, const float* params, size_t n_rows, int n, int kk,
             int cin, int c, int cs, void* out, size_t smem, int bf16,
             cudaStream_t stream) {
    if (bf16) {
        using T = __nv_bfloat16;
        const Args<T> a{static_cast<const T*>(rows), static_cast<const T*>(v_rows), p,
                        knn_idx, q, params, out, n, kk, cin, c, cs};
        return launch<kLoader, T>(a, n_rows, smem, stream);
    }
    const Args<float> a{static_cast<const float*>(rows),
                        static_cast<const float*>(v_rows), p, knn_idx, q, params,
                        out, n, kk, cin, c, cs};
    return launch<kLoader, float>(a, n_rows, smem, stream);
}

}  // namespace

// Shared memory of one K3 / K6 block.
extern "C" size_t tgn_attention_smem_bytes(int kk, int cin, int c) {
    return sizeof(float) * ((size_t)c + (size_t)kk * cin + 2 * (size_t)kk * c + 3 * (size_t)kk);
}

// Shared memory of one K7 block.
extern "C" size_t tgn_attention_projected_smem_bytes(int kk, int c, int cs) {
    return sizeof(float) * ((size_t)c + 2 * (size_t)kk * cs + 2 * (size_t)kk * c
                            + 3 * (size_t)kk);
}

// K3. x [B, N, Cin] (bf16 != 0: bfloat16, else float32), p [B, N, 3]
// float32, knn_idx [B, N, K] int32 (within-cloud), q [B*N, C] in x's
// dtype, params packed as above; out [B*N, C] in x's dtype. Returns
// cudaGetLastError().
extern "C" int tgn_attention(const void* x, const float* p, const int* knn_idx,
                             const void* q, const float* params, int b, int n,
                             int kk, int cin, int c, int cs, void* out, int bf16,
                             cudaStream_t stream) {
    return dispatch<kFusedGather>(x, nullptr, p, knn_idx, q, params, (size_t)b * n, n,
                                  kk, cin, c, cs, out,
                                  tgn_attention_smem_bytes(kk, cin, c), bf16, stream);
}

// K6. q [BN, C] float32, x_g [BN*K, Cin] and p_r [BN*K, 3] (bf16 != 0:
// bfloat16, else float32), params packed as above; out [BN, C] float32.
// Returns cudaGetLastError().
extern "C" int tgn_attention_gathered(const float* q, const void* x_g,
                                      const void* p_r, const float* params,
                                      int bn, int kk, int cin, int c, int cs,
                                      float* out, int bf16, cudaStream_t stream) {
    return dispatch<kGathered>(x_g, nullptr, p_r, nullptr, q, params, (size_t)bn, bn,
                               kk, cin, c, cs, out,
                               tgn_attention_smem_bytes(kk, cin, c), bf16, stream);
}

// K7. q [BN, C], k_g and v_g [BN*K, C], p_r [BN*K, 3] (bf16 != 0: all
// bfloat16, else float32), params packed as above without the k/v part;
// out [BN, C] float32. Returns cudaGetLastError().
extern "C" int tgn_attention_projected(const void* q, const void* k_g,
                                       const void* v_g, const void* p_r,
                                       const float* params, int bn, int kk, int c,
                                       int cs, float* out, int bf16,
                                       cudaStream_t stream) {
    return dispatch<kProjected>(k_g, v_g, p_r, nullptr, q, params, (size_t)bn, bn, kk,
                                0, c, cs, out,
                                tgn_attention_projected_smem_bytes(kk, c, cs), bf16,
                                stream);
}
