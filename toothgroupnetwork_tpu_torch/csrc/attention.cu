// K3 / K6: fused eval-mode point-transformer vector attention, one block per
// row.
//
// K3 (tgn_attention) replaces toothgroupnetwork_tpu/ops/pallas/
// attention_kernel.py: fused_vector_attention_packed_x (_packed_x_kernel +
// _packed_body) and fuses the neighbour gather as well. K6
// (tgn_attention_gathered) replaces attention_kernel.py:
// fused_vector_attention (_attn_kernel): it takes the gathered rows x_g and
// the relative positions p_r, as the cell-attention path produces them
// (K4/K5, csrc/cell_select.cu). Both share one kernel body; only the loader
// (a template parameter) differs. BatchNorms folded as in fold_bn /
// fold_attention_params. For one query row (b, n) with neighbours k < K:
//   (0) load x_g[k] and p_r[k]: K3 gathers x[b, j] and forms p[b, j] - p[b, n]
//       for j = knn_idx[b, n, k]; K6 reads rows (b*N + n)*K + k of x_g and p_r
//   (1) k = x_g Wk + bk, v = x_g Wv + bv                      (in-kernel)
//   (2) pe = relu(p_r A0 + b0) A1 + b1        (A0/b0 carry the folded BN)
//   (3) w = relu(s1 * (relu(s0 * (k - q + pe) + t0) W0 + c0) + t1) W1 + c1
//   (4) softmax of w over the K neighbours, per channel group
//   (5) out[c] = sum_k (v + pe)[k, c] * w[k, c mod cs]
//
// What bounds it on the H100: the neighbour rows and the K-fold k/v
// projection (2 K Cin C multiply-adds per row). The TPU kernel took the raw
// gather x_g [B*N*K, Cin] from HBM; K3 fuses the gather, so the
// [B*N*K, Cin] tensor (110 MB at B1/24000/K36/C32, 226 MB for 16 crops) and
// the relative positions are never written: each block reads K rows of x
// (L2 hits: the whole x fits in L2) into shared memory and keeps every
// per-neighbour intermediate there. K6 reads its K contiguous x_g rows
// (K*Cin*4 bytes per block, streamed once from HBM). The weights are read
// from global memory with consecutive threads on consecutive output
// channels (coalesced, L1/L2 resident); at C = 512 Wk + Wv are 2 MB and are
// not staged in shared memory. In the k/v projection each thread keeps
// kKB = 4 neighbours' sums in registers, so one weight load serves four
// multiply-adds (at B1/93/K24/C512 on an H100 that took K3 from 5.3 to
// 1.5 ms; one neighbour per thread is latency-bound on the weight loads). Shared memory per block is
// (C + K*Cin + 2*K*C + 3*K) floats, 218 KB at the worst case K=36/C=512; the
// launcher opts in above 48 KB.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kKB = 4;  // neighbours per thread in the k/v projection

// Offsets of the packed parameter buffer (all matrices [in, out] row-major):
// wk [Cin*C] bk [C] wv [Cin*C] bv [C] a0 [9] b0 [3] a1 [3*C] b1 [C]
// s0 [C] t0 [C] w0 [C*cs] c0 [cs] s1 [cs] t1 [cs] w1 [cs*cs] c1 [cs]
struct Params {
    const float *wk, *bk, *wv, *bv, *a0, *b0, *a1, *b1, *s0, *t0, *w0, *c0,
        *s1, *t1, *w1, *c1;
};

__device__ Params unpack(const float* base, int cin, int c, int cs) {
    Params r;
    r.wk = base; base += (size_t)cin * c;
    r.bk = base; base += c;
    r.wv = base; base += (size_t)cin * c;
    r.bv = base; base += c;
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
    r.c1 = base;
    return r;
}

// kGathered selects the loader of step (0): false (K3) gathers x [B, N, Cin]
// and p [B, N, 3] by knn_idx [B, N, K]; true (K6) reads rows of x_g
// [B*N*K, Cin] and p_r [B*N*K, 3], passed as x and p (knn_idx unused). Every
// other step is the same code.
template <bool kGathered>
__global__ void attention_kernel(const float* __restrict__ x,
                                 const float* __restrict__ p,
                                 const int* __restrict__ knn_idx,
                                 const float* __restrict__ q,
                                 const float* __restrict__ params,
                                 int n, int kk, int cin, int c, int cs,
                                 float* __restrict__ out) {
    extern __shared__ float smem[];
    const size_t row = blockIdx.x;        // b * n + i
    const Params w = unpack(params, cin, c, cs);

    float* s_q = smem;                    // [C]
    float* s_xg = s_q + c;                // [K, Cin]; later t [K, cs], w [K, cs]
    float* s_u = s_xg + (size_t)kk * cin; // [K, C] pre-softmax weight input
    float* s_vpe = s_u + (size_t)kk * c;  // [K, C] v + pe
    float* s_pe0 = s_vpe + (size_t)kk * c;  // [K, 3]
    float* s_t = s_xg;
    float* s_w = s_xg + (size_t)kk * cs;

    for (int e = threadIdx.x; e < c; e += blockDim.x) s_q[e] = q[row * c + e];
    if constexpr (kGathered) {
        const float* xg = x + row * kk * (size_t)cin;
        const float* pr = p + row * kk * 3;
        for (int e = threadIdx.x; e < kk * cin; e += blockDim.x) s_xg[e] = xg[e];
        for (int e = threadIdx.x; e < kk * 3; e += blockDim.x) {
            const int k = e / 3, o = e - k * 3;
            const float* rk = pr + k * 3;
            const float h = w.b0[o] + rk[0] * w.a0[o] + rk[1] * w.a0[3 + o]
                            + rk[2] * w.a0[6 + o];
            s_pe0[e] = fmaxf(h, 0.f);
        }
    } else {
        const size_t b = row / n;
        const int* nb = knn_idx + row * kk;
        const float* xb = x + b * (size_t)n * cin;
        const float* pb = p + b * (size_t)n * 3;
        const float* prow = p + row * 3;
        for (int e = threadIdx.x; e < kk * cin; e += blockDim.x) {
            const int k = e / cin;
            s_xg[e] = xb[(size_t)nb[k] * cin + (e - k * cin)];
        }
        for (int e = threadIdx.x; e < kk * 3; e += blockDim.x) {
            const int k = e / 3, o = e - k * 3;
            const float* pj = pb + (size_t)nb[k] * 3;
            const float r0 = pj[0] - prow[0], r1 = pj[1] - prow[1],
                        r2 = pj[2] - prow[2];
            const float h = w.b0[o] + r0 * w.a0[o] + r1 * w.a0[3 + o] + r2 * w.a0[6 + o];
            s_pe0[e] = fmaxf(h, 0.f);
        }
    }
    __syncthreads();

    // (1)-(3a): per (group of kKB neighbours, channel): each weight loaded
    // from global memory serves kKB neighbours; each (k, ch) sum runs over
    // i in order, as a plain loop per neighbour would
    const int n_kb = (kk + kKB - 1) / kKB;
    for (int e = threadIdx.x; e < n_kb * c; e += blockDim.x) {
        const int k0 = (e / c) * kKB, ch = e - (e / c) * c;
        const float* xg[kKB];
        float kv[kKB], vv[kKB];
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
    for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
        const int j = ch % cs;
        float acc = 0.f;
        for (int k = 0; k < kk; ++k) acc += s_vpe[(size_t)k * c + ch] * s_w[k * cs + j];
        out[row * c + ch] = acc;
    }
}

}  // namespace

extern "C" size_t tgn_attention_smem_bytes(int kk, int cin, int c) {
    return sizeof(float) * ((size_t)c + (size_t)kk * cin + 2 * (size_t)kk * c + 3 * (size_t)kk);
}

namespace {

template <bool kGathered>
int launch(const float* x, const float* p, const int* knn_idx, const float* q,
           const float* params, size_t rows, int n, int kk, int cin, int c, int cs,
           float* out, cudaStream_t stream) {
    const size_t smem = tgn_attention_smem_bytes(kk, cin, c);
    cudaError_t err = cudaFuncSetAttribute(attention_kernel<kGathered>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    attention_kernel<kGathered><<<(unsigned)rows, kThreads, smem, stream>>>(
        x, p, knn_idx, q, params, n, kk, cin, c, cs, out);
    return (int)cudaGetLastError();
}

}  // namespace

// K3. x [B, N, Cin], p [B, N, 3], knn_idx [B, N, K] int32 (within-cloud),
// q [B*N, C], params packed as above; out [B*N, C]. Returns cudaGetLastError().
extern "C" int tgn_attention(const float* x, const float* p, const int* knn_idx,
                             const float* q, const float* params, int b, int n,
                             int kk, int cin, int c, int cs, float* out,
                             cudaStream_t stream) {
    return launch<false>(x, p, knn_idx, q, params, (size_t)b * n, n, kk, cin, c,
                         cs, out, stream);
}

// K6. q [BN, C], x_g [BN*K, Cin], p_r [BN*K, 3], params packed as above;
// out [BN, C]. Returns cudaGetLastError().
extern "C" int tgn_attention_gathered(const float* q, const float* x_g,
                                      const float* p_r, const float* params,
                                      int bn, int kk, int cin, int c, int cs,
                                      float* out, cudaStream_t stream) {
    return launch<true>(x_g, p_r, nullptr, q, params, (size_t)bn, bn, kk, cin, c,
                        cs, out, stream);
}
