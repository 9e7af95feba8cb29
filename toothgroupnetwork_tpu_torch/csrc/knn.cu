// K2: exact k-nearest-neighbour selection, one warp per query for k <= 64
// (C = 3 and C <= 256), one block per query beyond (knn_kernel_any).
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
// stage-0 self-kNN, 9 operations a pair) and the selection's latency. One
// query per thread would give 24000 threads (under 10 % of the card's warp
// slots) with the best-k in local memory, and a scan in index order is slow
// on a spatially sorted cloud, where the near candidates come late and most
// of them are inserted.
//
// The design: one warp per query, kWarps queries a block sharing
// shared-memory tiles of kTile candidates (x, y, z and |p|^2 as one float4,
// and the bias). Each lane computes the distance of one candidate of 32, bit-equal to
// the plain twin (the _rn intrinsics in its order). Keys are (d2, index) pairs
// compared lexicographically, so the result is the contract's whatever order
// the candidates are visited in. A ballot of key < k-th key keeps the
// candidates that can enter; each survivor, lowest lane first, is inserted
// into a warp-resident sorted list of 64 keys, two register slots a lane
// (slot j in lane j % 32, bank j / 32): the insert position is a ballot over
// the list, the shift a __shfl_up_sync with lane 31 of the first bank carried
// into lane 0 of the second. No local memory is used. Because the order is
// free, each warp first scans the kSeed candidates around index row * N / M
// (a self-query's own index neighbourhood) and then the rest: on a spatially
// sorted cloud the k-th distance is then near its final value after the first
// two batches, and after warm-up an insert is rare (~k (1 + ln(N / k)) of N
// candidates in a random order, fewer in a sorted one).

#include "common.cuh"

namespace {

constexpr int kMaxK = 64;
constexpr int kWarps = 8;
constexpr int kTile = 1024;
constexpr int kSeed = 64;
constexpr int kUnroll = 4;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool key_less(float ad, int ai, float bd, int bi) {
    return ad < bd || (ad == bd && ai < bi);
}

// d2 of one (query, candidate) pair in the plain twin's order.
__device__ __forceinline__ float pair_d2(float qx, float qy, float qz, float q2,
                                         float4 p, float bias) {
    const float cross = __fadd_rn(__fadd_rn(__fmul_rn(qx, p.x), __fmul_rn(qy, p.y)),
                                  __fmul_rn(qz, p.z));
    const float e = __fadd_rn(__fsub_rn(q2, __fmul_rn(2.f, cross)), p.w);
    return __fadd_rn(fmaxf(e, 0.f), bias);
}

// The warp's sorted list of 64 (d2, index) keys: slot j lives in lane j % 32
// of bank a (j < 32) or bank b. (kd, ki) is the k-th key, the entry bar.
struct WarpList {
    float ad, bd, kd;
    int ai, bi, ki;

    __device__ __forceinline__ void init() {
        ad = bd = kd = CUDART_INF_F;
        ai = bi = ki = INT_MAX;
    }

    // insert (d, i), which is below the k-th key, keeping the list sorted
    __device__ __forceinline__ void insert(float d, int i, int k, int lane) {
        const int pos = __popc(__ballot_sync(kFull, key_less(ad, ai, d, i)))
                        + __popc(__ballot_sync(kFull, key_less(bd, bi, d, i)));
        const float up_ad = __shfl_up_sync(kFull, ad, 1);
        const int up_ai = __shfl_up_sync(kFull, ai, 1);
        float up_bd = __shfl_up_sync(kFull, bd, 1);
        int up_bi = __shfl_up_sync(kFull, bi, 1);
        const float carry_d = __shfl_sync(kFull, ad, 31);
        const int carry_i = __shfl_sync(kFull, ai, 31);
        if (lane == 0) {
            up_bd = carry_d;
            up_bi = carry_i;
        }
        if (lane > pos) {
            ad = up_ad;
            ai = up_ai;
        } else if (lane == pos) {
            ad = d;
            ai = i;
        }
        if (lane + 32 > pos) {
            bd = up_bd;
            bi = up_bi;
        } else if (lane + 32 == pos) {
            bd = d;
            bi = i;
        }
        if (k <= 32) {
            kd = __shfl_sync(kFull, ad, k - 1);
            ki = __shfl_sync(kFull, ai, k - 1);
        } else {
            kd = __shfl_sync(kFull, bd, k - 33);
            ki = __shfl_sync(kFull, bi, k - 33);
        }
    }

    // offer each lane's candidate (d, i) where ok; survivors of the ballot go
    // in lowest lane first, each checked against the bar as it stands then
    __device__ __forceinline__ void offer(bool ok, float d, int i, int k, int lane) {
        unsigned mask = __ballot_sync(kFull, ok && key_less(d, i, kd, ki));
        while (mask != 0) {
            const int src = __ffs(mask) - 1;
            mask &= mask - 1;
            const float cd = __shfl_sync(kFull, d, src);
            const int ci = __shfl_sync(kFull, i, src);
            if (key_less(cd, ci, kd, ki)) insert(cd, ci, k, lane);
        }
    }
};

__global__ void __launch_bounds__(kWarps * 32)
knn_kernel(const float* __restrict__ q, const float* __restrict__ p,
           const float* __restrict__ bias, int m, int n, int k,
           int* __restrict__ out_idx, float* __restrict__ out_d2) {
    __shared__ float4 s_p[kTile];   // x, y, z, |p|^2
    __shared__ float s_b[kTile];
    const size_t b = blockIdx.y;
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
    const bool active = row < m;   // warp-uniform; idle warps still load tiles
    q += b * (size_t)m * 3;
    p += b * (size_t)n * 3;
    if (bias != nullptr) bias += b * (size_t)n;

    float qx = 0.f, qy = 0.f, qz = 0.f;
    if (active) {
        qx = q[3 * (size_t)row];
        qy = q[3 * (size_t)row + 1];
        qz = q[3 * (size_t)row + 2];
    }
    const float q2 = sq3_rn(qx, qy, qz);

    WarpList list;
    list.init();

    // the seed window [ws, we): the candidates around index row * n / m
    int ws = 0, we = 0;
    if (active) {
        const int centre = (int)((long long)row * n / m);
        ws = max(0, min(centre - kSeed / 2, n - kSeed));
        we = min(n, ws + kSeed);
        for (int t0 = ws; t0 < we; t0 += 32) {
            const int t = t0 + lane;
            const bool ok = t < we;
            float d = 0.f;
            if (ok) {
                const float x = p[3 * (size_t)t];
                const float y = p[3 * (size_t)t + 1];
                const float z = p[3 * (size_t)t + 2];
                d = pair_d2(qx, qy, qz, q2, make_float4(x, y, z, sq3_rn(x, y, z)),
                            bias != nullptr ? bias[t] : 0.f);
            }
            list.offer(ok, d, t, k, lane);
        }
    }

    for (int base = 0; base < n; base += kTile) {
        const int len = min(kTile, n - base);
        __syncthreads();
        for (int t = threadIdx.x; t < len; t += blockDim.x) {
            const float x = p[3 * (size_t)(base + t)];
            const float y = p[3 * (size_t)(base + t) + 1];
            const float z = p[3 * (size_t)(base + t) + 2];
            s_p[t] = make_float4(x, y, z, sq3_rn(x, y, z));
            s_b[t] = bias != nullptr ? bias[base + t] : 0.f;
        }
        __syncthreads();
        if (!active) continue;
        for (int t0 = 0; t0 < len; t0 += 32 * kUnroll) {
            float d[kUnroll];
            bool ok[kUnroll];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
                const int t = t0 + 32 * u + lane;
                const int g = base + t;
                ok[u] = t < len && (g < ws || g >= we);   // the window is done
                d[u] = ok[u] ? pair_d2(qx, qy, qz, q2, s_p[t], s_b[t]) : 0.f;
            }
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
                list.offer(ok[u], d[u], base + t0 + 32 * u + lane, k, lane);
            }
        }
    }
    if (!active) return;
    int* oi = out_idx + (b * (size_t)m + row) * k;
    float* od = out_d2 + (b * (size_t)m + row) * k;
    // k > n: index 0 at 1e10 past the n real entries
    if (lane < k) {
        oi[lane] = lane < n ? list.ai : 0;
        od[lane] = lane < n ? list.ad : 1e10f;
    }
    if (lane + 32 < k) {
        oi[lane + 32] = lane + 32 < n ? list.bi : 0;
        od[lane + 32] = lane + 32 < n ? list.bd : 1e10f;
    }
}

// The general-C route (any C != 3, 1 <= C <= kMaxC): the same contract and
// the same warp selection, with the distance accumulated channel by channel
// in the plain twin's order (ops/distance.py:_dot_fixed: ((a0*b0 + a1*b1) +
// a2*b2) + ..., each product and sum rounded to nearest), so kernel and twin
// stay bit-equal. DGCNN's EdgeConv selects in feature space at C = 6 and 64
// (toothgroupnetwork_tpu/models/dgcnn.py:23-30), as knn_pallas_select's
// [tq, c] blocks allow any C. A block of kWarpsC queries keeps its query rows
// and one tile of `tile` candidates in dynamic shared memory, the tile
// transposed ([c][tile + 1], the odd stride keeping the loads and the
// per-lane reads free of bank conflicts) beside each candidate's |p|^2 and
// bias; `tile` is the largest multiple of 32 (at most 1024) that fits 48 KB.
// What bounds it: the (2C + 3) operations a pair and the shared-memory reads
// feeding them (one broadcast query value a channel, reused over kUnroll
// candidates a lane). No seed window: feature space has no index locality.
constexpr int kWarpsC = 8;
constexpr int kSmemFloatsC = 12288;   // 48 KB: no opt-in attribute needed
constexpr int kMaxC = 256;

__host__ __device__ inline int knn_tile_c(int c) {
    int t = (kSmemFloatsC - (kWarpsC + 1) * c) / (c + 2);
    t = t / 32 * 32;
    return t < 1024 ? t : 1024;
}

__device__ __forceinline__ float dot_rn(const float* a, const float* b, int c) {
    float acc = __fmul_rn(a[0], b[0]);
    for (int i = 1; i < c; ++i) acc = __fadd_rn(acc, __fmul_rn(a[i], b[i]));
    return acc;
}

__global__ void __launch_bounds__(kWarpsC * 32)
knn_kernel_c(const float* __restrict__ q, const float* __restrict__ p,
             const float* __restrict__ bias, int m, int n, int c, int k, int tile,
             int* __restrict__ out_idx, float* __restrict__ out_d2) {
    extern __shared__ float smem[];
    const int ts = tile + 1;
    float* s_q = smem;                         // [kWarpsC][c]
    float* s_p = s_q + kWarpsC * c;            // [c][ts], candidates transposed
    float* s_p2 = s_p + (size_t)c * ts;        // [tile] |p|^2
    float* s_b = s_p2 + tile;                  // [tile] bias
    const size_t b = blockIdx.y;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int row = blockIdx.x * kWarpsC + warp;
    const bool active = row < m;   // warp-uniform; idle warps still load tiles
    q += b * (size_t)m * c;
    p += b * (size_t)n * c;
    if (bias != nullptr) bias += b * (size_t)n;

    for (int i = threadIdx.x; i < kWarpsC * c; i += blockDim.x) {
        const int r = blockIdx.x * kWarpsC + i / c;
        s_q[i] = r < m ? q[(size_t)blockIdx.x * kWarpsC * c + i] : 0.f;
    }
    __syncthreads();
    const float* qr = s_q + warp * c;
    const float q2 = dot_rn(qr, qr, c);

    WarpList list;
    list.init();
    for (int base = 0; base < n; base += tile) {
        const int len = min(tile, n - base);
        __syncthreads();
        for (int i = threadIdx.x; i < len * c; i += blockDim.x) {
            const int t = i / c;
            s_p[(i - t * c) * ts + t] = p[(size_t)base * c + i];
        }
        __syncthreads();
        for (int t = threadIdx.x; t < len; t += blockDim.x) {
            float acc = __fmul_rn(s_p[t], s_p[t]);
            for (int ch = 1; ch < c; ++ch) {
                const float v = s_p[ch * ts + t];
                acc = __fadd_rn(acc, __fmul_rn(v, v));
            }
            s_p2[t] = acc;
            s_b[t] = bias != nullptr ? bias[base + t] : 0.f;
        }
        __syncthreads();
        if (!active) continue;
        for (int t0 = 0; t0 < len; t0 += 32 * kUnroll) {
            float acc[kUnroll];
            int tt[kUnroll];
            bool ok[kUnroll];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
                const int t = t0 + 32 * u + lane;
                ok[u] = t < len;
                tt[u] = ok[u] ? t : 0;
                acc[u] = __fmul_rn(qr[0], s_p[tt[u]]);
            }
            for (int ch = 1; ch < c; ++ch) {
                const float qv = qr[ch];
                const float* col = s_p + ch * ts;
#pragma unroll
                for (int u = 0; u < kUnroll; ++u) {
                    acc[u] = __fadd_rn(acc[u], __fmul_rn(qv, col[tt[u]]));
                }
            }
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
                const float e = __fadd_rn(__fsub_rn(q2, __fmul_rn(2.f, acc[u])),
                                          s_p2[tt[u]]);
                const float d = __fadd_rn(fmaxf(e, 0.f), s_b[tt[u]]);
                list.offer(ok[u], d, base + tt[u], k, lane);
            }
        }
    }
    if (!active) return;
    int* oi = out_idx + (b * (size_t)m + row) * k;
    float* od = out_d2 + (b * (size_t)m + row) * k;
    if (lane < k) {
        oi[lane] = lane < n ? list.ai : 0;
        od[lane] = lane < n ? list.ad : 1e10f;
    }
    if (lane + 32 < k) {
        oi[lane + 32] = lane + 32 < n ? list.bi : 0;
        od[lane + 32] = lane + 32 < n ? list.bd : 1e10f;
    }
}

// The any-size route (k > kMaxK or C > kMaxC, where the warp's list no
// longer fits two register banks or the query rows no longer fit shared
// memory): the same contract, one block of kAnyThreads threads a query.
// Each tile of kAnyThreads candidates (one a thread) is read kChunkC
// channels at a time through shared memory, transposed as in
// knn_kernel_c, the distance accumulated in the plain twin's order; any C
// fits. The sorted list of k (d2, index) keys lives in two rows of global
// memory (the output and a scratch row, in turns), as long as k requires.
// A tile's candidates below the k-th key are compacted into shared memory,
// sorted by rank (each counts the keys below its own: keys are unique, so
// the ranks are a permutation and the order of the compaction's atomics
// does not show), and merged with the list by rank: a key's place in the
// merged list is its own index plus the number of keys of the other list
// below it (a binary search). The merged list keeps its first k keys, and
// the k-th key is the next tile's bar. Deterministic, no float atomics.
// What bounds it: the M x N x C distance stream, each candidate tile read
// once a query (no reuse across queries); no preset reaches this route.
constexpr int kAnyThreads = 256;
constexpr int kChunkC = 32;

// keys of the sorted (d, i)[0, len) below (kd, ki)
__device__ __forceinline__ int rank_in(const float* d, const int* i, int len,
                                       float kd, int ki) {
    int lo = 0, hi = len;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (key_less(d[mid], i[mid], kd, ki)) {
            lo = mid + 1;
        } else {
            hi = mid;
        }
    }
    return lo;
}

__global__ void __launch_bounds__(kAnyThreads)
knn_kernel_any(const float* __restrict__ q, const float* __restrict__ p,
               const float* __restrict__ bias, int m, int n, int c, int k,
               int* out_idx, float* out_d2, int* scratch_idx, float* scratch_d2) {
    __shared__ float s_p[kChunkC][kAnyThreads + 1];   // candidates transposed
    __shared__ float s_q[kChunkC];
    __shared__ float s_cd[kAnyThreads], s_sd[kAnyThreads];   // survivors, sorted
    __shared__ int s_ci[kAnyThreads], s_si[kAnyThreads];
    __shared__ int s_count;
    __shared__ float s_q2, s_kd;
    __shared__ int s_ki;
    const size_t b = blockIdx.y;
    const int row = blockIdx.x;
    const int tid = threadIdx.x;
    const size_t at = (b * (size_t)m + row) * k;
    q += (b * (size_t)m + row) * c;
    p += b * (size_t)n * c;
    if (bias != nullptr) bias += b * (size_t)n;
    float* list_d[2] = {out_d2 + at, scratch_d2 + at};
    int* list_i[2] = {out_idx + at, scratch_idx + at};
    int cur = 0, len = 0;

    if (tid == 0) {
        float acc = __fmul_rn(q[0], q[0]);
        for (int ch = 1; ch < c; ++ch) acc = __fadd_rn(acc, __fmul_rn(q[ch], q[ch]));
        s_q2 = acc;
        s_kd = CUDART_INF_F;
        s_ki = INT_MAX;
    }
    for (int base = 0; base < n; base += kAnyThreads) {
        const int t = base + tid;
        const int rows = min(kAnyThreads, n - base);
        float cross = 0.f, p2 = 0.f;
        for (int c0 = 0; c0 < c; c0 += kChunkC) {
            const int cc = min(kChunkC, c - c0);
            __syncthreads();
            for (int i = tid; i < rows * cc; i += kAnyThreads) {
                const int r = i / cc;
                s_p[i - r * cc][r] = p[(size_t)(base + r) * c + c0 + (i - r * cc)];
            }
            if (tid < cc) s_q[tid] = q[c0 + tid];
            __syncthreads();
            if (tid < rows) {
                for (int j = 0; j < cc; ++j) {
                    const float v = s_p[j][tid];
                    if (c0 + j == 0) {
                        cross = __fmul_rn(s_q[0], v);
                        p2 = __fmul_rn(v, v);
                    } else {
                        cross = __fadd_rn(cross, __fmul_rn(s_q[j], v));
                        p2 = __fadd_rn(p2, __fmul_rn(v, v));
                    }
                }
            }
        }
        if (tid == 0) s_count = 0;
        __syncthreads();
        if (tid < rows) {
            const float e = __fadd_rn(__fsub_rn(s_q2, __fmul_rn(2.f, cross)), p2);
            const float d = __fadd_rn(fmaxf(e, 0.f), bias != nullptr ? bias[t] : 0.f);
            if (key_less(d, t, s_kd, s_ki)) {
                const int slot = atomicAdd(&s_count, 1);
                s_cd[slot] = d;
                s_ci[slot] = t;
            }
        }
        __syncthreads();
        const int cnt = s_count;
        if (cnt == 0) continue;   // block-uniform
        if (tid < cnt) {
            const float d = s_cd[tid];
            const int i = s_ci[tid];
            int r = 0;
            for (int j = 0; j < cnt; ++j) r += key_less(s_cd[j], s_ci[j], d, i);
            s_sd[r] = d;
            s_si[r] = i;
        }
        __syncthreads();
        const int merged = min(len + cnt, k);
        const float* old_d = list_d[cur];
        const int* old_i = list_i[cur];
        float* new_d = list_d[cur ^ 1];
        int* new_i = list_i[cur ^ 1];
        for (int j = tid; j < len; j += kAnyThreads) {
            const float d = old_d[j];
            const int i = old_i[j];
            const int r = j + rank_in(s_sd, s_si, cnt, d, i);
            if (r < merged) {
                new_d[r] = d;
                new_i[r] = i;
            }
        }
        for (int j = tid; j < cnt; j += kAnyThreads) {
            const int r = j + rank_in(old_d, old_i, len, s_sd[j], s_si[j]);
            if (r < merged) {
                new_d[r] = s_sd[j];
                new_i[r] = s_si[j];
            }
        }
        __syncthreads();
        cur ^= 1;
        len = merged;
        if (tid == 0 && len == k) {
            s_kd = list_d[cur][k - 1];
            s_ki = list_i[cur][k - 1];
        }
    }
    __syncthreads();
    // the list into the output row; k > n: index 0 at 1e10 past the n keys
    for (int j = tid; j < k; j += kAnyThreads) {
        if (j < len) {
            if (cur != 0) {
                out_d2[at + j] = list_d[cur][j];
                out_idx[at + j] = list_i[cur][j];
            }
        } else {
            out_d2[at + j] = 1e10f;
            out_idx[at + j] = 0;
        }
    }
}

}  // namespace

// q [B, M, 3], p [B, N, 3] f32; bias [B, N] f32 or null; out_idx [B, M, k]
// int32, out_d2 [B, M, k] f32. Returns cudaGetLastError() after the launch.
extern "C" int tgn_knn(const float* q, const float* p, const float* bias, int b,
                       int m, int n, int k, int* out_idx, float* out_d2,
                       cudaStream_t stream) {
    if (k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
    dim3 grid((m + kWarps - 1) / kWarps, b);
    knn_kernel<<<grid, kWarps * 32, 0, stream>>>(q, p, bias, m, n, k, out_idx, out_d2);
    return (int)cudaGetLastError();
}

// q [B, M, C], p [B, N, C] f32 (1 <= C <= kMaxC); bias [B, N] f32 or null;
// out_idx [B, M, k] int32, out_d2 [B, M, k] f32. Returns cudaGetLastError()
// after the launch.
extern "C" int tgn_knn_c(const float* q, const float* p, const float* bias, int b,
                         int m, int n, int c, int k, int* out_idx, float* out_d2,
                         cudaStream_t stream) {
    if (k < 1 || k > kMaxK || c < 1 || c > kMaxC) return (int)cudaErrorInvalidValue;
    const int tile = knn_tile_c(c);
    const size_t smem = ((size_t)kWarpsC * c + (size_t)c * (tile + 1) + 2 * (size_t)tile)
                        * sizeof(float);
    dim3 grid((m + kWarpsC - 1) / kWarpsC, b);
    knn_kernel_c<<<grid, kWarpsC * 32, smem, stream>>>(q, p, bias, m, n, c, k, tile,
                                                        out_idx, out_d2);
    return (int)cudaGetLastError();
}

// Any k >= 1 and C >= 1 (knn_kernel_any): q [B, M, C], p [B, N, C] f32; bias
// [B, N] f32 or null; out_idx [B, M, k] int32, out_d2 [B, M, k] f32, and
// scratch rows of the same shapes. Returns cudaGetLastError() after the
// launch.
extern "C" int tgn_knn_any(const float* q, const float* p, const float* bias,
                           int b, int m, int n, int c, int k, int* out_idx,
                           float* out_d2, int* scratch_idx, float* scratch_d2,
                           cudaStream_t stream) {
    if (k < 1 || c < 1) return (int)cudaErrorInvalidValue;
    dim3 grid(m, b);
    knn_kernel_any<<<grid, kAnyThreads, 0, stream>>>(q, p, bias, m, n, c, k, out_idx,
                                                     out_d2, scratch_idx, scratch_d2);
    return (int)cudaGetLastError();
}
