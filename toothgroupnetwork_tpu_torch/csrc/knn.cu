// K2: exact k-nearest-neighbour selection: one warp per query at C = 3 and
// k <= 64 (knn_kernel), a register-tiled distance stage over query tiles at
// any other C or k (knn_tile_kernel, below knn_kernel).
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

#include <algorithm>
#include <atomic>

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

// The feature-space routes: tgn_knn_c (C != 3, C <= kMaxC, k <= kMaxK;
// DGCNN's EdgeConv selects at C = 6 and 64, toothgroupnetwork_tpu/models/
// dgcnn.py:23-30) and tgn_knn_any (k > kMaxK or C > kMaxC; no preset), as
// knn_pallas_select's [tq, c] blocks take any C and k. The same contract,
// and the distance summed channel by channel in the plain twin's order
// (ops/distance.py:_dot_fixed: ((a0*b0 + a1*b1) + a2*b2) + ..., each product
// and sum rounded to nearest), so kernel and twin stay bit-equal.
//
// What bounds them: the M x N x C distance stream, 2C + 3 operations a pair,
// and at small C the selection's latency. The exact form issues each
// product and each sum on its own (__fmul_rn, __fadd_rn: an FMA, TF32 or the
// tensor cores would round otherwise), and the card's 67 TFLOP/s counts an
// FMA as two operations, so the FP32 pipe runs the exact form at half that
// rate. A self-query (DGCNN's EdgeConv) needs the cross term of only
// n (n + 1) / 2 pairs: it is symmetric bit for bit (the same products added
// in the same channel order), so its bound is (2C - 1) n (n + 1) / 2 + 4 n^2
// operations (C = 64 at [1,24000]: 0.58 ms), and the exact form's ceiling
// twice that (1.16 ms). The stage below computes every pair, which caps it
// at ~26 % of a self-query's bound (2.25 ms at C = 64); a tile computed
// once for both of its triangles is the next step. A warp a query, with
// one candidate read from shared memory a multiply-add, waits on the
// shared-memory pipe at ~2.5x the arithmetic's time.
//
// The distance stage, one for both routes. A block of kTThreads threads owns
// kTQ queries and walks a range of candidates in tiles of kTP; each thread
// accumulates a kTR x kTS register tile (4 query rows by 8 candidates). The
// channels go through shared memory in chunks of kCh, transposed and padded
// (strides of 4 mod 32 words keep the 16-byte reads aligned), so any C fits
// and the accumulators carry the fixed order across chunks; per channel a
// thread reads one float4 of queries (a broadcast) and two of candidates
// and issues 32 FMUL/FADD pairs, so the FP32 pipe, not the shared-memory
// path, sets the pace. A tile's first chunk is copied in by cp.async while
// the tile before it is selected. |q|^2 and |p|^2 come from a pre-pass
// (knn_norms_kernel) into the wrapper's scratch, once a call.
//
// The selection. The tile's d2 go to shared memory. Keys (d2, index) are
// unique, so the k smallest do not depend on the order in which candidates
// are offered: any order of the tiles, of a tile's keys and of the splits
// below gives the same list, and a bar that lags only lets more keys in.
// That is what makes each of the following safe.
//  * tgn_knn_c flags the rows with a candidate not above the row's k-th key;
//    one warp takes each flagged row, loads its list (a WarpList of 64 keys
//    in two register banks, one bank when k <= 32) from shared memory and
//    inserts the row's keys below the bar lowest lane first. The k
//    (1 + ln(N / k)) inserts a query are chains of ballots and shuffles,
//    latency that the block's other warps and the SM's other block hide, so
//    a split's first tile fills the lists with one bitonic sort of each row
//    instead of ~k (1 + ln(128 / k)) inserts, the new bar is taken off the
//    chain (list_insert), and a query's candidates are split only as far as
//    the card has idle block slots.
//  * tgn_knn_any, whose list of any k lives in two global rows used in
//    turns, queues each row's keys below its bar (shared atomics reserve
//    the slots, kQCap of them); only a row whose queue overflows is merged:
//    its queued keys and the tile's keys below the bar, sorted (a bitonic
//    network in registers above 64 keys, ranks below), merged with the list
//    by rank (a key's place is its index plus the other sequence's keys
//    below it), the first k kept, the k-th the next bar.
// To fill the card, the candidates are split into `splits` contiguous
// ranges, each block writes its range's sorted partial list, and
// knn_merge_kernel folds a query's partial lists together by rank.
// Deterministic, no float atomics.
constexpr int kMaxC = 256;
constexpr int kTQ = 64;                    // queries a block
constexpr int kTP = 128;                   // candidates a tile
constexpr int kTR = 4;                     // query rows a thread
constexpr int kTS = 8;                     // candidates a thread: two runs of 4
constexpr int kTThreads = 256;             // 16 x 16 threads of kTR x kTS
constexpr int kTWarps = kTThreads / 32;
constexpr int kCh = 32;                    // channels a chunk
constexpr int kQS = kTQ + 4;               // transposed strides (words)
constexpr int kPS = kTP + 4;
constexpr int kQCap = 16;                  // keys a query's queue holds
constexpr int kMaxSplits = 32;
static_assert(kTQ == 16 * kTR && kTP == 16 * kTS && kTThreads == 256 && kTP == 128,
              "the 16 x 16 thread tile; a batch sorts as 4 keys a lane");

// shared memory (4-byte words): s_q, s_p, s_d, s_p2, s_b, s_q2, s_kd, s_ki;
// then for tgn_knn_c each row's flag and list (two banks of 32 slots), for
// tgn_knn_any each row's offered and queued counts, list length, row in use
// and queue, and each warp's batch, its sorted copy and the ranks' histogram
constexpr int kSmemCommon = kCh * kQS + kCh * kPS + kTQ * kPS + 2 * kTP + 3 * kTQ;
constexpr int kSmemC = kTQ + 2 * kTQ * kMaxK;
constexpr int kWarpWords = 5 * kTP + 1;
constexpr int kSmemAny = 4 * kTQ + 2 * kTQ * kQCap + kTWarps * kWarpWords;

__host__ __device__ constexpr size_t tile_smem_bytes(bool any) {
    return (size_t)(kSmemCommon + (any ? kSmemAny : kSmemC)) * 4;
}

// the candidates [lo, hi) of split s of `splits`: whole tiles, as even as
// the tile count allows
__host__ __device__ inline void split_range(int s, int splits, int n, int* lo,
                                            int* hi) {
    const long long nt = (n + kTP - 1) / kTP;
    const long long a = nt * s / splits * kTP, z = nt * (s + 1) / splits * kTP;
    *lo = (int)(a < n ? a : n);
    *hi = (int)(z < n ? z : n);
}

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

// |x_r|^2 of each row in _dot_fixed's order, a thread a row
__global__ void __launch_bounds__(256)
knn_norms_kernel(const float* __restrict__ x, size_t rows, int c,
                 float* __restrict__ out) {
    const size_t r = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= rows) return;
    const float* xr = x + r * c;
    float acc = __fmul_rn(xr[0], xr[0]);
    for (int ch = 1; ch < c; ++ch) acc = __fadd_rn(acc, __fmul_rn(xr[ch], xr[ch]));
    out[r] = acc;
}

// A 4-byte copy from global to shared memory that the copy engine runs
// while the threads go on (zero-filled where !valid); cp_async_wait waits
// for this thread's copies.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
                 "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// channels [c0, c0 + cc) of rows [0, cap) of the row-major src (stride c)
// into dst[ch * stride + r], transposed, by cp_async4; rows from `rows` on
// are zero. A partial chunk takes each element's row from a float product:
// (i + 1/2) / cc lies at least 1 / (2 cc) from an integer, far beyond the
// product's rounding for i < 2^12.
__device__ __forceinline__ void async_chunk(float* dst, int stride,
                                            const float* __restrict__ src, int rows,
                                            int cap, int c, int c0, int cc, int tid) {
    if (cc == kCh) {   // a full chunk: one channel a thread
        const int ch = tid % kCh;
#pragma unroll 4
        for (int r = tid / kCh; r < cap; r += kTThreads / kCh) {
            cp_async4(dst + ch * stride + r, src + (size_t)min(r, rows - 1) * c + c0 + ch,
                      r < rows);
        }
    } else {
        const float inv = 1.f / (float)cc;
        for (int i = tid; i < cap * cc; i += kTThreads) {
            const int r = (int)(((float)i + 0.5f) * inv), ch = i - r * cc;
            cp_async4(dst + ch * stride + r, src + (size_t)min(r, rows - 1) * c + c0 + ch,
                      r < rows);
        }
    }
}

__device__ __forceinline__ float4 lds4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void sts4(float* p, float a, float b, float c, float d) {
    *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// compare-and-swap of keys a < b of this lane (a the lower element)
__device__ __forceinline__ void cas_keys(float* v, int* w, int a, int b, bool asc) {
    if (asc ? key_less(v[b], w[b], v[a], w[a]) : key_less(v[a], w[a], v[b], w[b])) {
        const float t = v[a];
        v[a] = v[b];
        v[b] = t;
        const int u = w[a];
        w[a] = w[b];
        w[b] = u;
    }
}

// Sort the warp's 128 keys ascending, key 32 r + lane in register r of the
// lane: a bitonic network, the strides of 32 and 64 within a lane.
__device__ __forceinline__ void bitonic128(float (&v)[4], int (&w)[4], int lane) {
#pragma unroll
    for (int ls = 1; ls <= 7; ++ls) {
        const int size = 1 << ls;
#pragma unroll
        for (int lt = ls - 1; lt >= 0; --lt) {
            const int stride = 1 << lt;
            if (stride == 64) {
                cas_keys(v, w, 0, 2, (lane & size) == 0);
                cas_keys(v, w, 1, 3, ((32 + lane) & size) == 0);
            } else if (stride == 32) {
                cas_keys(v, w, 0, 1, (lane & size) == 0);
                cas_keys(v, w, 2, 3, ((64 + lane) & size) == 0);
            } else {
                const bool lower = (lane & stride) == 0;
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    const float ov = __shfl_xor_sync(kFull, v[r], stride);
                    const int ow = __shfl_xor_sync(kFull, w[r], stride);
                    const bool asc = ((32 * r + lane) & size) == 0;
                    const bool less = key_less(ov, ow, v[r], w[r]);
                    if (lower == asc ? less : !less) {
                        v[r] = ov;
                        w[r] = ow;
                    }
                }
            }
        }
    }
}

// Insert (d, i), below the k-th key (kd, ki), into a sorted list of
// kBanks x 32 keys (slot j in lane j % 32 of bank j / 32), as
// WarpList::insert. The new k-th key is the old slot k - 2 when the key
// lands before it, else the key itself: slot k - 2 is shuffled before the
// ballot, off the chain from one insert to the next.
template <int kBanks>
__device__ __forceinline__ void list_insert(float& ad, int& ai, float& bd, int& bi,
                                            float& kd, int& ki, float d, int i, int k,
                                            int lane) {
    const bool in_b = kBanks == 2 && k - 2 >= 32;
    const float pk_d = __shfl_sync(kFull, in_b ? bd : ad, (k + 30) & 31);
    const int pk_i = __shfl_sync(kFull, in_b ? bi : ai, (k + 30) & 31);
    int pos = __popc(__ballot_sync(kFull, key_less(ad, ai, d, i)));
    if constexpr (kBanks == 2) pos += __popc(__ballot_sync(kFull, key_less(bd, bi, d, i)));
    const float up_ad = __shfl_up_sync(kFull, ad, 1);
    const int up_ai = __shfl_up_sync(kFull, ai, 1);
    if constexpr (kBanks == 2) {
        float up_bd = __shfl_up_sync(kFull, bd, 1);
        int up_bi = __shfl_up_sync(kFull, bi, 1);
        const float carry_d = __shfl_sync(kFull, ad, 31);
        const int carry_i = __shfl_sync(kFull, ai, 31);
        if (lane == 0) {
            up_bd = carry_d;
            up_bi = carry_i;
        }
        if (lane + 32 > pos) {
            bd = up_bd;
            bi = up_bi;
        } else if (lane + 32 == pos) {
            bd = d;
            bi = i;
        }
    }
    if (lane > pos) {
        ad = up_ad;
        ai = up_ai;
    } else if (lane == pos) {
        ad = d;
        ai = i;
    }
    if (pos < k - 1) {   // pos <= k - 1: the key is below the k-th
        kd = pk_d;
        ki = pk_i;
    } else {
        kd = d;
        ki = i;
    }
}

// tgn_knn_c's selection of a tile: the warp's flagged rows (w, w + kTWarps,
// ...) one at a time, the row's list loaded into registers, the keys below
// the bar inserted lowest lane first, the list stored back; one bank when
// k <= 32 (half the ballots and shuffles an insert). On a split's `first`
// tile the lists are empty: each row's 128 keys are sorted instead.
constexpr int kRowsAWarp = kTQ / kTWarps;

template <int kBanks>
__device__ void select_rows(float* s_ld, int* s_li, float* s_kd, int* s_ki,
                            int* s_flag, const float* s_d, int rows, int len,
                            int base, int k, int warp, int lane, bool first) {
    if (first) {   // empty lists: each row's tile sorted, its first keys kept
        for (int r = warp; r < rows; r += kTWarps) {
            const float* dr = s_d + r * kPS;
            float v[4];
            int w[4];
#pragma unroll
            for (int g = 0; g < 4; ++g) {
                const int t = 32 * g + lane;
                v[g] = t < len ? dr[t] : CUDART_INF_F;
                w[g] = t < len ? base + t : INT_MAX;
            }
            bitonic128(v, w, lane);
            s_ld[r * kMaxK + lane] = v[0];
            s_li[r * kMaxK + lane] = w[0];
            s_ld[r * kMaxK + 32 + lane] = v[1];
            s_li[r * kMaxK + 32 + lane] = w[1];
            const float kd = __shfl_sync(kFull, k <= 32 ? v[0] : v[1], (k - 1) & 31);
            const int ki = __shfl_sync(kFull, k <= 32 ? w[0] : w[1], (k - 1) & 31);
            if (lane == 0) {
                s_kd[r] = kd;
                s_ki[r] = ki;
                s_flag[r] = 0;
            }
        }
        return;
    }
    for (int r = warp; r < rows; r += kTWarps) {
        if (s_flag[r] == 0) continue;   // warp-uniform
        float* lrd = s_ld + r * kMaxK;
        int* lri = s_li + r * kMaxK;
        float ad = lrd[lane], bd = CUDART_INF_F, kd = s_kd[r];
        int ai = lri[lane], bi = INT_MAX, ki = s_ki[r];
        if constexpr (kBanks == 2) {
            bd = lrd[32 + lane];
            bi = lri[32 + lane];
        }
        // the four chunks' ballots against the row's bar at the start (a
        // superset: each key is checked again against the bar as it stands)
        const float* dr = s_d + r * kPS;
        float dv[kTP / 32];
        unsigned mk[kTP / 32];
#pragma unroll
        for (int g = 0; g < kTP / 32; ++g) {
            const int t = 32 * g + lane;
            dv[g] = t < len ? dr[t] : 0.f;
            mk[g] = __ballot_sync(kFull, t < len && key_less(dv[g], base + t, kd, ki));
        }
#pragma unroll
        for (int g = 0; g < kTP / 32; ++g) {
            for (unsigned mask = mk[g]; mask != 0u; mask &= mask - 1u) {
                const int src = __ffs(mask) - 1;
                const float cd = __shfl_sync(kFull, dv[g], src);
                const int ci = base + 32 * g + src;
                if (key_less(cd, ci, kd, ki)) {
                    list_insert<kBanks>(ad, ai, bd, bi, kd, ki, cd, ci, k, lane);
                }
            }
        }
        lrd[lane] = ad;
        lri[lane] = ai;
        if constexpr (kBanks == 2) {
            lrd[32 + lane] = bd;
            lri[32 + lane] = bi;
        }
        if (lane == 0) {
            s_kd[r] = kd;
            s_ki[r] = ki;
            s_flag[r] = 0;
        }
    }
}

// tgn_knn_any's selection state: each query row's queue, bar and sorted
// list of up to k keys in two global rows used in turns, and the calling
// warp's scratch. Warp w handles rows w, w + kTWarps, ...
struct RowMerger {
    int k, lane;
    float *kd, *qd, *ld, *wd, *sd;
    int *ki, *qi, *li, *wi, *si, *len, *cur, *hist;
    float* ld1;     // the lists' second rows, laid out as (ld, li)
    int* li1;

    // the n <= kTP keys (bd, bi) sorted into (sd, si): above 64 keys a
    // bitonic network in registers (key 32 r + lane in register r, padded
    // with (inf, INT_MAX)), else each key placed at its rank
    __device__ void sort(const float* bd, const int* bi, int n) {
        if (n > 64) {
            float v[4];
            int w[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const int x = 32 * r + lane;
                v[r] = x < n ? bd[x] : CUDART_INF_F;
                w[r] = x < n ? bi[x] : INT_MAX;
            }
            bitonic128(v, w, lane);
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                sd[32 * r + lane] = v[r];
                si[32 * r + lane] = w[r];
            }
        } else {
            for (int j = lane; j < n; j += 32) {
                const float d = bd[j];
                const int i = bi[j];
                int rk = 0;
#pragma unroll 8
                for (int t = 0; t < n; ++t) rk += key_less(bd[t], bi[t], d, i);
                sd[rk] = d;
                si[rk] = i;
            }
        }
    }

    // the n <= kTP keys (bd, bi) merged into row r's list: sorted, then each
    // key placed by rank (an old key: its index plus the sorted keys below
    // it, a binary search; a sorted key: its index plus the old keys below
    // it, the histogram of the old keys' ranks, old key j being below sorted
    // key t iff its rank <= t), the first k kept, the k-th the row's bar
    __device__ void merge(int r, const float* bd, const int* bi, int n) {
        sort(bd, bi, n);
        for (int j = lane; j <= n; j += 32) hist[j] = 0;
        __syncwarp();
        const int old = len[r], merged = min(old + n, k), row = cur[r];
        const float* od = (row ? ld1 : ld) + (size_t)r * k;
        const int* oi = (row ? li1 : li) + (size_t)r * k;
        float* nd = (row ? ld : ld1) + (size_t)r * k;
        int* ni = (row ? li : li1) + (size_t)r * k;
        for (int j = lane; j < old; j += 32) {
            const float d = od[j];
            const int i = oi[j];
            const int rj = rank_in(sd, si, n, d, i);
            if (j + rj < merged) {
                nd[j + rj] = d;
                ni[j + rj] = i;
                if (j + rj == k - 1) {
                    kd[r] = d;
                    ki[r] = i;
                }
            }
            if (rj < n) atomicAdd(&hist[rj], 1);
        }
        __syncwarp();
        for (int j = lane; j < n; j += 32) {
            int below = 0;
            if (old > 0) {
#pragma unroll 8
                for (int t = 0; t <= j; ++t) below += hist[t];
            }
            const int pos = j + below;
            if (pos < merged) {
                nd[pos] = sd[j];
                ni[pos] = si[j];
                if (pos == k - 1) {
                    kd[r] = sd[j];
                    ki[r] = si[j];
                }
            }
        }
        __syncwarp();
        if (lane == 0) {
            len[r] = merged;
            cur[r] = row ^ 1;
        }
        __syncwarp();
    }

    // row r's queue overflowed at this tile (d2 in dr, indices from base,
    // len candidates): its first q0 keys, from before the tile, and the
    // tile's candidates below the bar, found again in dr, merged
    __device__ void overflow(int r, int q0, const float* dr, int base, int len) {
        const float bar_d = kd[r];
        const int bar_i = ki[r];
        unsigned w[4];
        int cnt = 0;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
            const int t = 32 * g + lane;
            w[g] = __ballot_sync(kFull, t < len && key_less(dr[t], base + t, bar_d, bar_i));
            cnt += __popc(w[g]);
        }
        if (q0 + cnt > kTP) {   // the queue first: a batch holds at most kTP
            merge(r, qd + r * kQCap, qi + r * kQCap, q0);
            q0 = 0;
        }
        for (int j = lane; j < q0; j += 32) {
            wd[j] = qd[r * kQCap + j];
            wi[j] = qi[r * kQCap + j];
        }
        int before = q0;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
            if ((w[g] >> lane) & 1u) {
                const int slot = before + __popc(w[g] & ((1u << lane) - 1u));
                wd[slot] = dr[32 * g + lane];
                wi[slot] = base + 32 * g + lane;
            }
            before += __popc(w[g]);
        }
        __syncwarp();
        merge(r, wd, wi, before);
    }
};

// Block (query tile, split) of the grid's x, cloud of its y. Writes the
// split's sorted partial list of each of its queries into part_*:
// [splits][B][M][k], the first min(k, candidates of the split) entries real
// (tgn_knn_any keeps its lists' second rows in row1_*, laid out alike).
// With one split part_* is the output, and the k > n tail (index 0 at
// 1e10) is written here.
template <bool kAny>
__global__ void __launch_bounds__(kTThreads, 2)
knn_tile_kernel(const float* __restrict__ q, const float* __restrict__ p,
                const float* __restrict__ q2g, const float* __restrict__ p2g,
                const float* __restrict__ bias, int m, int n, int c, int k,
                int splits, int* part_idx, float* part_d2, int* row1_idx,
                float* row1_d2) {
    extern __shared__ float4 smem4[];
    float* s_q = reinterpret_cast<float*>(smem4);   // [kCh][kQS] query chunk
    float* s_p = s_q + kCh * kQS;                   // [kCh][kPS] candidate chunk
    float* s_d = s_p + kCh * kPS;                   // [kTQ][kPS] the tile's d2
    float* s_p2 = s_d + kTQ * kPS;                  // [kTP] |p|^2, inf past the tile
    float* s_b = s_p2 + kTP;                        // [kTP] bias
    float* s_q2 = s_b + kTP;                        // [kTQ] |q|^2
    float* s_kd = s_q2 + kTQ;                       // [kTQ] each query's bar
    int* s_ki = reinterpret_cast<int*>(s_kd + kTQ);
    int* s_rest = s_ki + kTQ;
    // tgn_knn_c: the rows flagged at this tile, the lists [kTQ][kMaxK]
    int* s_flag = s_rest;
    float* s_ld = reinterpret_cast<float*>(s_flag + kTQ);
    int* s_li = reinterpret_cast<int*>(s_ld + kTQ * kMaxK);
    // tgn_knn_any: keys offered to each queue, those queued before the
    // tile, the lists' lengths and rows in use, the queues [kTQ][kQCap]
    int* s_qn = s_rest;
    int* s_qbase = s_qn + kTQ;
    int* s_len = s_qbase + kTQ;
    int* s_cur = s_len + kTQ;
    float* s_qd = reinterpret_cast<float*>(s_cur + kTQ);
    int* s_qi = reinterpret_cast<int*>(s_qd + kTQ * kQCap);
    float* s_warp = reinterpret_cast<float*>(s_qi + kTQ * kQCap);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int tc = tid & 15, tq = tid >> 4;
    const int qt = blockIdx.x / splits, split = blockIdx.x - qt * splits;
    const size_t b = blockIdx.y;
    const int row0 = qt * kTQ;
    const int rows = min(kTQ, m - row0);
    int lo, hi;
    split_range(split, splits, n, &lo, &hi);
    q += (b * m + row0) * (size_t)c;
    p += b * (size_t)n * c;
    q2g += b * m + row0;
    p2g += b * (size_t)n;
    if (bias != nullptr) bias += b * (size_t)n;
    const size_t at = (((size_t)split * gridDim.y + b) * m + row0) * k;
    float* ld = part_d2 + at;
    int* li = part_idx + at;

    RowMerger sel;
    if constexpr (kAny) {
        sel.k = k;
        sel.lane = lane;
        sel.kd = s_kd;
        sel.ki = s_ki;
        sel.qd = s_qd;
        sel.qi = s_qi;
        sel.ld = ld;
        sel.li = li;
        sel.len = s_len;
        sel.cur = s_cur;
        sel.ld1 = row1_d2 + at;
        sel.li1 = row1_idx + at;
        sel.wd = s_warp + warp * kWarpWords;                   // the batch,
        sel.wi = reinterpret_cast<int*>(sel.wd + kTP);
        sel.sd = sel.wd + 2 * kTP;                             // sorted,
        sel.si = reinterpret_cast<int*>(sel.wd + 3 * kTP);
        sel.hist = reinterpret_cast<int*>(sel.wd + 4 * kTP);   // the ranks
    }

    for (int i = tid; i < kTQ; i += kTThreads) {
        s_q2[i] = i < rows ? q2g[i] : 0.f;
        s_kd[i] = CUDART_INF_F;
        s_ki[i] = INT_MAX;
        if constexpr (!kAny) s_flag[i] = 0;
        if constexpr (kAny) {
            s_qn[i] = 0;
            s_qbase[i] = 0;
            s_len[i] = 0;
            s_cur[i] = 0;
        }
    }
    if constexpr (!kAny) {
        for (int i = tid; i < kTQ * kMaxK; i += kTThreads) {
            s_ld[i] = CUDART_INF_F;
            s_li[i] = INT_MAX;
        }
    }
    // the query rows stay for every tile when they fit one chunk. A tile's
    // first chunk of candidates, |p|^2 and bias (and query chunk) are copied
    // in while the tile before it is selected; later chunks as they come
    const bool q_once = c <= kCh;
    auto issue = [&](int at, int c0) {
        const int n_at = min(kTP, hi - at), cc = min(kCh, c - c0);
        async_chunk(s_p, kPS, p + (size_t)at * c, n_at, kTP, c, c0, cc, tid);
        if (!q_once || at == lo) async_chunk(s_q, kQS, q, rows, kTQ, c, c0, cc, tid);
        if (c0 == 0 && tid < kTP) {
            const int src = at + min(tid, n_at - 1);
            cp_async4(s_p2 + tid, p2g + src, tid < n_at);
            if (bias != nullptr) {
                cp_async4(s_b + tid, bias + src, tid < n_at);
            } else {
                s_b[tid] = 0.f;
            }
        }
    };
    if (lo < hi) issue(lo, 0);

    for (int base = lo; base < hi; base += kTP) {
        const int len = min(kTP, hi - base);
        float acc[kTR][kTS];
        for (int c0 = 0; c0 < c; c0 += kCh) {
            const int cc = min(kCh, c - c0);
            if (c0 > 0) {
                __syncthreads();   // the last chunk's reads are done
                issue(base, c0);
            }
            cp_async_wait();
            __syncthreads();
            const float* qa = s_q + tq * kTR;
            const float* pa = s_p + tc * 4;
            int ch = 0;
            if (c0 == 0) {   // the first channel: the products alone
                const float4 a = lds4(qa), b0 = lds4(pa), b1 = lds4(pa + kTP / 2);
                const float av[kTR] = {a.x, a.y, a.z, a.w};
                const float bv[kTS] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
                for (int i = 0; i < kTR; ++i) {
#pragma unroll
                    for (int j = 0; j < kTS; ++j) acc[i][j] = __fmul_rn(av[i], bv[j]);
                }
                ch = 1;
            }
#pragma unroll 4
            for (; ch < cc; ++ch) {
                const float4 a = lds4(qa + ch * kQS);
                const float4 b0 = lds4(pa + ch * kPS), b1 = lds4(pa + ch * kPS + kTP / 2);
                const float av[kTR] = {a.x, a.y, a.z, a.w};
                const float bv[kTS] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
                for (int i = 0; i < kTR; ++i) {
#pragma unroll
                    for (int j = 0; j < kTS; ++j) {
                        acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(av[i], bv[j]));
                    }
                }
            }
        }

        // d2 into shared memory. tgn_knn_c flags each row with a candidate
        // not above its bar (d2 <= the bar's: never fewer than the exact test
        // lets in). tgn_knn_any puts each candidate below its row's bar into
        // the row's queue (one atomic a thread and row reserves the slots;
        // those past kQCap are dropped, the count marking the overflow)
        {
            const float4 q2v = lds4(s_q2 + tq * kTR), kdv = lds4(s_kd + tq * kTR);
            const int4 kiv = *reinterpret_cast<const int4*>(s_ki + tq * kTR);
            const float4 pa2 = lds4(s_p2 + tc * 4), pb2 = lds4(s_p2 + kTP / 2 + tc * 4);
            const float4 ba = lds4(s_b + tc * 4), bb = lds4(s_b + kTP / 2 + tc * 4);
            const float q2[kTR] = {q2v.x, q2v.y, q2v.z, q2v.w};
            const float kd[kTR] = {kdv.x, kdv.y, kdv.z, kdv.w};
            const int ki[kTR] = {kiv.x, kiv.y, kiv.z, kiv.w};
            const float p2[kTS] = {pa2.x, pa2.y, pa2.z, pa2.w, pb2.x, pb2.y, pb2.z, pb2.w};
            const float bs[kTS] = {ba.x, ba.y, ba.z, ba.w, bb.x, bb.y, bb.z, bb.w};
#pragma unroll
            for (int i = 0; i < kTR; ++i) {
                const int r = tq * kTR + i;
                float d[kTS];
                unsigned bits = 0u;
#pragma unroll
                for (int j = 0; j < kTS; ++j) {
                    const int col = (j < 4 ? 0 : kTP / 2 - 4) + tc * 4 + j;
                    const float e = __fadd_rn(__fsub_rn(q2[i], __fmul_rn(2.f, acc[i][j])),
                                              p2[j]);
                    d[j] = __fadd_rn(fmaxf(e, 0.f), bs[j]);
                    const bool in = kAny ? col < len && key_less(d[j], base + col, kd[i], ki[i])
                                         : d[j] <= kd[i];
                    bits |= (unsigned)in << j;
                }
                float* dr = s_d + r * kPS + tc * 4;
                sts4(dr, d[0], d[1], d[2], d[3]);
                sts4(dr + kTP / 2, d[4], d[5], d[6], d[7]);
                if (bits == 0u || r >= rows) continue;
                if constexpr (!kAny) {
                    s_flag[r] = 1;
                } else {
                    int slot = atomicAdd(s_qn + r, __popc(bits));
#pragma unroll
                    for (int j = 0; j < kTS; ++j) {
                        if ((bits >> j) & 1u) {
                            if (slot < kQCap) {
                                s_qd[r * kQCap + slot] = d[j];
                                s_qi[r * kQCap + slot] =
                                    base + (j < 4 ? 0 : kTP / 2 - 4) + tc * 4 + j;
                            }
                            ++slot;
                        }
                    }
                }
            }
        }
        __syncthreads();
        if (base + kTP < hi) issue(base + kTP, 0);   // copied during the selection

        if constexpr (!kAny) {
            if (k <= 32) {
                select_rows<1>(s_ld, s_li, s_kd, s_ki, s_flag, s_d, rows, len, base, k,
                               warp, lane, base == lo);
            } else {
                select_rows<2>(s_ld, s_li, s_kd, s_ki, s_flag, s_d, rows, len, base, k,
                               warp, lane, base == lo);
            }
        } else {
            // the rows of this warp whose queue overflowed, one at a time;
            // the others keep their queue
            const int rl = warp + kTWarps * lane;
            const bool mine = lane < kRowsAWarp && rl < rows;
            const int offered = mine ? s_qn[rl] : 0;
            if (mine && offered <= kQCap) s_qbase[rl] = offered;
            for (unsigned todo = __ballot_sync(kFull, offered > kQCap); todo != 0u;
                 todo &= todo - 1u) {
                const int r = warp + kTWarps * (__ffs(todo) - 1);
                sel.overflow(r, s_qbase[r], s_d + r * kPS, base, len);
                if (lane == 0) {
                    s_qn[r] = 0;
                    s_qbase[r] = 0;
                }
                __syncwarp();
            }
        }
    }

    // tgn_knn_any's queues into its lists (each within kQCap after its
    // warp's last overflow pass); then each list into plane 0
    if constexpr (kAny) {
        for (int r = warp; r < rows; r += kTWarps) {
            const int queued = s_qn[r];
            if (queued > 0) sel.merge(r, s_qd + r * kQCap, s_qi + r * kQCap, queued);
        }
    }
    __syncthreads();
    const int real = min(k, hi - lo);
    for (int i = tid; i < rows * k; i += kTThreads) {
        const int r = i / k, j = i - r * k;
        if (splits == 1 && j >= real) {
            ld[i] = 1e10f;
            li[i] = 0;
        } else if constexpr (!kAny) {
            ld[i] = s_ld[r * kMaxK + j];
            li[i] = s_li[r * kMaxK + j];
        } else if (s_cur[r] == 1 && j < s_len[r]) {
            ld[i] = sel.ld1[i];
            li[i] = sel.li1[i];
        }
    }
}

// One warp a (cloud, query): the splits' partial lists merged into the
// output, then the k > n tail (index 0 at 1e10). With `staged`, the warp
// copies its query's lists into shared memory and folds them in one at a
// time, two sorted lists merged by rank (a key's place is its index plus
// the other list's keys below it), the first k kept; else each key's rank
// is counted over every other list in global memory.
constexpr int kMergeSmemMax = 96 * 1024;   // bytes: the merge's fixed limit

__host__ __device__ inline size_t merge_smem_bytes(int splits, int k) {
    return (size_t)8 * 2 * (splits + 2) * k * 4;
}

__global__ void __launch_bounds__(256)
knn_merge_kernel(const int* __restrict__ part_idx, const float* __restrict__ part_d2,
                 int bsz, int m, int n, int k, int splits, int staged,
                 int* __restrict__ out_idx, float* __restrict__ out_d2) {
    extern __shared__ float smem_m[];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const size_t g = (size_t)blockIdx.x * 8 + warp;
    if (g >= (size_t)bsz * m) return;
    const size_t stride = (size_t)bsz * m * k;   // one split's lists
    const float* pd = part_d2 + g * k;
    const int* pi = part_idx + g * k;
    float* od = out_d2 + g * k;
    int* oi = out_idx + g * k;
    int total = 0;
    if (staged) {
        // [splits + 2][k] keys: the lists, then two buffers of the fold
        float* wd = smem_m + (size_t)warp * 2 * (splits + 2) * k;
        int* wi = reinterpret_cast<int*>(wd + (size_t)(splits + 2) * k);
        int len0 = 0;
        for (int s = 0; s < splits; ++s) {
            int lo, hi;
            split_range(s, splits, n, &lo, &hi);
            const int len = min(k, hi - lo);
            for (int j = lane; j < len; j += 32) {
                wd[s * k + j] = pd[s * stride + j];
                wi[s * k + j] = pi[s * stride + j];
            }
            if (s == 0) len0 = len;
        }
        __syncwarp();
        const float* ad = wd;
        const int* ai = wi;
        int alen = len0;
        float* xd = wd + (size_t)splits * k;
        int* xi = wi + (size_t)splits * k;
        for (int s = 1; s < splits; ++s) {
            int lo, hi;
            split_range(s, splits, n, &lo, &hi);
            const int blen = min(k, hi - lo), merged = min(alen + blen, k);
            const float* bd = wd + s * k;
            const int* bi = wi + s * k;
            for (int j = lane; j < alen; j += 32) {
                const int pos = j + rank_in(bd, bi, blen, ad[j], ai[j]);
                if (pos < merged) {
                    xd[pos] = ad[j];
                    xi[pos] = ai[j];
                }
            }
            for (int j = lane; j < blen; j += 32) {
                const int pos = j + rank_in(ad, ai, alen, bd[j], bi[j]);
                if (pos < merged) {
                    xd[pos] = bd[j];
                    xi[pos] = bi[j];
                }
            }
            __syncwarp();
            ad = xd;
            ai = xi;
            alen = merged;
            xd = (xd == wd + (size_t)splits * k) ? xd + k : xd - k;   // the other buffer
            xi = (xi == wi + (size_t)splits * k) ? xi + k : xi - k;
        }
        for (int j = lane; j < alen; j += 32) {
            od[j] = ad[j];
            oi[j] = ai[j];
        }
        total = alen;
    } else {
        for (int s = 0; s < splits; ++s) {
            int lo, hi;
            split_range(s, splits, n, &lo, &hi);
            total += min(k, hi - lo);
        }
        for (int s = 0; s < splits; ++s) {
            int lo, hi;
            split_range(s, splits, n, &lo, &hi);
            const int len = min(k, hi - lo);
            for (int j = lane; j < len; j += 32) {
                const float d = pd[s * stride + j];
                const int i = pi[s * stride + j];
                int rk = j;
                for (int t = 0; t < splits && rk < k; ++t) {
                    if (t == s) continue;
                    int tlo, thi;
                    split_range(t, splits, n, &tlo, &thi);
                    rk += rank_in(pd + t * stride, pi + t * stride, min(k, thi - tlo), d, i);
                }
                if (rk < k) {
                    od[rk] = d;
                    oi[rk] = i;
                }
            }
        }
    }
    for (int j = total + lane; j < k; j += 32) {
        od[j] = 1e10f;
        oi[j] = 0;
    }
}

using TileKernel = void (*)(const float*, const float*, const float*, const float*,
                            const float*, int, int, int, int, int, int*, float*, int*,
                            float*);

TileKernel tile_kernel(bool any) {
    return any ? knn_tile_kernel<true> : knn_tile_kernel<false>;
}

// The tile kernel's shared-memory limit and its resident blocks an SM.
cudaError_t tile_setup(bool any, int* per_sm) {
    cudaError_t err = cudaFuncSetAttribute(
        tile_kernel(any), cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)tile_smem_bytes(any));
    if (err != cudaSuccess || per_sm == nullptr) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, tile_kernel(any), kTThreads, tile_smem_bytes(any));
}

// Each route's resident tile blocks on each card (SMs x blocks an SM), 0
// until the first call on that card, which also sets the kernel's
// shared-memory limit there: the same value always, so launches from
// several host threads never race to lower it.
constexpr int kMaxDevices = 64;
std::atomic<int> g_slots[2][kMaxDevices];

cudaError_t card_slots(bool any, int* slots) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    std::atomic<int>* known = device < kMaxDevices ? &g_slots[any][device] : nullptr;
    int v = known != nullptr ? known->load(std::memory_order_acquire) : 0;
    if (v == 0) {
        int per_sm = 0, sms = 0;
        err = tile_setup(any, &per_sm);
        if (err == cudaSuccess) {
            err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
        }
        if (err != cudaSuccess) return err;
        if (per_sm < 1) return cudaErrorLaunchOutOfResources;
        v = sms * per_sm;
        if (known != nullptr) known->store(v, std::memory_order_release);
    }
    *slots = v;
    return cudaSuccess;
}

// The candidate splits of a call: as many as give each of the card's
// resident block slots a block, at least 1 and at most kMaxSplits and the
// candidate tiles. A split costs a warm-up (its lists start empty, and the
// inserts of a list run ~k (1 + ln(N / k)) over N candidates) and a merge,
// so the queries' tiles alone fill the card when they can.
int feature_splits(int slots, int b, int m, int n) {
    const long long tiles_q = std::max(1LL, (long long)b * ((m + kTQ - 1) / kTQ));
    const long long most = std::min(kMaxSplits, std::max((n + kTP - 1) / kTP, 1));
    return (int)std::max(1LL, std::min(most, slots / tiles_q));
}

// The scratch of a call, one buffer of the caller's (byte offsets, each
// part 256-aligned): |q|^2 and |p|^2 [B (M + N)] f32; for tgn_knn_any the
// lists' second rows [splits][B][M][k] (int32 idx, f32 d2); when splits > 1
// the splits' partial lists, laid out alike, which knn_merge_kernel folds
// into the output. With one split the tile kernel writes the output itself.
struct Scratch {
    size_t row1_idx = 0, row1_d2 = 0, part_idx = 0, part_d2 = 0, bytes = 0;
};

Scratch scratch_layout(bool any, int b, int m, int n, int k, int splits) {
    auto up = [](size_t x) { return (x + 255) / 256 * 256; };
    const size_t lists = up((size_t)splits * b * m * k * 4);
    Scratch s;
    size_t at = up((size_t)b * ((size_t)m + n) * 4);
    if (any) {
        s.row1_idx = at;
        s.row1_d2 = at + lists;
        at += 2 * lists;
    }
    if (splits > 1) {
        s.part_idx = at;
        s.part_d2 = at + lists;
        at += 2 * lists;
    }
    s.bytes = at;
    return s;
}

int launch_feature_knn(bool any, const float* q, const float* p, const float* bias,
                       int b, int m, int n, int c, int k, char* scratch, int* out_idx,
                       float* out_d2, cudaStream_t stream) {
    if (b < 1 || m < 1) return (int)cudaSuccess;   // no query: nothing to write
    int slots = 0;
    cudaError_t err = card_slots(any, &slots);
    if (err != cudaSuccess) return (int)err;
    const int splits = feature_splits(slots, b, m, n);
    const Scratch s = scratch_layout(any, b, m, n, k, splits);
    float* q2 = reinterpret_cast<float*>(scratch);
    float* p2 = q2 + (size_t)b * m;
    int* part_idx = splits > 1 ? reinterpret_cast<int*>(scratch + s.part_idx) : out_idx;
    float* part_d2 = splits > 1 ? reinterpret_cast<float*>(scratch + s.part_d2) : out_d2;
    int* row1_idx = any ? reinterpret_cast<int*>(scratch + s.row1_idx) : nullptr;
    float* row1_d2 = any ? reinterpret_cast<float*>(scratch + s.row1_d2) : nullptr;
    const size_t qrows = (size_t)b * m, prows = (size_t)b * n;
    knn_norms_kernel<<<(unsigned)((qrows + 255) / 256), 256, 0, stream>>>(q, qrows, c, q2);
    if (q == p && m == n) {   // a self-query: one pass
        p2 = q2;
    } else if (prows > 0) {
        knn_norms_kernel<<<(unsigned)((prows + 255) / 256), 256, 0, stream>>>(p, prows, c,
                                                                              p2);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    dim3 grid((unsigned)(((m + kTQ - 1) / kTQ) * splits), (unsigned)b);
    if (any) {
        knn_tile_kernel<true><<<grid, kTThreads, tile_smem_bytes(true), stream>>>(
            q, p, q2, p2, bias, m, n, c, k, splits, part_idx, part_d2, row1_idx, row1_d2);
    } else {
        knn_tile_kernel<false><<<grid, kTThreads, tile_smem_bytes(false), stream>>>(
            q, p, q2, p2, bias, m, n, c, k, splits, part_idx, part_d2, row1_idx, row1_d2);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess || splits == 1) return (int)err;
    const size_t merge_smem = merge_smem_bytes(splits, k);
    const int staged = merge_smem <= (size_t)kMergeSmemMax;
    err = cudaFuncSetAttribute(knn_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMergeSmemMax);
    if (err != cudaSuccess) return (int)err;
    knn_merge_kernel<<<(unsigned)((qrows + 7) / 8), 256, staged ? merge_smem : 0, stream>>>(
        part_idx, part_d2, b, m, n, k, splits, staged, out_idx, out_d2);
    return (int)cudaGetLastError();
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

// The scratch bytes of a feature-space call (any: tgn_knn_any, else
// tgn_knn_c, which takes k <= kMaxK) into *bytes, for the caller to
// allocate and pass to that entry on the same card. Returns the candidate
// splits the call will run (>= 1), or minus a CUDA error.
extern "C" int tgn_knn_scratch(int any, int b, int m, int n, int k, size_t* bytes) {
    if (k < 1 || (any == 0 && k > kMaxK)) return -(int)cudaErrorInvalidValue;
    int slots = 0;
    const cudaError_t err = card_slots(any != 0, &slots);
    if (err != cudaSuccess) return -(int)err;
    const int splits = feature_splits(slots, b, m, n);
    *bytes = scratch_layout(any != 0, b, m, n, k, splits).bytes;
    return splits;
}

// The feature-space design's geometry, into out[10]: queries a block,
// candidates a tile, a thread's query rows and candidates, channels a
// chunk, threads a block, registers a thread, local memory a thread (bytes;
// spills land there), dynamic shared memory a block (bytes), resident
// blocks an SM. Returns 0 or a CUDA error.
extern "C" int tgn_knn_geometry(int any, int* out) {
    int per_sm = 0;
    cudaError_t err = tile_setup(any != 0, &per_sm);
    if (err != cudaSuccess) return (int)err;
    cudaFuncAttributes fa;
    err = cudaFuncGetAttributes(&fa, tile_kernel(any != 0));
    if (err != cudaSuccess) return (int)err;
    const int vals[10] = {kTQ, kTP, kTR, kTS, kCh, kTThreads, fa.numRegs,
                          (int)fa.localSizeBytes, (int)tile_smem_bytes(any != 0),
                          per_sm};
    for (int i = 0; i < 10; ++i) out[i] = vals[i];
    return 0;
}

// q [B, M, C], p [B, N, C] f32 (1 <= C <= kMaxC, k <= kMaxK); bias [B, N]
// f32 or null; scratch of tgn_knn_scratch(0, ...) bytes; out_idx [B, M, k]
// int32, out_d2 [B, M, k] f32. Returns cudaGetLastError() after the
// launches.
extern "C" int tgn_knn_c(const float* q, const float* p, const float* bias, int b,
                         int m, int n, int c, int k, void* scratch, int* out_idx,
                         float* out_d2, cudaStream_t stream) {
    if (k < 1 || k > kMaxK || c < 1 || c > kMaxC) return (int)cudaErrorInvalidValue;
    return launch_feature_knn(false, q, p, bias, b, m, n, c, k,
                              static_cast<char*>(scratch), out_idx, out_d2, stream);
}

// Any k >= 1 and C >= 1: as tgn_knn_c, with scratch of
// tgn_knn_scratch(1, ...) bytes.
extern "C" int tgn_knn_any(const float* q, const float* p, const float* bias,
                           int b, int m, int n, int c, int k, void* scratch,
                           int* out_idx, float* out_d2, cudaStream_t stream) {
    if (k < 1 || c < 1) return (int)cudaErrorInvalidValue;
    return launch_feature_knn(true, q, p, bias, b, m, n, c, k,
                              static_cast<char*>(scratch), out_idx, out_d2, stream);
}
