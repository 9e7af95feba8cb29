// K1: farthest point sampling, one thread-block cluster per cloud.
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
// What bounds it on the H100: the chain. The M steps are dependent, and each
// ends in an argmax over the whole cloud, so a step costs a reduction's latency
// whatever the arithmetic (10 operations a point); one thread block per cloud
// puts a 100k-point cloud on one of 132 SMs at ~42 us a step.
//
// The design: a cloud is spread over a cluster of C <= 16 CTAs (the wrapper
// picks C from N; B clouds are B clusters). CTA r owns the contiguous slice
// [r L, (r + 1) L), L = ceil(N / C), and holds it in dynamic shared memory as
// SoA x / y / z plus the running min, 16 bytes a point, loaded once (16 CTAs x
// 224 KB hold 229k points; the part of a slice beyond its CTA's shared memory
// stays in global memory: xyz and the scratch row `dist`, the same loop over a
// second range). An invalid point is stored with running min -inf, which
// min(-inf, d) keeps, so no step reads the mask. A step:
//   1. every thread lowers the running min of its points with the last winner
//      and keeps its own argmax, ties to the lowest index;
//   2. a block argmax (redux.sync per warp, one __syncthreads) gives the CTA's
//      candidate (value, index, x, y, z);
//   3. one warp pushes it into slot [rank] of every CTA's row s & 1 with
//      st.async, each store completing its bytes on that CTA's mbarrier s & 1;
//      every warp waits on its own CTA's mbarrier, reduces the C slots in the
//      same order, and so every thread of the cluster agrees on the winner and
//      its xyz without a global read or a cluster barrier; CTA 0 writes out[s].
// Pulling instead (each CTA writes its own slot, all pass cluster.sync(),
// every warp reads the C slots through DSMEM) costs about 4.4 us a step for
// the exchange alone at C = 16 on an H100, twice a whole step of the push
// (fps_chain_kernel times both ways). The seed is step 0 of the same loop:
// the argmax of the initial running min is the first valid point (0 if
// none). Distances use the _rn intrinsics in the plain twin's order, so both
// pick the same winner on near-ties. Each CTA asks for at least kSoloSmem of
// shared memory so that no two CTAs of a cluster share an SM.

#include <cooperative_groups.h>

#include <algorithm>
#include <cstdint>
#include <utility>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 16;
constexpr int kMaxThreads = 1024;
// points a CTA keeps in shared memory (4 floats each: 224 KB)
constexpr int kSmemPoints = 14336;
// more than half an SM's 228 KB: one CTA of the kernel per SM
constexpr int kSoloSmem = 120 * 1024;
constexpr unsigned kFull = 0xffffffffu;

// A running min as an int key: on {-inf} and [+0, +inf], the only values a
// running min takes, the float bits order as signed ints (-inf is negative),
// so a warp's argmax is two redux.sync: the max key, then the min index
// among the lanes that hold it (ties to the lowest index). INT_MIN is below
// every key: "no candidate".
__device__ __forceinline__ int key_of(float d) { return __float_as_int(d); }

// One CTA's candidate of one step: its key, its index and its xyz.
struct alignas(16) Slot {
    int key, i;
    float x, y, z;
    int pad[3];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

// the address of the same shared variable in CTA `rank` of the cluster
__device__ __forceinline__ uint32_t cluster_addr(uint32_t local, int rank) {
    uint32_t out;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(out) : "r"(local), "r"(rank));
    return out;
}

// 16 bytes into another CTA's shared memory; the store completes its bytes
// on that CTA's mbarrier (release at cluster scope)
__device__ __forceinline__ void store_remote(uint32_t dst, uint32_t bar, int a, int b,
                                             int c, int d) {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
        "[%0], {%1, %2, %3, %4}, [%5];"
        :: "r"(dst), "r"(a), "r"(b), "r"(c), "r"(d), "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar) : "memory");
}

// this CTA's one arrival of a phase, expecting `bytes` from the senders
__device__ __forceinline__ void mbar_arm(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(bytes) : "memory");
}

// wait for the phase of `parity`; a wait of ~4e9 cycles (seconds: a step
// takes microseconds) means a sender is lost, and traps rather than hangs
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done = 0;
    const long long t0 = clock64();
    while (true) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}"
            : "=r"(done) : "r"(bar), "r"(parity) : "memory");
        if (done) return;
        if (clock64() - t0 > 4000000000LL) __trap();
    }
}

// The per-step exchange: two slot rows and two mbarriers per CTA, row and
// barrier s & 1 for step s. Each CTA sends its candidate to slot [rank] of
// row s & 1 of every CTA (lane r of one warp stores to CTA r) and every
// warp waits on its own CTA's barrier, so no step needs a cluster barrier.
// A row is rewritten at step s + 2 only by a CTA that has every CTA's
// candidate of step s + 1, which each CTA sends after all its warps read
// row s; the mbarrier's phase s completed before any byte of phase s + 2
// can come, for the same reason.
struct Exchange {
    Slot (*rows)[kMaxCluster];
    uint64_t* bars;
    int c, rank;

    __device__ __forceinline__ void init() {
        if (threadIdx.x == 0) {
            mbar_init(smem_addr(&bars[0]));
            mbar_init(smem_addr(&bars[1]));
            asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
        }
        cg::this_cluster().sync();   // every barrier is set before any send
    }

    // called by one whole warp with the CTA's candidate in every lane
    __device__ __forceinline__ void send(int s, int key, int i, float x, float y,
                                         float z) {
        const int lane = threadIdx.x & 31;
        const int p = s & 1;
        if (lane == 0) mbar_arm(smem_addr(&bars[p]), c * (uint32_t)sizeof(Slot));
        if (lane < c) {
            const uint32_t dst = cluster_addr(smem_addr(&rows[p][rank]), lane);
            const uint32_t bar = cluster_addr(smem_addr(&bars[p]), lane);
            store_remote(dst, bar, key, i, __float_as_int(x), __float_as_int(y));
            store_remote(dst + 16, bar, __float_as_int(z), 0, 0, 0);
        }
    }

    // every warp: wait for step s's row, then its argmax and the winner's xyz
    __device__ __forceinline__ int winner(int s, float& wx, float& wy, float& wz) {
        const int lane = threadIdx.x & 31;
        const int p = s & 1;
        mbar_wait(smem_addr(&bars[p]), (uint32_t)(s >> 1) & 1u);
        int key = INT_MIN, i = INT_MAX;
        float x = 0.f, y = 0.f, z = 0.f;
        if (lane < c) {
            const Slot& slot = rows[p][lane];
            key = slot.key;
            i = slot.i;
            x = slot.x;
            y = slot.y;
            z = slot.z;
        }
        const int top = __reduce_max_sync(kFull, key);
        const int win = __reduce_min_sync(kFull, key == top ? i : INT_MAX);
        const int src = __ffs(__ballot_sync(kFull, i == win)) - 1;
        wx = __shfl_sync(kFull, x, src);
        wy = __shfl_sync(kFull, y, src);
        wz = __shfl_sync(kFull, z, src);
        return win;
    }
};

__global__ void __launch_bounds__(kMaxThreads, 1)
fps_kernel(const float* __restrict__ xyz, const unsigned char* __restrict__ valid,
           int n, int m, int slice, int cached, float* __restrict__ dist,
           int* __restrict__ out) {
    extern __shared__ float4 smem4[];
    float* s_x = reinterpret_cast<float*>(smem4);
    float* s_y = s_x + cached;
    float* s_z = s_y + cached;
    float* s_d = s_z + cached;
    __shared__ Slot rows[2][kMaxCluster];
    __shared__ uint64_t bars[2];
    __shared__ int s_wk[32], s_wi[32];

    cg::cluster_group cluster = cg::this_cluster();
    Exchange ex{rows, bars, (int)cluster.num_blocks(), (int)cluster.block_rank()};
    const size_t b = blockIdx.x / ex.c;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    xyz += b * (size_t)n * 3;
    dist += b * (size_t)n;
    out += b * (size_t)m;
    if (valid != nullptr) valid += b * (size_t)n;
    const int start = ex.rank * slice;
    const int count = max(0, min(slice, n - start));
    const int in_smem = min(count, cached);
    ex.init();

    // load the slice once; the argmax of the initial running min is the
    // seed. Each thread visits its points in rising index order, so a strict
    // compare keeps the lowest index on ties.
    int bk = INT_MIN, bi = INT_MAX;
    for (int j = threadIdx.x; j < count; j += blockDim.x) {
        const int g = start + j;
        const float d = (valid == nullptr || valid[g] != 0) ? CUDART_INF_F
                                                            : -CUDART_INF_F;
        if (j < in_smem) {
            s_x[j] = xyz[3 * (size_t)g];
            s_y[j] = xyz[3 * (size_t)g + 1];
            s_z[j] = xyz[3 * (size_t)g + 2];
            s_d[j] = d;
        } else {
            dist[g] = d;
        }
        if (key_of(d) > bk) {
            bk = key_of(d);
            bi = g;
        }
    }

    float wx = 0.f, wy = 0.f, wz = 0.f;
    for (int s = 0; s < m; ++s) {
        if (s > 0) {
            bk = INT_MIN;
            bi = INT_MAX;
            for (int j = threadIdx.x; j < in_smem; j += blockDim.x) {
                float d = s_d[j];
                const float nd = sq3_rn(__fsub_rn(s_x[j], wx), __fsub_rn(s_y[j], wy),
                                        __fsub_rn(s_z[j], wz));
                if (nd < d) {
                    d = nd;
                    s_d[j] = d;
                }
                if (key_of(d) > bk) {
                    bk = key_of(d);
                    bi = start + j;
                }
            }
            for (int j = in_smem + threadIdx.x; j < count; j += blockDim.x) {
                const int g = start + j;
                float d = dist[g];
                const float nd = sq3_rn(__fsub_rn(xyz[3 * (size_t)g], wx),
                                        __fsub_rn(xyz[3 * (size_t)g + 1], wy),
                                        __fsub_rn(xyz[3 * (size_t)g + 2], wz));
                if (nd < d) {
                    d = nd;
                    dist[g] = d;
                }
                if (key_of(d) > bk) {
                    bk = key_of(d);
                    bi = g;
                }
            }
        }
        // block argmax, then warp 0 sends the CTA's candidate
        const int wk = __reduce_max_sync(kFull, bk);
        const int wi = __reduce_min_sync(kFull, bk == wk ? bi : INT_MAX);
        if (lane == 0) {
            s_wk[warp] = wk;
            s_wi[warp] = wi;
        }
        __syncthreads();
        if (warp == 0) {
            const int k = lane < nwarps ? s_wk[lane] : INT_MIN;
            const int i = lane < nwarps ? s_wi[lane] : INT_MAX;
            const int ck = __reduce_max_sync(kFull, k);
            const int ci = __reduce_min_sync(kFull, k == ck ? i : INT_MAX);
            float x = 0.f, y = 0.f, z = 0.f;
            if (ci != INT_MAX) {   // an empty slice has no candidate
                const int j = ci - start;
                const bool cached_pt = j < in_smem;
                x = cached_pt ? s_x[j] : xyz[3 * (size_t)ci];
                y = cached_pt ? s_y[j] : xyz[3 * (size_t)ci + 1];
                z = cached_pt ? s_z[j] : xyz[3 * (size_t)ci + 2];
            }
            ex.send(s, ck, ci, x, y, z);
        }
        const int win = ex.winner(s, wx, wy, wz);
        if (ex.rank == 0 && threadIdx.x == 0) out[s] = win;
    }
    cluster.sync();   // no CTA leaves while a store to it may be in flight
}

// The chain alone, no points: per step warp 0 makes a candidate from the
// last winner and the exchange runs as in fps_kernel (kPull false), or each
// CTA writes its own slot, all threads pass cluster.sync() and every warp
// reads the C slots through DSMEM (kPull true: the barrier design). Its time
// is K1's floor at that cluster size and step count.
template <bool kPull>
__global__ void __launch_bounds__(kMaxThreads, 1)
fps_chain_kernel(int m, int* __restrict__ out) {
    __shared__ Slot rows[2][kMaxCluster];
    __shared__ uint64_t bars[2];
    cg::cluster_group cluster = cg::this_cluster();
    Exchange ex{rows, bars, (int)cluster.num_blocks(), (int)cluster.block_rank()};
    const int lane = threadIdx.x & 31;
    out += (blockIdx.x / ex.c) * (size_t)m;
    if (!kPull) ex.init();
    int win = 0;
    float wx = 0.f, wy = 0.f, wz = 0.f;
    for (int s = 0; s < m; ++s) {
        const int key = (win + ex.rank * 7) % 13;
        if (kPull) {
            const int p = s & 1;
            if (threadIdx.x == 0) {
                rows[p][0] = Slot{key, ex.rank, wx + 1.f, wy, wz, {0, 0, 0}};
            }
            cluster.sync();
            int k = INT_MIN, i = INT_MAX;
            float x = 0.f, y = 0.f, z = 0.f;
            if (lane < ex.c) {
                const Slot* r = cluster.map_shared_rank(&rows[p][0], lane);
                k = r->key;
                i = r->i;
                x = r->x;
                y = r->y;
                z = r->z;
            }
            const int top = __reduce_max_sync(kFull, k);
            win = __reduce_min_sync(kFull, k == top ? i : INT_MAX);
            const int src = __ffs(__ballot_sync(kFull, i == win)) - 1;
            wx = __shfl_sync(kFull, x, src);
            wy = __shfl_sync(kFull, y, src);
            wz = __shfl_sync(kFull, z, src);
        } else {
            if (threadIdx.x < 32) ex.send(s, key, ex.rank, wx + 1.f, wy, wz);
            win = ex.winner(s, wx, wy, wz);
        }
        if (ex.rank == 0 && threadIdx.x == 0) out[s] = win;
    }
    cluster.sync();
}

}  // namespace

// xyz [B, N, 3] f32, valid [B, N] bool bytes or null, dist scratch [B, N] f32
// (read only beyond a CTA's shared memory), out [B, M] int32; `cluster` CTAs
// per cloud (1..16). Returns the launch's CUDA status.
extern "C" int tgn_fps(const float* xyz, const unsigned char* valid, int b,
                       int n, int m, int cluster, float* dist, int* out,
                       cudaStream_t stream) {
    if (n < 1 || m < 1 || cluster < 1) return (int)cudaErrorInvalidValue;
    const int slice = (n + cluster - 1) / cluster;
    const int cached = std::min(slice, kSmemPoints);
    int threads = kMaxThreads;
    while (threads > 32 && threads / 2 >= slice) threads /= 2;
    const size_t smem = std::max((size_t)kSoloSmem, 4 * sizeof(float) * (size_t)cached);
    return launch_clusters(fps_kernel, b, cluster, threads, smem, stream, xyz, valid,
                           n, m, slice, cached, dist, out);
}

// The chain floor: B clusters of `cluster` CTAs of 1024 threads run `m` steps
// of fps_chain_kernel, through K1's exchange (pull 0) or through
// cluster.sync() and DSMEM reads (pull 1); out [B, M] int32.
extern "C" int tgn_fps_chain(int b, int m, int cluster, int pull, int* out,
                             cudaStream_t stream) {
    if (m < 1) return (int)cudaErrorInvalidValue;
    return pull ? launch_clusters(fps_chain_kernel<true>, b, cluster, kMaxThreads,
                                  (size_t)kSoloSmem, stream, m, out)
                : launch_clusters(fps_chain_kernel<false>, b, cluster, kMaxThreads,
                                  (size_t)kSoloSmem, stream, m, out);
}
