// Shared helpers for the hand-written Hopper kernels of toothgroupnetwork_tpu_torch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <math_constants.h>
#include <utility>

// Element access of the two model dtypes: bf16 is read widened to float
// (exact) and written with round-to-nearest-even, as a cast in the JAX
// package rounds it.
__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, size_t i) {
    return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, size_t i, float v) {
    p[i] = __float2bfloat16_rn(v);
}

// v rounded to T and widened back: the identity for float.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
    if constexpr (sizeof(T) == 2) {
        return __bfloat162float(__float2bfloat16_rn(v));
    } else {
        return v;
    }
}

// Blocks of `threads` for a grid-stride loop over `work` items, capped at
// 16 * 65535 blocks (a thread then loops over the rest).
inline unsigned grid_for(size_t work, int threads) {
    const size_t blocks = (work + threads - 1) / threads;
    return (unsigned)(blocks < 65535u * 16u ? (blocks > 0 ? blocks : 1) : 65535u * 16u);
}

// The copy unit of a row copy: the widest of 16, 8, 4 and 2 bytes that
// divides the row and both base addresses, so that every row of source and
// destination starts aligned to it (the rows of a float32 or bfloat16
// tensor are whole multiples of 2 bytes).
inline int copy_unit(size_t row_bytes, const void* src, const void* dst) {
    const size_t bits = row_bytes | (size_t)src | (size_t)dst;
    for (int u = 16; u > 2; u /= 2) {
        if (bits % u == 0) return u;
    }
    return 2;
}

// Launch `kernel` as B clusters of `c` CTAs (1 <= c <= 16; dynamic shared
// memory `smem` a CTA) after cudaOccupancyMaxActiveClusters finds room for
// one; a refused size or launch is returned as its error. The kernel's
// dynamic shared memory limit is set to the most the device lets it opt
// into (the opt-in maximum less its static shared memory), the same value
// at every launch: launches of one kernel with different `smem` from
// several host threads (one scan a thread) then never lower the limit under
// another thread's launch.
template <typename... Params, typename... Args>
int launch_clusters(void (*kernel)(Params...), int b, int c, int threads,
                    size_t smem, cudaStream_t stream, Args&&... args) {
    if (b < 1 || c < 1 || c > 16) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    int device = 0, optin = 0;
    err = cudaGetDevice(&device);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return (int)err;
    cudaFuncAttributes fa;
    err = cudaFuncGetAttributes(&fa, kernel);
    if (err != cudaSuccess) return (int)err;
    const int smem_max = optin - (int)fa.sharedSizeBytes;
    if (smem > (size_t)smem_max) return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_max);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = c;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(b * c));
    cfg.blockDim = dim3((unsigned)threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (clusters < 1) return (int)cudaErrorLaunchOutOfResources;
    err = cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

// Squared distance in a fixed order, (dx*dx + dy*dy) + dz*dz, with the
// round-to-nearest intrinsics so nvcc cannot contract it into FMAs. The plain
// PyTorch versions evaluate the same expression op by op, so the kernels and
// their twins see bit-identical distances and break near-ties the same way.
__device__ __forceinline__ float sq3_rn(float dx, float dy, float dz) {
    return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                     __fmul_rn(dz, dz));
}
