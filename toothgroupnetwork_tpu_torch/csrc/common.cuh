// Shared helpers for the hand-written Hopper kernels of toothgroupnetwork_tpu_torch.
#pragma once

#include <cuda_runtime.h>
#include <climits>
#include <math_constants.h>

// Squared distance in a fixed order, (dx*dx + dy*dy) + dz*dz, with the
// round-to-nearest intrinsics so nvcc cannot contract it into FMAs. The plain
// PyTorch versions evaluate the same expression op by op, so the kernels and
// their twins see bit-identical distances and break near-ties the same way.
__device__ __forceinline__ float sq3_rn(float dx, float dy, float dz) {
    return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                     __fmul_rn(dz, dz));
}

// (value, index) argmax with ties to the LOWEST index.
__device__ __forceinline__ void argmax_merge(float& v, int& i, float ov, int oi) {
    if (ov > v || (ov == v && oi < i)) {
        v = ov;
        i = oi;
    }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
    for (int off = 16; off > 0; off >>= 1) {
        float ov = __shfl_down_sync(0xffffffffu, v, off);
        int oi = __shfl_down_sync(0xffffffffu, i, off);
        argmax_merge(v, i, ov, oi);
    }
}

__device__ __forceinline__ int warp_min_int(int v) {
    for (int off = 16; off > 0; off >>= 1) {
        v = min(v, __shfl_down_sync(0xffffffffu, v, off));
    }
    return v;
}
