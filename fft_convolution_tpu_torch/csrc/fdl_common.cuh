// Shared pieces of the frequency-delay-line kernels (B1, B1p, B2, B3, B4, B5).
//
// Spectra are complex64 rows of B+1 bins (float2, interleaved re/im), the
// layout torch.fft.rfft gives for a 2B-point real transform.  The bf16
// storage variants keep rows of __nv_bfloat162 (torch.bfloat16 [.., B+1, 2])
// and widen each bin to float2 on load; all arithmetic is FP32.  Every sum
// runs in a fixed order, so a step is bit-reproducible.  No TF32, no library
// transforms: plain FP32 FMA.  The transforms (shared-memory FFTs) are in
// fdl_step.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fdl {

// A stored complex bin, widened to float2; stores round to nearest even.
__device__ __forceinline__ float2 load_c(const float2* p) { return *p; }
__device__ __forceinline__ float2 load_c(const __nv_bfloat162* p) {
  return __bfloat1622float2(*p);
}
// The same through the read-only data path (__ldg), for tables no kernel
// writes.
__device__ __forceinline__ float2 ldg_c(const float2* p) { return __ldg(p); }
__device__ __forceinline__ float2 ldg_c(const __nv_bfloat162* p) {
  return __bfloat1622float2(__ldg(p));
}
__device__ __forceinline__ void store_c(float2* p, float2 v) { *p = v; }
__device__ __forceinline__ void store_c(__nv_bfloat162* p, float2 v) {
  *p = __float22bfloat162_rn(v);
}

// acc += s * h (complex), four FP32 FMAs in a fixed order.
__device__ __forceinline__ void cmac(float2& acc, float2 s, float2 h) {
  acc.x = fmaf(s.x, h.x, acc.x);
  acc.x = fmaf(-s.y, h.y, acc.x);
  acc.y = fmaf(s.x, h.y, acc.y);
  acc.y = fmaf(s.y, h.x, acc.y);
}

// NT IR tables with bins stored as T (float2 or __nv_bfloat162).
template <int NT, typename T = float2>
struct Tables {
  const T* p[NT];
};

// Kernels whose dynamic shared memory passes the 48 KB default need an
// explicit opt-in before launch.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace fdl
