// Shared pieces of the frequency-delay-line kernels (B1, B1p, B2, B3, B4, B5).
//
// Spectra are complex64 rows of B+1 bins (float2, interleaved re/im), the
// layout torch.fft.rfft gives for a 2B-point real transform.  The bf16
// storage variants keep rows of __nv_bfloat162 (torch.bfloat16 [.., B+1, 2])
// and widen each bin to float2 on load; all arithmetic is FP32.  Every sum
// runs in a fixed order, so a step is bit-reproducible.  No TF32, no library
// transforms: plain FP32 FMA.
//
// B1, B1p, B2 and B3 run their step in one launch with shared-memory FFTs
// (fdl_step.cuh).  The direct DFTs below (rdft_padded, irdft: sums against a
// float32 twiddle table tw[m] = (cos, sin)(2 pi m / 2B) built in float64 on
// the host) and the launch shapes mac_threads and kFinalizeThreads serve B4
// (b4_stream.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fdl {

constexpr int kFinalizeThreads = 256;

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

// spec[k] = sum_{i<b} x[i] exp(-2 pi i k i / 2b), k = 0..b: the rFFT of the
// block zero-padded to 2b (the padded half contributes nothing).
__device__ __forceinline__ void rdft_padded(const float* x, const float2* tw,
                                            int b, float2* spec) {
  const int n2 = 2 * b;
  for (int k = threadIdx.x; k <= b; k += blockDim.x) {
    float re = 0.f, im = 0.f;
    int m = 0;  // (k * i) mod 2b
    for (int i = 0; i < b; ++i) {
      const float2 w = tw[m];
      re = fmaf(x[i], w.x, re);
      im = fmaf(-x[i], w.y, im);
      m += k;
      if (m >= n2) m -= n2;
    }
    spec[k] = make_float2(re, im);
  }
}

// out[i], i = 0..2b-1: the inverse rFFT with 1/(2b), from bins 0..b.  As in
// a C2R transform, the imaginary parts of the DC and Nyquist bins are not
// read.
__device__ __forceinline__ void irdft(const float2* spec, const float2* tw,
                                      int b, float* out) {
  const int n2 = 2 * b;
  const float scale = 1.f / static_cast<float>(n2);
  for (int i = threadIdx.x; i < n2; i += blockDim.x) {
    float acc = 0.f;
    int m = i;  // (k * i) mod 2b at k = 1
    for (int k = 1; k < b; ++k) {
      const float2 w = tw[m];
      const float2 c = spec[k];
      acc = fmaf(c.x, w.x, acc);
      acc = fmaf(-c.y, w.y, acc);
      m += i;
      if (m >= n2) m -= n2;
    }
    const float nyq = (i & 1) ? -spec[b].x : spec[b].x;
    out[i] = (spec[0].x + nyq + 2.f * acc) * scale;
  }
}

inline int mac_threads(int b) {
  const int warps = (b + 1 + 31) / 32;
  return warps * 32 < 256 ? warps * 32 : 256;
}

// Kernels whose dynamic shared memory passes the 48 KB default need an
// explicit opt-in before launch.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace fdl
