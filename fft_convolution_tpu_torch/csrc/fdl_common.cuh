// Shared pieces of the frequency-delay-line block-step kernels (B1, B2).
//
// Spectra are complex64 rows of B+1 bins (float2, interleaved re/im), the
// layout torch.fft.rfft gives for a 2B-point real transform.  The DFTs are
// direct sums against a float32 twiddle table tw[m] = (cos, sin)(2 pi m / 2B)
// built in float64 on the host; every sum runs in a fixed order, so a step
// is bit-reproducible.  No TF32, no library transforms: plain FP32 FMA.
//
// The MAC over the ring is split across thread blocks (mac_partial): block g
// owns ring rows [g*rows, (g+1)*rows) and writes one partial spectrum per
// IR table.  The block that owns row `cur` computes the fresh spectrum of the
// new input block, uses it for that row and writes it into the ring; no
// other block reads row `cur`, so the in-kernel ring write needs neither the
// TPU kernel's algebraic stale-row correction nor a separate launch.  A
// second, single-block launch reduces the partials in block order (no float
// atomics), runs the inverse DFT and the overlap-add.
#pragma once

#include <cuda_runtime.h>

namespace fdl {

constexpr int kFinalizeThreads = 256;

template <int NT>
struct Tables {
  const float2* p[NT];
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

// Partial MAC of ring rows [j0, j1) against NT IR tables:
//   partial[t][g][k] = sum_j seg[j][k] * ir_t[(j - cur) mod n][k]
// with row `cur` taken from the fresh spectrum of x (see the file note).
// Dynamic shared memory: (b+1 + 2b) float2 + b float.
template <int NT>
__global__ void mac_partial(const float* __restrict__ x, float2* seg,
                            Tables<NT> ir, const float2* __restrict__ tw,
                            float2* __restrict__ partial, int n, int b,
                            int cur, int rows) {
  extern __shared__ float4 smem[];
  const int nb = b + 1;
  float2* spec = reinterpret_cast<float2*>(smem);
  float2* tws = spec + nb;
  float* xs = reinterpret_cast<float*>(tws + 2 * b);

  const int j0 = blockIdx.x * rows;
  const int j1 = min(j0 + rows, n);
  const bool owner = cur >= j0 && cur < j1;  // uniform across the block
  if (owner) {
    for (int i = threadIdx.x; i < 2 * b; i += blockDim.x) tws[i] = tw[i];
    for (int i = threadIdx.x; i < b; i += blockDim.x) xs[i] = x[i];
    __syncthreads();
    rdft_padded(xs, tws, b, spec);
    __syncthreads();
  }

  for (int k = threadIdx.x; k < nb; k += blockDim.x) {
    float2 acc[NT];
#pragma unroll
    for (int t = 0; t < NT; ++t) acc[t] = make_float2(0.f, 0.f);
    for (int j = j0; j < j1; ++j) {
      const float2 s = (j == cur) ? spec[k] : seg[static_cast<size_t>(j) * nb + k];
      int r = j - cur;
      if (r < 0) r += n;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const float2 h = ir.p[t][static_cast<size_t>(r) * nb + k];
        acc[t].x = fmaf(s.x, h.x, acc[t].x);
        acc[t].x = fmaf(-s.y, h.y, acc[t].x);
        acc[t].y = fmaf(s.x, h.y, acc[t].y);
        acc[t].y = fmaf(s.y, h.x, acc[t].y);
      }
    }
    if (owner) seg[static_cast<size_t>(cur) * nb + k] = spec[k];
#pragma unroll
    for (int t = 0; t < NT; ++t)
      partial[(static_cast<size_t>(t) * gridDim.x + blockIdx.x) * nb + k] = acc[t];
  }
}

// conv[k] = sum over g = 0..grid-1, in order, of partial[g][k].
__device__ __forceinline__ void reduce_partials(const float2* __restrict__ partial,
                                                int grid, int nb, float2* conv) {
  for (int k = threadIdx.x; k < nb; k += blockDim.x) {
    float2 a = make_float2(0.f, 0.f);
    for (int g = 0; g < grid; ++g) {
      const float2 p = partial[static_cast<size_t>(g) * nb + k];
      a.x += p.x;
      a.y += p.y;
    }
    conv[k] = a;
  }
}

inline int mac_threads(int b) {
  const int warps = (b + 1 + 31) / 32;
  return warps * 32 < 256 ? warps * 32 : 256;
}

inline size_t mac_smem(int b) {
  return static_cast<size_t>(b + 1 + 2 * b) * sizeof(float2) + b * sizeof(float);
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
