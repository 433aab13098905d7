// Kernel B1: the uniform frequency-delay-line block step.
//
// Replaces the Pallas kernel fft_convolution_tpu/ops/pallas_engine.py:_kernel
// (via block_step).  One step: forward 2B-point real DFT of the new block,
// its write into ring row `cur`, the complex MAC of the N-row ring against
// the IR table rolled by `cur` (ir[(j - cur) mod N], indexed directly: the
// TPU's doubled table is not needed), the inverse DFT with 1/(2B) and the
// overlap-add.  The ring head `cur` is a host int the wrapper decrements.
//
// What bounds it on an H100: at the flagship N = 3750, B = 128 the ring and
// the table are 2 x 3750 x 129 complex64 = 7.7 MB read per block, far more
// than one SM holds, against ~4 MFLOP of MAC and ~0.1 MFLOP of DFT, so the
// step is bound by memory bandwidth (the 7.7 MB stay resident in the 50 MB
// L2 from one block to the next) and, at this size, by launch latency.  The
// design spreads the rows over ~130 thread blocks, one per SM, each thread
// on one bin so that a warp reads 256 contiguous bytes per row, and reduces
// the per-block partial spectra in a second launch in fixed order.
//
// Kernel B1p (fdl_b1p_step) is the same step over bf16 storage: it replaces
// fft_convolution_tpu/ops/pallas_engine.py:_kernel_packed (via
// block_step_packed).  Ring and table hold bf16 pairs (__nv_bfloat162, not
// the TPU's packed uint32 words), widened to FP32 on load; the fresh
// spectrum is written into the ring rounded to nearest even, and the
// current block's term uses it unrounded, as the TPU kernel's stale-row
// correction does.  Half the bytes of B1 per step (3.9 MB at the flagship).
#include "fdl_common.cuh"

namespace {

// Dynamic shared memory: (b+1 + 2b) float2 + 2b float.
__global__ void b1_finalize(const float2* __restrict__ partial, int grid,
                            const float2* __restrict__ tw, float* __restrict__ y,
                            float* __restrict__ overlap, int b) {
  extern __shared__ float4 smem[];
  const int nb = b + 1;
  float2* conv = reinterpret_cast<float2*>(smem);
  float2* tws = conv + nb;
  float* out = reinterpret_cast<float*>(tws + 2 * b);

  for (int i = threadIdx.x; i < 2 * b; i += blockDim.x) tws[i] = tw[i];
  fdl::reduce_partials(partial, grid, nb, conv);
  __syncthreads();
  fdl::irdft(conv, tws, b, out);
  __syncthreads();
  // each thread reads overlap[i] before it overwrites it: no cross-thread race
  for (int i = threadIdx.x; i < b; i += blockDim.x) {
    y[i] = out[i] + overlap[i];
    overlap[i] = out[b + i];
  }
}

}  // namespace

namespace {

// One step with ring and table bins stored as T (float2 or __nv_bfloat162).
template <typename T>
int b1_step(const float* x, void* seg, const void* ir, const void* tw,
            void* partial, float* y, float* overlap, int n, int b, int cur,
            int rows, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t mac_smem = fdl::mac_smem(b);
  const size_t fin_smem = static_cast<size_t>(b + 1 + 2 * b) * sizeof(float2) +
                          2 * b * sizeof(float);
  cudaError_t e = fdl::allow_smem(fdl::mac_partial<1, T>, mac_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = fdl::allow_smem(b1_finalize, fin_smem);
  if (e != cudaSuccess) return static_cast<int>(e);

  fdl::Tables<1, T> tables{{static_cast<const T*>(ir)}};
  fdl::mac_partial<1, T><<<grid, fdl::mac_threads(b), mac_smem, s>>>(
      x, static_cast<T*>(seg), tables, static_cast<const float2*>(tw),
      static_cast<float2*>(partial), n, b, cur, rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  b1_finalize<<<1, fdl::kFinalizeThreads, fin_smem, s>>>(
      static_cast<const float2*>(partial), grid, static_cast<const float2*>(tw),
      y, overlap, b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x f32[b]; seg c64[n, b+1] (row cur written); ir c64[n, b+1];
// tw f32[2b, 2]; partial c64[grid, b+1] scratch; y f32[b] out;
// overlap f32[b] in/out.  Returns cudaGetLastError() after the launches.
extern "C" int fdl_b1_step(const float* x, void* seg, const void* ir,
                           const void* tw, void* partial, float* y,
                           float* overlap, int n, int b, int cur, int rows,
                           int grid, void* stream) {
  return b1_step<float2>(x, seg, ir, tw, partial, y, overlap, n, b, cur, rows,
                         grid, stream);
}

// B1p: as fdl_b1_step with seg and ir bf16[n, b+1, 2].
extern "C" int fdl_b1p_step(const float* x, void* seg, const void* ir,
                            const void* tw, void* partial, float* y,
                            float* overlap, int n, int b, int cur, int rows,
                            int grid, void* stream) {
  return b1_step<__nv_bfloat162>(x, seg, ir, tw, partial, y, overlap, n, b, cur,
                                 rows, grid, stream);
}

// The message for a cudaError_t returned by the step functions.
extern "C" const char* fdl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
