// Kernel B1: the uniform frequency-delay-line block step.
//
// Replaces the Pallas kernel fft_convolution_tpu/ops/pallas_engine.py:_kernel
// (via block_step).  One step: forward 2B-point real FFT of the new block,
// its write into ring row `cur`, the complex MAC of the N-row ring against
// the IR table rolled by `cur` (ir[(j - cur) mod N], indexed directly: the
// TPU's doubled table is not needed), the inverse FFT with 1/(2B) and the
// overlap-add.  The ring head `cur` is a host int the wrapper decrements.
// Block 0 writes ring row `cur` and no MAC block reads it, so the in-kernel
// write needs neither the TPU kernel's stale-row correction nor a second
// launch.
//
// What bounds it on an H100: at the flagship N = 3750, B = 128 the ring and
// the table are 2 x 3750 x 129 complex64 = 7.74 MB read per block, which
// stay resident in the 50 MB L2 from one block to the next, against ~4
// MFLOP of MAC: 2.3 us at the 3.35 TB/s HBM rate.  Far less than that is
// the floor in practice: the step is a chain of dependent global round
// trips (launch, the MAC's loads, the ticket, the partials, the stores) of
// about 1 us each.  The design (fdl_step.cuh at one table, shared with B2
// and B3) keeps that chain short: one launch a step of ~130 MAC blocks and
// a block that computes the fresh spectrum with a shared-memory FFT beside
// them; each MAC thread keeps six rows of loads in flight; the last block to
// take the integer ticket reduces the partials in a fixed order, 16 loads a
// thread a trip, and runs the inverse FFT and the overlap-add.
//
// Kernel B1p (fdl_b1p_step) is the same step over bf16 storage: it replaces
// fft_convolution_tpu/ops/pallas_engine.py:_kernel_packed (via
// block_step_packed).  Ring and table hold bf16 pairs (__nv_bfloat162, not
// the TPU's packed uint32 words), widened to FP32 on load; the fresh
// spectrum is written into the ring rounded to nearest even, and the
// current block's term uses it unrounded, as the TPU kernel's stale-row
// correction does.  Half the bytes of B1 per step (3.87 MB at the flagship),
// but the same chain of round trips.
#include "fdl_step.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(fdl::kStepMaxThreads)
b1_step(fdl::StepArgs<1, T> a, float* __restrict__ y, float* __restrict__ overlap) {
  extern __shared__ float4 smem[];
  float2* sm = reinterpret_cast<float2*>(smem);
  if (!fdl::step_arrive(a, sm)) return;
  const int b = a.b;
  // the overlap, loaded now so it arrives during the finish; each thread
  // reads its overlap before it overwrites it: no cross-thread race
  constexpr int kPer = fdl::kEpiloguePerThread;
  float ov[kPer];
#pragma unroll
  for (int c = 0; c < kPer; ++c) {
    const int i = fdl::step_tid() + c * fdl::step_threads();
    if (i < b) ov[c] = overlap[i];
  }
  const float* out = fdl::step_finish(a, sm);
  const float scale = 1.f / static_cast<float>(2 * b);
#pragma unroll
  for (int c = 0; c < kPer; ++c) {
    const int i = fdl::step_tid() + c * fdl::step_threads();
    if (i < b) {
      y[i] = out[i] * scale + ov[c];
      overlap[i] = out[b + i] * scale;
    }
  }
}

// One step with ring and table bins stored as T (float2 or __nv_bfloat162).
template <typename T>
int launch_b1(const float* x, void* seg, const void* ir, const void* tw, void* partial,
              void* ticket, float* y, float* overlap, int n, int b, int cur, int rows,
              int grid, void* stream) {
  const fdl::StepArgs<1, T> a{x,
                              static_cast<T*>(seg),
                              {{static_cast<const T*>(ir)}},
                              static_cast<const float2*>(tw),
                              static_cast<float2*>(partial),
                              static_cast<unsigned int*>(ticket),
                              n, b, cur, rows};
  return static_cast<int>(fdl::launch_step(b1_step<T>, a, grid,
                                           static_cast<cudaStream_t>(stream), y, overlap));
}

}  // namespace

// x f32[b]; seg c64[n, b+1] (row cur written); ir c64[n, b+1]; tw f32[2b, 2];
// partial c64[1, 1 + grid, b+1] scratch; ticket u32[1], 0 between steps;
// y f32[b] out; overlap f32[b] in/out.  rows: ring rows a MAC block; grid:
// MAC blocks, covering the n-1 rows other than cur.  One launch; returns
// cudaGetLastError().
extern "C" int fdl_b1_step(const float* x, void* seg, const void* ir, const void* tw,
                           void* partial, void* ticket, float* y, float* overlap, int n,
                           int b, int cur, int rows, int grid, void* stream) {
  return launch_b1<float2>(x, seg, ir, tw, partial, ticket, y, overlap, n, b, cur, rows,
                           grid, stream);
}

// B1p: as fdl_b1_step with seg and ir bf16[n, b+1, 2].
extern "C" int fdl_b1p_step(const float* x, void* seg, const void* ir, const void* tw,
                            void* partial, void* ticket, float* y, float* overlap, int n,
                            int b, int cur, int rows, int grid, void* stream) {
  return launch_b1<__nv_bfloat162>(x, seg, ir, tw, partial, ticket, y, overlap, n, b, cur,
                                   rows, grid, stream);
}

// The message for a cudaError_t returned by the step functions.
extern "C" const char* fdl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
