// Kernel B2: the fused head + tail0 block step of the two-stage convolver.
//
// Replaces the Pallas kernel fft_convolution_tpu/ops/pallas_two_stage.py:_kernel
// (via block_step).  Head and tail0 run at the same block size over the same
// input, so they share one input-spectra ring: one forward FFT, two rolled-IR
// MACs over that ring (head and tail0 tables, tail0 padded with zero rows to
// the ring's n), two inverse FFTs, the head overlap-add plus the two
// precalculated tail rows at the period row (a finished y), and tail0's
// overlap-add written straight into its period-buffer row.  The kernel also
// copies x into the period input row, which the big tail reads at period end.
//
// What bounds it on an H100: at the flagship n = 64, B = 128 the ring and the
// two tables are 3 x 64 x 129 complex64 = 198 KB and the MAC is 66 K complex
// FMAs, 0.06 us of memory time: far too little work to fill the card, so the
// step is bound by latency, the chain of dependent steps from launch to the
// last store.  The design (fdl_step.cuh) shortens that chain: one launch a
// step (the last block to take the integer ticket finishes), the forward FFT
// in its own block beside the MAC, six rows of loads in flight a thread,
// and O(B log B) shared-memory FFTs in place of O(B^2) direct sums.
#include "fdl_step.cuh"

namespace {

__global__ void __launch_bounds__(fdl::kStepMaxThreads)
b2_step(fdl::StepArgs<2> a, float* __restrict__ y, float* __restrict__ h_ov,
        float* __restrict__ t_ov, float* __restrict__ out0_row,
        float* __restrict__ tail_in_row, const float* __restrict__ pre0_row,
        const float* __restrict__ pre_row) {
  extern __shared__ float4 smem[];
  float2* sm = reinterpret_cast<float2*>(smem);
  if (!fdl::step_arrive<2>(a, sm)) return;
  const int b = a.b;
  // the epilogue's inputs, loaded now so they arrive during the finish; each
  // thread reads its overlaps before it overwrites them: no cross-thread race
  constexpr int kPer = fdl::kEpiloguePerThread;
  float hv[kPer], tv[kPer], p0[kPer], p1[kPer], xv[kPer];
#pragma unroll
  for (int c = 0; c < kPer; ++c) {
    const int i = fdl::step_tid() + c * fdl::step_threads();
    if (i < b) {
      hv[c] = h_ov[i];
      tv[c] = t_ov[i];
      p0[c] = pre0_row[i];
      p1[c] = pre_row[i];
      xv[c] = a.x[i];
    }
  }
  const float* out_h = fdl::step_finish<2>(a, sm);
  const float* out_t = out_h + 2 * b;
  const float scale = 1.f / static_cast<float>(2 * b);
#pragma unroll
  for (int c = 0; c < kPer; ++c) {
    const int i = fdl::step_tid() + c * fdl::step_threads();
    if (i < b) {
      // src/fft_convolver.rs:439-456: head output plus both precalculated tails
      y[i] = ((out_h[i] * scale + hv[c]) + p0[c]) + p1[c];
      h_ov[i] = out_h[b + i] * scale;
      out0_row[i] = out_t[i] * scale + tv[c];
      t_ov[i] = out_t[b + i] * scale;
      tail_in_row[i] = xv[c];
    }
  }
}

}  // namespace

// x f32[b]; seg c64[n, b+1] (row cur written); h_ir, t_ir c64[n, b+1];
// tw f32[2b, 2]; partial c64[2, 1 + grid, b+1] scratch; ticket u32[1], 0
// between steps; y f32[b] out; h_ov, t_ov f32[b] in/out; out0_row,
// tail_in_row f32[b] out (rows of the period buffers); pre0_row, pre_row
// f32[b] in.  rows: ring rows a MAC block; grid: MAC blocks, covering the
// n-1 rows other than cur.  One launch; returns cudaGetLastError().
extern "C" int fdl_b2_step(const float* x, void* seg, const void* h_ir,
                           const void* t_ir, const void* tw, void* partial,
                           void* ticket, float* y, float* h_ov, float* t_ov,
                           float* out0_row, float* tail_in_row,
                           const float* pre0_row, const float* pre_row, int n,
                           int b, int cur, int rows, int grid, void* stream) {
  const fdl::StepArgs<2> a{x,
                           static_cast<float2*>(seg),
                           {{static_cast<const float2*>(h_ir),
                             static_cast<const float2*>(t_ir)}},
                           static_cast<const float2*>(tw),
                           static_cast<float2*>(partial),
                           static_cast<unsigned int*>(ticket),
                           n, b, cur, rows};
  return static_cast<int>(fdl::launch_step<2>(
      b2_step, a, grid, static_cast<cudaStream_t>(stream), y, h_ov, t_ov,
      out0_row, tail_in_row, pre0_row, pre_row));
}
