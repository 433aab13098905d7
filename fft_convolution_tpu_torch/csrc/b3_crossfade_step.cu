// Kernel B3: the A/B crossfade block step (IR morphing while serving).
//
// Replaces the Pallas kernel fft_convolution_tpu/ops/pallas_crossfade.py:_kernel
// (via block_step).  The crossfade convolver runs two engines on the same
// input every block (src/crossfade_convolver.rs:66-78), so they share one
// input-spectra ring: one forward FFT, two rolled-IR MACs over that ring
// (tables A and B), two inverse FFTs and overlap-adds.  The TPU kernel
// returned ya and yb and left the per-sample crossfade mix to XLA; here the
// finishing block also mixes, from the crossfader's host scalars passed as
// arguments (models/crossfade.py:mix_samples is the plain version), so a
// block costs one launch and no extra torch ops.
//
// What bounds it on an H100: at the flagship N = 3750, B = 128 the ring and
// the two tables are 3 x 3750 x 129 complex64 = 11.6 MB read per block (L2
// resident across blocks) for ~8 MFLOP of MAC: 3.5 us at the 3.35 TB/s HBM
// rate, so memory, and after it the latency of the tail of the step.  The
// design (fdl_step.cuh, shared with B2): the MAC spreads the ring over ~130
// thread blocks, each thread keeping six rows of loads (eighteen of them)
// in flight; the forward FFT runs in its own block beside it; the last block to
// take the integer ticket reduces the partials with all its threads in a
// fixed order and runs both inverse FFTs side by side, in the same launch.
#include "fdl_step.cuh"

namespace {

// The crossfader's state at the block start (models/crossfade.py).
struct Mix {
  int approaching;  // 0: Reached, output the target side
  int is_b;         // target is B
  int counter;      // entry counter c0
  int fading;       // fading_samples
  int mixer;        // 0 raised_cosine, 1 linear, 2 sqrt, 3 cosine
  float mix_value;  // entry v0
  float step;       // mix_value_step
};

// Sample i of the mixed block.  The _rn intrinsics keep the compiler from
// contracting into FMAs, so v_i and the ramp round as in the plain version.
__device__ __forceinline__ float mix_sample(const Mix& m, int i, float ya, float yb) {
  const float new_side = m.is_b ? yb : ya;
  if (!m.approaching) return new_side;
  const int c = m.counter + i + 1;
  if (c <= 0) return m.is_b ? ya : yb;  // hold: the old side
  if (c >= m.fading) return new_side;   // snapped to the target
  const int inc = c - max(m.counter, 0);
  const float v = __fadd_rn(m.mix_value, __fmul_rn(m.step, static_cast<float>(inc)));
  const float hv = __fmul_rn(1.57079637f, v);  // float32(pi / 2) * v
  float g1, g2;
  switch (m.mixer) {
    case 0: {
      const float cv = cosf(hv);
      g1 = __fmul_rn(cv, cv);
      g2 = __fsub_rn(1.f, g1);
      break;
    }
    case 1:
      g1 = __fsub_rn(1.f, v);
      g2 = __fsub_rn(1.f, g1);
      break;
    case 2:
      g1 = sqrtf(fmaxf(__fsub_rn(1.f, v), 0.f));
      g2 = sqrtf(fmaxf(v, 0.f));
      break;
    default:
      g1 = cosf(hv);
      g2 = sinf(hv);
  }
  return __fadd_rn(__fmul_rn(ya, g1), __fmul_rn(yb, g2));
}

__global__ void __launch_bounds__(fdl::kStepMaxThreads)
b3_step(fdl::StepArgs<2> a, float* __restrict__ y, float* __restrict__ ov_a,
        float* __restrict__ ov_b, Mix mix) {
  extern __shared__ float4 smem[];
  float2* sm = reinterpret_cast<float2*>(smem);
  if (!fdl::step_arrive<2>(a, sm)) return;
  const int b = a.b;
  // the overlaps, loaded now so they arrive during the finish; each thread
  // reads its overlaps before it overwrites them: no cross-thread race
  constexpr int kPer = fdl::kEpiloguePerThread;
  float va[kPer], vb[kPer];
#pragma unroll
  for (int c = 0; c < kPer; ++c) {
    const int i = fdl::step_tid() + c * fdl::step_threads();
    if (i < b) {
      va[c] = ov_a[i];
      vb[c] = ov_b[i];
    }
  }
  const float* out_a = fdl::step_finish<2>(a, sm);
  const float* out_b = out_a + 2 * b;
  const float scale = 1.f / static_cast<float>(2 * b);
#pragma unroll
  for (int c = 0; c < kPer; ++c) {
    const int i = fdl::step_tid() + c * fdl::step_threads();
    if (i < b) {
      const float ya = out_a[i] * scale + va[c];
      const float yb = out_b[i] * scale + vb[c];
      ov_a[i] = out_a[b + i] * scale;
      ov_b[i] = out_b[b + i] * scale;
      y[i] = mix_sample(mix, i, ya, yb);
    }
  }
}

}  // namespace

// x f32[b]; seg c64[n, b+1] (row cur written); ir_a, ir_b c64[n, b+1];
// tw f32[2b, 2]; partial c64[2, 1 + grid, b+1] scratch; ticket u32[1], 0
// between steps; y f32[b] out (mixed); ov_a, ov_b f32[b] in/out; rows: ring
// rows a MAC block; grid: MAC blocks, covering the n-1 rows other than cur;
// then the crossfader's scalars (struct Mix).  One launch; returns
// cudaGetLastError().
extern "C" int fdl_b3_step(const float* x, void* seg, const void* ir_a,
                           const void* ir_b, const void* tw, void* partial,
                           void* ticket, float* y, float* ov_a, float* ov_b,
                           int n, int b, int cur, int rows, int grid,
                           int approaching, int is_b, int counter, int fading,
                           int mixer, float mix_value, float step, void* stream) {
  const fdl::StepArgs<2> a{x,
                           static_cast<float2*>(seg),
                           {{static_cast<const float2*>(ir_a),
                             static_cast<const float2*>(ir_b)}},
                           static_cast<const float2*>(tw),
                           static_cast<float2*>(partial),
                           static_cast<unsigned int*>(ticket),
                           n, b, cur, rows};
  const Mix mix{approaching, is_b, counter, fading, mixer, mix_value, step};
  return static_cast<int>(fdl::launch_step<2>(
      b3_step, a, grid, static_cast<cudaStream_t>(stream), y, ov_a, ov_b, mix));
}
