// Kernel B3: the A/B crossfade block step (IR morphing while serving).
//
// Replaces the Pallas kernel fft_convolution_tpu/ops/pallas_crossfade.py:_kernel
// (via block_step).  The crossfade convolver runs two engines on the same
// input every block (src/crossfade_convolver.rs:66-78), so they share one
// input-spectra ring: one forward DFT, two rolled-IR MACs over that ring
// (tables A and B), two inverse DFTs and overlap-adds.  The TPU kernel
// returned ya and yb and left the per-sample crossfade mix to XLA; here the
// finalising launch also mixes, from the crossfader's host scalars passed as
// arguments (models/crossfade.py:mix_samples is the plain version), so a
// block costs two launches and no extra torch ops.
//
// What bounds it on an H100: at the flagship N = 3750, B = 128 the ring and
// the two tables are 3 x 3750 x 129 complex64 = 11.6 MB read per block (L2
// resident across blocks) for ~8 MFLOP of MAC.  B2's split serves as is:
// mac_partial<2> reads each ring row once for both tables over ~130 thread
// blocks, and one finalising block reduces the partials in block order.
#include "fdl_common.cuh"

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

// Dynamic shared memory: 2 (b+1) + 2b float2 + 4b float.
__global__ void b3_finalize(const float2* __restrict__ partial, int grid,
                            const float2* __restrict__ tw, float* __restrict__ y,
                            float* __restrict__ ov_a, float* __restrict__ ov_b,
                            int b, Mix mix) {
  extern __shared__ float4 smem[];
  const int nb = b + 1;
  float2* conv_a = reinterpret_cast<float2*>(smem);
  float2* conv_b = conv_a + nb;
  float2* tws = conv_b + nb;
  float* out_a = reinterpret_cast<float*>(tws + 2 * b);
  float* out_b = out_a + 2 * b;

  for (int i = threadIdx.x; i < 2 * b; i += blockDim.x) tws[i] = tw[i];
  fdl::reduce_partials(partial, grid, nb, conv_a);
  fdl::reduce_partials(partial + static_cast<size_t>(grid) * nb, grid, nb, conv_b);
  __syncthreads();
  fdl::irdft(conv_a, tws, b, out_a);
  fdl::irdft(conv_b, tws, b, out_b);
  __syncthreads();
  // each thread reads overlap[i] before it overwrites it: no cross-thread race
  for (int i = threadIdx.x; i < b; i += blockDim.x) {
    const float ya = out_a[i] + ov_a[i];
    const float yb = out_b[i] + ov_b[i];
    ov_a[i] = out_a[b + i];
    ov_b[i] = out_b[b + i];
    y[i] = mix_sample(mix, i, ya, yb);
  }
}

}  // namespace

// x f32[b]; seg c64[n, b+1] (row cur written); ir_a, ir_b c64[n, b+1];
// tw f32[2b, 2]; partial c64[2, grid, b+1] scratch; y f32[b] out (mixed);
// ov_a, ov_b f32[b] in/out; then the crossfader's scalars (struct Mix).
// Returns cudaGetLastError() after the launches.
extern "C" int fdl_b3_step(const float* x, void* seg, const void* ir_a,
                           const void* ir_b, const void* tw, void* partial,
                           float* y, float* ov_a, float* ov_b, int n, int b,
                           int cur, int rows, int grid, int approaching,
                           int is_b, int counter, int fading, int mixer,
                           float mix_value, float step, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t mac_smem = fdl::mac_smem(b);
  const size_t fin_smem = static_cast<size_t>(2 * (b + 1) + 2 * b) * sizeof(float2) +
                          4 * b * sizeof(float);
  cudaError_t e = fdl::allow_smem(fdl::mac_partial<2>, mac_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = fdl::allow_smem(b3_finalize, fin_smem);
  if (e != cudaSuccess) return static_cast<int>(e);

  fdl::Tables<2> tables{{static_cast<const float2*>(ir_a),
                         static_cast<const float2*>(ir_b)}};
  fdl::mac_partial<2><<<grid, fdl::mac_threads(b), mac_smem, s>>>(
      x, static_cast<float2*>(seg), tables, static_cast<const float2*>(tw),
      static_cast<float2*>(partial), n, b, cur, rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const Mix mix{approaching, is_b, counter, fading, mixer, mix_value, step};
  b3_finalize<<<1, fdl::kFinalizeThreads, fin_smem, s>>>(
      static_cast<const float2*>(partial), grid, static_cast<const float2*>(tw),
      y, ov_a, ov_b, b, mix);
  return static_cast<int>(cudaGetLastError());
}
