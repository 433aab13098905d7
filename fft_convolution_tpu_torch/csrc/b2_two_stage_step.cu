// Kernel B2: the fused head + tail0 block step of the two-stage convolver.
//
// Replaces the Pallas kernel fft_convolution_tpu/ops/pallas_two_stage.py:_kernel
// (via block_step).  Head and tail0 run at the same block size over the same
// input, so they share one input-spectra ring: one forward DFT, two rolled-IR
// MACs over that ring (head and tail0 tables, tail0 padded with zero rows to
// the ring's n), two inverse DFTs, the head overlap-add plus the two
// precalculated tail rows at the period row (a finished y), and tail0's
// overlap-add written straight into its period-buffer row.  The kernel also
// copies x into the period input row, which the big tail reads at period end.
//
// What bounds it on an H100: at the flagship n = 64, B = 128 the ring and the
// two tables are 3 x 64 x 129 complex64 = 198 KB and the MAC is 66 K complex
// FMAs: far too little work to fill the card, so the step is bound by launch
// and memory latency.  The design keeps B1's split (shared code in
// fdl_common.cuh): 16 thread blocks of 4 rows each read both tables in one
// pass over the ring, and one finalising block does the rest.
#include "fdl_common.cuh"

namespace {

// Dynamic shared memory: 2 (b+1) + 2b float2 + 4b float.
__global__ void b2_finalize(const float2* __restrict__ partial, int grid,
                            const float2* __restrict__ tw,
                            const float* __restrict__ x, float* __restrict__ y,
                            float* __restrict__ h_ov, float* __restrict__ t_ov,
                            float* __restrict__ out0_row,
                            float* __restrict__ tail_in_row,
                            const float* __restrict__ pre0_row,
                            const float* __restrict__ pre_row, int b) {
  extern __shared__ float4 smem[];
  const int nb = b + 1;
  float2* conv_h = reinterpret_cast<float2*>(smem);
  float2* conv_t = conv_h + nb;
  float2* tws = conv_t + nb;
  float* out_h = reinterpret_cast<float*>(tws + 2 * b);
  float* out_t = out_h + 2 * b;

  for (int i = threadIdx.x; i < 2 * b; i += blockDim.x) tws[i] = tw[i];
  fdl::reduce_partials(partial, grid, nb, conv_h);
  fdl::reduce_partials(partial + static_cast<size_t>(grid) * nb, grid, nb, conv_t);
  __syncthreads();
  fdl::irdft(conv_h, tws, b, out_h);
  fdl::irdft(conv_t, tws, b, out_t);
  __syncthreads();
  for (int i = threadIdx.x; i < b; i += blockDim.x) {
    // src/fft_convolver.rs:439-456: head output plus both precalculated tails
    y[i] = ((out_h[i] + h_ov[i]) + pre0_row[i]) + pre_row[i];
    h_ov[i] = out_h[b + i];
    out0_row[i] = out_t[i] + t_ov[i];
    t_ov[i] = out_t[b + i];
    tail_in_row[i] = x[i];
  }
}

}  // namespace

// x f32[b]; seg c64[n, b+1] (row cur written); h_ir, t_ir c64[n, b+1];
// tw f32[2b, 2]; partial c64[2, grid, b+1] scratch; y f32[b] out;
// h_ov, t_ov f32[b] in/out; out0_row, tail_in_row f32[b] out (rows of the
// period buffers); pre0_row, pre_row f32[b] in.
// Returns cudaGetLastError() after the launches.
extern "C" int fdl_b2_step(const float* x, void* seg, const void* h_ir,
                           const void* t_ir, const void* tw, void* partial,
                           float* y, float* h_ov, float* t_ov, float* out0_row,
                           float* tail_in_row, const float* pre0_row,
                           const float* pre_row, int n, int b, int cur,
                           int rows, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t mac_smem = fdl::mac_smem(b);
  const size_t fin_smem = static_cast<size_t>(2 * (b + 1) + 2 * b) * sizeof(float2) +
                          4 * b * sizeof(float);
  cudaError_t e = fdl::allow_smem(fdl::mac_partial<2>, mac_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = fdl::allow_smem(b2_finalize, fin_smem);
  if (e != cudaSuccess) return static_cast<int>(e);

  fdl::Tables<2> tables{{static_cast<const float2*>(h_ir),
                         static_cast<const float2*>(t_ir)}};
  fdl::mac_partial<2><<<grid, fdl::mac_threads(b), mac_smem, s>>>(
      x, static_cast<float2*>(seg), tables, static_cast<const float2*>(tw),
      static_cast<float2*>(partial), n, b, cur, rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  b2_finalize<<<1, fdl::kFinalizeThreads, fin_smem, s>>>(
      static_cast<const float2*>(partial), grid, static_cast<const float2*>(tw),
      x, y, h_ov, t_ov, out0_row, tail_in_row, pre0_row, pre_row, b);
  return static_cast<int>(cudaGetLastError());
}
