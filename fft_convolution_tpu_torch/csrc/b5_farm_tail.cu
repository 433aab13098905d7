// Kernel B5: the reverb farm's big-tail phased correlation step.
//
// Replaces the Pallas kernels fft_convolution_tpu/ops/pallas_farm_mac.py:
// _kernel_v2 (f32 planes) and _kernel_packed_v2 (bf16 words), via
// phased_step; the v1 bodies _kernel and _kernel_packed compute the same.
// Over a fused lane axis of L = V * (tb + 1) complex bins, with the phased
// ring U[N][L], the IR table K[N][L] (one copy: rows are indexed mod N,
// where the TPU kept a doubled table for its DMA window), this call's tail
// spectra specs[T][L] and the phase q in [0, N):
//
//   conv[t] = sum_{x<N} U[x] K[(q + t + x) mod N]
//           + sum_{s<=t} (specs[s] - U[row_s]) K[t - s],  row_s = (N - q - s) mod N
//   pre     = conv[T-1] - specs[T-1] K[0]
//   then U[row_s] <- specs[s] for every s < T.
//
// Complex bins need no DC/Nyquist masks (the TPU's packed halfcomplex lane 0).
//
// What bounds it on an H100: memory.  Each lane's sum reads its N ring rows
// and N + TT - 1 table rows once; at 128 voices of 60 s (tb = 32768, N = 88)
// that is 2 x 2.95 GB per call in complex64 and half of it in bf16 pairs,
// against at most 16 complex FMAs per pair of loads.  The TPU's lane-chunk
// grid, double-buffered DMA window and residue roll do not carry over: lanes
// are independent, so one thread owns one lane (a warp's loads are
// coalesced), keeps TT accumulators and a sliding window of TT table rows in
// registers (as b4_mac does), and after its sums adds the corrections (the T
// ring rows and T table rows re-read from cache), writes conv and pre, and
// overwrites its own lane of the T ring rows.  No other thread reads that
// lane, so one launch does the MAC, the corrections, pre and the ring write.
//
// bf16 storage: ring and table are __nv_bfloat162, widened on load; the new
// ring rows are rounded to nearest even; the correction uses the widened
// stored row, as the TPU kernel does.  Arithmetic is FP32 FMA in a fixed
// order, so a replay is bit-exact.
#include "fdl_common.cuh"

namespace {

constexpr int kThreads = 256;

// TT: compile-time window (a power of two >= T, at most 16); T: blocks.
template <int TT, typename S>
__global__ void __launch_bounds__(kThreads)
b5_phased(S* __restrict__ ring, const S* __restrict__ table,
          const float2* __restrict__ specs, float2* __restrict__ convs,
          float2* __restrict__ pre, int lanes, int n, int q, int nblocks) {
  const int l = blockIdx.x * kThreads + threadIdx.x;
  if (l >= lanes) return;
  const size_t L = static_cast<size_t>(lanes);
  float2 acc[TT], win[TT];
#pragma unroll
  for (int j = 0; j < TT; ++j) acc[j] = make_float2(0.f, 0.f);
  // win[j] holds K[(q + x + j) mod n] at step x
#pragma unroll
  for (int j = 0; j < TT - 1; ++j)
    win[j] = fdl::load_c(table + static_cast<size_t>((q + j) % n) * L + l);
  int rnext = (q + TT - 1) % n;
#pragma unroll 4
  for (int x = 0; x < n; ++x) {
    win[TT - 1] = fdl::load_c(table + static_cast<size_t>(rnext) * L + l);
    const float2 u = fdl::load_c(ring + static_cast<size_t>(x) * L + l);
#pragma unroll
    for (int j = 0; j < TT; ++j) fdl::cmac(acc[j], u, win[j]);
#pragma unroll
    for (int j = 0; j < TT - 1; ++j) win[j] = win[j + 1];
    if (++rnext == n) rnext = 0;
  }

  // corrections: win[s] <- specs[s] - U[row_s] (the stored, widened row)
#pragma unroll
  for (int s = 0; s < TT; ++s) {
    if (s < nblocks) {
      const int row = ((n - q - s) % n + n) % n;
      const float2 sp = specs[static_cast<size_t>(s) * L + l];
      const float2 uo = fdl::load_c(ring + static_cast<size_t>(row) * L + l);
      win[s] = make_float2(sp.x - uo.x, sp.y - uo.y);
    }
  }
  // conv[s + j] += win[s] * K[j]  (j = t - s < T <= n)
#pragma unroll
  for (int j = 0; j < TT; ++j) {
    if (j < nblocks) {
      const float2 k = fdl::load_c(table + static_cast<size_t>(j) * L + l);
#pragma unroll
      for (int s = 0; s + j < TT; ++s)
        if (s + j < nblocks) fdl::cmac(acc[s + j], win[s], k);
    }
  }

  const float2 k0 = fdl::load_c(table + l);
#pragma unroll
  for (int t = 0; t < TT; ++t) {
    if (t < nblocks) {
      convs[static_cast<size_t>(t) * L + l] = acc[t];
      if (t == nblocks - 1) {
        float2 sk = make_float2(0.f, 0.f);
        fdl::cmac(sk, specs[static_cast<size_t>(t) * L + l], k0);
        pre[l] = make_float2(acc[t].x - sk.x, acc[t].y - sk.y);
      }
    }
  }
  // the ring write, after every read of the old rows by this thread
  for (int s = 0; s < nblocks; ++s) {
    const int row = ((n - q - s) % n + n) % n;
    fdl::store_c(ring + static_cast<size_t>(row) * L + l,
                 specs[static_cast<size_t>(s) * L + l]);
  }
}

template <int TT, typename S>
int launch(void* ring, const void* table, const void* specs, void* convs, void* pre,
           int lanes, int n, int q, int nblocks, void* stream) {
  const int grid = (lanes + kThreads - 1) / kThreads;
  b5_phased<TT, S><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<S*>(ring), static_cast<const S*>(table),
      static_cast<const float2*>(specs), static_cast<float2*>(convs),
      static_cast<float2*>(pre), lanes, n, q, nblocks);
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int b5_step(void* ring, const void* table, const void* specs, void* convs, void* pre,
            int lanes, int n, int q, int nblocks, void* stream) {
  if (nblocks < 1 || nblocks > 16 || nblocks > n || q < 0 || q >= n || lanes < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nblocks <= 1) return launch<1, S>(ring, table, specs, convs, pre, lanes, n, q, nblocks, stream);
  if (nblocks <= 2) return launch<2, S>(ring, table, specs, convs, pre, lanes, n, q, nblocks, stream);
  if (nblocks <= 4) return launch<4, S>(ring, table, specs, convs, pre, lanes, n, q, nblocks, stream);
  if (nblocks <= 8) return launch<8, S>(ring, table, specs, convs, pre, lanes, n, q, nblocks, stream);
  return launch<16, S>(ring, table, specs, convs, pre, lanes, n, q, nblocks, stream);
}

}  // namespace

// ring c64[n, lanes] in/out; table c64[n, lanes]; specs c64[T, lanes];
// convs c64[T, lanes] out; pre c64[lanes] out; lanes, n, q (phase), T
// (1..min(n, 16)).  Returns cudaGetLastError() after the launch.
extern "C" int fdl_b5_step(void* ring, const void* table, const void* specs, void* convs,
                           void* pre, int lanes, int n, int q, int nblocks, void* stream) {
  return b5_step<float2>(ring, table, specs, convs, pre, lanes, n, q, nblocks, stream);
}

// The bf16 form: ring and table bf16[n, lanes, 2]; specs, convs, pre as above.
extern "C" int fdl_b5p_step(void* ring, const void* table, const void* specs, void* convs,
                            void* pre, int lanes, int n, int q, int nblocks, void* stream) {
  return b5_step<__nv_bfloat162>(ring, table, specs, convs, pre, lanes, n, q, nblocks,
                                 stream);
}
