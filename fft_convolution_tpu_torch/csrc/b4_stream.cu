// Kernel B4: long-IR uniform streaming, T blocks per call.
//
// Replaces the Pallas kernel fft_convolution_tpu/ops/pallas_stream.py:_kernel
// (via stream), in its f32 form and its `packed` form (bf16 table).  The
// state layout is the TPU kernel's: a chronological ring of N spectra (block
// t of a call lands in slot (w0 + t) mod N), the reversed IR table
// irrev[u] = ir[N-1-u], the overlap, and w0 as a host int.
//
// The TPU walked the blocks one grid step at a time because its ring lived
// in one core's VMEM.  Here every output is independent: with the extended
// buffer ext = [the N-1 newest old ring rows, oldest first; the T new
// spectra],
//     conv[t] = sum_{u<N} irrev[u] * ext[u + t],
// T * (B+1) sums of N terms.  Only the overlap-add links block t to t-1.
//
// What bounds it on an H100: at the 30 s / 48 kHz IR and B = 128 (N = 11264
// after padding) the table is 11.6 MB in f32 (5.8 MB in bf16) and the MAC
// is T x 11264 x 129 complex FMAs (370 MFLOP at T = 64).  Read once per
// block, as a one-block step would, the table alone is 0.74 GB per 64
// blocks; so the MAC takes the blocks in tiles of TT = 16 and each thread
// holds TT accumulators and a sliding window of TT ext rows in registers:
// one table row and one ext row loaded per u feed TT complex FMAs, and the
// table is read once per tile.  The u range is split over enough thread
// blocks to fill the 132 SMs; partials are reduced in a fixed order.
//
// Launches per call: forward DFTs (one block per audio block); the MAC;
// the reduction + inverse DFT (one block per audio block, heads into y,
// tails to scratch); the overlap-add and the ring write.  Stream order puts
// the ring write after every MAC has read the old rows, so T > N is legal.
#include "fdl_common.cuh"

namespace {

constexpr int kTile = 16;  // TT: audio blocks per MAC tile

// Dynamic shared memory: 2b float2 + b float.
__global__ void b4_forward(const float* __restrict__ x, const float2* __restrict__ tw,
                           float2* __restrict__ spec, int b) {
  extern __shared__ float4 smem[];
  float2* tws = reinterpret_cast<float2*>(smem);
  float* xs = reinterpret_cast<float*>(tws + 2 * b);
  const size_t t = blockIdx.x;
  for (int i = threadIdx.x; i < 2 * b; i += blockDim.x) tws[i] = tw[i];
  for (int i = threadIdx.x; i < b; i += blockDim.x) xs[i] = x[t * b + i];
  __syncthreads();
  fdl::rdft_padded(xs, tws, b, spec + t * (b + 1));
}

// ext[e][k]: old ring row (w0 + 1 + e) mod n for e < n-1, else new spectrum
// e - (n-1); zero past the end (only read for tile slots past T).
__device__ __forceinline__ float2 ext_load(const float2* __restrict__ ring,
                                           const float2* __restrict__ spec, int n,
                                           int nb, int w0, int ext_len, int e, int k) {
  if (e >= ext_len) return make_float2(0.f, 0.f);
  if (e < n - 1) {
    int r = w0 + 1 + e;
    if (r >= n) r -= n;
    return ring[static_cast<size_t>(r) * nb + k];
  }
  return spec[static_cast<size_t>(e - (n - 1)) * nb + k];
}

// Grid (tiles, splits): block (i, s) sums u in [s*rows, (s+1)*rows) for
// audio blocks [i*TT, i*TT + TT):
//   partial[s][t][k] = sum_u irrev[u][k] * ext[u + t][k].
template <typename T>
__global__ void b4_mac(const float2* __restrict__ ring, const float2* __restrict__ spec,
                       const T* __restrict__ irrev, float2* __restrict__ partial,
                       int n, int b, int nblocks, int w0, int rows) {
  const int nb = b + 1;
  const int t0 = blockIdx.x * kTile;
  const int s = blockIdx.y;
  const int u0 = s * rows;
  const int u1 = min(u0 + rows, n);
  const int ext_len = n - 1 + nblocks;
  for (int k = threadIdx.x; k < nb; k += blockDim.x) {
    float2 acc[kTile], win[kTile];
#pragma unroll
    for (int j = 0; j < kTile; ++j) acc[j] = make_float2(0.f, 0.f);
    // win[j] holds ext[u + t0 + j] at step u
#pragma unroll
    for (int j = 0; j < kTile - 1; ++j)
      win[j] = ext_load(ring, spec, n, nb, w0, ext_len, u0 + t0 + j, k);
    for (int u = u0; u < u1; ++u) {
      win[kTile - 1] = ext_load(ring, spec, n, nb, w0, ext_len, u + t0 + kTile - 1, k);
      const float2 h = fdl::load_c(irrev + static_cast<size_t>(u) * nb + k);
#pragma unroll
      for (int j = 0; j < kTile; ++j) fdl::cmac(acc[j], win[j], h);
#pragma unroll
      for (int j = 0; j < kTile - 1; ++j) win[j] = win[j + 1];
    }
#pragma unroll
    for (int j = 0; j < kTile; ++j)
      if (t0 + j < nblocks)
        partial[(static_cast<size_t>(s) * nblocks + t0 + j) * nb + k] = acc[j];
  }
}

// Block t: conv[t] = sum over s = 0..splits-1, in order, of partial[s][t];
// its inverse DFT; y[t] <- the head half, tails[t] <- the tail half.
// Dynamic shared memory: (b+1 + 2b) float2 + 2b float.
__global__ void b4_finalize(const float2* __restrict__ partial, int splits, int nblocks,
                            const float2* __restrict__ tw, float* __restrict__ y,
                            float* __restrict__ tails, int b) {
  extern __shared__ float4 smem[];
  const int nb = b + 1;
  float2* conv = reinterpret_cast<float2*>(smem);
  float2* tws = conv + nb;
  float* out = reinterpret_cast<float*>(tws + 2 * b);
  const size_t t = blockIdx.x;

  for (int i = threadIdx.x; i < 2 * b; i += blockDim.x) tws[i] = tw[i];
  for (int k = threadIdx.x; k < nb; k += blockDim.x) {
    float2 a = make_float2(0.f, 0.f);
    for (int s = 0; s < splits; ++s) {
      const float2 p = partial[(static_cast<size_t>(s) * nblocks + t) * nb + k];
      a.x += p.x;
      a.y += p.y;
    }
    conv[k] = a;
  }
  __syncthreads();
  fdl::irdft(conv, tws, b, out);
  __syncthreads();
  for (int i = threadIdx.x; i < b; i += blockDim.x) {
    y[t * b + i] = out[i];
    tails[t * b + i] = out[b + i];
  }
}

// Block t: y[t] += the previous block's tail (the carried overlap for
// t = 0, which block 0 then replaces with the last tail); the new spectrum
// of block t goes to ring slot (w0 + t) mod n if it is among the last n.
__global__ void b4_overlap_ring(float* __restrict__ y, const float* __restrict__ tails,
                                float* __restrict__ overlap, const float2* __restrict__ spec,
                                float2* __restrict__ ring, int n, int b, int nblocks,
                                int w0) {
  const int t = blockIdx.x;
  for (int i = threadIdx.x; i < b; i += blockDim.x) {
    if (t == 0) {
      // read before write, same thread: no race
      y[i] += overlap[i];
      overlap[i] = tails[static_cast<size_t>(nblocks - 1) * b + i];
    } else {
      y[static_cast<size_t>(t) * b + i] += tails[static_cast<size_t>(t - 1) * b + i];
    }
  }
  if (t >= nblocks - n) {
    const int nb = b + 1;
    const size_t slot = (static_cast<size_t>(w0) + t) % n;
    for (int k = threadIdx.x; k < nb; k += blockDim.x)
      ring[slot * nb + k] = spec[static_cast<size_t>(t) * nb + k];
  }
}

template <typename T>
int b4_stream(const float* x, void* spec, void* ring, const void* irrev,
              const void* tw, void* partial, float* tails, float* y,
              float* overlap, int n, int b, int nblocks, int w0, int rows,
              int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nb = b + 1;
  const size_t fwd_smem = 2 * b * sizeof(float2) + b * sizeof(float);
  const size_t fin_smem = static_cast<size_t>(nb + 2 * b) * sizeof(float2) +
                          2 * b * sizeof(float);
  cudaError_t e = fdl::allow_smem(b4_forward, fwd_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = fdl::allow_smem(b4_finalize, fin_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const float2* twp = static_cast<const float2*>(tw);
  float2* specp = static_cast<float2*>(spec);
  float2* ringp = static_cast<float2*>(ring);
  float2* partp = static_cast<float2*>(partial);

  b4_forward<<<nblocks, fdl::kFinalizeThreads, fwd_smem, st>>>(x, twp, specp, b);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 mac_grid((nblocks + kTile - 1) / kTile, splits);
  b4_mac<T><<<mac_grid, fdl::mac_threads(b), 0, st>>>(
      ringp, specp, static_cast<const T*>(irrev), partp, n, b, nblocks, w0, rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  b4_finalize<<<nblocks, fdl::kFinalizeThreads, fin_smem, st>>>(
      partp, splits, nblocks, twp, y, tails, b);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  b4_overlap_ring<<<nblocks, fdl::kFinalizeThreads, 0, st>>>(
      y, tails, overlap, specp, ringp, n, b, nblocks, w0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x f32[T, b]; spec c64[T, b+1] scratch; ring c64[n, b+1] in/out;
// irrev c64[n, b+1]; tw f32[2b, 2]; partial c64[splits, T, b+1] scratch;
// tails f32[T, b] scratch; y f32[T, b] out; overlap f32[b] in/out;
// n, b, T, w0 (next write slot), rows (u per split), splits.
// Returns cudaGetLastError() after the launches.
extern "C" int fdl_b4_stream(const float* x, void* spec, void* ring, const void* irrev,
                             const void* tw, void* partial, float* tails, float* y,
                             float* overlap, int n, int b, int nblocks, int w0,
                             int rows, int splits, void* stream) {
  return b4_stream<float2>(x, spec, ring, irrev, tw, partial, tails, y, overlap,
                           n, b, nblocks, w0, rows, splits, stream);
}

// The packed form: as fdl_b4_stream with irrev bf16[n, b+1, 2]; the ring
// stays complex64.
extern "C" int fdl_b4p_stream(const float* x, void* spec, void* ring, const void* irrev,
                              const void* tw, void* partial, float* tails, float* y,
                              float* overlap, int n, int b, int nblocks, int w0,
                              int rows, int splits, void* stream) {
  return b4_stream<__nv_bfloat162>(x, spec, ring, irrev, tw, partial, tails, y,
                                   overlap, n, b, nblocks, w0, rows, splits, stream);
}
