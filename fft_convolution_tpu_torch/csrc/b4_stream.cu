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
// after padding) the MAC is T x 11264 x 129 complex FMAs, 745 MFLOP at
// T = 64: 11.1 us at the 67 TFLOP/s FP32 rate, against 7.0 us for the 23.4
// MB of ring and table at the HBM rate.  No operand is shared across bins, so
// there is no matrix product for the tensor cores, and TF32 would not hold
// the 1e-4 gate at an output scale of ~55: the target is the FP32 FMA rate.
//
// Three launches a call:
// - b4_forward: the T forward rFFTs (fdl_step.cuh's shared-memory FFT and
//   post-twiddle), a few transforms a thread block.
// - b4_mac: thread block (split, t-tile, bin tile) sums table rows
//   [split rows, +rows) for `groups` t-groups of 16 audio blocks and `kb`
//   bins; one thread a (t-group, bin), so bins of one row sit on
//   neighbouring threads.  Table rows and ext rows are staged in shared
//   memory by cp.async, kStages stages in flight: each stage brings 16 table
//   rows and the 16 ext rows the block's window moves on by; ext lives in a
//   ring of ring_rows slots (ext row e in slot e mod ring_rows), so a row is
//   copied once per block whatever the number of t-groups reading it.  A
//   thread keeps its 16 accumulators and a window of 16 ext values in
//   registers; the u-loop is unrolled by the stage, so the window shifts by
//   renaming (window slot (j + i) mod 16) and one table value and one ext
//   value a step feed 16 complex FMAs.  The source of an ext row (ring from
//   slot w0+1, ring from 0, the new spectra, zero past the end) is worked out
//   once per row copied, never in the MAC.  Rows are 8 B (f32) or 4 B (bf16)
//   a bin and start 8 B off a 16-byte boundary on odd rows, so each bin is
//   one 8- or 4-byte cp.async.ca; bf16 is widened at use.
// - b4_finish: thread block t sums the partials of blocks t and t-1 over the
//   splits in split order (runs a thread, then a fixed-order tree in shared
//   memory), runs both inverse rFFTs side by side, and writes y[t] = head of
//   t + tail of t-1 (the carried overlap, copied by b4_forward, for t = 0),
//   the new overlap (t = T-1), and block t's spectrum into ring slot
//   (w0 + t) mod N if it is among the last N.  Stream order puts that ring
//   write after every MAC read of the old rows, so T > N is legal.
// Every sum has a fixed order whichever block runs first: replays are
// bit-equal, and there are no atomics.
#include "fdl_step.cuh"

namespace {

constexpr int kTile = 16;    // audio blocks a MAC thread; table rows a stage
constexpr int kStages = 4;   // cp.async stages in flight in the MAC
// MAC threads a block at most, and blocks an SM: two blocks of at most 8
// warps hold 128 registers a thread (an SM's four sub-partitions of 16384
// registers take 4 such warps each).  The launch plan
// (cuda_stream.stream_plan) keeps to it.
constexpr int kMacMaxThreads = 256;
constexpr int kMacMinBlocks = 2;
constexpr int kFwdPerBlock = 4;    // forward transforms a thread block, at most
constexpr int kFwdPerThread = 4;   // transform inputs a forward thread: b / fft_team(b)
constexpr int kFinishSlots = 8;    // splits a finishing thread loads a trip (x 2 blocks)
constexpr int kRingPerThread = 3;  // bins of a ring row a finishing thread copies

// Copy kBytes from global to shared memory asynchronously (cp.async.ca), or
// zero-fill them when !valid (src is then not read).
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
               "n"(kBytes), "r"(valid ? kBytes : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Thread blocks of `per` transforms, fft_team(b) threads each: spec[t] = the
// rFFT of x[t] zero-padded to 2b, through the b-point FFT of the pairs
// (x[2m], x[2m+1]).  Block 0 also copies the overlap to prev, which
// b4_finish reads while its last block rewrites the overlap.  Every global
// load is issued before the first shared store: one round trip.
// Dynamic shared memory: (2b + 2 per b) float2.
__global__ void __launch_bounds__(1024)
b4_forward(const float* __restrict__ x, const float2* __restrict__ tw,
           float2* __restrict__ spec, const float* __restrict__ overlap,
           float* __restrict__ prev, int b, int nblocks, int per) {
  extern __shared__ float4 smem[];
  float2* tws = reinterpret_cast<float2*>(smem);
  float2* za = tws + 2 * b;
  float2* zb = za + per * b;
  const int tid = threadIdx.x, threads = blockDim.x, nb = b + 1;
  const int t0 = blockIdx.x * per;
  const int count = min(per, nblocks - t0);
  const int log_b = __ffs(b) - 1;
  const int pairs = (b + 1) / 2;  // z[m] for m >= pairs is zero padding
  float2 twv[fdl::kTwPerThread];
  fdl::load_tw(tw, b, twv);
  float2 zv[kFwdPerThread];
#pragma unroll
  for (int c = 0; c < kFwdPerThread; ++c) {
    const int m = tid + c * threads, i = m & (b - 1);
    zv[c] = make_float2(0.f, 0.f);
    if (m < count * b && i < pairs) {
      const float* xt = x + static_cast<size_t>(t0 + (m >> log_b)) * b;
      zv[c] = 2 * i + 1 < b ? __ldg(reinterpret_cast<const float2*>(xt) + i)
                            : make_float2(__ldg(xt + 2 * i), 0.f);
    }
  }
  float ov[fdl::kEpiloguePerThread];
  const bool copy_overlap = blockIdx.x == 0;
#pragma unroll
  for (int c = 0; c < fdl::kEpiloguePerThread; ++c) {
    const int i = tid + c * threads;
    if (copy_overlap && i < b) ov[c] = overlap[i];
  }
  fdl::store_tw(tws, b, twv);
#pragma unroll
  for (int c = 0; c < kFwdPerThread; ++c) {
    const int m = tid + c * threads;
    if (m < per * b) za[m] = zv[c];
  }
#pragma unroll
  for (int c = 0; c < fdl::kEpiloguePerThread; ++c) {
    const int i = tid + c * threads;
    if (copy_overlap && i < b) prev[i] = ov[c];
  }
  __syncthreads();
  const float2* z = fdl::fft_shared<false>(za, zb, b, count, tws);
  for (int j = 0; j < count; ++j)
    for (int k = tid; k < nb; k += threads)
      spec[static_cast<size_t>(t0 + j) * nb + k] = fdl::real_post_twiddle(z + j * b, tws, b, k);
}

template <typename T>
struct MacArgs {
  const float2* ring;   // c64[n, nb]
  const float2* spec;   // c64[T, nb]: this call's spectra
  const T* irrev;       // [n, nb] of T
  float2* partial;      // c64[T, splits, nb]
  int n, nb, nblocks, w0;
  int kb, groups, ring_rows, rows;  // the launch plan
};

// Grid (splits, t-tiles, bin tiles); block (split, i, z) over table rows
// u in [split rows, +rows), audio blocks [i 16 groups, +16 groups) and bins
// [z kb, +kb):
//   partial[t][split][k] = sum_u irrev[u][k] * ext[u + t][k], in u order.
// Dynamic shared memory: ring_rows kb float2 (ext) + kStages 16 kb T (table).
template <typename T>
__global__ void __launch_bounds__(kMacMaxThreads, kMacMinBlocks) b4_mac(const MacArgs<T> a) {
  extern __shared__ float4 smem[];
  const int kb = a.kb, nb = a.nb, n = a.n, mask = a.ring_rows - 1;
  float2* ext = reinterpret_cast<float2*>(smem);
  T* tab = reinterpret_cast<T*>(ext + static_cast<size_t>(a.ring_rows) * kb);
  // thread (g, kl): bin k; copies rows g, g + groups, ... of each stage and
  // sums audio blocks t0 .. t0+15
  const int g = threadIdx.x / kb, kl = threadIdx.x - g * kb;
  const int k = blockIdx.z * kb + kl;
  const int span = kTile * a.groups;
  const int tb0 = blockIdx.y * span;
  const int t0 = tb0 + kTile * g;
  const int u0 = blockIdx.x * a.rows, u1 = min(u0 + a.rows, n);
  const int nstages = (u1 - u0 + kTile - 1) / kTile;
  const int ext_len = n - 1 + a.nblocks;
  const bool copier = g < a.groups && k < nb;
  const bool active = copier && t0 < a.nblocks;

  // ext row e, bin k, into its slot; zero past the end of ext
  auto load_ext = [&](int e) {
    const float2* src = a.ring;
    if (e < n - 1) {
      int r = a.w0 + 1 + e;
      if (r >= n) r -= n;
      src = a.ring + static_cast<size_t>(r) * nb + k;
    } else if (e < ext_len) {
      src = a.spec + static_cast<size_t>(e - (n - 1)) * nb + k;
    }
    cp_async<8>(ext + static_cast<size_t>(e & mask) * kb + kl, src, e < ext_len);
  };
  // stage s: table rows u0 + 16 s + r (zero past u1) and the ext rows the
  // window moves on to, u0 + 16 s + tb0 + span - 1 + r, r < 16
  auto load_stage = [&](int s) {
    const int ub = u0 + kTile * s;
    T* dst = tab + static_cast<size_t>(s % kStages) * kTile * kb + kl;
    for (int r = g; r < kTile; r += a.groups) {
      const int u = ub + r;
      cp_async<sizeof(T)>(dst + r * kb, a.irrev + static_cast<size_t>(u < u1 ? u : u0) * nb + k,
                          u < u1);
      load_ext(ub + tb0 + span - 1 + r);
    }
  };

  // the window's first span - 1 ext rows go with stage 0
  if (copier)
    for (int r = g; r < span - 1; r += a.groups) load_ext(u0 + tb0 + r);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (copier && s < nstages) load_stage(s);
    cp_async_commit();
  }

  float2 acc[kTile], win[kTile];
#pragma unroll
  for (int i = 0; i < kTile; ++i) acc[i] = win[i] = make_float2(0.f, 0.f);
  const float2* ek = ext + kl;
  for (int s = 0; s < nstages; ++s) {
    cp_async_wait<kStages - 2>();  // this thread's copies of stage s have landed
    __syncthreads();               // everyone's have; stage s-1's slots are free
    if (copier && s + kStages - 1 < nstages) load_stage(s + kStages - 1);
    cp_async_commit();
    if (active) {
      // win[(j + i) mod 16] holds ext[u0 + 16 s + j + t0 + i] at step j
      if (s == 0) {
#pragma unroll
        for (int i = 0; i < kTile - 1; ++i) win[i] = ek[((u0 + t0 + i) & mask) * kb];
      }
      const T* hk = tab + static_cast<size_t>(s % kStages) * kTile * kb + kl;
      const int e0 = u0 + kTile * s + t0 + kTile - 1;
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        win[(j + kTile - 1) % kTile] = ek[((e0 + j) & mask) * kb];
        const float2 h = fdl::load_c(hk + j * kb);
#pragma unroll
        for (int i = 0; i < kTile; ++i) fdl::cmac(acc[i], win[(j + i) % kTile], h);
      }
    }
  }
  if (active) {
#pragma unroll
    for (int i = 0; i < kTile; ++i)
      if (t0 + i < a.nblocks)
        a.partial[(static_cast<size_t>(t0 + i) * gridDim.x + blockIdx.x) * nb + k] = acc[i];
  }
}

// Block t: conv[t] and conv[t-1], each the sum over the splits, in split
// order, of the MAC's partials; their inverse rFFTs side by side; y[t] = the
// head half of block t's + the tail half of block t-1's (prev, the carried
// overlap, for t = 0).  Block T-1 writes the new overlap; block t writes its
// spectrum into ring slot (w0 + t) mod n if it is among the last n blocks.
// Launched (lanes, groups): lane = bin, and row group g < runs sums run g of
// the splits; a fixed-order tree in shared memory then adds the runs.
// Dynamic shared memory: (2b + groups 2 (b+1) + 4b) float2.
__global__ void __launch_bounds__(1024)
b4_finish(const float2* __restrict__ partial, const float2* __restrict__ tw,
          const float2* __restrict__ spec, float2* __restrict__ ring,
          const float* __restrict__ prev, float* __restrict__ y, float* __restrict__ overlap,
          int n, int b, int nblocks, int splits, int w0, int runs, int run) {
  extern __shared__ float4 smem[];
  const int nb = b + 1, tid = fdl::step_tid(), threads = fdl::step_threads();
  const int lanes = blockDim.x, lane = threadIdx.x, g = threadIdx.y;
  const int t = blockIdx.x;
  const int count = t > 0 ? 2 : 1;  // transform 0: block t; 1: block t - 1
  float2* tws = reinterpret_cast<float2*>(smem);
  float2* red = tws + 2 * b;  // [groups][2][nb]
  float2* za = red + blockDim.y * 2 * nb;
  float2* zb = za + 2 * b;
  // the epilogue's global loads go out with the partials': the carried
  // overlap (t = 0) and block t's spectrum, if it enters the ring
  float2 twv[fdl::kTwPerThread];
  fdl::load_tw(tw, b, twv);
  float ov[fdl::kEpiloguePerThread];
#pragma unroll
  for (int c = 0; c < fdl::kEpiloguePerThread; ++c) {
    const int i = tid + c * threads;
    if (t == 0 && i < b) ov[c] = prev[i];
  }
  const bool to_ring = t >= nblocks - n;
  float2 row[kRingPerThread];
#pragma unroll
  for (int c = 0; c < kRingPerThread; ++c) {
    const int k = tid + c * threads;
    if (to_ring && k < nb) row[c] = spec[static_cast<size_t>(t) * nb + k];
  }

  const int s0 = g * run, s1 = min(s0 + run, splits);
  for (int k0 = 0; k0 < nb; k0 += lanes) {
    const int k = k0 + lane;
    if (k < nb && g < runs) {
      float2 sum[2] = {make_float2(0.f, 0.f), make_float2(0.f, 0.f)};
      for (int s = s0; s < s1; s += kFinishSlots) {
        // the split clamped into the run, the adds past its end skipped
        float2 v[kFinishSlots][2];
#pragma unroll
        for (int u = 0; u < kFinishSlots; ++u) {
          const size_t slot = min(s + u, s1 - 1);
#pragma unroll
          for (int c = 0; c < 2; ++c)
            v[u][c] = c < count
                          ? __ldcg(partial + (static_cast<size_t>(t - c) * splits + slot) * nb + k)
                          : make_float2(0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < kFinishSlots; ++u) {
          if (s + u < s1) {
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              sum[c].x += v[u][c].x;
              sum[c].y += v[u][c].y;
            }
          }
        }
      }
#pragma unroll
      for (int c = 0; c < 2; ++c) red[(g * 2 + c) * nb + k] = sum[c];
    }
  }
  fdl::store_tw(tws, b, twv);
  __syncthreads();
  // fixed-order tree over the runs: run g takes in run g + w
  for (int w = 1; w < runs; w *= 2) {
    if (g < runs && (g & (2 * w - 1)) == 0 && g + w < runs) {
      for (int k = lane; k < nb; k += lanes) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float2& dst = red[(g * 2 + c) * nb + k];
          const float2 src = red[((g + w) * 2 + c) * nb + k];
          dst.x += src.x;
          dst.y += src.y;
        }
      }
    }
    __syncthreads();
  }

  const int log_b = __ffs(b) - 1;
  for (int idx = tid; idx < count * b; idx += threads) {
    const int c = idx >> log_b, k = idx & (b - 1);
    za[idx] = fdl::real_pre_twiddle(red + c * nb, tws, b, k);
  }
  __syncthreads();
  const float* out = reinterpret_cast<const float*>(fdl::fft_shared<true>(za, zb, b, count, tws));
  const float scale = 1.f / static_cast<float>(2 * b);
#pragma unroll
  for (int c = 0; c < fdl::kEpiloguePerThread; ++c) {
    const int i = tid + c * threads;
    if (i < b) {
      y[static_cast<size_t>(t) * b + i] = out[i] * scale + (t > 0 ? out[3 * b + i] * scale : ov[c]);
      if (t == nblocks - 1) overlap[i] = out[b + i] * scale;
    }
  }
  if (to_ring) {
    const size_t slot = (static_cast<size_t>(w0) + t) % n;
#pragma unroll
    for (int c = 0; c < kRingPerThread; ++c) {
      const int k = tid + c * threads;
      if (k < nb) ring[slot * nb + k] = row[c];
    }
  }
}

template <typename T>
int b4_stream(const float* x, void* ring, const void* irrev, const void* tw, void* scratch,
              float* y, float* overlap, int n, int b, int nblocks, int w0, int kb, int groups,
              int ring_rows, int rows, int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nb = b + 1;
  const int span = kTile * groups;
  const int threads = (kb * groups + 31) / 32 * 32;
  if (n < 1 || nblocks < 1 || kb < 1 || groups < 1 || rows < 1 || splits < 1 ||
      threads > kMacMaxThreads || (ring_rows & (ring_rows - 1)) != 0 ||
      ring_rows < span - 1 + kStages * kTile || static_cast<long long>(rows) * splits < n)
    return static_cast<int>(cudaErrorInvalidValue);
  float2* spec = static_cast<float2*>(scratch);
  float2* partial = spec + static_cast<size_t>(nblocks) * nb;
  float* prev = reinterpret_cast<float*>(partial + static_cast<size_t>(nblocks) * splits * nb);
  const float2* twp = static_cast<const float2*>(tw);

  const int team = fdl::fft_team(b);
  const int per = 1024 / team < kFwdPerBlock ? 1024 / team : kFwdPerBlock;
  const size_t fwd_smem = static_cast<size_t>(2 * b + 2 * per * b) * sizeof(float2);
  cudaError_t e = fdl::allow_smem(b4_forward, fwd_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  b4_forward<<<(nblocks + per - 1) / per, team * per, fwd_smem, st>>>(x, twp, spec, overlap,
                                                                      prev, b, nblocks, per);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  const size_t mac_smem = static_cast<size_t>(ring_rows) * kb * sizeof(float2) +
                          static_cast<size_t>(kStages) * kTile * kb * sizeof(T);
  e = fdl::allow_smem(b4_mac<T>, mac_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const MacArgs<T> a{static_cast<const float2*>(ring), spec, static_cast<const T*>(irrev),
                     partial, n, nb, nblocks, w0, kb, groups, ring_rows, rows};
  const dim3 grid(splits, (nblocks + span - 1) / span, (nb + kb - 1) / kb);
  b4_mac<T><<<grid, threads, mac_smem, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  int lanes = (nb + 31) / 32 * 32;
  if (lanes > 512) lanes = 512;
  const int fgroups = 1024 / lanes < 8 ? 1024 / lanes : 8;
  int runs = (splits + kFinishSlots - 1) / kFinishSlots;
  if (runs > fgroups) runs = fgroups;
  const int run = (splits + runs - 1) / runs;
  const size_t fin_smem = static_cast<size_t>(2 * b + fgroups * 2 * nb + 4 * b) * sizeof(float2);
  e = fdl::allow_smem(b4_finish, fin_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  b4_finish<<<nblocks, dim3(lanes, fgroups), fin_smem, st>>>(
      partial, twp, spec, static_cast<float2*>(ring), prev, y, overlap, n, b, nblocks, splits,
      w0, runs, run);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x f32[T, b]; ring c64[n, b+1] in/out; irrev c64[n, b+1]; tw f32[2b, 2];
// scratch c64[T (1 + splits) (b+1) + ceil(b/2)] (the spectra, the partials,
// the carried overlap); y f32[T, b] out; overlap f32[b] in/out; n, b, T,
// w0 (next write slot); the MAC's launch plan (cuda_stream.stream_plan):
// kb, groups, ring_rows, rows, splits.  Three launches; returns
// cudaGetLastError() after them (cudaErrorInvalidValue for a plan the MAC
// cannot run).
extern "C" int fdl_b4_stream(const float* x, void* ring, const void* irrev, const void* tw,
                             void* scratch, float* y, float* overlap, int n, int b, int nblocks,
                             int w0, int kb, int groups, int ring_rows, int rows, int splits,
                             void* stream) {
  return b4_stream<float2>(x, ring, irrev, tw, scratch, y, overlap, n, b, nblocks, w0, kb,
                           groups, ring_rows, rows, splits, stream);
}

// The packed form: as fdl_b4_stream with irrev bf16[n, b+1, 2]; the ring
// stays complex64.
extern "C" int fdl_b4p_stream(const float* x, void* ring, const void* irrev, const void* tw,
                              void* scratch, float* y, float* overlap, int n, int b, int nblocks,
                              int w0, int kb, int groups, int ring_rows, int rows, int splits,
                              void* stream) {
  return b4_stream<__nv_bfloat162>(x, ring, irrev, tw, scratch, y, overlap, n, b, nblocks, w0,
                                   kb, groups, ring_rows, rows, splits, stream);
}
