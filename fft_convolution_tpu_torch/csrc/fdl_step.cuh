// The one-launch block step shared by kernels B1, B1p, B2 and B3: NT
// rolled-IR MACs over one input-spectra ring, in a single CUDA launch.  Ring
// and tables store their bins as T: float2 (complex64), or __nv_bfloat162
// (B1p), widened to FP32 on load; the fresh ring row is stored rounded to
// nearest even, and block 0's own term uses it unrounded.
//
// A step launches 1 + G thread blocks:
// - Block 0 computes the fresh spectrum of the input block (the rFFT of the
//   block zero-padded to 2b, a shared-memory FFT), writes it into ring row
//   `cur`, and writes its partial spec * ir_t[0] for each table (row `cur`
//   meets table row 0).  It runs beside the MAC, not before it.
// - Blocks 1..G split the other n-1 ring rows.  A block's threads form row
//   groups of one lane a bin; each group walks its rows six at a time, so
//   eighteen loads (NT = 2) are in flight a thread, and the groups' sums are
//   added in shared memory in group order.
// - Every block writes its partials and takes an integer ticket (an
//   acquire-release increment that wraps the counter back to 0 in the last
//   block): step_arrive.  The block that arrives last reduces the 1 + G
//   partials in block order, every thread over a fixed contiguous run and
//   then a fixed-order tree in shared memory, runs the NT inverse FFTs side
//   by side and hands the 2b samples of each to the kernel's epilogue:
//   step_finish.
// Every sum has a fixed order whichever block finishes, so a replay is
// bit-equal; there are no float atomics.
//
// The FFTs are Stockham radix-4 (one radix-2 stage when log2 b is odd) over
// b complex points, with the real-to-complex post-twiddle (forward) and
// pre-twiddle (inverse) from the twiddle table tw[m] = (cos, sin)(2 pi m / 2b),
// built in float64 on the host; B4 (b4_stream.cu) runs the same transforms
// and twiddles in its own launches.  Each runs on
// its own team of b/4 threads (one warp at b <= 128) that synchronise only
// among themselves; a block-wide barrier a stage, with every other warp of
// the block working out the stage's indices too, cost ~0.9 us a stage at
// b = 128 on an H100.  The rest of a step's latency is a chain of dependent
// global round trips, so each phase issues all its global loads before it
// waits on any of them, and the epilogue loads its inputs before the finish.
#pragma once

#include "fdl_common.cuh"

namespace fdl {

constexpr int kStepMaxThreads = 1024;
constexpr int kStepMaxGroups = 8;
// Ring rows a MAC thread loads in one round trip (1 + NT loads each): at
// the flagship N = 3750 a thread has 5 rows (29 a block over 6 row groups).
constexpr int kRowsPerTrip = 6;
// Partial slots a finishing thread loads in one round trip: 16 loads a
// thread, NT a slot (16 slots at NT = 1, 8 at NT = 2).
template <int NT>
constexpr int kSlotsPerTrip = 16 / NT;

// A step block, launched as blockDim (lanes, groups) so that no thread works
// out its lane or row group by division: `lanes` threads a row group (one a
// bin; whole warps, at most 512, looping over the bins past that), `groups`
// row groups.
struct StepShape {
  int lanes, groups;
};

inline StepShape step_shape(int b) {
  int lanes = (b + 1 + 31) / 32 * 32;
  if (lanes > 512) lanes = 512;
  int groups = kStepMaxThreads / lanes;
  if (groups > kStepMaxGroups) groups = kStepMaxGroups;
  return {lanes, groups};
}

// Dynamic shared memory of a step launch: the largest of the MAC's group
// sums, block 0's table and FFT buffers, and the finishing block's table,
// run sums and NT pairs of FFT buffers.
inline size_t step_smem(int b, int nt) {
  const StepShape s = step_shape(b);
  const size_t mac = static_cast<size_t>(s.groups) * nt * s.lanes;
  const size_t fwd = 4 * static_cast<size_t>(b);
  const size_t fin = 2 * static_cast<size_t>(b) + static_cast<size_t>(s.groups) * nt * (b + 1) +
                     2 * static_cast<size_t>(nt) * b;
  size_t most = mac > fwd ? mac : fwd;
  if (fin > most) most = fin;
  return most * sizeof(float2);
}

template <int NT, typename T = float2>
struct StepArgs {
  const float* x;         // f32[b], the new input block
  T* seg;                 // [n, b+1] ring of T; row cur is written
  Tables<NT, T> ir;       // NT tables [n, b+1] of T
  const float2* tw;       // f32[2b, 2] twiddle table
  float2* partial;        // c64[NT, 1 + G, b+1] scratch
  unsigned int* ticket;   // the state's counter, 0 between steps
  int n, b, cur, rows;    // ring rows, block size, ring head, rows a MAC block
  int runs, run;          // the finisher's runs of partial slots, and their length (launch_step)
};

// The thread's index in its block, and the block's thread count.
__device__ __forceinline__ int step_tid() { return threadIdx.y * blockDim.x + threadIdx.x; }
__device__ __forceinline__ int step_threads() { return blockDim.x * blockDim.y; }

__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}

// Threads a transform of n points: n/4 (one radix-4 butterfly each), at
// least a warp, at most 512.
__host__ __device__ __forceinline__ int fft_team(int n) {
  const int t = n / 4;
  return t < 32 ? 32 : (t > 512 ? 512 : t);
}

// Synchronise the fft_team(n) threads of one transform: the warp itself, or
// named barrier `id` (1, 2, ...; 0 is __syncthreads) over the team's warps.
__device__ __forceinline__ void team_sync(int team, int id) {
  if (team == 32) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(team) : "memory");
  }
}

// `count` Stockham FFTs of n points (a power of two), stored side by side
// in a; bb is scratch of the same size.  Transform t runs on threads
// [t team, (t+1) team), team = fft_team(n), synchronised among themselves
// only, so the block's other warps do no work; every thread of the block
// calls it, and it ends with __syncthreads.  Returns the buffer that holds
// the result.
template <bool kInverse>
__device__ float2* fft_shared(float2* a, float2* bb, int n, int count, const float2* tw) {
  const int team = fft_team(n), tid = step_tid();
  const int t = tid >> (__ffs(team) - 1);
  const int log_n = __ffs(n) - 1;
  if (t < count) {
    const int lane = tid & (team - 1);
    const float2* src = a + t * n;
    float2* dst = bb + t * n;
    for (int log_ns = 0; log_ns < log_n;) {
      const int log_r = log_n - log_ns >= 2 ? 2 : 1;
      const int ns = 1 << log_ns;
      const int quarter = n >> log_r;
      const int shift = log_n + 1 - log_ns - log_r;  // twiddle step 2n / (ns r)
      for (int j = lane; j < quarter; j += team) {
        const int k = j & (ns - 1);
        const int d0 = ((j - k) << log_r) + k;
        if (log_r == 2) {
          float2 w1 = tw[k << shift], w2 = tw[(2 * k) << shift], w3 = tw[(3 * k) << shift];
          if (!kInverse) {
            w1.y = -w1.y;
            w2.y = -w2.y;
            w3.y = -w3.y;
          }
          const float2 v0 = src[j];
          const float2 v1 = cmul(src[j + quarter], w1);
          const float2 v2 = cmul(src[j + 2 * quarter], w2);
          const float2 v3 = cmul(src[j + 3 * quarter], w3);
          const float2 a0 = make_float2(v0.x + v2.x, v0.y + v2.y);
          const float2 a1 = make_float2(v0.x - v2.x, v0.y - v2.y);
          const float2 a2 = make_float2(v1.x + v3.x, v1.y + v3.y);
          const float2 dd = make_float2(v1.x - v3.x, v1.y - v3.y);
          // dd * (-i) forward, dd * (+i) inverse
          const float2 a3 = kInverse ? make_float2(-dd.y, dd.x) : make_float2(dd.y, -dd.x);
          dst[d0] = make_float2(a0.x + a2.x, a0.y + a2.y);
          dst[d0 + ns] = make_float2(a1.x + a3.x, a1.y + a3.y);
          dst[d0 + 2 * ns] = make_float2(a0.x - a2.x, a0.y - a2.y);
          dst[d0 + 3 * ns] = make_float2(a1.x - a3.x, a1.y - a3.y);
        } else {
          float2 w1 = tw[k << shift];
          if (!kInverse) w1.y = -w1.y;
          const float2 v0 = src[j];
          const float2 v1 = cmul(src[j + quarter], w1);
          dst[d0] = make_float2(v0.x + v1.x, v0.y + v1.y);
          dst[d0 + ns] = make_float2(v0.x - v1.x, v0.y - v1.y);
        }
      }
      team_sync(team, 1 + t);
      float2* tmp = const_cast<float2*>(src);
      src = dst;
      dst = tmp;
      log_ns += log_r;
    }
  }
  __syncthreads();
  return ((log_n + 1) / 2) % 2 == 0 ? a : bb;  // one buffer swap a stage
}

// Post-twiddle of the forward real transform: bin k (0..b) of the rFFT of 2b
// real samples, of which z is the b-point FFT of the packed pairs
// (x[2m], x[2m+1]).  tws: the twiddle table (cos, sin)(2 pi m / 2b).
__device__ __forceinline__ float2 real_post_twiddle(const float2* z, const float2* tws, int b,
                                                    int k) {
  const float2 zk = z[k & (b - 1)];
  const float2 zm = z[(b - k) & (b - 1)];  // conj(zm) pairs with zk
  const float2 e = make_float2(0.5f * (zk.x + zm.x), 0.5f * (zk.y - zm.y));
  const float2 o = make_float2(0.5f * (zk.y + zm.y), -0.5f * (zk.x - zm.x));
  const float2 w = make_float2(tws[k].x, -tws[k].y);  // exp(-2 pi i k / 2b)
  const float2 wo = cmul(o, w);
  return make_float2(e.x + wo.x, e.y + wo.y);
}

// Pre-twiddle of the inverse real transform: element k (0..b-1) of the
// b-point input whose inverse FFT holds the 2b real samples (unscaled) of
// the spectrum x[0..b] as pairs: Z[k] = (X[k] + conj X[b-k]) + i (X[k] -
// conj X[b-k]) exp(2 pi i k / 2b), with the imaginary parts of DC and
// Nyquist not read, as in a C2R transform.
__device__ __forceinline__ float2 real_pre_twiddle(const float2* x, const float2* tws, int b,
                                                   int k) {
  float2 xk = x[k];
  float2 xm = x[b - k];
  if (k == 0) xk.y = xm.y = 0.f;
  const float2 s = make_float2(xk.x + xm.x, xk.y - xm.y);
  const float2 p = cmul(make_float2(xk.x - xm.x, xk.y + xm.y), tws[k]);
  return make_float2(s.x - p.y, s.y + p.x);
}

// Global loads a thread stages into shared memory: the twiddle table (2b
// entries) over at least 1024 threads at b = 2048 is 4 a thread.
constexpr int kTwPerThread = 4;

// Load this thread's share of the twiddle table into registers; store it
// with store_tw once the phase's other loads are issued.
__device__ __forceinline__ void load_tw(const float2* tw, int b, float2 (&v)[kTwPerThread]) {
#pragma unroll
  for (int c = 0; c < kTwPerThread; ++c) {
    const int i = step_tid() + c * step_threads();
    if (i < 2 * b) v[c] = __ldg(tw + i);
  }
}

__device__ __forceinline__ void store_tw(float2* tws, int b, const float2 (&v)[kTwPerThread]) {
#pragma unroll
  for (int c = 0; c < kTwPerThread; ++c) {
    const int i = step_tid() + c * step_threads();
    if (i < 2 * b) tws[i] = v[c];
  }
}

// Block 0: X = rFFT of x zero-padded to 2b (b + 1 bins) through a b-point
// complex FFT of the packed pairs (x[2m], x[2m+1]) and the post-twiddle;
// X goes into ring row cur (rounded to T) and, unrounded, times table row
// 0 into partial slot 0.  Its global loads are issued before its first
// shared store.
template <int NT, typename T>
__device__ void step_fresh(const StepArgs<NT, T>& a, int nparts, float2* sm) {
  const int b = a.b, nb = b + 1, tid = step_tid(), threads = step_threads();
  float2* tws = sm;
  float2* za = tws + 2 * b;
  float2* zb = za + b;
  float2 twv[kTwPerThread];
  load_tw(a.tw, b, twv);
  const int pairs = (b + 1) / 2;  // z[m] for m >= pairs is zero padding
  float2 xv = make_float2(0.f, 0.f);
  if (tid < pairs) xv = make_float2(a.x[2 * tid], 2 * tid + 1 < b ? a.x[2 * tid + 1] : 0.f);
  float2 h0[NT];  // table row 0 at bin tid, for block 0's partial
#pragma unroll
  for (int t = 0; t < NT; ++t) h0[t] = tid < nb ? ldg_c(a.ir.p[t] + tid) : make_float2(0.f, 0.f);
  store_tw(tws, b, twv);
  for (int m = tid; m < b; m += threads) za[m] = m < pairs ? xv : make_float2(0.f, 0.f);
  __syncthreads();
  const float2* z = fft_shared<false>(za, zb, b, 1, tws);
  for (int k = tid; k < nb; k += threads) {
    const float2 spec = real_post_twiddle(z, tws, b, k);
    store_c(a.seg + static_cast<size_t>(a.cur) * nb + k, spec);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      float2 acc = make_float2(0.f, 0.f);
      cmac(acc, spec, k == tid ? h0[t] : ldg_c(a.ir.p[t] + k));
      a.partial[static_cast<size_t>(t) * nparts * nb + k] = acc;
    }
  }
}

// Blocks 1..G: the MAC over ring rows i in [(blk-1) rows, blk rows) of the
// n-1 rows other than cur (row j = i, or i + 1 past cur), each against table
// row (j - cur) mod n; the partial of block blk goes into slot blk.
template <int NT, typename T>
__device__ void step_mac(const StepArgs<NT, T>& a, int nparts, float2* red) {
  const int nb = a.b + 1, n = a.n, cur = a.cur, lanes = blockDim.x, groups = blockDim.y;
  const int lane = threadIdx.x, g = threadIdx.y;
  const int blk = blockIdx.x;
  const int i0 = (blk - 1) * a.rows;
  const int i1 = min(i0 + a.rows, n - 1);
  for (int k0 = 0; k0 < nb; k0 += lanes) {
    const int k = k0 + lane;
    float2 acc[NT];
#pragma unroll
    for (int t = 0; t < NT; ++t) acc[t] = make_float2(0.f, 0.f);
    if (k < nb) {
      // kRowsPerTrip rows a round trip (the row index clamped into the
      // block's rows, the MACs past them skipped)
      for (int i = i0 + g; i < i1; i += kRowsPerTrip * groups) {
        float2 s[kRowsPerTrip], h[kRowsPerTrip][NT];
#pragma unroll
        for (int u = 0; u < kRowsPerTrip; ++u) {
          const int ii = min(i + u * groups, i1 - 1);
          const int j = ii < cur ? ii : ii + 1;
          const int r = j > cur ? j - cur : j - cur + n;
          s[u] = load_c(a.seg + static_cast<size_t>(j) * nb + k);
#pragma unroll
          for (int t = 0; t < NT; ++t) h[u][t] = ldg_c(a.ir.p[t] + static_cast<size_t>(r) * nb + k);
        }
#pragma unroll
        for (int u = 0; u < kRowsPerTrip; ++u) {
          if (i + u * groups < i1) {
#pragma unroll
            for (int t = 0; t < NT; ++t) cmac(acc[t], s[u], h[u][t]);
          }
        }
      }
    }
#pragma unroll
    for (int t = 0; t < NT; ++t) red[(g * NT + t) * lanes + lane] = acc[t];
    __syncthreads();
    if (g == 0 && k < nb) {
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        float2 sum = red[t * lanes + lane];
        for (int gg = 1; gg < groups; ++gg) {
          const float2 v = red[(gg * NT + t) * lanes + lane];
          sum.x += v.x;
          sum.y += v.y;
        }
        a.partial[(static_cast<size_t>(t) * nparts + blk) * nb + k] = sum;
      }
    }
    __syncthreads();
  }
}

// True in the block that arrives last.  After the barrier, thread 0 takes
// the ticket with one acquire-release increment at device scope (the
// release covers the partials every thread of the block stored before the
// barrier; the acquire, the partials of the blocks that arrived earlier):
// a fence a thread around atomicInc costs 0.6 us more at B2's shape on an
// H100.  The increment wraps the counter to 0 in the last block, ready for
// the next step.
__device__ __forceinline__ bool last_to_arrive(unsigned int* ticket) {
  __shared__ unsigned int last;
  __syncthreads();
  if (step_tid() == 0) {
    unsigned int old;
    asm volatile("atom.acq_rel.gpu.global.inc.u32 %0, [%1], %2;"
                 : "=r"(old)
                 : "l"(ticket), "r"(gridDim.x - 1)
                 : "memory");
    last = old == gridDim.x - 1;
  }
  __syncthreads();
  return last != 0;
}

// The step up to the reduction: block 0's fresh spectrum or a MAC block's
// rows, then the ticket.  True in the block that arrives last (uniform
// across a block), which goes on with step_finish.
template <int NT, typename T>
__device__ bool step_arrive(const StepArgs<NT, T>& a, float2* sm) {
  if (blockIdx.x == 0) {
    step_fresh(a, gridDim.x, sm);
  } else {
    step_mac(a, gridDim.x, sm);
  }
  return last_to_arrive(a.ticket);
}

// The finishing block: conv_t[k] = sum over slots 0..nparts-1, in order, of
// partial[t][slot][k]; then the NT inverse rFFTs of 2b points, side by side.
// Returns the samples, unscaled by 1/(2b): transform t's 2b samples start at
// 2b t (the complex result z[m] holds samples 2m and 2m+1).
//
// The reduction keeps the MAC's thread mapping: lane = bin, for every table,
// and row group g < a.runs sums run g of the slots, in slot order; a
// fixed-order tree in shared memory then adds the runs.
template <int NT, typename T>
__device__ const float* step_finish(const StepArgs<NT, T>& a, float2* sm) {
  const int b = a.b, nb = b + 1, tid = step_tid(), nparts = gridDim.x;
  const int lanes = blockDim.x, lane = threadIdx.x, g = threadIdx.y;
  const int runs = a.runs, run = a.run;
  constexpr int kSlots = kSlotsPerTrip<NT>;
  float2* tws = sm;
  float2* red = tws + 2 * b;          // [runs][NT][nb]
  float2* za = red + blockDim.y * NT * nb;
  float2* zb = za + NT * b;
  float2 twv[kTwPerThread];
  load_tw(a.tw, b, twv);

  const int s0 = g * run, s1 = min(s0 + run, nparts);
  for (int k0 = 0; k0 < nb; k0 += lanes) {
    const int k = k0 + lane;
    if (k < nb && g < runs) {
      float2 sum[NT];
#pragma unroll
      for (int t = 0; t < NT; ++t) sum[t] = make_float2(0.f, 0.f);
      for (int s = s0; s < s1; s += kSlots) {
        // the slot clamped into the run, the adds past its end skipped
        float2 v[kSlots][NT];
#pragma unroll
        for (int u = 0; u < kSlots; ++u) {
          const size_t slot = min(s + u, s1 - 1);
#pragma unroll
          for (int t = 0; t < NT; ++t)
            v[u][t] = __ldcg(a.partial + (static_cast<size_t>(t) * nparts + slot) * nb + k);
        }
#pragma unroll
        for (int u = 0; u < kSlots; ++u) {
          if (s + u < s1) {
#pragma unroll
            for (int t = 0; t < NT; ++t) {
              sum[t].x += v[u][t].x;
              sum[t].y += v[u][t].y;
            }
          }
        }
      }
#pragma unroll
      for (int t = 0; t < NT; ++t) red[(g * NT + t) * nb + k] = sum[t];
    }
  }
  store_tw(tws, b, twv);
  __syncthreads();
  // fixed-order tree over the runs: run g takes in run g + w
  for (int w = 1; w < runs; w *= 2) {
    if (g < runs && (g & (2 * w - 1)) == 0 && g + w < runs) {
      for (int k = lane; k < nb; k += lanes) {
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          float2& dst = red[(g * NT + t) * nb + k];
          const float2 src = red[((g + w) * NT + t) * nb + k];
          dst.x += src.x;
          dst.y += src.y;
        }
      }
    }
    __syncthreads();
  }

  const int log_b = __ffs(b) - 1;
  for (int idx = tid; idx < NT * b; idx += step_threads()) {
    const int t = idx >> log_b, k = idx & (b - 1);
    za[idx] = real_pre_twiddle(red + t * nb, tws, b, k);
  }
  __syncthreads();
  return reinterpret_cast<const float*>(fft_shared<true>(za, zb, b, NT, tws));
}

// Samples of the epilogue a thread handles: b <= 2048 over at least 1024
// threads at b = 2048 (step_shape), so at most 2.
constexpr int kEpiloguePerThread = 2;

// Launch 1 + grid blocks of `kernel`, shaped (lanes, groups), with the
// step's shared memory (opted in past 48 KB); sets the finisher's runs: the
// fewest that take each run's slots in one round trip, at most one a row
// group.  Returns cudaGetLastError().
template <int NT, typename T, typename K, typename... Args>
inline cudaError_t launch_step(K kernel, StepArgs<NT, T> a, int grid, cudaStream_t s,
                               Args... args) {
  const StepShape sh = step_shape(a.b);
  const int nparts = 1 + grid;
  const int runs = (nparts + kSlotsPerTrip<NT> - 1) / kSlotsPerTrip<NT>;
  a.runs = runs < sh.groups ? runs : sh.groups;
  a.run = (nparts + a.runs - 1) / a.runs;
  const size_t smem = step_smem(a.b, NT);
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<1 + grid, dim3(sh.lanes, sh.groups), smem, s>>>(a, args...);
  return cudaGetLastError();
}

}  // namespace fdl
