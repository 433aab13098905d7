// Kernel B7: the reverb farm's big-tail transforms, T tail rows of V voices
// a call, in two launches around kernel B5.
//
// Replaces no TPU kernel.  The JAX package runs these transforms as jnp
// around its Pallas B5 (fft_convolution_tpu/parallel/farm2.py:666,
// _tail_corr_phased_fused: rdft_block of the rows, irdft_block, the
// overlap-add); the port ran them on cuFFT and torch, some ten passes over
// HBM a call (the rows' copy, the zero pad, r2c, c2r's input copy, c2r, the
// 1/n scaling, the cat, the add, the overlap's copy).
//
// - b7_tail_fwd: tail row (t, v) is the p = tb / B head blocks of voice v in
//   period t, read straight from the call's blocks [T p, V, B]:
//       specs[t][v][k] = sum_{n < tb} x[n] exp(-2 pi i n k / 2tb),  k = 0..tb,
//   the rDFT of the row zero-padded to 2tb, written [T, V, tb+1] complex64
//   (the layout B5 takes).  The zero half is never stored or loaded.
// - b7_tail_inv: voice v, rows t = 0..T-1 in order, out_t = irfft(convs[t][v],
//   2tb) (1/2tb; the imaginary parts of DC and Nyquist not read, as in a C2R
//   transform):
//       y[t][v] = out_t[:tb] + carry,  carry <- out_t[tb:],
//   carry starting from overlap[v] and written back there after the last row
//   (in place).  y is [T, V, tb] float32, the layout B6's delay line reads.
//
// What bounds it on an H100: bytes.  At the farm's shape (tb = 32768, T = 8,
// 1024 voices) the compulsory traffic is 1.07 GB of samples in and 2.15 GB
// of spectra out (forward), 2.15 GB of spectra in, 1.07 GB of y out and 0.27
// GB of overlap (inverse): 6.71 GB, 2.00 ms at 3.35 TB/s; the transforms'
// 43 GFLOP take 0.64 ms at the FP32 peak.
//
// Design.  A row's transform is a complex FFT of N = tb points over the
// sample pairs (x[2m], x[2m+1]) with the real post-twiddle after it
// (forward) or the pre-twiddle before it (inverse), as B6's block
// transforms.  At tb = 32768 that is 256 KB of points, more than a thread
// block's shared memory, so a row goes to a thread block cluster of R =
// max(2, tb / 16384) CTAs, each holding an M = N / R point FFT in registers
// and one padded exchange buffer:
// - forward, decimation in frequency, two rows a cluster: CTA r reads the
//   row's tb samples straight from the blocks (the cluster's other CTAs
//   find them in L2) and forms y_r[m] = W_N^{m r} sum_{j < R/2} z[m + M j]
//   W_R^{j r}, the first radix-R stage with its zero upper half left out
//   (at R = 2 a twiddle); its M-point FFT gives Z[R k + r].  It writes the
//   bins k = r mod R, each from Z[k] and Z[N - k]: at R = 2 both lie in its
//   own shared memory, so the cluster exchanges nothing (at R > 2 Z[N - k]
//   is read from CTA (R - r) mod R).  The second row's samples load while
//   the first row's bins are written.
// - inverse, decimation in frequency, one cluster a voice walking its T
//   rows: CTA s computes the output pairs z[R m + s], the inverse M-point
//   FFT of u_s[k] = exp(2 pi i s k / N) sum_{j < R} Z[k + j M] exp(2 pi i j s
//   / R), each Z from a bin and its mirror with the pre-twiddle.  The bins k
//   + j M and M - k + j M serve both u_s[k] and u_s[M - k], so the thread
//   holding point k < M/2 loads them once, straight into its FFT's
//   registers, and leaves u_s[M - k] in shared memory for that point's
//   owner.  Outputs m < M/2 lie in the row's first half and go to y with the
//   carry added; m >= M/2 lie in its second half, the next row's carry, kept
//   by the same thread in shared memory.  The overlap is read and written
//   once a call and no second half goes to HBM; the cluster exchanges
//   nothing (it keeps the CTAs that read a row on the card together, so the
//   row's second read comes from L2).
// - the CTA's FFT: a Stockham FFT of radix-16 stages and one last stage of
//   radix 2 to 8, 16 points a thread (two sets of 16 at M = 16384, 512
//   threads), an exchange through padded shared memory between stages.
//   Twiddles come from a two-level table in shared memory (W^i as the
//   product of two correctly rounded entries, 4 KB at tb = 32768); a
//   stage's 15 twiddles are powers of two entries, at most three products
//   away.  The butterflies are fft16.cuh's, which B6 shares.
// - what the design avoids, measured on the way (NVIDIA H100 80GB HBM3, 700
//   W, 1024 voices, T = 8): twiddles read from the 2tb-entry table in L2
//   took 1.1 ms of the forward's 3.7; sending each CTA's share of a row to
//   its owner through distributed shared memory, so that every global
//   access is contiguous, cost 1.0 ms (forward) and 2.0 ms (inverse) of
//   remote stores; walking rows on as many clusters as the card holds
//   instead of two rows a cluster was 65 % slower; clusters of four CTAs of
//   8192 points, two CTAs an SM, were 2.0x (forward) and 1.15x (inverse)
//   slower, each CTA reading every sector of a row; decimation in time for
//   the inverse, with its last butterfly across the cluster, was 8 % slower.
//   What is left is the memory path: without its FFT the forward takes 2.2
//   of its 2.4 ms, and the bins' interleaved stores (each CTA writes every
//   R-th bin) 0.35 ms of that.
// Every sum has a fixed order and there are no atomics, so a replay is
// bit-equal.  FP32 FMA only: no TF32, no library transform.
#include <climits>

#include <cooperative_groups.h>

#include "fdl_step.cuh"
#include "fft16.cuh"

namespace cg = cooperative_groups;

namespace {

using fdl::dft;
using fdl::pad16;
using fdl::padded16;
using fdl::twiddled;

constexpr int kMaxSmem = 232448;  // dynamic shared memory a thread block may opt into
constexpr int kMinLogTb = 6;      // tail blocks of 64 ..
constexpr int kMaxLogTb = 17;     // .. 131072 samples
// Forward rows a cluster: the second row's samples load while the first
// row's bins are written.  Two read 9 % faster than one at the farm's shape
// and four or eight slower (the last clusters run alone; NVIDIA H100 80GB
// HBM3, 700 W).
constexpr int kRowsPerCluster = 2;

// A CTA's FFT of M = 2^LOG points (5 <= LOG <= 14): kV virtual threads of 16
// points, point vj + q kV in register q of virtual thread vj; kActive
// threads hold kSets virtual threads each (vj = j + u kActive); the block
// has at least a warp.  LOG / 4 radix-16 stages, then one of radix kRL.
template <int LOG>
struct Sub {
  static constexpr int kM = 1 << LOG;
  static constexpr int kV = kM / 16;
  static constexpr int kSets = kV > 512 ? kV / 512 : 1;
  static constexpr int kActive = kV / kSets;
  static constexpr int kThreads = kActive < 32 ? 32 : kActive;
  static constexpr int kR16 = LOG / 4;
  static constexpr int kRL = 1 << (LOG % 4);
  static constexpr int kLo = 16 / kRL;
};

template <int R>
__host__ __device__ constexpr int log2_of() {
  return R == 2 ? 1 : R == 4 ? 2 : 3;
}

// The shapes of a row's transform: N = M R points over a cluster of R CTAs.
// Twiddles are powers of W = exp(2 pi i / 2N), kept in shared memory as a
// two-level table: W^i = hi[i >> kLoBits] lo[i & (2^kLoBits - 1)], a
// product of two correctly rounded entries (2^kLoBits + 2^kHiBits of the
// 2N a full table would hold: 4 KB at N = 32768).
template <int LOG, int R>
struct Row {
  using S = Sub<LOG>;
  static constexpr int kM = S::kM, kN = kM * R, kLogR = log2_of<R>();
  static constexpr int kLog2N = LOG + kLogR + 1;
  static constexpr int kLoBits = (kLog2N + 1) / 2, kHiBits = kLog2N - kLoBits;
  static constexpr int kLo = padded16(1 << kLoBits);  // the lo entries, padded as buf
  static constexpr int kTable = kLo + padded16(1 << kHiBits);
  static constexpr int kPad = padded16(kM);
};

// W^i from the two-level table (lo at tab, hi after it), each half padded
// one entry in seventeen: the strides the transforms read at (multiples of
// 2, 4 and 16 entries) then spread over the banks.
template <int LOG, int R>
__device__ __forceinline__ float2 twz(const float2* tab, int i) {
  using W = Row<LOG, R>;
  return fdl::cmul(tab[W::kLo + pad16(i >> W::kLoBits)], tab[pad16(i & ((1 << W::kLoBits) - 1))]);
}

// v[q] <- v[q] w^q (w conjugated for the forward), q = 1..15, from w1 = w
// and w4 = w^4: each power at most three products from the two, made as it
// is used, so that few are live at once.
template <bool kInverse>
__device__ __forceinline__ void twiddle16(float2 (&v)[16], float2 w1, float2 w4) {
  const float2 w2 = fdl::cmul(w1, w1), w3 = fdl::cmul(w2, w1);
  v[1] = twiddled<kInverse>(v[1], w1);
  v[2] = twiddled<kInverse>(v[2], w2);
  v[3] = twiddled<kInverse>(v[3], w3);
  float2 b = w4;  // w^4, w^8, w^12
#pragma unroll
  for (int h = 4; h < 16; h += 4) {
    v[h] = twiddled<kInverse>(v[h], b);
    v[h + 1] = twiddled<kInverse>(v[h + 1], fdl::cmul(b, w1));
    v[h + 2] = twiddled<kInverse>(v[h + 2], fdl::cmul(b, w2));
    v[h + 3] = twiddled<kInverse>(v[h + 3], fdl::cmul(b, w3));
    if (h < 12) b = fdl::cmul(b, w4);
  }
}

// The FFT on v, unnormalised, the inverse with the + sign; the output lands
// in natural order in the same registers.  buf: padded16(M) float2 of shared
// memory, one exchange buffer (two barriers an exchange); tab: the row's
// twiddle table (struct Row): a stage's twiddles are powers of one or two
// of its entries (twiddle16).  Every thread of the block calls it.
template <int LOG, int R, bool kInverse>
__device__ __forceinline__ void sub_fft(float2 (&v)[Sub<LOG>::kSets][16], float2* buf,
                                        const float2* tab, int j) {
  using S = Sub<LOG>;
  constexpr int M = S::kM, P = S::kV, A = S::kActive, RL = S::kRL, LO = S::kLo;
  constexpr int N2 = 2 * M * R;  // the table's root: W = exp(2 pi i / N2)
  const bool act = j < A;
#pragma unroll
  for (int s = 0; s < S::kR16; ++s) {
    const int ns = 1 << (4 * s);
    if (act) {
#pragma unroll
      for (int u = 0; u < S::kSets; ++u) {
        if (s > 0) {
          // W_{16 ns}^{q k} = W^{q k N2 / (16 ns)}
          const int k = (j + u * A) & (ns - 1), i1 = k * (N2 / (16 * ns));
          twiddle16<kInverse>(v[u], twz<LOG, R>(tab, i1), twz<LOG, R>(tab, 4 * i1));
        }
        dft<16, kInverse>(v[u]);
      }
    }
    if (s < S::kR16 - 1 || RL > 1) {  // the last radix-16 stage leaves its points in place
      if (act) {
#pragma unroll
        for (int u = 0; u < S::kSets; ++u) {
          const int vj = j + u * A, k = vj & (ns - 1), d0 = ((vj - k) << 4) + k;
#pragma unroll
          for (int q = 0; q < 16; ++q) buf[pad16(d0 + q * ns)] = v[u][q];
        }
      }
      __syncthreads();
      if (act) {
#pragma unroll
        for (int u = 0; u < S::kSets; ++u)
#pragma unroll
          for (int q = 0; q < 16; ++q) v[u][q] = buf[pad16(j + u * A + q * P)];
      }
      __syncthreads();
    }
  }
  if constexpr (RL > 1) {
    // ns = M / RL: butterfly b = vj + l P holds the thread's points l + LO q,
    // twiddles W_M^{q b} = W^{q b N2 / M}
    if (act) {
#pragma unroll
      for (int u = 0; u < S::kSets; ++u) {
        const int vj = j + u * A;
#pragma unroll
        for (int l = 0; l < LO; ++l) {
          const int i1 = (vj + l * P) * (N2 / M);
          float2 p[RL];
          p[1] = twz<LOG, R>(tab, i1);
          if constexpr (RL > 2) {
            p[2] = fdl::cmul(p[1], p[1]);
            p[3] = fdl::cmul(p[2], p[1]);
          }
          if constexpr (RL > 4) {
            p[4] = twz<LOG, R>(tab, 4 * i1);
            p[5] = fdl::cmul(p[4], p[1]);
            p[6] = fdl::cmul(p[4], p[2]);
            p[7] = fdl::cmul(p[4], p[3]);
          }
          float2 t[RL];
#pragma unroll
          for (int q = 0; q < RL; ++q)
            t[q] = q == 0 ? v[u][l] : twiddled<kInverse>(v[u][l + LO * q], p[q]);
          dft<RL, kInverse>(t);
#pragma unroll
          for (int q = 0; q < RL; ++q) v[u][l + LO * q] = t[q];
        }
      }
    }
  }
}

// The CTA's two-level twiddle table from the full one (tw: W^i, i < N2).
template <int LOG, int R>
__device__ __forceinline__ void load_table(float2* tab, const float2* __restrict__ tw, int j) {
  using W = Row<LOG, R>;
  constexpr int kLoN = 1 << W::kLoBits, kN = kLoN + (1 << W::kHiBits);
  for (int i = j; i < kN; i += Sub<LOG>::kThreads) {
    if (i < kLoN) {
      tab[pad16(i)] = __ldg(tw + i);
    } else {
      tab[W::kLo + pad16(i - kLoN)] = __ldg(tw + ((i - kLoN) << W::kLoBits));
    }
  }
  __syncthreads();
}

struct FwdArgs {
  const float* x;    // f32 [T p, V, B]: the call's blocks
  const float2* tw;  // (cos, sin)(2 pi m / 2tb), m < 2tb
  float2* specs;     // c64 [T, V, tb+1] out
  int voices, rows, log_b, log_p;  // rows: T V
};

// Clusters of R CTAs, each walking kRowsPerCluster consecutive tail rows
// (row t V + v).  CTA r reads a row's samples (the cluster's other CTAs
// read them from L2), forms y_r and transforms it into Z[R k + r], then
// writes the bins k = r mod R, each from Z[k] and Z[N - k]: at R = 2 both
// lie in its own shared memory, at R > 2 Z[N - k] lies in CTA (R - r) mod
// R.  The next row's samples are loaded while the bins are written.
template <int LOG, int R>
__global__ void __launch_bounds__(Sub<LOG>::kThreads, 1) b7_tail_fwd(const FwdArgs a) {
  using S = Sub<LOG>;
  using W = Row<LOG, R>;
  constexpr int M = S::kM, P = S::kV, A = S::kActive, T = S::kThreads, N = W::kN;
  constexpr int LOG_R = W::kLogR, N2 = 2 * N;
  extern __shared__ float4 smem[];
  float2* buf = reinterpret_cast<float2*>(smem);  // [padded16(M)]
  float2* tab = buf + W::kPad;                     // [kTable]
  cg::cluster_group cl = cg::this_cluster();
  const int r = static_cast<int>(cl.block_rank());
  const int row0 = blockIdx.x / R * kRowsPerCluster;
  const int row_end = row0 + kRowsPerCluster < a.rows ? row0 + kRowsPerCluster : a.rows;
  const int j = threadIdx.x;
  load_table<LOG, R>(tab, a.tw, j);
  // sample pair i of a row lies at head block 2i / B of the row's period
  const size_t stride = static_cast<size_t>(a.voices) << a.log_b;
  const int bmask = (1 << a.log_b) - 1;
  auto row_base = [&](int row) {
    const int t = row / a.voices, v = row - t * a.voices;
    return a.x + (static_cast<size_t>(t) << a.log_p) * stride +
           (static_cast<size_t>(v) << a.log_b);
  };
  auto pair = [&](const float* base, int i) {
    const int n = 2 * i;
    return __ldg(reinterpret_cast<const float2*>(
        base + static_cast<size_t>(n >> a.log_b) * stride + (n & bmask)));
  };
  // the FFT's points, z[m] of the row first (a row ahead)
  float2 z[S::kSets][16];
  auto fetch = [&](int row) {
    const float* base = row_base(row);
    if (j < A) {
#pragma unroll
      for (int u = 0; u < S::kSets; ++u)
#pragma unroll
        for (int q = 0; q < 16; ++q) z[u][q] = pair(base, j + u * A + q * P);
    }
  };
  fetch(row0);
  for (int row = row0; row < row_end; ++row) {
    // y_r[m] = exp(-2 pi i m r / N) sum_{jj < R/2} z[m + M jj] exp(-2 pi i
    // jj r / R): the first radix-R stage, its upper half zero
    if (j < A) {
      const float* base = row_base(row);
#pragma unroll
      for (int jj = 1; jj < R / 2; ++jj) {
        const float2 w = twz<LOG, R>(tab, ((jj * r) & (R - 1)) * (N2 / R));
#pragma unroll
        for (int u = 0; u < S::kSets; ++u)
#pragma unroll
          for (int q = 0; q < 16; ++q) {
            const float2 p = twiddled<false>(pair(base, j + u * A + q * P + jj * M), w);
            z[u][q] = make_float2(z[u][q].x + p.x, z[u][q].y + p.y);
          }
      }
      if (r > 0) {
#pragma unroll
        for (int u = 0; u < S::kSets; ++u)
#pragma unroll
          for (int q = 0; q < 16; ++q)
            z[u][q] = twiddled<false>(z[u][q], twz<LOG, R>(tab, 2 * (j + u * A + q * P) * r));
      }
    }
    sub_fft<LOG, R, false>(z, buf, tab, j);
    if (j < A) {
#pragma unroll
      for (int u = 0; u < S::kSets; ++u)
#pragma unroll
        for (int q = 0; q < 16; ++q) buf[pad16(j + u * A + q * P)] = z[u][q];
    }
    if constexpr (R > 2) {
      cl.sync();
    } else {
      __syncthreads();
    }
    if (row + 1 < row_end) fetch(row + 1);  // in flight through the bins
    // bin k = R k' + r from Z[k] = buf[k'] and Z[N - k] (Z[i] lives in CTA i
    // mod R, slot i / R); a chunk's loads are all issued before its stores
    float2* out = a.specs + static_cast<size_t>(row) * (N + 1);
    auto load = [&](int k, float2& zk, float2& zm) {
      const int ka = k & (N - 1), kb = (N - k) & (N - 1);
      zk = buf[pad16(ka >> LOG_R)];
      if constexpr (R == 2) {
        zm = buf[pad16(kb >> LOG_R)];
      } else {
        zm = *cl.map_shared_rank(buf + pad16(kb >> LOG_R), kb & (R - 1));
      }
    };
    auto bin = [&](int k, float2 zk, float2 zm) {
      const float2 e = make_float2(0.5f * (zk.x + zm.x), 0.5f * (zk.y - zm.y));
      const float2 o = make_float2(0.5f * (zk.y + zm.y), -0.5f * (zk.x - zm.x));
      const float2 wo = twiddled<false>(o, twz<LOG, R>(tab, k));
      out[k] = make_float2(e.x + wo.x, e.y + wo.y);
    };
    constexpr int kPer = M / T, kChunk = kPer < 8 ? kPer : 8;
    for (int w0 = 0; w0 < kPer; w0 += kChunk) {
      float2 zk[kChunk], zm[kChunk];
#pragma unroll
      for (int w = 0; w < kChunk; ++w) load(R * (j + (w0 + w) * T) + r, zk[w], zm[w]);
#pragma unroll
      for (int w = 0; w < kChunk; ++w) bin(R * (j + (w0 + w) * T) + r, zk[w], zm[w]);
    }
    if (r == 0 && j == 0) {  // the Nyquist bin, from Z[0]
      const float2 z0 = buf[0];
      bin(N, z0, z0);
    }
    // every read of the buffers before the next row's transform writes them
    if constexpr (R > 2) {
      cl.sync();
    } else {
      __syncthreads();
    }
  }
}

struct InvArgs {
  const float2* convs;  // c64 [T, V, tb+1]
  const float2* tw;     // (cos, sin)(2 pi m / 2tb), m < 2tb
  float* y;             // f32 [T, V, tb] out
  float* overlap;       // f32 [V, tb]: the carry, in and out
  int voices, rows;
};

// Clusters of R CTAs, one a voice walking its T rows (the cluster only
// keeps the CTAs that read a row together on the card at once).  Decimation
// in frequency: CTA s computes the output pairs z[R m + s] as the inverse
// M-point FFT of u_s[k] = exp(2 pi i s k / N) sum_{j < R} Z[k + j M] exp(2 pi
// i j s / R).  The
// bins k + j M and M - k + j M (and their mirrors, the same 2R bins) give
// both u_s[k] and u_s[M - k], so the thread holding point k (k < M/2) loads
// them once and leaves u_s[M - k] in shared memory for the point's owner.
// Its outputs m < M/2 lie in the row's first half and go to y with the
// carry added; m >= M/2 lie in the second half, the next row's carry, which
// the same thread keeps (in shared memory).  No shared memory is read
// across the cluster, and the overlap is read and written once a call.
template <int LOG, int R>
__global__ void __launch_bounds__(Sub<LOG>::kThreads, 1) b7_tail_inv(const InvArgs a) {
  using S = Sub<LOG>;
  using W = Row<LOG, R>;
  constexpr int M = S::kM, P = S::kV, A = S::kActive, T = S::kThreads, N = W::kN;
  constexpr int N2 = 2 * N, H = 8;  // points q < H of a thread lie in m < M/2
  extern __shared__ float4 smem[];
  float2* buf = reinterpret_cast<float2*>(smem);  // [padded16(M)]
  float2* tab = buf + W::kPad;                     // [kTable]
  float2* carry = tab + W::kTable;                 // [kSets H][T]: the thread's carry pairs
  cg::cluster_group cl = cg::this_cluster();
  const int s = static_cast<int>(cl.block_rank());
  const int v = blockIdx.x / R;
  const int j = threadIdx.x;
  const float scale = 1.f / static_cast<float>(2 * N);
  load_table<LOG, R>(tab, a.tw, j);
  float2* ov = reinterpret_cast<float2*>(a.overlap + static_cast<size_t>(v) * N);
  if (j < A) {
#pragma unroll
    for (int u = 0; u < S::kSets; ++u)
#pragma unroll
      for (int q = 0; q < H; ++q) carry[(u * H + q) * T + j] = ov[R * (j + u * A + q * P) + s];
  }
  // Z[k] = (X[k] + conj X[N-k]) + i (X[k] - conj X[N-k]) W^k, w = W^k
  auto pre_w = [&](float2 xk, float2 xm, float2 w) {
    const float2 c = make_float2(xk.x + xm.x, xk.y - xm.y);
    const float2 p = fdl::cmul(make_float2(xk.x - xm.x, xk.y + xm.y), w);
    return make_float2(c.x - p.y, c.y + p.x);
  };
  auto pre = [&](float2 xk, float2 xm, int k) { return pre_w(xk, xm, twz<LOG, R>(tab, k)); };
  // u_s at index kk from Z[kk + j M] (j < R): the sum over j, then exp(2 pi i s kk / N)
  auto fold = [&](const float2 (&z)[R], int kk) {
    float2 acc = z[0];
#pragma unroll
    for (int jj = 1; jj < R; ++jj) {
      const float2 w = twz<LOG, R>(tab, ((jj * s) & (R - 1)) * (N2 / R));
      const float2 p = fdl::cmul(z[jj], w);
      acc = make_float2(acc.x + p.x, acc.y + p.y);
    }
    return s > 0 ? fdl::cmul(acc, twz<LOG, R>(tab, 2 * s * kk)) : acc;
  };

  for (int t = 0; t < a.rows; ++t) {
    const size_t row = static_cast<size_t>(t) * a.voices + v;
    const float2* x = a.convs + row * (N + 1);
    float2 z[S::kSets][16];
    if (j < A) {
#pragma unroll
      for (int u = 0; u < S::kSets; ++u) {
        // bins a_j = j M + k and b_j = j M + M - k of the points k < M/2 (k =
        // 0: b_{R-1} is the Nyquist bin N); at R = 2 a set's 32 loads are in
        // flight together, at R > 2 a point's
#pragma unroll
        for (int q = 0; q < H; ++q) {
          const int k = j + u * A + q * P;
          float2 xa[R], xb[R];
#pragma unroll
          for (int jj = 0; jj < R; ++jj) {
            xa[jj] = __ldg(x + jj * M + k);
            xb[jj] = __ldg(x + jj * M + M - k);
          }
          if (k == 0) xa[0].y = xb[R - 1].y = 0.f;  // DC and Nyquist: no imaginary part
          if constexpr (R == 2) {
            // every twiddle from w = W^k and c = W^{2k}: W^{M+k} = i w, W^{M-k} =
            // i conj(w), W^{N-k} = -conj(w), and W^{2(M-k)} = -conj(c)
            const float2 w = twz<LOG, R>(tab, k);
            const float2 za0 = pre_w(xa[0], xb[1], w);
            const float2 za1 = pre_w(xa[1], xb[0], make_float2(-w.y, w.x));
            const float2 zb0 = pre_w(xb[0], xa[1], make_float2(w.y, w.x));
            const float2 zb1 = pre_w(xb[1], xa[0], make_float2(-w.x, w.y));
            float2 ua = s ? make_float2(za0.x - za1.x, za0.y - za1.y)
                          : make_float2(za0.x + za1.x, za0.y + za1.y);
            float2 ub = s ? make_float2(zb0.x - zb1.x, zb0.y - zb1.y)
                          : make_float2(zb0.x + zb1.x, zb0.y + zb1.y);
            if (s) {
              const float2 c = twz<LOG, R>(tab, 2 * k);
              ua = fdl::cmul(ua, c);
              ub = fdl::cmul(ub, make_float2(-c.x, c.y));
            }
            z[u][q] = ua;
            if (k != 0) buf[pad16(M - k)] = ub;
          } else {
            float2 za[R], zb[R];
#pragma unroll
            for (int jj = 0; jj < R; ++jj) {
              za[jj] = pre(xa[jj], xb[R - 1 - jj], jj * M + k);
              zb[jj] = pre(xb[jj], xa[R - 1 - jj], (jj * M + M - k) & (N - 1));
            }
            z[u][q] = fold(za, k);
            if (k != 0) buf[pad16(M - k)] = fold(zb, M - k);
          }
          if constexpr (R > 2) asm volatile("" ::: "memory");
        }
        if constexpr (R == 2) asm volatile("" ::: "memory");  // the next set's loads after this set
      }
    }
    if (j == 0) {  // u_s[M/2], its own mirror, from the R bins j M + M/2
      float2 xc[R], zc[R];
#pragma unroll
      for (int jj = 0; jj < R; ++jj) xc[jj] = __ldg(x + jj * M + M / 2);
#pragma unroll
      for (int jj = 0; jj < R; ++jj) zc[jj] = pre(xc[jj], xc[R - 1 - jj], jj * M + M / 2);
      buf[pad16(M / 2)] = fold(zc, M / 2);
    }
    __syncthreads();
    if (j < A) {
#pragma unroll
      for (int u = 0; u < S::kSets; ++u)
#pragma unroll
        for (int q = H; q < 16; ++q) z[u][q] = buf[pad16(j + u * A + q * P)];
    }
    __syncthreads();  // every point read before the first exchange writes
    sub_fft<LOG, R, true>(z, buf, tab, j);
    // pair R m + s of the row: m < M/2 to y with the carry, m + M/2 the next carry
    if (j < A) {
      float2* yrow = reinterpret_cast<float2*>(a.y + row * N);
#pragma unroll
      for (int u = 0; u < S::kSets; ++u)
#pragma unroll
        for (int q = 0; q < H; ++q) {
          float2& cy = carry[(u * H + q) * T + j];
          const float2 lo = z[u][q], hi = z[u][q + H];
          yrow[R * (j + u * A + q * P) + s] =
              make_float2(fmaf(lo.x, scale, cy.x), fmaf(lo.y, scale, cy.y));
          cy = make_float2(hi.x * scale, hi.y * scale);
        }
    }
  }
  if (j < A) {
#pragma unroll
    for (int u = 0; u < S::kSets; ++u)
#pragma unroll
      for (int q = 0; q < H; ++q) ov[R * (j + u * A + q * P) + s] = carry[(u * H + q) * T + j];
  }
}

template <int LOG, int R>
constexpr size_t fwd_smem() {
  return static_cast<size_t>(Row<LOG, R>::kPad + Row<LOG, R>::kTable) * sizeof(float2);
}
template <int LOG, int R>
constexpr size_t inv_smem() {
  return fwd_smem<LOG, R>() +
         static_cast<size_t>(Sub<LOG>::kSets) * 8 * Sub<LOG>::kThreads * sizeof(float2);
}

// Launch `items` clusters of R CTAs.
template <int LOG, int R, typename Args>
cudaError_t launch(void (*kernel)(Args), const Args& args, int items, size_t smem,
                   cudaStream_t st) {
  static_assert(inv_smem<LOG, R>() <= kMaxSmem, "shared memory");
  cudaError_t e = fdl::allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = R;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(static_cast<unsigned>(items) * R);
  cfg.blockDim = dim3(Sub<LOG>::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, args);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <bool kInverse, int LOG, int R, typename Args>
cudaError_t launch_one(const Args& args, int items, cudaStream_t st) {
  if constexpr (kInverse) {
    return launch<LOG, R>(b7_tail_inv<LOG, R>, args, items, inv_smem<LOG, R>(), st);
  } else {
    return launch<LOG, R>(b7_tail_fwd<LOG, R>, args, items, fwd_smem<LOG, R>(), st);
  }
}

// The launch for tail block 2^log_tb: M = tb / 2 points a CTA in clusters of
// two up to tb = 32768, then M = 16384 in clusters of tb / 16384.
template <bool kInverse, typename Args>
cudaError_t launch_tb(int log_tb, const Args& args, int items, cudaStream_t st) {
  switch (log_tb) {
    case 6: return launch_one<kInverse, 5, 2>(args, items, st);
    case 7: return launch_one<kInverse, 6, 2>(args, items, st);
    case 8: return launch_one<kInverse, 7, 2>(args, items, st);
    case 9: return launch_one<kInverse, 8, 2>(args, items, st);
    case 10: return launch_one<kInverse, 9, 2>(args, items, st);
    case 11: return launch_one<kInverse, 10, 2>(args, items, st);
    case 12: return launch_one<kInverse, 11, 2>(args, items, st);
    case 13: return launch_one<kInverse, 12, 2>(args, items, st);
    case 14: return launch_one<kInverse, 13, 2>(args, items, st);
    case 15: return launch_one<kInverse, 14, 2>(args, items, st);
    case 16: return launch_one<kInverse, 14, 4>(args, items, st);
    case 17: return launch_one<kInverse, 14, 8>(args, items, st);
    default: return cudaErrorInvalidValue;
  }
}

int log2_exact(int n) {
  int l = 0;
  while ((1 << l) < n && l < 30) ++l;
  return (n >= 1 && (1 << l) == n) ? l : -1;
}

bool tb_ok(int log_tb) { return log_tb >= kMinLogTb && log_tb <= kMaxLogTb; }


}  // namespace

// x f32[T p, V, b]: the call's blocks (p = tb / b a period); tw f32[2tb, 2]:
// ops.fft.twiddles(2 tb); out: specs c64[T, V, tb+1].  Ints: voices, b (a
// power of two, 2 <= b <= tb), tb (a power of two, 64 to 131072), T (the
// rows).  One launch; returns cudaGetLastError() after it
// (cudaErrorInvalidValue for a shape the kernel cannot run).
extern "C" int fdl_b7_tail_fwd(const float* x, const void* tw, void* specs, int voices, int b,
                               int tb, int rows, void* stream) {
  const int log_b = log2_exact(b), log_tb = log2_exact(tb);
  if (voices < 1 || rows < 1 || log_b < 1 || !tb_ok(log_tb) || log_b > log_tb ||
      static_cast<long long>(rows) * voices * (tb > 32768 ? tb / 16384 : 2) > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int clusters = (rows * voices + kRowsPerCluster - 1) / kRowsPerCluster;
  const FwdArgs fa{x, static_cast<const float2*>(tw), static_cast<float2*>(specs), voices,
                   rows * voices, log_b, log_tb - log_b};
  return static_cast<int>(launch_tb<false>(log_tb, fa, clusters, static_cast<cudaStream_t>(stream)));
}

// convs c64[T, V, tb+1]; tw f32[2tb, 2]: ops.fft.twiddles(2 tb); out: y
// f32[T, V, tb]; overlap f32[V, tb]: the carry, read before the first row
// and written after the last (in place).  Ints: voices, tb (a power of two,
// 64 to 131072), T.  One launch; returns cudaGetLastError() after it
// (cudaErrorInvalidValue for a shape the kernel cannot run).
extern "C" int fdl_b7_tail_inv(const void* convs, const void* tw, float* y, float* overlap,
                               int voices, int tb, int rows, void* stream) {
  const int log_tb = log2_exact(tb);
  if (voices < 1 || rows < 1 || !tb_ok(log_tb))
    return static_cast<int>(cudaErrorInvalidValue);
  const InvArgs ia{static_cast<const float2*>(convs), static_cast<const float2*>(tw), y, overlap,
                   voices, rows};
  return static_cast<int>(launch_tb<true>(log_tb, ia, voices, static_cast<cudaStream_t>(stream)));
}
