// Kernel B6: the reverb farm's head + tail0 path, T blocks of V voices a call.
//
// Replaces the JAX package's jnp path fft_convolution_tpu/parallel/farm2.py:
// _heads_fused (with _heads_state_out), which has no Pallas kernel; the TPU
// ran it as XLA's DFT matmuls.  Per voice v and bin k, with the combined
// 2n-segment table h (head rows, then tail0's rows one period later) and
// ext = [hist (n-1 rows), the ring read oldest first (n rows), the T new
// spectra], L = 2n - 1 + T rows:
//     conv[t] = sum_{i<2n} h[i] ext[2n - 1 + t - i],  t < T,
// minus, after an update, the suppress pass's w[t] for t < n (the wrapper
// computes w in torch from the ring before this call writes it);
//     y[t] = irfft(conv[t])[:B] + (t > 0 ? irfft(conv[t-1])[B:] : overlap),
// plus, where given, the big tail's delay line (the pending precalc in
// period 0, the pending output in period 1, this call's tail row j - 2 in
// period j).  Exit state, in place: ring slot (cur' + d) mod n <- ext[L-d]
// (d = 1..n, cur' = (cur - T) mod n), hist <- ext[L-2n+1 .. L-n-1], both
// pre_multiplied = sum_{j=1}^{n-1} table[j] ext[L-1-j], the new overlap.
//
// What bounds it on an H100: at the farm's shape (128 voices, block 128,
// n = 256, T = 2048) the compulsory bytes are 0.47 GB (0.14 ms) and the
// block-axis FFTs 11 GFLOP (0.17 ms at the FP32 peak).  The torch path
// (cuFFT) moved ~7 GB a call through HBM: an m = npo2(2n-1+T)-point
// meta-spectrum of the table cached per voice and bin, four transients of
// that size, and copies.  Here the intermediates are the bins-major spectra
// and convolution (2 x 0.27 GB), and every transform runs in registers:
// - fft: a Stockham FFT with 16 points a thread in registers, radix-16
//   stages and one last stage of radix 2 to 8, an exchange through padded
//   shared memory between radix-16 stages; a thread's twiddles loaded once.
//   Exchanges and barriers, not bytes, bound the transforms: in the column
//   launch a radix-4 form, with twice the exchanges, took 41 % longer, and
//   without its spectra reads that form ran only 5 % faster (NVIDIA H100
//   80GB HBM3, 700 W; profile_farm_heads.py).
// - b6_forward: a thread block takes a tile of consecutive blocks of one
//   voice, one team of B/16 threads a block: its rFFT (the B-point FFT of
//   the sample pairs and the post-twiddle), staged in shared memory
//   bins-major and written to [V, B+1, T] in runs of the tile.
// - b6_columns: a team of M/16 threads a (voice, bin) column.  It
//   transforms the column's 2n table rows (no cached meta-spectra: 2n rows
//   read instead of m), then convolves along the block axis by overlap-save
//   at a meta size M (256, 1024 or 4096, the least >= 4n): each segment
//   takes M - 1 ext rows (history from the state on the first, the
//   bins-major new spectra after), forward FFT, the product with the
//   table's spectrum, inverse FFT, and writes its S = M - 2n rows of conv.
//   The last segment's window holds the exit rows, so the same launch writes
//   the ring, hist and both pre (a fixed-order reduction in the team).
//   What bounds it: per column 8 (6n - 2 + 2T) bytes against three
//   M-point FFTs at T <= S, so bytes at 3.35 TB/s outweigh the FP32 work;
//   but a thread block a column (the first form) reached 27-37 % of that
//   floor: it read the state rows one float2 per 1032-byte row (a 32-byte
//   sector each), loaded its twiddles anew and left nothing in flight while
//   it waited on its rows.  So the launch is persistent: SMs x the blocks
//   an SM holds thread blocks of G teams (ColShape) walk tiles of G
//   adjacent columns, whose state rows are runs of G x 8 bytes; each item
//   (a tile's segment) is staged in shared memory by cp.async while the
//   item before it transforms, and a thread's twiddles load once.  The
//   column's old rows are read only in its first segment's staging, before
//   the last segment's writes (block barriers apart), so the in-place update
//   is safe.  At the farm's shape (n = 256, M = 1024) that reads 49-50 % of
//   the floor at T = 512 and 44 % at T = 2048 (1024 voices: 2.98 -> 1.64
//   and 4.81 -> 4.04 ms), one 256-thread block an SM at 233 registers a
//   thread; M = 256 and 4096 run 2.3x and 1.7x faster.  Alone, the loads
//   and stores take 1.17 / 2.62 ms and the transforms 1.03 / 2.87 ms, and
//   the two overlap only in part; of the memory path the exit rows' 32-byte
//   partial-sector writes cost most (without them 0.91 ms at T = 512; with
//   every state row contiguous 0.97).  Measured and dropped (NVIDIA H100
//   80GB HBM3, 700 W; profile_farm_heads.py): G = 2 at 3 blocks an SM (168
//   registers, 228 KB of shared memory: slower than the first form), G = 2
//   at 2; two items staged ahead (less L1 and more registers: 3-33 %
//   slower); the window as a ring of M rows, so a later segment loads only
//   its new rows; the exit stores after the transforms; each block on one
//   contiguous range of tiles; a shared-memory carveout hint; 16-byte
//   cp.async.cg for the spectra rows.
// - b6_finish: a thread block takes a tile of consecutive blocks of one
//   voice and the block before (bins-major reads), subtracts w, runs the
//   inverse rFFTs, one team a block, and writes y [T, V, B] (the layout the
//   farm returns) with the overlap-add and the delay line.
// Every sum has a fixed order; there are no atomics, so a replay is
// bit-equal.  FP32 FMA only: no TF32, no library transform.
#include "fdl_step.cuh"
#include "fft16.cuh"

namespace {

using fdl::dft;
using fdl::pad16;
using fdl::padded16;
using fdl::twiddled;

constexpr int kMaxThreads = 1024;
constexpr int kMaxSmem = 232448;  // dynamic shared memory a thread block may opt into

// Synchronise a transform's team: the whole block (TEAM == 0), the warp
// (TEAM <= 32: every team of a warp runs the same stages), or named barrier
// `id` over TEAM threads.
template <int TEAM>
__device__ __forceinline__ void team_sync(int id) {
  if constexpr (TEAM == 0) {
    __syncthreads();
  } else if constexpr (TEAM <= 32) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(TEAM) : "memory");
  }
}

// A Stockham FFT of N = 2^LOG points (2 <= LOG <= 12) on kP threads, each
// holding kPT points j + q kP (q < kPT) in registers: LOG / 4 radix-16
// stages (a 16-point DFT in registers as 4 x 4), then one stage of radix
// kRL = 2^(LOG mod 4) (kLo butterflies a thread, on the same registers);
// below 16 points one thread does one radix-N stage.  Between radix-16
// stages the points go once through shared memory.
template <int LOG>
struct Fft {
  static constexpr int kN = 1 << LOG;
  static constexpr int kPT = LOG >= 4 ? 16 : kN;
  static constexpr int kP = kN / kPT;
  static constexpr int kR16 = LOG >= 4 ? LOG / 4 : 0;
  static constexpr int kRL = LOG >= 4 ? 1 << (LOG % 4) : kN;
  static constexpr int kLo = kPT / kRL;
};

// One thread's twiddles, loaded once: radix-16 stage s >= 1 (stage 0 has
// ns = 1, so none), q = 1..15; the last stage's butterfly l, q = 1..kRL-1.
// Stored for the inverse direction; the forward transform conjugates at use.
template <int LOG>
struct FftTw {
  using F = Fft<LOG>;
  float2 w16[F::kR16 > 1 ? F::kR16 - 1 : 1][15];
  float2 wl[F::kRL > 1 ? F::kLo : 1][F::kRL > 1 ? F::kRL - 1 : 1];
};

// tw2n: (cos, sin)(2 pi m / 2N), m < 2N (ops.fft.twiddles(2N)).
template <int LOG>
__device__ __forceinline__ void fft_twiddles(FftTw<LOG>& tw, const float2* tw2n, int j) {
  using F = Fft<LOG>;
  constexpr int N = F::kN, P = F::kP;
#pragma unroll
  for (int s = 1; s < F::kR16; ++s) {
    const int ns = 1 << (4 * s), k = j & (ns - 1);
#pragma unroll
    for (int q = 1; q < 16; ++q) tw.w16[s - 1][q - 1] = __ldg(tw2n + q * k * (N / (8 * ns)));
  }
  if constexpr (F::kRL > 1) {
    // the last stage: ns = N / kRL, butterfly j + l P, w^q with w = exp(2 pi i (j + l P) / N)
#pragma unroll
    for (int l = 0; l < F::kLo; ++l)
#pragma unroll
      for (int q = 1; q < F::kRL; ++q) tw.wl[l][q - 1] = __ldg(tw2n + 2 * q * (j + l * P));
  }
}

// The FFT (struct Fft) on v, thread j of its team, unnormalised, the
// inverse with the + sign; the output lands in natural order in the same
// registers.  b0 and b1: the team's exchange buffers of padded16(N) float2,
// used in turn from `sel` (b0 == b1: one buffer, and a second barrier an
// exchange).
template <int LOG, bool kInverse, int TEAM>
__device__ __forceinline__ void fft(float2 (&v)[Fft<LOG>::kPT], float2* b0, float2* b1,
                                    int& sel, const FftTw<LOG>& tw, int j, int bar) {
  using F = Fft<LOG>;
  constexpr int P = F::kP, RL = F::kRL, LO = F::kLo;
  if constexpr (F::kR16 > 0) {  // then kPT == 16
#pragma unroll
    for (int s = 0; s < F::kR16; ++s) {
      const int ns = 1 << (4 * s);
      if (s > 0) {
#pragma unroll
        for (int q = 1; q < 16; ++q) v[q] = twiddled<kInverse>(v[q], tw.w16[s - 1][q - 1]);
      }
      dft<16, kInverse>(v);
      if (s < F::kR16 - 1 || RL > 1) {  // the last radix-16 stage writes the thread's own points
        float2* buf = sel ? b1 : b0;
        sel ^= 1;
        const int k = j & (ns - 1), d0 = ((j - k) << 4) + k;
#pragma unroll
        for (int q = 0; q < 16; ++q) buf[pad16(d0 + q * ns)] = v[q];
        team_sync<TEAM>(bar);
#pragma unroll
        for (int q = 0; q < 16; ++q) v[q] = buf[pad16(j + q * P)];
        if (b0 == b1) team_sync<TEAM>(bar);
      }
    }
  }
  if constexpr (RL > 1) {
    // ns = N / RL: butterfly j + l P holds the thread's points l + LO q
#pragma unroll
    for (int l = 0; l < LO; ++l) {
      float2 t[RL];
#pragma unroll
      for (int q = 0; q < RL; ++q)
        t[q] = q == 0 ? v[l] : twiddled<kInverse>(v[l + LO * q], tw.wl[l][q - 1]);
      dft<RL, kInverse>(t);
#pragma unroll
      for (int q = 0; q < RL; ++q) v[l + LO * q] = t[q];
    }
  }
}

// Bin k (0..b) of the rFFT of 2b real samples from z, the b-point FFT of the
// pairs, in a padded buffer (fdl::real_post_twiddle's arithmetic); tw:
// (cos, sin)(2 pi m / 2b).
__device__ __forceinline__ float2 post_twiddle(const float2* z, const float2* tw, int b, int k) {
  const float2 zk = z[pad16(k & (b - 1))];
  const float2 zm = z[pad16((b - k) & (b - 1))];
  const float2 e = make_float2(0.5f * (zk.x + zm.x), 0.5f * (zk.y - zm.y));
  const float2 o = make_float2(0.5f * (zk.y + zm.y), -0.5f * (zk.x - zm.x));
  float2 w = __ldg(tw + k);
  w.y = -w.y;
  const float2 wo = fdl::cmul(o, w);
  return make_float2(e.x + wo.x, e.y + wo.y);
}

// The block transforms' shape at B = 2^LOG: a team of Fft<LOG>::kP threads
// a block (B/16, at least one); at most 1024 threads a thread block, for
// teams of more than a warp 15 teams (one named barrier each), and as many
// teams as leave a forward thread block's exchange buffers and staging tile
// in shared memory; a forward thread block takes kFwd blocks, a finishing
// one kFin and the block before them.  Thread blocks are whole warps (the
// teams past the tile's run idle).  Each team has one exchange buffer.
template <int LOG>
struct BlockShape {
  static constexpr int kB = 1 << LOG, kTeam = Fft<LOG>::kP;
  static constexpr int kSmemTeams =
      (kMaxSmem / 8 - (kB + 1)) / (padded16(kB) + kB + 1);
  static constexpr int kLimit =
      kTeam <= 32 ? kMaxThreads / kTeam : (kMaxThreads / kTeam < 15 ? kMaxThreads / kTeam : 15);
  static constexpr int kMaxTeams = kLimit < kSmemTeams ? kLimit : kSmemTeams;
  static constexpr int kFwd = kMaxTeams < 16 ? kMaxTeams : 16;
  static constexpr int kFin = kMaxTeams - 1 < 16 ? kMaxTeams - 1 : 16;
  static constexpr int kFwdThreads = (kTeam * kFwd + 31) / 32 * 32;
  static constexpr int kFinThreads = (kTeam * (kFin + 1) + 31) / 32 * 32;
  // dynamic shared memory, in float2: the teams' exchange buffers and the
  // bins-major staging tile (forward), the spectra tile (finish)
  static constexpr int kFwdSmem = (kFwdThreads / kTeam) * padded16(kB) + (kB + 1) * (kFwd + 1);
  static constexpr int kFinSmem = (kFin + 1) * (kB + 1) + (kFinThreads / kTeam) * padded16(kB);
};

// Thread blocks (tile, voice): blocks t0 .. t0 + kFwd - 1 of voice v, one a
// team: spec[v][k][t] = bin k of the rFFT of x[t][v] zero-padded to 2B.
template <int LOG>
__global__ void __launch_bounds__(BlockShape<LOG>::kFwdThreads)
b6_forward(const float* __restrict__ x, const float2* __restrict__ tw, float2* __restrict__ spec,
           int voices, int nblocks) {
  using S = BlockShape<LOG>;
  constexpr int B = S::kB, TEAM = S::kTeam, PT = Fft<LOG>::kPT, NB = B + 1;
  constexpr int PB = padded16(B), PER = S::kFwd, PITCH = PER + 1;
  constexpr int TEAMS = S::kFwdThreads / TEAM;
  extern __shared__ float4 smem[];
  float2* bufs = reinterpret_cast<float2*>(smem);  // [TEAMS][PB]
  float2* tile = bufs + TEAMS * PB;                 // [NB][PITCH]
  const int team = threadIdx.x / TEAM, j = threadIdx.x - team * TEAM;
  const int v = blockIdx.y, t0 = blockIdx.x * PER;
  const int count = min(PER, nblocks - t0);
  const bool live = team < count;
  FftTw<LOG> ftw;
  fft_twiddles<LOG>(ftw, tw, j);
  float2 z[PT];
  const float* xt = x + (static_cast<size_t>(t0 + team) * voices + v) * B;
#pragma unroll
  for (int q = 0; q < PT; ++q) {
    const int m = j + q * TEAM;  // pairs m >= B/2 are the zero padding
    z[q] = live && m < B / 2 ? __ldg(reinterpret_cast<const float2*>(xt) + m)
                             : make_float2(0.f, 0.f);
  }
  float2* buf = bufs + team * PB;
  int sel = 0;
  fft<LOG, false, TEAM>(z, buf, buf, sel, ftw, j, 1 + team);
#pragma unroll
  for (int q = 0; q < PT; ++q) buf[pad16(j + q * TEAM)] = z[q];
  team_sync<TEAM>(1 + team);
  if (live) {
#pragma unroll
    for (int q = 0; q < PT; ++q) {
      const int k = j + q * TEAM;
      tile[k * PITCH + team] = post_twiddle(buf, tw, B, k);
    }
    if (j == 0) tile[B * PITCH + team] = post_twiddle(buf, tw, B, B);
  }
  __syncthreads();
  float2* col0 = spec + static_cast<size_t>(v) * NB * nblocks + t0;
  for (int idx = threadIdx.x; idx < NB * PER; idx += S::kFwdThreads) {
    const int k = idx / PER, c = idx - k * PER;
    if (c < count) col0[static_cast<size_t>(k) * nblocks + c] = tile[k * PITCH + c];
  }
}

// The column launch's shape at M = 2^LOG: a team of M/16 threads a
// (voice, bin) column and G teams a thread block, which takes tiles of G
// adjacent columns (bins k0 .. k0 + G - 1 of a voice; a tile crosses into
// the next voice where V (B+1) is not a multiple of G).  Shared memory, in
// float2: each team's table spectrum and exchange buffers; each column's
// staged window (M rows) and table (2n rows, at a pitch of round16(2n) +
// kPad); each team's warp sums of the two pre.  kPad makes both pitches
// kPad mod 16, so a warp that stages or reads G bins of 32/G rows hits 16
// distinct 8-byte bank pairs a half-warp.  kColBlocks: the thread blocks
// of the largest n (M/4) that an SM holds, which __launch_bounds__ then
// guarantees in registers.
__host__ __device__ constexpr int round16(int x) { return (x + 15) / 16 * 16; }
constexpr int kSmemPerSm = 233472;   // shared memory of an SM (228 KB)
constexpr int kSmemReserved = 1024;  // of it, held back for each resident thread block

// The form at M = 256, 1024, 4096 (cuda_farm_heads.COLUMN_FORM): G and each
// team's exchange buffers (two: one barrier an exchange; one: two).
template <int LOG>
constexpr int kColTile = LOG == 8 ? 8 : LOG == 10 ? 4 : 1;
template <int LOG>
constexpr int kColBuffers = LOG == 10 ? 2 : 1;

template <int LOG>
struct ColShape {
  static constexpr int G = kColTile<LOG>, kBufs = kColBuffers<LOG>;
  static constexpr int kM = 1 << LOG, kNT = kM / 16, kThreads = G * kNT;
  static constexpr int kTeam = G == 1 ? 0 : kNT;  // fft's team: the whole block for one team
  static constexpr int kPad = 16 / G;
  static constexpr int kWin = kM + kPad;
  static constexpr int kRed = kNT > 32 ? 2 * (kNT / 32) : 0;  // teams of half a warp shuffle only
  static constexpr int kExit = 4;  // ring (or hist) rows a thread stores: n / (kThreads / G) <= 4
  __host__ __device__ static constexpr int tab_pitch(int n) { return round16(2 * n) + kPad; }
  __host__ __device__ static constexpr int smem(int n) {
    return G * (kM + kBufs * padded16(kM) + kWin + tab_pitch(n) + kRed);
  }
};

template <int LOG>
constexpr int kColBlocks =
    kSmemPerSm / (ColShape<LOG>::smem((1 << LOG) / 4) * 8 + kSmemReserved) <
            2048 / ColShape<LOG>::kThreads
        ? kSmemPerSm / (ColShape<LOG>::smem((1 << LOG) / 4) * 8 + kSmemReserved)
        : 2048 / ColShape<LOG>::kThreads;

struct ColArgs {
  const float2* spec;  // c64 [V, nb, T]: this call's spectra, bins-major
  float2* ring;        // c64 [V, n, nb]: the head ring, in/out
  float2* hist;        // c64 [V, n-1, nb]: in/out
  const float2* h_ir;  // c64 [V, n, nb]: the head table
  const float2* t_ir;  // c64 [V, n, nb]: tail0's table
  const float2* tw;    // f32 [2M, 2]: the meta transform's twiddles
  float2* conv;        // c64 [V, nb, T] out
  float2* pre_h;       // c64 [V, nb] out
  float2* pre_t;       // c64 [V, nb] out
  int n, nb, nblocks, cur, cur_new;
  int columns, tiles;  // V nb; tiles of G columns, the last one ragged
};

// One 8-byte copy from global to shared memory, asynchronous (cp.async.ca).
__device__ __forceinline__ void cp_async8(float2* dst, const float2* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Work item `it` of this thread block: tile blockIdx.x + (it / segments)
// gridDim.x, segment it % segments.
struct ColItem {
  int tile, seg;
  __device__ ColItem(int it, int segments)
      : tile(static_cast<int>(blockIdx.x + (it / segments) * gridDim.x)), seg(it % segments) {}
};

// Stage work item `it` into shared memory by cp.async: at segment 0 each
// column's 2n table rows (head, then tail0) and its history (hist, then the
// ring read backwards from cur) G bins at a time, so a row of the tile is
// one run of G x 8 bytes; then the segment's rows of this call's spectra, a
// column at a time (contiguous).  A thread stages column tid mod G of every
// state row it takes (the block's threads are a multiple of G).
template <int LOG>
__device__ __forceinline__ void stage_item(const ColArgs& a, int it, int segments, float2* wins,
                                           float2* tabs, int tp) {
  using S = ColShape<LOG>;
  constexpr int M = S::kM, THREADS = S::kThreads, G = S::G;
  const int n = a.n, nb = a.nb, tid = threadIdx.x;
  const ColItem item(it, segments);
  const int e0 = item.seg * (M - 2 * n);
  if (item.seg == 0) {
    const int lg = tid % G, c = item.tile * G + lg;
    if (c < a.columns) {
      const int v = c / nb, k = c - v * nb;
      const size_t rows = static_cast<size_t>(v) * n * nb + k;
      const size_t hrows = static_cast<size_t>(v) * (n - 1) * nb + k;
      float2* wl = wins + lg * S::kWin;
      float2* tl = tabs + lg * tp;
      for (int r = tid / G; r < n; r += THREADS / G) {
        int slot = a.cur - r;  // ext row n - 1 + r: the ring read backwards from cur
        if (slot < 0) slot += n;
        cp_async8(tl + r, a.h_ir + rows + r * nb);
        cp_async8(tl + n + r, a.t_ir + rows + r * nb);
        cp_async8(wl + n - 1 + r, a.ring + rows + slot * nb);
        if (r < n - 1) cp_async8(wl + r, a.hist + hrows + r * nb);
      }
    }
  }
  // ext rows lo .. hi - 1 of the window e0 .. e0 + M - 2 are new spectra
  const int lo = max(e0, 2 * n - 1), hi = min(e0 + M - 1, 2 * n - 1 + a.nblocks);
  for (int g = 0; g < G; ++g) {
    const int c = item.tile * G + g;
    if (c >= a.columns) break;
    const float2* src = a.spec + static_cast<size_t>(c) * a.nblocks + (lo - (2 * n - 1));
    float2* dst = wins + g * S::kWin + (lo - e0);
    for (int r = tid; r < hi - lo; r += THREADS) cp_async8(dst + r, src + r);
  }
}

// Persistent thread blocks of G teams (module note): the grid (at most
// tiles; heads_plan: SMs x kColBlocks) walks the tiles in a fixed order,
// and a thread block takes each of its tiles' segments in turn.  An item's
// rows are staged in shared memory while the item before it runs.  Once
// they have landed, its threads take into registers everything they read
// of them: the table column and the rows both pre need (segment 0, kept to
// the tile's last segment), the window, the exit rows (last segment; the
// whole block, G bins a row) and both pre; then a barrier frees the
// buffers for the next item, whose loads then run under this item's
// stores and transforms.  Each team's transforms synchronise the team
// alone (named barriers; half-warp teams a warp); two block-wide barriers
// an item hand the buffers over.  Each thread's twiddles are loaded once
// for the block's lifetime.
template <int LOG>
__global__ void __launch_bounds__(ColShape<LOG>::kThreads, kColBlocks<LOG>)
b6_columns(const ColArgs a) {
  using S = ColShape<LOG>;
  constexpr int M = S::kM, NT = S::kNT, PM = padded16(M), TEAM = S::kTeam;
  constexpr int THREADS = S::kThreads, EX = S::kExit, G = S::G;
  extern __shared__ float4 smem[];
  const int n = a.n, nb = a.nb, nblocks = a.nblocks;
  const int step = M - 2 * n, len = 2 * n - 1 + nblocks;
  const int segments = (nblocks + step - 1) / step;
  const int tp = S::tab_pitch(n);
  const int g = threadIdx.x / NT, j = threadIdx.x - g * NT;  // column g of a tile, thread j of its team
  const int lg = threadIdx.x % G, row0 = threadIdx.x / G;    // the exit rows' column and first row
  float2* const all = reinterpret_cast<float2*>(smem);
  float2* const khs = all + g * M;  // point q of thread j at q M/16 + j, read back by that thread only
  float2* const b0 = all + G * M + g * S::kBufs * PM;
  float2* const b1 = b0 + (S::kBufs - 1) * PM;
  float2* const wins = all + G * (M + S::kBufs * PM);  // [G][kWin]
  float2* const tabs = wins + G * S::kWin;              // [G][tp]
  float2* const red = tabs + G * tp + g * S::kRed;
  const float2* const win = wins + g * S::kWin;
  const float2* const tab = tabs + g * tp;

  FftTw<LOG> ftw;
  fft_twiddles<LOG>(ftw, a.tw, j);
  const float scale = 1.f / static_cast<float>(M);
  const int grid = static_cast<int>(gridDim.x);
  const int items = ((a.tiles - 1 - static_cast<int>(blockIdx.x)) / grid + 1) * segments;
  stage_item<LOG>(a, 0, segments, wins, tabs, tp);
  cp_async_commit();
  int sel = 0;
  // table rows i = j + u M/16 and n + i of the team's column, from its
  // first segment to its last, for both pre (i = 1 .. n-1; u < 4 as n <= M/4)
  float2 hrow[4], trow[4];
  for (int it = 0; it < items; ++it) {
    const ColItem item(it, segments);
    const int e0 = item.seg * step, c = item.tile * G + g, cl = item.tile * G + lg;
    const bool live = c < a.columns, last = item.seg == segments - 1;
    cp_async_wait_all();
    __syncthreads();  // the item's rows have landed, for every thread
    float2 x[16], h[16];
    if (item.seg == 0) {  // the combined table column, zero-padded to M
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int i = j + q * NT;
        h[q] = live && i < 2 * n ? tab[i] : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = j + u * NT;
        hrow[u] = h[u];
        trow[u] = live && i < n ? tab[n + i] : make_float2(0.f, 0.f);
      }
    }
    // ext rows e0 .. e0 + M - 2 into the transform's points; zero past the
    // end and in the last point
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int i = j + q * NT;
      x[q] = live && i < M - 1 && e0 + i < len ? win[i] : make_float2(0.f, 0.f);
    }
    // the exit state, from the last segment's window: ring slot (cur' + d)
    // mod n <- ext[L-d], d = 1..n; hist row r <- ext[L-2n+1+r]
    float2 er[EX], eh[EX];
    if (last) {
      const float2* wl = wins + lg * S::kWin - e0;
#pragma unroll
      for (int u = 0; u < EX; ++u) {
        const int r = row0 + u * (THREADS / G);
        er[u] = r < n ? wl[len - 1 - r] : make_float2(0.f, 0.f);
        eh[u] = r < n - 1 ? wl[len - 2 * n + 1 + r] : make_float2(0.f, 0.f);
      }
      // both pre = sum_{i=1}^{n-1} table[i] ext[L-1-i]: the team's threads,
      // a shuffle tree in each warp, then its warps in order
      float2 ph = make_float2(0.f, 0.f), pt = make_float2(0.f, 0.f);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = j + u * NT;
        if (i >= 1 && i < n) {
          const float2 xv = win[len - 1 - i - e0];
          fdl::cmac(ph, xv, hrow[u]);
          fdl::cmac(pt, xv, trow[u]);
        }
      }
      constexpr int W = NT < 32 ? NT : 32;
#pragma unroll
      for (int o = W / 2; o > 0; o >>= 1) {
        ph.x += __shfl_down_sync(0xffffffffu, ph.x, o, W);
        ph.y += __shfl_down_sync(0xffffffffu, ph.y, o, W);
        pt.x += __shfl_down_sync(0xffffffffu, pt.x, o, W);
        pt.y += __shfl_down_sync(0xffffffffu, pt.y, o, W);
      }
      if constexpr (NT > 32) {
        if ((j & 31) == 0) {
          red[j >> 5] = ph;
          red[NT / 32 + (j >> 5)] = pt;
        }
        team_sync<TEAM>(1 + g);
        if (j == 0) {
#pragma unroll
          for (int w = 1; w < NT / 32; ++w) {
            ph.x += red[w].x;
            ph.y += red[w].y;
            pt.x += red[NT / 32 + w].x;
            pt.y += red[NT / 32 + w].y;
          }
        }
      }
      if (j == 0 && live) {
        a.pre_h[c] = ph;
        a.pre_t[c] = pt;
      }
    }
    __syncthreads();  // every read of this item's buffers is done
    if (it + 1 < items) stage_item<LOG>(a, it + 1, segments, wins, tabs, tp);
    cp_async_commit();
    if (last && cl < a.columns) {
      const int v = cl / nb, k = cl - v * nb;
      float2* ring = a.ring + static_cast<size_t>(v) * n * nb + k;
      float2* hist = a.hist + static_cast<size_t>(v) * (n - 1) * nb + k;
#pragma unroll
      for (int u = 0; u < EX; ++u) {
        const int r = row0 + u * (THREADS / G);  // ring row d = r + 1
        int slot = a.cur_new + r + 1;
        if (slot >= n) slot -= n;
        if (r < n) ring[slot * nb] = er[u];
        if (r < n - 1) hist[r * nb] = eh[u];
      }
    }
    if (item.seg == 0) {  // the table's spectrum
      fft<LOG, false, TEAM>(h, b0, b1, sel, ftw, j, 1 + g);
#pragma unroll
      for (int q = 0; q < 16; ++q) khs[q * NT + j] = h[q];
    }
    fft<LOG, false, TEAM>(x, b0, b1, sel, ftw, j, 1 + g);
#pragma unroll
    for (int q = 0; q < 16; ++q) x[q] = fdl::cmul(x[q], khs[q * NT + j]);
    fft<LOG, true, TEAM>(x, b0, b1, sel, ftw, j, 1 + g);
    if (live) {
      float2* cv = a.conv + static_cast<size_t>(c) * nblocks;
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int r = j + q * NT - (2 * n - 1);  // conv row e0 + r
        if (r >= 0 && r < step && e0 + r < nblocks)
          cv[e0 + r] = make_float2(x[q].x * scale, x[q].y * scale);
      }
    }
  }
}

struct FinArgs {
  const float2* conv;     // c64 [V, nb, T]
  const float2* w;        // c64 [V, nb, n] or null: subtracted from rows t < n
  const float2* tw;       // f32 [2b, 2]
  const float* overlap;   // f32 [V, b]: the carried overlap
  float* overlap_out;     // f32 [V, b]: the new overlap (another tensor)
  float* y;               // f32 [T, V, b] out
  const float* d_pre;     // f32 [V, n b] or null: the big tail's pending precalc
  const float* d_out;     // f32 [V, n b]: the pending output
  const float* d_rows;    // f32 [q, V, n b]: this call's tail rows
  int voices, nblocks, n;
};

// Thread blocks (tile, voice): blocks t0 .. t0 + kFin - 1 of voice v and
// the block before (a zero row for block -1), one a team.
template <int LOG>
__global__ void __launch_bounds__(BlockShape<LOG>::kFinThreads) b6_finish(const FinArgs a) {
  using S = BlockShape<LOG>;
  constexpr int B = S::kB, TEAM = S::kTeam, PT = Fft<LOG>::kPT, NB = B + 1;
  constexpr int PB = padded16(B), PER = S::kFin, ROWS = PER + 1;
  extern __shared__ float4 smem[];
  const int n = a.n, nblocks = a.nblocks;
  const int v = blockIdx.y, t0 = blockIdx.x * PER;
  const int count = min(PER, nblocks - t0), rows = count + 1;
  float2* spec = reinterpret_cast<float2*>(smem);  // [ROWS][NB]: blocks t0 - 1 ..
  float2* bufs = spec + ROWS * NB;                 // [teams][PB]
  const size_t col0 = static_cast<size_t>(v) * NB;
  const size_t tail = static_cast<size_t>(n) * B;  // samples of a tail period
  const int p0 = t0 / n, r0 = t0 - p0 * n;         // block t0's period and row in it
  // Every global load of a thread is issued before any is used: the tile's
  // spectra (less w), then the delay line's samples, in flight during the
  // transforms (a loop that used each load before issuing the next left the
  // launch waiting on memory).
  constexpr int THREADS = S::kFinThreads;
  constexpr int LOADS = (ROWS * NB + THREADS - 1) / THREADS;
  constexpr int OUTS = (PER * B + THREADS - 1) / THREADS;
  float2 c[LOADS];
#pragma unroll
  for (int u = 0; u < LOADS; ++u) {
    const int idx = threadIdx.x + u * THREADS;
    const int k = idx / ROWS, r = idx - k * ROWS, t = t0 - 1 + r;
    c[u] = make_float2(0.f, 0.f);
    if (idx < ROWS * NB && r < rows && t >= 0) {
      c[u] = a.conv[(col0 + k) * nblocks + t];
      if (a.w != nullptr && t < n) {
        const float2 w = a.w[(col0 + k) * n + t];
        c[u].x -= w.x;
        c[u].y -= w.y;
      }
    }
  }
  float dl[OUTS];
#pragma unroll
  for (int u = 0; u < OUTS; ++u) {
    const int idx = threadIdx.x + u * THREADS;
    const int jt = idx >> LOG, i = idx & (B - 1);
    dl[u] = 0.f;
    if (a.d_pre != nullptr && idx < PER * B && jt < count) {
      int period = p0, row = r0 + jt;
      while (row >= n) {
        row -= n;
        ++period;
      }
      const size_t s = static_cast<size_t>(row) * B + i;
      dl[u] = period == 0   ? a.d_pre[v * tail + s]
              : period == 1 ? a.d_out[v * tail + s]
                            : a.d_rows[(static_cast<size_t>(period - 2) * a.voices + v) * tail + s];
    }
  }
#pragma unroll
  for (int u = 0; u < LOADS; ++u) {
    const int idx = threadIdx.x + u * THREADS;
    const int k = idx / ROWS, r = idx - k * ROWS;
    if (idx < ROWS * NB && r < rows) spec[r * NB + k] = c[u];
  }
  const int team = threadIdx.x / TEAM, j = threadIdx.x - team * TEAM;
  FftTw<LOG> ftw;
  fft_twiddles<LOG>(ftw, a.tw, j);
  __syncthreads();
  float2 z[PT];
#pragma unroll
  for (int q = 0; q < PT; ++q)
    z[q] = team < rows ? fdl::real_pre_twiddle(spec + team * NB, a.tw, B, j + q * TEAM)
                       : make_float2(0.f, 0.f);
  float2* buf = bufs + team * PB;
  int sel = 0;
  fft<LOG, true, TEAM>(z, buf, buf, sel, ftw, j, 1 + team);
  // z[m] holds samples 2m and 2m + 1 of the team's block (unscaled)
#pragma unroll
  for (int q = 0; q < PT; ++q) buf[pad16(j + q * TEAM)] = z[q];
  __syncthreads();
  const float scale = 1.f / static_cast<float>(2 * B);
  auto sample = [&](int r, int s) {
    const float2 p = bufs[r * PB + pad16(s >> 1)];
    return (s & 1) ? p.y : p.x;
  };
#pragma unroll
  for (int u = 0; u < OUTS; ++u) {
    const int idx = threadIdx.x + u * THREADS;
    const int jt = idx >> LOG, i = idx & (B - 1), t = t0 + jt;
    if (idx >= PER * B || jt >= count) continue;
    const float yv = sample(jt + 1, i) * scale +
                     (t > 0 ? sample(jt, B + i) * scale
                            : a.overlap[static_cast<size_t>(v) * B + i]) +
                     dl[u];
    a.y[(static_cast<size_t>(t) * a.voices + v) * B + i] = yv;
    if (t == nblocks - 1) a.overlap_out[static_cast<size_t>(v) * B + i] = sample(jt + 1, B + i) * scale;
  }
}

template <int LOG>
cudaError_t launch_forward(const float* x, const float2* tw, float2* spec, int voices,
                           int nblocks, cudaStream_t st) {
  using S = BlockShape<LOG>;
  const size_t bytes = S::kFwdSmem * sizeof(float2);
  cudaError_t e = fdl::allow_smem(b6_forward<LOG>, bytes);
  if (e != cudaSuccess) return e;
  b6_forward<LOG><<<dim3((nblocks + S::kFwd - 1) / S::kFwd, voices), S::kFwdThreads, bytes, st>>>(
      x, tw, spec, voices, nblocks);
  return cudaGetLastError();
}

template <int LOG>
cudaError_t launch_finish(const FinArgs& fa, cudaStream_t st) {
  using S = BlockShape<LOG>;
  const size_t bytes = S::kFinSmem * sizeof(float2);
  cudaError_t e = fdl::allow_smem(b6_finish<LOG>, bytes);
  if (e != cudaSuccess) return e;
  b6_finish<LOG><<<dim3((fa.nblocks + S::kFin - 1) / S::kFin, fa.voices), S::kFinThreads, bytes,
                   st>>>(fa);
  return cudaGetLastError();
}

// The column launch at M = 2^LOG over V voices, whose tile width and grid
// must be the plan's (col_tile, col_grid: at least one tile a thread block).
template <int LOG>
cudaError_t launch_columns(ColArgs ca, int voices, int tile, int grid, cudaStream_t st) {
  using S = ColShape<LOG>;
  static_assert(kColBlocks<LOG> >= 1, "a column thread block must fit an SM");
  ca.columns = voices * ca.nb;
  ca.tiles = (ca.columns + S::G - 1) / S::G;
  const size_t bytes = static_cast<size_t>(S::smem(ca.n)) * sizeof(float2);
  if (tile != S::G || grid < 1 || grid > ca.tiles || bytes > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e = fdl::allow_smem(b6_columns<LOG>, bytes);
  if (e != cudaSuccess) return e;
  b6_columns<LOG><<<grid, S::kThreads, bytes, st>>>(ca);
  return cudaGetLastError();
}

// The forward (finish == false) or finishing launch at B = 2^log_b, 4 <= B
// <= 2048, whose tiles must be the plan's: the forward's and the finish's
// blocks a thread block (fwd_per, fin_per).
cudaError_t launch_block_kernel(bool finish, int log_b, int fwd_per, int fin_per,
                                const float* x, const float2* tw, float2* spec,
                                const FinArgs& fa, int voices, int nblocks, cudaStream_t st) {
#define B6_CASE(L)                                                                    \
  case L:                                                                             \
    if (fwd_per != BlockShape<L>::kFwd || fin_per != BlockShape<L>::kFin)             \
      return cudaErrorInvalidValue;                                                   \
    return finish ? launch_finish<L>(fa, st) : launch_forward<L>(x, tw, spec, voices, \
                                                                 nblocks, st);
  switch (log_b) {
    B6_CASE(2)
    B6_CASE(3)
    B6_CASE(4)
    B6_CASE(5)
    B6_CASE(6)
    B6_CASE(7)
    B6_CASE(8)
    B6_CASE(9)
    B6_CASE(10)
    B6_CASE(11)
    default:
      return cudaErrorInvalidValue;
  }
#undef B6_CASE
}

}  // namespace

// x f32[T, V, b]: the new blocks; ring c64[V, n, b+1] and hist c64[V, n-1,
// b+1]: in/out; h_ir, t_ir c64[V, n, b+1]: the head and tail0 tables;
// overlap f32[V, b]: the carried overlap; tw_b f32[2b, 2], tw_m f32[2M, 2]:
// the block and meta transforms' twiddles; scratch c64[2, V, b+1, T]; out:
// y f32[T, V, b], overlap_out f32[V, b], pre_h and pre_t c64[V, b+1].
// Optional (null: none): w c64[V, b+1, n], subtracted from conv rows t < n;
// the delay line d_pre, d_out f32[V, n b] and d_rows f32[q, V, n b].  Ints:
// voices, b (4 to 2048), n, T (a positive multiple of n), cur (the ring
// head), cur_new ((cur - T) mod n), M (the meta size: 256, 1024 or 4096, at
// least 4n), fwd_per and fin_per (blocks a forward and a finishing thread
// block), col_tile and col_grid (the columns of a column thread block's tile
// and its persistent thread blocks; cuda_farm_heads.heads_plan).  Three
// launches; returns cudaGetLastError() after them (cudaErrorInvalidValue
// for a shape or plan the kernels cannot run).
extern "C" int fdl_b6_heads(const float* x, void* ring, void* hist, const void* h_ir,
                            const void* t_ir, const float* overlap, const void* tw_b,
                            const void* tw_m, void* scratch, float* y, float* overlap_out,
                            void* pre_h, void* pre_t, const void* w, const float* d_pre,
                            const float* d_out, const float* d_rows, int voices, int b, int n,
                            int nblocks, int cur, int cur_new, int meta, int fwd_per,
                            int fin_per, int col_tile, int col_grid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nb = b + 1;
  int log_b = 0;
  while ((1 << log_b) < b) ++log_b;
  if (voices < 1 || b < 4 || b > 2048 || (1 << log_b) != b || n < 1 || nblocks < n ||
      nblocks % n != 0 || cur < 0 || cur >= n || cur_new < 0 || cur_new >= n ||
      (meta != 256 && meta != 1024 && meta != 4096) || meta < 4 * n ||
      (d_pre != nullptr && (d_out == nullptr || d_rows == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  float2* spec = static_cast<float2*>(scratch);
  float2* conv = spec + static_cast<size_t>(voices) * nb * nblocks;
  const float2* twb = static_cast<const float2*>(tw_b);
  const FinArgs fa{conv, static_cast<const float2*>(w), twb, overlap, overlap_out, y,
                   d_pre, d_out, d_rows, voices, nblocks, n};

  cudaError_t e =
      launch_block_kernel(false, log_b, fwd_per, fin_per, x, twb, spec, fa, voices, nblocks, st);
  if (e != cudaSuccess) return static_cast<int>(e);

  const ColArgs ca{spec,
                   static_cast<float2*>(ring),
                   static_cast<float2*>(hist),
                   static_cast<const float2*>(h_ir),
                   static_cast<const float2*>(t_ir),
                   static_cast<const float2*>(tw_m),
                   conv,
                   static_cast<float2*>(pre_h),
                   static_cast<float2*>(pre_t),
                   n,
                   nb,
                   nblocks,
                   cur,
                   cur_new,
                   0,
                   0};
  e = meta == 256    ? launch_columns<8>(ca, voices, col_tile, col_grid, st)
      : meta == 1024 ? launch_columns<10>(ca, voices, col_tile, col_grid, st)
                     : launch_columns<12>(ca, voices, col_tile, col_grid, st);
  if (e != cudaSuccess) return static_cast<int>(e);

  return static_cast<int>(
      launch_block_kernel(true, log_b, fwd_per, fin_per, x, twb, spec, fa, voices, nblocks, st));
}
