// The radix-16 butterflies of the farm kernels' register FFTs (B6's block
// and column transforms, B7's row transforms): exchange padding, twiddle
// products and the in-register DFTs of 2 to 16 points.
#pragma once

#include "fdl_step.cuh"

namespace fdl {

// One pad float2 in seventeen: every exchange's stores and loads then take
// two shared-memory wavefronts a warp, the fewest for 8-byte points.
__device__ __forceinline__ int pad16(int i) { return i + (i >> 4); }
__host__ __device__ constexpr int padded16(int n) { return n + (n >> 4); }

template <bool kInverse>
__device__ __forceinline__ float2 twiddled(float2 a, float2 w) {
  if (!kInverse) w.y = -w.y;
  return fdl::cmul(a, w);
}

// exp(-+ 2 pi i e / 16) for the forward / inverse transform, e in {1, 2, 3,
// 4, 6, 9}: the inner twiddles of the 4 x 4 and 2 x 4 decompositions.
template <bool kInverse>
__device__ __forceinline__ float2 w16(int e) {
  constexpr float c1 = 0.92387953251128674f, s1 = 0.38268343236508978f,
                  r2 = 0.70710678118654752f;
  float2 w = e == 1   ? make_float2(c1, -s1)
             : e == 2 ? make_float2(r2, -r2)
             : e == 3 ? make_float2(s1, -c1)
             : e == 4 ? make_float2(0.f, -1.f)
             : e == 6 ? make_float2(-r2, -r2)
                      : make_float2(-c1, s1);  // e == 9
  if (kInverse) w.y = -w.y;
  return w;
}

template <bool kInverse>
__device__ __forceinline__ void dft4(float2& x0, float2& x1, float2& x2, float2& x3) {
  const float2 a0 = make_float2(x0.x + x2.x, x0.y + x2.y);
  const float2 a1 = make_float2(x0.x - x2.x, x0.y - x2.y);
  const float2 a2 = make_float2(x1.x + x3.x, x1.y + x3.y);
  const float2 dd = make_float2(x1.x - x3.x, x1.y - x3.y);
  // dd * (-i) forward, dd * (+i) inverse
  const float2 a3 = kInverse ? make_float2(-dd.y, dd.x) : make_float2(dd.y, -dd.x);
  x0 = make_float2(a0.x + a2.x, a0.y + a2.y);
  x1 = make_float2(a1.x + a3.x, a1.y + a3.y);
  x2 = make_float2(a0.x - a2.x, a0.y - a2.y);
  x3 = make_float2(a1.x - a3.x, a1.y - a3.y);
}

// x[a] <- sum_q x[q] W_R^{q a} (W_R = exp(-+ 2 pi i / R)), in registers, R
// = 2, 4, 8 or 16.  R = 8: X[a0 + 4 a1] = sum_q0 W8^{q0 a0} W2^{q0 a1}
// sum_q1 x[2 q1 + q0] W4^{q1 a0}; R = 16: X[a0 + 4 a1] = sum_q0 W16^{q0 a0}
// W4^{q0 a1} sum_q1 x[4 q1 + q0] W4^{q1 a0}.
template <int R, bool kInverse>
__device__ __forceinline__ void dft(float2 (&x)[R]) {
  if constexpr (R == 2) {
    const float2 a = x[0], b = x[1];
    x[0] = make_float2(a.x + b.x, a.y + b.y);
    x[1] = make_float2(a.x - b.x, a.y - b.y);
  } else if constexpr (R == 4) {
    dft4<kInverse>(x[0], x[1], x[2], x[3]);
  } else if constexpr (R == 8) {
    dft4<kInverse>(x[0], x[2], x[4], x[6]);  // x[2 a0] = Y[0][a0]
    dft4<kInverse>(x[1], x[3], x[5], x[7]);  // x[2 a0 + 1] = Y[1][a0]
    float2 y[8];
#pragma unroll
    for (int a0 = 0; a0 < 4; ++a0) {
      const float2 u = x[2 * a0];
      const float2 t = a0 == 0 ? x[1] : fdl::cmul(x[2 * a0 + 1], w16<kInverse>(2 * a0));
      y[a0] = make_float2(u.x + t.x, u.y + t.y);
      y[a0 + 4] = make_float2(u.x - t.x, u.y - t.y);
    }
#pragma unroll
    for (int a = 0; a < 8; ++a) x[a] = y[a];
  } else {
#pragma unroll
    for (int q0 = 0; q0 < 4; ++q0) dft4<kInverse>(x[q0], x[4 + q0], x[8 + q0], x[12 + q0]);
    // x[4 a0 + q0] now holds Y[q0][a0]
#pragma unroll
    for (int q0 = 1; q0 < 4; ++q0)
#pragma unroll
      for (int a0 = 1; a0 < 4; ++a0)
        x[4 * a0 + q0] = fdl::cmul(x[4 * a0 + q0], w16<kInverse>(q0 * a0));
    float2 y[16];
#pragma unroll
    for (int a0 = 0; a0 < 4; ++a0) {
      float2 t0 = x[4 * a0], t1 = x[4 * a0 + 1], t2 = x[4 * a0 + 2], t3 = x[4 * a0 + 3];
      dft4<kInverse>(t0, t1, t2, t3);
      y[a0] = t0;
      y[a0 + 4] = t1;
      y[a0 + 8] = t2;
      y[a0 + 12] = t3;
    }
#pragma unroll
    for (int a = 0; a < 16; ++a) x[a] = y[a];
  }
}

}  // namespace fdl
