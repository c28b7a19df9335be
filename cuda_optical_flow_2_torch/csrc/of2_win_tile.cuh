// Box window of five normal-equation planes and the guarded 2x2 solve: the
// register-blocked window pass and the solve shared by win_solve.cu (the
// planes come from device memory) and fb_step.cu (the planes are computed
// in the block).
//
// The window is two passes of of2_win_sum_run over planes that are zero
// outside the image (ops/window.window_sum's zero padding): the column pass
// sums each cell's 2 rw + 1 rows, the row pass its 2 rw + 1 columns of the
// column sums, each sum over the taps 0 .. 2 rw in order, as the plain
// version sums (rows, then columns).  The callers choose which cells a
// thread takes and where its loads come from, through the load functor, so
// each keeps its own address expressions.  The solve, per pixel:
//   det = g11 g22 - g12^2,  safe = |det| >= det_eps  (false for a NaN det),
//   (u, v) = safe ? ((g22 h1 - g12 h2), (g11 h2 - g12 h1)) / det : 0.
// det_eps <= 0 keeps every det but NaN, so 1/det divides unguarded, as in
// models/farneback.solve_normal_eqs.
#pragma once

#include "of2_common.cuh"

#define OF2_WT_MAX_R 16  // window <= 33

// The window sums of the five planes for a run of OF2_RUN cells: load(j, v)
// fills v with the five planes at span cell j (j = 0 .. OF2_RUN + 2 rw - 1;
// cell k's taps are span cells k .. k + 2 rw); a[c][k] = sum over the taps
// of plane c, in tap order.  RW >= 0 fixes the radius at compile time (it
// must equal rw).
template <int RW, class Load>
__device__ __forceinline__ void of2_win_sum_run(int rw, Load load, float (&a)[5][OF2_RUN]) {
  constexpr int WTAPS = RW >= 0 ? 2 * RW + 1 : 0;
#pragma unroll
  for (int c = 0; c < 5; ++c)
#pragma unroll
    for (int k = 0; k < OF2_RUN; ++k) a[c][k] = 0.f;
  of2_run_sum<5, 5, WTAPS>(
      2 * (RW >= 0 ? RW : rw) + 1, load,
      [&](int, const float (&v)[5], float (&acc)[5][OF2_RUN], int k) {
#pragma unroll
        for (int c = 0; c < 5; ++c) acc[c][k] += v[c];
      },
      a);
}

// The guarded solve of one pixel's five window sums s = (g11, g12, g22, h1,
// h2).  Rounded products (no FMA contraction) keep the solve's float steps
// those of the plain version: 1/det amplifies any difference.
__device__ __forceinline__ float2 of2_win_solve(const float s[5], float det_eps) {
  const float det = __fsub_rn(__fmul_rn(s[0], s[2]), __fmul_rn(s[1], s[1]));
  const bool safe = fabsf(det) >= det_eps;
  const float inv = 1.f / (safe ? det : 1.f);
  const float u = __fmul_rn(__fsub_rn(__fmul_rn(s[2], s[3]), __fmul_rn(s[1], s[4])), inv);
  const float v = __fmul_rn(__fsub_rn(__fmul_rn(s[0], s[4]), __fmul_rn(s[1], s[3])), inv);
  return make_float2(safe ? u : 0.f, safe ? v : 0.f);
}
