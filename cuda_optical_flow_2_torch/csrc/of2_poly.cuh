// Farnebaeck quadratic polynomial expansion: the two register-blocked passes
// shared by poly_exp.cu (the expansion alone) and fb_step.cu (the fused
// iteration, which re-expands the warped frame).
//
// The counterpart of kernels/fb_step_fused.band_expansion in the JAX
// package.  Two steps over a zero-padded source tile S in shared memory:
//   vertical:   T_c[i][j] = sum_t g_c[t] S[i + t][j],  g_c = {g, g*o, g*o^2};
//   horizontal: the six moments at (i, j) from T_c[i][j .. j + 2r], then the
//               constant rows of G^-1 (ops/poly_exp.mixing_matrix, the axy row
//               halved on the host) give (bx, by, axx, ayy, axy).
// Each pass works on a run of OF2_RUN cells (of2_run_sum, of2_common.cuh):
// a thread loads each input of the run's span once and sums every cell of
// the run from registers, each sum over the taps 0 .. 2r in order, as the
// plain version sums.  The callers choose which cells a thread takes and
// where the results go.  The taps and the mixing rows are computed in
// float64 on the host and come in as float32 kernel parameters; with the
// radius RP >= 0 compiled in, each tap is an immediate operand.
#pragma once

#include "of2_common.cuh"

#define OF2_POLY_MAX_R 15  // poly_n <= 31
#define OF2_POLY_MAX_N (2 * OF2_POLY_MAX_R + 1)

struct Of2PolyTaps {
  float g[3][OF2_POLY_MAX_N];  // {g, g*o, g*o^2}, 2r+1 used
  float mix[5][6];             // (bx, by, axx, ayy, axy) from (m00, m10, m01, m20, m02, m11)
  int r;
};

// Host side: fill the constants from taps (3 x (2r+1), row-major) and mix (5 x 6).
static inline bool of2_poly_fill(Of2PolyTaps* p, int r, const float* taps, const float* mix) {
  if (r < 1 || r > OF2_POLY_MAX_R) return false;
  const int n = 2 * r + 1;
  for (int k = 0; k < 3; ++k)
    for (int t = 0; t < OF2_POLY_MAX_N; ++t) p->g[k][t] = t < n ? taps[k * n + t] : 0.f;
  for (int k = 0; k < 5; ++k)
    for (int l = 0; l < 6; ++l) p->mix[k][l] = mix[6 * k + l];
  p->r = r;
  return true;
}

// Vertical sums of a run of OF2_RUN cells down one column: load(j, v) sets
// v[0] to the source cell j rows below the run's first cell and tap 0 (j = 0
// .. OF2_RUN + 2r - 1); a[c][k] = sum_t g_c[t] (cell k + t) (RP >= 0: RP ==
// p.r, compiled in).
template <int RP, class Load>
__device__ __forceinline__ void of2_poly_vertical_run(Load load, const Of2PolyTaps& p,
                                                      float (&a)[3][OF2_RUN]) {
  constexpr int PTAPS = RP >= 0 ? 2 * RP + 1 : 0;
#pragma unroll
  for (int k = 0; k < OF2_RUN; ++k) a[0][k] = a[1][k] = a[2][k] = 0.f;
  of2_run_sum<1, 3, PTAPS>(
      2 * (RP >= 0 ? RP : p.r) + 1, load,
      [&](int t, const float (&v)[1], float (&acc)[3][OF2_RUN], int k) {
#pragma unroll
        for (int c = 0; c < 3; ++c) acc[c][k] += p.g[c][t] * v[0];
      },
      a);
}

// Horizontal moments and the mixing of a run of OF2_RUN cells along one
// row: load(j, v) fills v with the three vertical sums at span cell j (j = 0
// .. OF2_RUN + 2r - 1; cell k's taps are span cells k .. k + 2r);
// store(q, k, e) takes coefficient q of (bx, by, axx, ayy, axy) of cell k.
template <int RP, class Load, class Store>
__device__ __forceinline__ void of2_poly_moments_run(Load load, const Of2PolyTaps& p,
                                                     Store store) {
  constexpr int PTAPS = RP >= 0 ? 2 * RP + 1 : 0;
  float m[6][OF2_RUN];
#pragma unroll
  for (int l = 0; l < 6; ++l)
#pragma unroll
    for (int k = 0; k < OF2_RUN; ++k) m[l][k] = 0.f;
  of2_run_sum<3, 6, PTAPS>(
      2 * (RP >= 0 ? RP : p.r) + 1, load,
      [&](int t, const float (&v)[3], float (&acc)[6][OF2_RUN], int k) {
        const float g0 = p.g[0][t], g1 = p.g[1][t], g2 = p.g[2][t];
        acc[0][k] += g0 * v[0];  // m00: 1
        acc[1][k] += g1 * v[0];  // m10: x
        acc[2][k] += g0 * v[1];  // m01: y
        acc[3][k] += g2 * v[0];  // m20: x^2
        acc[4][k] += g0 * v[2];  // m02: y^2
        acc[5][k] += g1 * v[1];  // m11: xy
      },
      m);
#pragma unroll
  for (int k = 0; k < OF2_RUN; ++k)
#pragma unroll
    for (int q = 0; q < 5; ++q) {
      float acc = 0.f;
#pragma unroll
      for (int l = 0; l < 6; ++l) acc += p.mix[q][l] * m[l][k];
      store(q, k, acc);
    }
}

// The five normal-equation products of one Farnebaeck iteration
// (models/farneback.fb_normal_eq_products): e1 and w are the (bx, by, axx,
// ayy, axy) planes of the previous frame and of the warped next frame, (u, v)
// the flow the warp used.  Returns (g11, g12, g22, h1, h2).
__device__ __forceinline__ void of2_fb_products(const float e1[5], const float w[5], float u,
                                                float v, float prod[5]) {
  const float axx = 0.5f * (e1[2] + w[2]);
  const float ayy = 0.5f * (e1[3] + w[3]);
  const float axy = 0.5f * (e1[4] + w[4]);
  const float db_x = 0.5f * (e1[0] - w[0]) + axx * u + axy * v;
  const float db_y = 0.5f * (e1[1] - w[1]) + axy * u + ayy * v;
  prod[0] = axx * axx + axy * axy;
  prod[1] = axy * (axx + ayy);
  prod[2] = axy * axy + ayy * ayy;
  prod[3] = axx * db_x + axy * db_y;
  prod[4] = axy * db_x + ayy * db_y;
}
