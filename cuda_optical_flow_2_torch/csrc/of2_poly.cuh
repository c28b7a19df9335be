// Farnebaeck quadratic polynomial expansion, per pixel, from shared memory.
//
// The counterpart of kernels/fb_step_fused.band_expansion in the JAX
// package, shared by poly_exp.cu (the expansion alone) and fb_step.cu (the
// fused iteration, which re-expands the warped frame).  Two steps over a
// zero-padded source tile S in shared memory:
//   vertical:   T_k[i][j] = sum_t g_k[t] S[i + t][j],  g_k = {g, g*o, g*o^2};
//   horizontal: the six moments at (i, j) from T_k[i][j .. j + 2r], then the
//               constant rows of G^-1 (ops/poly_exp.mixing_matrix, the axy row
//               halved on the host) give (bx, by, axx, ayy, axy).
// The taps and the mixing rows are computed in float64 on the host and come
// in as float32 kernel parameters, in the order the plain version sums.
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

// Vertical pass: t holds three planes of th x tw (one after another); row i
// of each reads source rows i .. i + 2r of s (leading dimension lds).
__device__ __forceinline__ void of2_poly_vertical(const float* __restrict__ s, int lds,
                                                  float* __restrict__ t, int th, int tw,
                                                  const Of2PolyTaps& p) {
  const int n = 2 * p.r + 1, plane = th * tw;
  for (int i = threadIdx.x; i < plane; i += blockDim.x) {
    const int y = i / tw, x = i % tw;
    const float* col = s + y * lds + x;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f;
    for (int k = 0; k < n; ++k) {
      const float v = col[k * lds];
      a0 += p.g[0][k] * v;
      a1 += p.g[1][k] * v;
      a2 += p.g[2][k] * v;
    }
    t[i] = a0;
    t[plane + i] = a1;
    t[2 * plane + i] = a2;
  }
}

// Horizontal moments and mixing for the pixel whose vertical sums start at
// t[i * ldt + j] (columns j .. j + 2r); plane is the size of one t plane.
__device__ __forceinline__ void of2_poly_pixel(const float* __restrict__ t, int plane, int ldt,
                                               int i, int j, const Of2PolyTaps& p,
                                               float out[5]) {
  const int n = 2 * p.r + 1;
  const float* t0 = t + i * ldt + j;
  const float* t1 = t0 + plane;
  const float* t2 = t1 + plane;
  float m[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int k = 0; k < n; ++k) {
    const float g0 = p.g[0][k], g1 = p.g[1][k], g2 = p.g[2][k];
    const float v0 = t0[k], v1 = t1[k], v2 = t2[k];
    m[0] += g0 * v0;  // m00: 1
    m[1] += g1 * v0;  // m10: x
    m[2] += g0 * v1;  // m01: y
    m[3] += g2 * v0;  // m20: x^2
    m[4] += g0 * v2;  // m02: y^2
    m[5] += g1 * v1;  // m11: xy
  }
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    float acc = 0.f;
#pragma unroll
    for (int l = 0; l < 6; ++l) acc += p.mix[c][l] * m[l];
    out[c] = acc;
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
