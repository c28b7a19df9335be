// Box window of five normal-equation planes and the guarded 2x2 solve, for
// one output tile, from shared memory.  Shared by win_solve.cu (the planes
// come from device memory) and fb_step.cu (the planes are computed in the
// block).
//
// A block owns an OF2_WT_TILE x OF2_WT_TILE output tile.  With window radius
// rw the caller fills P: five planes (g11, g12, g22, h1, h2) of
// (TILE + 2 rw) x (TILE + 2 rw), zero outside the image, so the sums see
// zero padding at the border (ops/window.window_sum).  The column pass goes
// into V (five planes of TILE x (TILE + 2 rw)), then the row pass and
// the solve write (u, v) per in-image pixel:
//   det = g11 g22 - g12^2,  safe = |det| >= det_eps  (false for a NaN det),
//   (u, v) = safe ? ((g22 h1 - g12 h2), (g11 h2 - g12 h1)) / det : 0.
// det_eps <= 0 keeps every det but NaN, so 1/det divides unguarded, as in
// models/farneback.solve_normal_eqs.
#pragma once

#include "of2_common.cuh"

#define OF2_WT_TILE 32
#define OF2_WT_THREADS 256
#define OF2_WT_MAX_R 16  // window <= 33

// Floats of P and V for window radius rw.
static inline size_t of2_wt_p_floats(int rw) {
  const size_t pw = OF2_WT_TILE + 2 * rw;
  return 5 * pw * pw;
}
static inline size_t of2_wt_v_floats(int rw) {
  return 5 * (size_t)OF2_WT_TILE * (OF2_WT_TILE + 2 * rw);
}

__device__ __forceinline__ void of2_window_solve_tile(const float* __restrict__ P,
                                                      float* __restrict__ V, int rw, int oy,
                                                      int ox, int H, int W, float det_eps,
                                                      float* __restrict__ flow_out) {
  const int pw = OF2_WT_TILE + 2 * rw;
  const int pplane = pw * pw, vplane = OF2_WT_TILE * pw, side = 2 * rw + 1;
  // Column pass, in the plain version's order (rows first, then columns).
  for (int i = threadIdx.x; i < vplane; i += blockDim.x) {
    const int y = i / pw, x = i % pw;
    float a[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
    for (int d = 0; d < side; ++d) {
      const int k = (y + d) * pw + x;
#pragma unroll
      for (int c = 0; c < 5; ++c) a[c] += P[c * pplane + k];
    }
#pragma unroll
    for (int c = 0; c < 5; ++c) V[c * vplane + i] = a[c];
  }
  __syncthreads();
  // Row pass and solve.
  for (int i = threadIdx.x; i < OF2_WT_TILE * OF2_WT_TILE; i += blockDim.x) {
    const int ty = i / OF2_WT_TILE, tx = i % OF2_WT_TILE;
    const int y = oy + ty, x = ox + tx;
    if (y >= H || x >= W) continue;
    float s[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
    for (int d = 0; d < side; ++d) {
      const int k = ty * pw + tx + d;
#pragma unroll
      for (int c = 0; c < 5; ++c) s[c] += V[c * vplane + k];
    }
    // Rounded products (no FMA contraction) keep the solve's float steps
    // those of the plain version: 1/det amplifies any difference.
    const float det = __fsub_rn(__fmul_rn(s[0], s[2]), __fmul_rn(s[1], s[1]));
    const bool safe = fabsf(det) >= det_eps;
    const float inv = 1.f / (safe ? det : 1.f);
    const float u = __fmul_rn(__fsub_rn(__fmul_rn(s[2], s[3]), __fmul_rn(s[1], s[4])), inv);
    const float v = __fmul_rn(__fsub_rn(__fmul_rn(s[0], s[4]), __fmul_rn(s[1], s[3])), inv);
    const size_t k = (size_t)y * W + x;
    flow_out[2 * k] = safe ? u : 0.f;
    flow_out[2 * k + 1] = safe ? v : 0.f;
  }
}
