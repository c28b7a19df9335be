// Device helpers shared by the LK kernels and the standalone warp.
//
// Layouts: images are (B, H, W) float32, row-major; flow is (B, H, W, 2)
// float32 with [..., 0] = u (x) and [..., 1] = v (y).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#define OF2_MAX_R 32
#define OF2_MAX_TAPS (2 * OF2_MAX_R + 1)

// Clamp that keeps NaN (fminf/fmaxf would turn NaN into a bound), as
// torch.clamp and jnp.clip do: a NaN flow must fail the in-bounds test below.
__device__ __forceinline__ float of2_clamp(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

// The pre-warp invariant of kernels/select_core.global_clamp plus the
// bilinear sample of ops/warp.warp_bilinear, for pixel (x, y) of one image:
//   (u_b, v_b) = flow clipped to +-d;
//   valid      = (x + u_b, y + v_b) lies in [0, W-1] x [0, H-1];
//   result     = bilinear img at that point if valid, else img(y, x).
// The coordinate is tested before any integer conversion, so NaN or huge
// flow never becomes an index.  A direct four-tap gather replaces the TPU
// kernel's select-loops: no per-tile recentering, no d_local or c_max bound.
__device__ __forceinline__ float of2_warp_pixel(const float* __restrict__ img, int H, int W,
                                                int x, int y, float u, float v, float d) {
  const float fx = (float)x + of2_clamp(u, -d, d);
  const float fy = (float)y + of2_clamp(v, -d, d);
  const bool valid = fx >= 0.f && fx <= (float)(W - 1) && fy >= 0.f && fy <= (float)(H - 1);
  if (!valid) return img[(size_t)y * W + x];
  const float x0 = floorf(fx);
  const float y0 = floorf(fy);
  const float tx = fx - x0;
  const float ty = fy - y0;
  const int x0i = (int)x0;
  const int y0i = (int)y0;
  const int x1i = min(x0i + 1, W - 1);
  const int y1i = min(y0i + 1, H - 1);
  const float v00 = img[(size_t)y0i * W + x0i];
  const float v01 = img[(size_t)y0i * W + x1i];
  const float v10 = img[(size_t)y1i * W + x0i];
  const float v11 = img[(size_t)y1i * W + x1i];
  const float top = v00 + tx * (v01 - v00);
  const float bot = v10 + tx * (v11 - v10);
  return top + ty * (bot - top);
}
