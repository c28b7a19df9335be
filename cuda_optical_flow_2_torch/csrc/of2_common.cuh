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
// bilinear sample of ops/warp.warp_bilinear_band, for pixel (x, y) of a band
// of H rows holding global rows [row0, row0 + H) of an Hg-row image (the
// whole image: row0 = 0, Hg = H):
//   (u_b, v_b) = flow clipped to +-d;
//   valid      = (x + u_b, row0 + y + v_b) lies in [0, W-1] x [0, Hg-1];
//   result     = bilinear img at that point if valid, else img(y, x).
// The coordinate is tested before any integer conversion, so NaN or huge
// flow never becomes an index.  Floor and fraction are taken in global rows
// and the row index is then moved into the band by integer arithmetic (a
// band-local float coordinate would round the fraction differently), and
// clamped to the band: a sample that leaves it belongs to a band-edge row,
// which the caller crops.  A direct four-tap gather replaces the TPU
// kernel's select-loops: no per-tile recentering, no d_local or c_max bound.
__device__ __forceinline__ float of2_warp_pixel_band(const float* __restrict__ img, int H, int W,
                                                     int x, int y, float u, float v, float d,
                                                     int row0, int Hg) {
  const float fx = (float)x + of2_clamp(u, -d, d);
  const float fy = (float)(row0 + y) + of2_clamp(v, -d, d);
  const bool valid = fx >= 0.f && fx <= (float)(W - 1) && fy >= 0.f && fy <= (float)(Hg - 1);
  if (!valid) return img[(size_t)y * W + x];
  const float x0 = floorf(fx);
  const float y0 = floorf(fy);
  const float tx = fx - x0;
  const float ty = fy - y0;
  const int x0i = (int)x0;
  const int y0g = (int)y0;
  const int x1i = min(x0i + 1, W - 1);
  const int y0i = min(max(y0g - row0, 0), H - 1);
  const int y1i = min(max(min(y0g + 1, Hg - 1) - row0, 0), H - 1);
  const float v00 = img[(size_t)y0i * W + x0i];
  const float v01 = img[(size_t)y0i * W + x1i];
  const float v10 = img[(size_t)y1i * W + x0i];
  const float v11 = img[(size_t)y1i * W + x1i];
  const float top = v00 + tx * (v01 - v00);
  const float bot = v10 + tx * (v11 - v10);
  return top + ty * (bot - top);
}
