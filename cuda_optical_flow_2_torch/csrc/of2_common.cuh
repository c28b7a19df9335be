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

// of2_warp_pixel_band without a branch, for a cell (x, y) that may lie
// outside the band (live = false: the result is 0): every address is
// clamped into the band and all four taps are loaded whatever the bounds
// test says, so the loads of several cells can be in flight at once.  For a
// live cell the arithmetic and the result are of2_warp_pixel_band's: an
// invalid sample keeps the source pixel, which the clamped tap v00 then is.
// Its two halves, of2_warp_taps (where the four taps lie and how they
// weigh) and of2_warp_blend (the sample from the taps' values), let a
// caller issue the taps' loads (e.g. cp.async) long before it blends them.
struct Of2WarpTaps {
  size_t o00, o01, o10, o11;  // offsets of the taps in img
  float tx, ty;               // the sample's fractions
  bool valid;                 // the sample lies in the image
};

__device__ __forceinline__ Of2WarpTaps of2_warp_taps(int H, int W, int x, int y, float u, float v,
                                                     float d, int row0, int Hg) {
  const float fx = (float)x + of2_clamp(u, -d, d);
  const float fy = (float)(row0 + y) + of2_clamp(v, -d, d);
  Of2WarpTaps t;
  t.valid = fx >= 0.f && fx <= (float)(W - 1) && fy >= 0.f && fy <= (float)(Hg - 1);
  const float x0 = floorf(fx);
  const float y0 = floorf(fy);
  t.tx = fx - x0;
  t.ty = fy - y0;
  const int xc = min(max(x, 0), W - 1), yc = min(max(y, 0), H - 1);
  const int x0i = t.valid ? (int)x0 : xc;
  const int y0g = t.valid ? (int)y0 : row0 + yc;
  const int x1i = min(x0i + 1, W - 1);
  const int y0i = min(max(y0g - row0, 0), H - 1);
  const int y1i = min(max(min(y0g + 1, Hg - 1) - row0, 0), H - 1);
  t.o00 = (size_t)y0i * W + x0i;
  t.o01 = (size_t)y0i * W + x1i;
  t.o10 = (size_t)y1i * W + x0i;
  t.o11 = (size_t)y1i * W + x1i;
  return t;
}

__device__ __forceinline__ float of2_warp_blend(const Of2WarpTaps& t, float v00, float v01,
                                                float v10, float v11, bool live) {
  const float top = v00 + t.tx * (v01 - v00);
  const float bot = v10 + t.tx * (v11 - v10);
  return live ? (t.valid ? top + t.ty * (bot - top) : v00) : 0.f;
}

__device__ __forceinline__ float of2_warp_gather(const float* __restrict__ img, int H, int W,
                                                 int x, int y, bool live, float u, float v,
                                                 float d, int row0, int Hg) {
  const Of2WarpTaps t = of2_warp_taps(H, W, x, y, u, v, d, row0, Hg);
  return of2_warp_blend(t, img[t.o00], img[t.o01], img[t.o10], img[t.o11], live);
}

// 0.75 c + 0.25 n with each product and the sum rounded on its own, as
// torch's separate elementwise kernels round them (nvcc would contract the
// plain expression into an FMA and change the bits).
__device__ __forceinline__ float of2_lerp_quarter(float c, float n) {
  return __fadd_rn(__fmul_rn(0.75f, c), __fmul_rn(0.25f, n));
}

// cp.async: a 4-byte copy from device memory straight into shared memory,
// without a round trip through registers.  dst[0] = *src if valid, else 0;
// src must be a valid address either way.
__device__ __forceinline__ void of2_cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// Wait for this thread's cp.async copies; a __syncthreads() must follow
// before another thread reads them.
__device__ __forceinline__ void of2_cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Register-blocked passes (the LK tile, the Farnebaeck step): a thread owns
// OF2_RUN consecutive cells of a pass and sums every cell of the run from
// registers (of2_run_sum).  Run k of a pass over `extent` >= OF2_RUN cells
// starts at of2_run_start(k, extent): the last run is moved back to end at
// the extent, so it recomputes cells of the run before it with the same
// arithmetic and writes the same values.  The wrappers'
// kernels/tile_geometry.py mirrors this.
#define OF2_RUN 4
#define OF2_SMEM_MAX 232448  // bytes of shared memory one block may opt in to

__host__ __device__ __forceinline__ int of2_runs(int extent) {
  return (extent + OF2_RUN - 1) / OF2_RUN;
}
__host__ __device__ __forceinline__ int of2_run_start(int k, int extent) {
  return k * OF2_RUN < extent - OF2_RUN ? k * OF2_RUN : extent - OF2_RUN;
}

// A window sum over `taps` taps for each of a run's OF2_RUN cells: for d =
// 0 .. taps - 1 in order, step(d, v, acc, k) adds tap d of cell k, whose
// NC input planes at the run's span cell k + d are v.  load(j, v) fills v
// with span cell j; each span cell is loaded once, into a ring of OF2_RUN
// registers a plane whose slots the unrolled phases rename (cell j sits in
// slot j % OF2_RUN), so the ring costs no moves.  Every cell's sum runs
// over the taps in the same order, whatever its place in the run.  TAPS > 0
// fixes the tap count at compile time (it must equal taps).
template <int NC, int NA = NC, int TAPS = 0, class Load, class Step>
__device__ __forceinline__ void of2_run_sum(int taps, Load load, Step step,
                                            float (&acc)[NA][OF2_RUN]) {
  float ring[NC][OF2_RUN];
#pragma unroll
  for (int s = 0; s < OF2_RUN; ++s) {
    float v[NC];
    load(s, v);
#pragma unroll
    for (int c = 0; c < NC; ++c) ring[c][s] = v[c];
  }
  if constexpr (TAPS > 0) {
    // taps known at compile time: fully unrolled, each tap's weight an
    // immediate operand
#pragma unroll
    for (int d = 0; d < TAPS; ++d) {
#pragma unroll
      for (int k = 0; k < OF2_RUN; ++k) {
        float v[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) v[c] = ring[c][(d + k) % OF2_RUN];
        step(d, v, acc, k);
      }
      if (d + 1 < TAPS) {
        float v[NC];
        load(d + OF2_RUN, v);
#pragma unroll
        for (int c = 0; c < NC; ++c) ring[c][d % OF2_RUN] = v[c];
      }
    }
  } else {
    for (int d0 = 0; d0 < taps; d0 += OF2_RUN) {
#pragma unroll
      for (int ph = 0; ph < OF2_RUN; ++ph) {
        const int d = d0 + ph;
        if (d >= taps) break;
#pragma unroll
        for (int k = 0; k < OF2_RUN; ++k) {
          float v[NC];
#pragma unroll
          for (int c = 0; c < NC; ++c) v[c] = ring[c][(ph + k) % OF2_RUN];
          step(d, v, acc, k);
        }
        // slot ph held cell d, no longer needed: the run's next cell goes there
        if (d + 1 < taps) {
          float v[NC];
          load(d + OF2_RUN, v);
#pragma unroll
          for (int c = 0; c < NC; ++c) ring[c][ph] = v[c];
        }
      }
    }
  }
}
