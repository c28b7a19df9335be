// One LK solve per output tile: (warp) -> gradients -> weighted window sums
// -> guarded 2x2 solve, with every intermediate in shared memory.
//
// Shared by lk_fused.cu (residual only, STEP = false) and lk_step_fused.cu
// (warp + residual + accumulate, STEP = true).  CENTERED (the DIS data term)
// carries four more sums, Ix, Iy, It and the in-image count n, and turns
// each product sum into S_ab - S_a S_b / max(n, 1) before the solve
// (ops/window.centered_structure_tensor_sums).
//
// A block owns a TILE_H x TILE_W output tile.  With window radius r:
//   S: (TILE_H + 2r + 2) x (TILE_W + 2r + 2) source pixels, prev and
//      (warped) next - prev, zero outside the image;
//   G: (TILE_H + 2r) x (TILE_W + 2r) gradients Ix, Iy, It, zero outside the
//      image, so window sums see zero padding at the border;
//   R: five (CENTERED: nine) row-pass sums, (TILE_H + 2r) x TILE_W each
//      (overwrites S).
// The column pass then reads R and the solve writes (u, v) per pixel.
//
// Bands (spatial TP, STEP only): the H rows are global rows [row0, row0 + H)
// of an Hg-row image.  The warp samples in global rows, the warped frame is
// zero and the gradients and the centered count are zero outside the global
// image, and everything outside the band reads as zero, as the plain version
// (kernels/lk_step_fused.lk_band_step_plain) computes.  The whole image is
// the band row0 = 0, Hg = H.
//
// HALF (STEP, whole image only): flow_in is the coarser level's flow, (B,
// H/2, W/2, 2), and every read of the flow upsamples it at that pixel
// (of2_up2x_flow): four coarse taps per read, from global memory, in place
// of the separate upsample pass and its full-size flow plane.
#pragma once

#include "of2_common.cuh"

#define OF2_TILE_H 16
#define OF2_TILE_W 32
#define OF2_THREADS 256

struct Of2LKParams {
  float taps[OF2_MAX_TAPS];  // window weights, 2r+1 used
  float sx[9];               // Sobel-x mask times the gradient scale
  float sy[9];               // Sobel-y mask times the gradient scale
  float st[9];               // temporal mask (normalized when configured)
  float det_eps;             // |det| guard; 0 divides by the raw det
  float max_disp;            // STEP only: flow budget before the warp
  int r;
  int H;
  int W;
  int row0;  // global row of band row 0
  int Hg;    // global image height
};

// r = 32 centered: 9*80*32 + 3*80*96 floats = 184,320 bytes, under the
// 227 KB a block may opt in to.
static inline size_t of2_lk_smem_floats(int r, bool centered) {
  const size_t sh = OF2_TILE_H + 2 * r + 2, sw = OF2_TILE_W + 2 * r + 2;
  const size_t gh = OF2_TILE_H + 2 * r, gw = OF2_TILE_W + 2 * r;
  const size_t s = 2 * sh * sw, rows = (centered ? 9 : 5) * gh * OF2_TILE_W;
  return 3 * gh * gw + (s > rows ? s : rows);
}

__device__ __forceinline__ float of2_stencil3(const float* __restrict__ s, int ld,
                                              const float* __restrict__ m) {
  float acc = 0.f;
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int q = 0; q < 3; ++q) acc += m[3 * p + q] * s[p * ld + q];
  return acc;
}

// The incoming flow at pixel (y, x): read, or with HALF upsampled from the
// coarser level's (H/2, W/2) flow.
template <bool HALF>
__device__ __forceinline__ float2 of2_flow_at(const float* __restrict__ f, int H, int W, int y,
                                              int x) {
  if (HALF) return of2_up2x_flow(f, H >> 1, W >> 1, y, x);
  const size_t k = (size_t)y * W + x;
  return make_float2(f[2 * k], f[2 * k + 1]);
}

template <bool STEP, bool CENTERED, bool HALF>
__global__ void __launch_bounds__(OF2_THREADS)
of2_lk_tile_kernel(const float* __restrict__ prev, const float* __restrict__ nxt,
                   const float* __restrict__ flow_in, float* __restrict__ flow_out,
                   const Of2LKParams p) {
  extern __shared__ float smem[];
  const int r = p.r, H = p.H, W = p.W;
  const int sh = OF2_TILE_H + 2 * r + 2, sw = OF2_TILE_W + 2 * r + 2;
  const int gh = OF2_TILE_H + 2 * r, gw = OF2_TILE_W + 2 * r;
  float* g_ix = smem;
  float* g_iy = g_ix + gh * gw;
  float* g_it = g_iy + gh * gw;
  float* s_prev = g_it + gh * gw;
  float* s_diff = s_prev + sh * sw;
  float* rows = s_prev;  // R reuses S once the gradients are taken

  const size_t plane = (size_t)H * W;
  const size_t flow_plane = HALF ? (size_t)(H >> 1) * (W >> 1) : plane;
  const float* P = prev + blockIdx.z * plane;
  const float* N = nxt + blockIdx.z * plane;
  const float* Fin = STEP ? flow_in + 2 * blockIdx.z * flow_plane : nullptr;
  float* Fout = flow_out + 2 * blockIdx.z * plane;
  const int oy = blockIdx.y * OF2_TILE_H, ox = blockIdx.x * OF2_TILE_W;

  // S: prev and (warped next) - prev.  Each pixel is warped by its own flow,
  // halo included, as the plain composition warps the whole image first.
  for (int i = threadIdx.x; i < sh * sw; i += blockDim.x) {
    const int y = oy - r - 1 + i / sw, x = ox - r - 1 + i % sw;
    float pv = 0.f, dv = 0.f;
    if (y >= 0 && y < H && x >= 0 && x < W) {
      const size_t k = (size_t)y * W + x;
      pv = P[k];
      const bool in_image = p.row0 + y >= 0 && p.row0 + y < p.Hg;
      float nv = 0.f;
      if (in_image) {
        if (STEP) {
          const float2 f = of2_flow_at<HALF>(Fin, H, W, y, x);
          nv = of2_warp_pixel_band(N, H, W, x, y, f.x, f.y, p.max_disp, p.row0, p.Hg);
        } else {
          nv = N[k];
        }
      }
      dv = nv - pv;
    }
    s_prev[i] = pv;
    s_diff[i] = dv;
  }
  __syncthreads();

  // G: 3x3 stencils, zeroed outside the band and outside the image.
  for (int i = threadIdx.x; i < gh * gw; i += blockDim.x) {
    const int gy = i / gw, gx = i % gw;
    const int y = oy - r + gy, x = ox - r + gx;
    float ix = 0.f, iy = 0.f, it = 0.f;
    if (y >= 0 && y < H && x >= 0 && x < W && p.row0 + y >= 0 && p.row0 + y < p.Hg) {
      const int s0 = gy * sw + gx;  // top-left of the 3x3 neighbourhood
      ix = of2_stencil3(s_prev + s0, sw, p.sx);
      iy = of2_stencil3(s_prev + s0, sw, p.sy);
      it = of2_stencil3(s_diff + s0, sw, p.st);
    }
    g_ix[i] = ix;
    g_iy[i] = iy;
    g_it[i] = it;
  }
  __syncthreads();

  // R: row pass of the five products (CENTERED: and of Ix, Iy, It and the
  // in-image indicator) over the window's columns.
  const int rplane = gh * OF2_TILE_W;
  for (int i = threadIdx.x; i < rplane; i += blockDim.x) {
    const int gy = i / OF2_TILE_W, c = i % OF2_TILE_W;
    const int g0 = gy * gw + c;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f, a4 = 0.f;
    float a5 = 0.f, a6 = 0.f, a7 = 0.f, a8 = 0.f;
    const int y = oy - r + gy;
    const bool row_in = y >= 0 && y < H && p.row0 + y >= 0 && p.row0 + y < p.Hg;
    for (int d = 0; d <= 2 * r; ++d) {
      const float w = p.taps[d];
      const float ix = g_ix[g0 + d], iy = g_iy[g0 + d], it = g_it[g0 + d];
      a0 += w * (ix * ix);
      a1 += w * (iy * iy);
      a2 += w * (ix * iy);
      a3 += w * (ix * it);
      a4 += w * (iy * it);
      if (CENTERED) {
        const int x = ox - r + c + d;
        a5 += w * ix;
        a6 += w * iy;
        a7 += w * it;
        a8 += (row_in && x >= 0 && x < W) ? w : 0.f;
      }
    }
    rows[i] = a0;
    rows[rplane + i] = a1;
    rows[2 * rplane + i] = a2;
    rows[3 * rplane + i] = a3;
    rows[4 * rplane + i] = a4;
    if (CENTERED) {
      rows[5 * rplane + i] = a5;
      rows[6 * rplane + i] = a6;
      rows[7 * rplane + i] = a7;
      rows[8 * rplane + i] = a8;
    }
  }
  __syncthreads();

  // Column pass, solve, write.
  for (int i = threadIdx.x; i < OF2_TILE_H * OF2_TILE_W; i += blockDim.x) {
    const int ty = i / OF2_TILE_W, c = i % OF2_TILE_W;
    const int y = oy + ty, x = ox + c;
    if (y >= H || x >= W) continue;
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f, s4 = 0.f;
    float s5 = 0.f, s6 = 0.f, s7 = 0.f, s8 = 0.f;
    for (int d = 0; d <= 2 * r; ++d) {
      const float w = p.taps[d];
      const int k = (ty + d) * OF2_TILE_W + c;
      s0 += w * rows[k];
      s1 += w * rows[rplane + k];
      s2 += w * rows[2 * rplane + k];
      s3 += w * rows[3 * rplane + k];
      s4 += w * rows[4 * rplane + k];
      if (CENTERED) {
        s5 += w * rows[5 * rplane + k];
        s6 += w * rows[6 * rplane + k];
        s7 += w * rows[7 * rplane + k];
        s8 += w * rows[8 * rplane + k];
      }
    }
    if (CENTERED) {
      // s5..s8 = sum Ix, Iy, It, n: the per-window covariances
      const float inv_n = 1.f / fmaxf(s8, 1.f);
      s0 = s0 - s5 * s5 * inv_n;
      s1 = s1 - s6 * s6 * inv_n;
      s2 = s2 - s5 * s6 * inv_n;
      s3 = s3 - s5 * s7 * inv_n;
      s4 = s4 - s6 * s7 * inv_n;
    }
    // s0..s4 = sum Ix^2, Iy^2, IxIy, IxIt, IyIt; d = -A^-1 b.
    const float det = s0 * s1 - s2 * s2;
    float u, v;
    if (p.det_eps > 0.f) {
      const bool safe = fabsf(det) >= p.det_eps;
      const float inv = 1.f / (safe ? det : 1.f);
      u = safe ? (-s1 * s3 + s2 * s4) * inv : 0.f;
      v = safe ? (s2 * s3 - s0 * s4) * inv : 0.f;
    } else {
      const float inv = 1.f / det;
      u = (-s1 * s3 + s2 * s4) * inv;
      v = (s2 * s3 - s0 * s4) * inv;
    }
    const size_t k = (size_t)y * W + x;
    if (STEP) {
      // Accumulate on the budget-clamped flow, not the border-clamped one.
      const float2 f = of2_flow_at<HALF>(Fin, H, W, y, x);
      u += of2_clamp(f.x, -p.max_disp, p.max_disp);
      v += of2_clamp(f.y, -p.max_disp, p.max_disp);
    }
    Fout[2 * k] = u;
    Fout[2 * k + 1] = v;
  }
}

template <bool STEP, bool CENTERED, bool HALF>
static int of2_lk_run(const float* prev, const float* nxt, const float* flow_in, float* flow_out,
                      int B, int H, int W, const Of2LKParams& p, void* stream) {
  const size_t smem = of2_lk_smem_floats(p.r, CENTERED) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(of2_lk_tile_kernel<STEP, CENTERED, HALF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + OF2_TILE_W - 1) / OF2_TILE_W, (H + OF2_TILE_H - 1) / OF2_TILE_H, B);
  of2_lk_tile_kernel<STEP, CENTERED, HALF><<<grid, OF2_THREADS, smem, (cudaStream_t)stream>>>(
      prev, nxt, flow_in, flow_out, p);
  return (int)cudaGetLastError();
}

// Host side: fill the parameters, allow the dynamic shared memory, launch,
// and return the launch status (cudaSuccess == 0).  half != 0 (STEP only)
// takes the (B, H/2, W/2, 2) coarser flow: even H and W, the whole image.
template <bool STEP>
static int of2_lk_launch(const float* prev, const float* nxt, const float* flow_in,
                         float* flow_out, int B, int H, int W, int row0, int Hg, int r,
                         const float* taps, const float* masks, float det_eps, float max_disp,
                         int centered, int half, void* stream) {
  if (r < 0 || r > OF2_MAX_R || B < 1 || H < 1 || W < 1 || Hg < 1)
    return (int)cudaErrorInvalidValue;
  if (half && (!STEP || (H & 1) || (W & 1) || row0 != 0 || Hg != H))
    return (int)cudaErrorInvalidValue;
  Of2LKParams p;
  for (int d = 0; d < OF2_MAX_TAPS; ++d) p.taps[d] = d <= 2 * r ? taps[d] : 0.f;
  for (int k = 0; k < 9; ++k) {
    p.sx[k] = masks[k];
    p.sy[k] = masks[9 + k];
    p.st[k] = masks[18 + k];
  }
  p.det_eps = det_eps;
  p.max_disp = max_disp;
  p.r = r;
  p.H = H;
  p.W = W;
  p.row0 = row0;
  p.Hg = Hg;
  if constexpr (STEP) {
    if (half)
      return centered
                 ? of2_lk_run<STEP, true, true>(prev, nxt, flow_in, flow_out, B, H, W, p, stream)
                 : of2_lk_run<STEP, false, true>(prev, nxt, flow_in, flow_out, B, H, W, p, stream);
  }
  return centered
             ? of2_lk_run<STEP, true, false>(prev, nxt, flow_in, flow_out, B, H, W, p, stream)
             : of2_lk_run<STEP, false, false>(prev, nxt, flow_in, flow_out, B, H, W, p, stream);
}
