// Horn-Schunck Jacobi relaxation, quadratic or Charbonnier (lagged
// diffusivity), time-tiled: a tile launch runs k sweeps on 64 x 64 tiles
// held in shared memory (of2_tile.cuh), and a call runs its sweeps in tile
// launches of near equal k <= K.
//
// Layouts: images (B, H, W) float32; flow (B, H, W, 2) float32 read as one
// float2 (u, v) per pixel.  Everything outside the image reads as zero
// (the zero-padded boundary of models/horn_schunck's plain version).
//
// Bands (spatial TP): the H rows are global rows [row0, row0 + H) of an
// Hg-row image.  The frames read as zero outside the band; the gradients,
// the flow and the smoothness weights read as zero outside the band and
// outside the global image ("live" pixels are inside both), and a sweep
// writes zero outside the global image, as kernels/hs_sweep
// .hs_relax_band_plain computes.  The whole image is the band row0 = 0,
// Hg = H.
//
// The tile: a sweep reads the flow at the eight neighbours (and in
// Charbonnier mode their smoothness weights), so with the flow
// double-buffered in shared memory a ring of R = k cells keeps the output
// tile exact after k sweeps; the non-live cells of the tile hold zero on
// every sweep.  A thread walks its column of OF2_ROWS cells with the three
// rows around the current cell in registers, so it reads three cells per
// row and plane from shared memory, not eight neighbours.  The per-pixel
// constants stay in the thread's registers: the gradients and, quadratic,
// the denominator; Charbonnier, also the chunk's coefficients.  Tensor
// cores have no part: FP32 stencils whose result depends on per-step
// rounding.
//
// Per call: one gradient launch, then quadratic, ceil(iterations / K) tile
// launches; Charbonnier, the sweeps in chunks of at most max_sweeps, each
// chunk first recomputing its weights from the chunk's incoming flow (two
// launches: wd/ws, then the normalizers that need the neighbours' ws) and
// freezing them for the chunk's tile launches; there the chunk length is
// part of the result (the IRLS outer loop).
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "of2_tile.cuh"

struct Of2HSParams {
  float sx[9];  // Sobel-x / 8
  float sy[9];  // Sobel-y / 8
  float st[9];  // temporal mask scaled to unit sum
  float alpha2;
  float eps_data, eps_data2;
  float eps_smooth, eps_smooth2;
  int H;
  int W;
  int ylo, yhi;  // the band rows inside the global image: [ylo, yhi)
};

#define OF2_HS_BX 32
#define OF2_HS_BY 8

__device__ __forceinline__ bool of2_in(int H, int W, int y, int x) {
  return y >= 0 && y < H && x >= 0 && x < W;
}

// The live pixels, inside the band and inside the global image: band rows
// [ylo, yhi), columns [0, W).  Passed by value, so each neighbour read costs
// the four comparisons of a plain bounds test.
struct Of2Live {
  int ylo, yhi, W;
};

__device__ __forceinline__ bool of2_live(const Of2Live l, int y, int x) {
  return y >= l.ylo && y < l.yhi && x >= 0 && x < l.W;
}

// The flow at a pixel: zero outside the live pixels or without a flow.
__device__ __forceinline__ float2 of2_uv(const float2* __restrict__ uv, const Of2Live l, int y,
                                         int x) {
  return uv != nullptr && of2_live(l, y, x) ? uv[(size_t)y * l.W + x] : make_float2(0.f, 0.f);
}

// A frame pixel: zero outside the band.
__device__ __forceinline__ float of2_px(const float* __restrict__ a, int H, int W, int y, int x) {
  return of2_in(H, W, y, x) ? a[(size_t)y * W + x] : 0.f;
}

// A smoothness weight: zero outside the live pixels.
__device__ __forceinline__ float of2_ws(const float* __restrict__ ws, const Of2Live l, int y,
                                        int x) {
  return of2_live(l, y, x) ? ws[(size_t)y * l.W + x] : 0.f;
}

#define OF2_HS_PIXEL                                         \
  const int x = blockIdx.x * blockDim.x + threadIdx.x;       \
  const int y = blockIdx.y * blockDim.y + threadIdx.y;       \
  const int H = p.H, W = p.W;                                \
  if (x >= W || y >= H) return;                              \
  const size_t plane = (size_t)H * W;                        \
  const size_t base = blockIdx.z * plane;                    \
  const size_t k = base + (size_t)y * W + x;                 \
  const Of2Live live = {p.ylo, p.yhi, W};

// grad[k] = (Ix, Iy, It [+ offset], alpha^2 + Ix^2 + Iy^2 or 0), with Ix, Iy,
// It zero outside the global image.
__global__ void of2_hs_grad_kernel(const float* __restrict__ prev, const float* __restrict__ nxt,
                                   const float* __restrict__ offset, float4* __restrict__ grad,
                                   const Of2HSParams p, int quadratic) {
  OF2_HS_PIXEL
  const float* P = prev + base;
  const float* N = nxt + base;
  float ix = 0.f, iy = 0.f, it = 0.f;
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      const int t = 3 * a + b;
      const float pv = of2_px(P, H, W, y + a - 1, x + b - 1);
      const float dv = of2_px(N, H, W, y + a - 1, x + b - 1) - pv;
      if (p.sx[t] != 0.f) ix += p.sx[t] * pv;
      if (p.sy[t] != 0.f) iy += p.sy[t] * pv;
      if (p.st[t] != 0.f) it += p.st[t] * dv;
    }
  if (offset != nullptr) it += offset[k];
  if (!of2_live(live, y, x)) ix = iy = it = 0.f;
  grad[k] = make_float4(ix, iy, it, quadratic ? p.alpha2 + ix * ix + iy * iy : 0.f);
}

// Charbonnier weights from the chunk's incoming flow (null: zero): data
// weight wd of the linearized residual, smoothness weight ws of the
// central-difference flow gradient (zero outside the image).
__global__ void of2_hs_weights(const float4* __restrict__ grad, const float2* __restrict__ uv,
                               float* __restrict__ wd, float* __restrict__ ws,
                               const Of2HSParams p) {
  OF2_HS_PIXEL
  const float2* UV = uv == nullptr ? nullptr : uv + base;
  const float4 g = grad[k];
  const float2 c = of2_uv(UV, live, y, x);
  const float r = g.x * c.x + g.y * c.y + g.z;
  wd[k] = p.eps_data * rsqrtf(r * r + p.eps_data2);
  const float2 l = of2_uv(UV, live, y, x - 1), rr = of2_uv(UV, live, y, x + 1);
  const float2 u_ = of2_uv(UV, live, y - 1, x), d_ = of2_uv(UV, live, y + 1, x);
  const float dux = 0.5f * l.x + -0.5f * rr.x, dvx = 0.5f * l.y + -0.5f * rr.y;
  const float duy = 0.5f * u_.x + -0.5f * d_.x, dvy = 0.5f * u_.y + -0.5f * d_.y;
  const float g2 = dux * dux + dvx * dvx + duy * duy + dvy * dvy;
  ws[k] = p.eps_smooth * rsqrtf(g2 + p.eps_smooth2);
}

// coef[k] = (wd, ws, 1/S, 1/(alpha^2 S + wd (Ix^2 + Iy^2))), S = max((ws + avg(ws))/2, 1e-12).
__global__ void of2_hs_coef(const float4* __restrict__ grad, const float* __restrict__ wd,
                            const float* __restrict__ ws, float4* __restrict__ coef,
                            const Of2HSParams p) {
  OF2_HS_PIXEL
  const float* WS = ws + base;
  const float cross = of2_ws(WS, live, y - 1, x) + of2_ws(WS, live, y + 1, x) +
                      of2_ws(WS, live, y, x - 1) + of2_ws(WS, live, y, x + 1);
  const float diag = of2_ws(WS, live, y - 1, x - 1) + of2_ws(WS, live, y - 1, x + 1) +
                     of2_ws(WS, live, y + 1, x - 1) + of2_ws(WS, live, y + 1, x + 1);
  const float w_s = ws[k];
  const float s = fmaxf((w_s + (cross * (1.f / 6.f) + diag * (1.f / 12.f))) * 0.5f, 1e-12f);
  const float4 g = grad[k];
  const float w_d = wd[k];
  coef[k] = make_float4(w_d, w_s, 1.f / s, 1.f / (p.alpha2 * s + w_d * (g.x * g.x + g.y * g.y)));
}

// One row of the window: the cells left of, at and right of column c of
// tile row q of a plane, zero outside the tile.
struct Of2Row {
  float l, m, r;
};

__device__ __forceinline__ Of2Row of2_row(const float* __restrict__ s, int q, int c) {
  if (q < 0 || q >= OF2_EXT) return {0.f, 0.f, 0.f};
  const float* row = s + q * OF2_EXT;
  return {c > 0 ? row[c - 1] : 0.f, row[c], c + 1 < OF2_EXT ? row[c + 1] : 0.f};
}

// `sweeps` sweeps on the tile of block (x, y, batch) from uv_in (null:
// zero) into uv_out, with the gradient launch's planes grad and, ROBUST,
// the chunk's planes coef and ws.
template <bool ROBUST>
__global__ void __launch_bounds__(OF2_THREADS, 1)
of2_hs_tile(const float4* __restrict__ grad, const float4* __restrict__ coef,
            const float* __restrict__ ws, const float* __restrict__ uv_in,
            float* __restrict__ uv_out, const Of2HSParams p, int sweeps) {
  // Flow buffer b: u at of2_smem + 2b planes, v the plane after; then ws.
  extern __shared__ float of2_smem[];
  float* const sws = of2_smem + 4 * OF2_PLANE;
  const int H = p.H, W = p.W, R = sweeps, T = of2_tile_out(R);
  const size_t base = blockIdx.z * (size_t)H * W;
  const int c = threadIdx.x % OF2_EXT, g0 = threadIdx.x / OF2_EXT * OF2_ROWS;
  const int oy = blockIdx.y * T - R + g0, x = blockIdx.x * T - R + c;
  const Of2Live lv = {p.ylo, p.yhi, W};

  unsigned live_m = 0;
#pragma unroll
  for (int j = 0; j < OF2_ROWS; ++j) {
    const int y = oy + j, e = (g0 + j) * OF2_EXT + c;
    const bool live = of2_live(lv, y, x), fin = live && uv_in != nullptr;
    const size_t k = live ? base + (size_t)y * W + x : 0;
    const float* src = fin ? uv_in + 2 * k : reinterpret_cast<const float*>(grad);
    of2_cp_async4(of2_smem + e, src, fin);
    of2_cp_async4(of2_smem + OF2_PLANE + e, src + (fin ? 1 : 0), fin);
    if (ROBUST) of2_cp_async4(sws + e, ws + k, live);
    if (live) live_m |= 1u << j;
  }
  float4 g[OF2_ROWS], cf[OF2_ROWS];
#pragma unroll
  for (int j = 0; j < OF2_ROWS; ++j) {
    g[j] = cf[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (!(live_m & (1u << j))) continue;
    const size_t k = base + (size_t)(oy + j) * W + x;
    g[j] = grad[k];
    if (ROBUST) cf[j] = coef[k];  // (wd, ws, 1/S, inv_denom)
  }
  of2_cp_async_wait();
  __syncthreads();

  for (int s = 0; s < sweeps; ++s) {
    const float* cu = of2_smem + (s & 1) * 2 * OF2_PLANE;
    const float* cv = cu + OF2_PLANE;
    float* nu = of2_smem + ((s + 1) & 1) * 2 * OF2_PLANE;
    float* nv = nu + OF2_PLANE;
    Of2Row tu = of2_row(cu, g0 - 1, c), tv = of2_row(cv, g0 - 1, c);
    Of2Row mu = of2_row(cu, g0, c), mv = of2_row(cv, g0, c);
    Of2Row tw{}, mw{};
    if (ROBUST) {
      tw = of2_row(sws, g0 - 1, c);
      mw = of2_row(sws, g0, c);
    }
    float2 o[OF2_ROWS];
#pragma unroll
    for (int j = 0; j < OF2_ROWS; ++j) {
      const Of2Row bu = of2_row(cu, g0 + j + 1, c), bv = of2_row(cv, g0 + j + 1, c);
      Of2Row bw{};
      if (ROBUST) bw = of2_row(sws, g0 + j + 1, c);
      float2 out = make_float2(0.f, 0.f);
      if (live_m & (1u << j)) {
        // The HS neighbour average, cross 1/6 and diagonals 1/12, centre 0,
        // in models/horn_schunck._avg3x3's order (n, s, w, e; nw, ne, sw, se).
        const float cru = tu.m + bu.m + mu.l + mu.r, crv = tv.m + bv.m + mv.l + mv.r;
        const float dgu = tu.l + tu.r + bu.l + bu.r, dgv = tv.l + tv.r + bv.l + bv.r;
        const float2 a = make_float2(cru * (1.f / 6.f) + dgu * (1.f / 12.f),
                                     crv * (1.f / 6.f) + dgv * (1.f / 12.f));
        const float4 gg = g[j];
        if (!ROBUST) {
          const float rate = (gg.x * a.x + gg.y * a.y + gg.z) / gg.w;
          out = make_float2(a.x - gg.x * rate, a.y - gg.y * rate);
        } else {
          // avg(ws * u) and avg(ws * v): the neighbours' products, same order.
          const float bcu = tw.m * tu.m + bw.m * bu.m + mw.l * mu.l + mw.r * mu.r;
          const float bcv = tw.m * tv.m + bw.m * bv.m + mw.l * mv.l + mw.r * mv.r;
          const float bdu = tw.l * tu.l + tw.r * tu.r + bw.l * bu.l + bw.r * bu.r;
          const float bdv = tw.l * tv.l + tw.r * tv.r + bw.l * bv.l + bw.r * bv.r;
          const float2 b = make_float2(bcu * (1.f / 6.f) + bdu * (1.f / 12.f),
                                       bcv * (1.f / 6.f) + bdv * (1.f / 12.f));
          const float4 cc = cf[j];
          const float ub = (cc.y * a.x + b.x) * 0.5f * cc.z;
          const float vb = (cc.y * a.y + b.y) * 0.5f * cc.z;
          const float rate = cc.x * (gg.x * ub + gg.y * vb + gg.z) * cc.w;
          out = make_float2(ub - gg.x * rate, vb - gg.y * rate);
        }
      }
      o[j] = out;
      tu = mu;
      tv = mv;
      mu = bu;
      mv = bv;
      if (ROBUST) {
        tw = mw;
        mw = bw;
      }
    }
    // Stored after the walk, so no store sits between the walk's loads.
#pragma unroll
    for (int j = 0; j < OF2_ROWS; ++j) {
      nu[(g0 + j) * OF2_EXT + c] = o[j].x;
      nv[(g0 + j) * OF2_EXT + c] = o[j].y;
    }
    __syncthreads();
  }

  // The output tile: rows and columns [R, R + T) of the tile, in the band.
  if (c < R || c >= R + T || x >= W) return;
  const float* fu = of2_smem + (sweeps & 1) * 2 * OF2_PLANE;
  const float* fv = fu + OF2_PLANE;
#pragma unroll
  for (int j = 0; j < OF2_ROWS; ++j) {
    const int y = oy + j;
    if (y < 0 || y >= H || g0 + j < R || g0 + j >= R + T) continue;
    const int e = (g0 + j) * OF2_EXT + c;
    reinterpret_cast<float2*>(uv_out)[base + (size_t)y * W + x] = make_float2(fu[e], fv[e]);
  }
}

#define OF2_HS_SMEM(robust) (((robust) ? 5 : 4) * OF2_PLANE * (int)sizeof(float))

// prev, nxt: (B, H, W); it_offset: (B, H, W) or null; flow_init: (B, H, W, 2)
// or null (zeros); flow_out: (B, H, W, 2), distinct from flow_init.  The H
// rows are global rows [row0, row0 + H) of an Hg-row image (whole image:
// 0, H).  Tile launches run at most max_tile sweeps (1 <= max_tile <
// OF2_EXT / 2).
// scratch: 8*n2 floats (quadratic) or 14*n2 (Charbonnier), n2 = B*H*W
// rounded up to even so that every float4 plane stays 16-byte aligned;
// 16-byte aligned itself, laid out as grad float4 | [coef float4 | wd | ws |]
// flow float2 x 2.
// masks: 27 host floats (Sobel-x/8, Sobel-y/8, temporal).  iterations >= 1.
extern "C" int of2_hs_relax(const float* prev, const float* nxt, const float* it_offset,
                            const float* flow_init, float* flow_out, float* scratch, int B, int H,
                            int W, int row0, int Hg, int iterations, int max_sweeps, int max_tile,
                            float alpha2, const float* masks, int robust, float eps_data,
                            float eps_data2, float eps_smooth, float eps_smooth2, void* stream) {
  if (B < 1 || H < 1 || W < 1 || Hg < 1 || iterations < 1 || max_sweeps < 1 || max_tile < 1 ||
      2 * max_tile >= OF2_EXT)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Of2HSParams p;
  for (int t = 0; t < 9; ++t) {
    p.sx[t] = masks[t];
    p.sy[t] = masks[9 + t];
    p.st[t] = masks[18 + t];
  }
  p.alpha2 = alpha2;
  p.eps_data = eps_data;
  p.eps_data2 = eps_data2;
  p.eps_smooth = eps_smooth;
  p.eps_smooth2 = eps_smooth2;
  p.H = H;
  p.W = W;
  p.ylo = row0 < 0 ? -row0 : 0;
  p.yhi = Hg - row0 < H ? Hg - row0 : H;

  cudaError_t err = robust ? cudaFuncSetAttribute(of2_hs_tile<true>,
                                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                  OF2_HS_SMEM(true))
                           : cudaFuncSetAttribute(of2_hs_tile<false>,
                                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                  OF2_HS_SMEM(false));
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)B * H * W, n2 = n + (n & 1);
  float4* grad = (float4*)scratch;
  float4* coef = robust ? (float4*)(scratch + 4 * n2) : nullptr;
  float* wd = robust ? scratch + 8 * n2 : nullptr;
  float* ws = robust ? scratch + 9 * n2 : nullptr;
  float* pong[2] = {scratch + (robust ? 10 : 4) * n2, scratch + (robust ? 12 : 6) * n2};

  const dim3 block(OF2_HS_BX, OF2_HS_BY);
  const dim3 grid((W + OF2_HS_BX - 1) / OF2_HS_BX, (H + OF2_HS_BY - 1) / OF2_HS_BY, B);
  of2_hs_grad_kernel<<<grid, block, 0, st>>>(prev, nxt, it_offset, grad, p, !robust);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // The chunks (quadratic: one, the whole call), each in tile launches of
  // near equal length; launch j writes pong[j % 2], the last one flow_out.
  const int chunk = robust && max_sweeps < iterations ? max_sweeps : iterations;
  int total = 0;
  for (int s = 0; s < iterations; s += chunk)
    total += of2_launches(iterations - s < chunk ? iterations - s : chunk, max_tile);
  const float* cur = flow_init;
  for (int s = 0, j = 0; s < iterations; s += chunk) {
    const int m = iterations - s < chunk ? iterations - s : chunk;
    if (robust) {
      of2_hs_weights<<<grid, block, 0, st>>>(grad, (const float2*)cur, wd, ws, p);
      of2_hs_coef<<<grid, block, 0, st>>>(grad, wd, ws, coef, p);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    for (int i = 0; i < of2_launches(m, max_tile); ++i, ++j) {
      float* out = j + 1 == total ? flow_out : pong[j % 2];
      const int k = of2_part(m, max_tile, i), T = of2_tile_out(k);
      const dim3 tiles((W + T - 1) / T, (H + T - 1) / T, B);
      if (robust)
        of2_hs_tile<true><<<tiles, OF2_THREADS, OF2_HS_SMEM(true), st>>>(grad, coef, ws, cur,
                                                                         out, p, k);
      else
        of2_hs_tile<false><<<tiles, OF2_THREADS, OF2_HS_SMEM(false), st>>>(grad, coef, ws, cur,
                                                                           out, p, k);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
      cur = out;
    }
  }
  return (int)cudaSuccess;
}
