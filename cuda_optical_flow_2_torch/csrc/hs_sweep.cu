// Horn-Schunck Jacobi relaxation, quadratic or Charbonnier (lagged
// diffusivity), one launch per sweep with ping-pong flow buffers.
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
// Per call: one gradient launch (Ix, Iy, It and, quadratic, the
// denominator), then the sweeps in chunks of at most max_sweeps.  In
// Charbonnier mode each chunk first recomputes its weights from the
// chunk's incoming flow (two launches: wd/ws, then the normalizers that
// need the neighbours' ws) and freezes them for the chunk's sweeps; there
// the chunk length is part of the result (the IRLS outer loop).
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

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

__device__ __forceinline__ float2 of2_uv(const float2* __restrict__ uv, const Of2Live l, int y,
                                         int x) {
  return of2_live(l, y, x) ? uv[(size_t)y * l.W + x] : make_float2(0.f, 0.f);
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

// The HS neighbour average, cross 1/6 and diagonals 1/12, centre 0, in
// models/horn_schunck._avg3x3's order.
__device__ __forceinline__ float2 of2_avg_uv(const float2* __restrict__ uv, const Of2Live l,
                                             int y, int x) {
  const float2 n = of2_uv(uv, l, y - 1, x), s = of2_uv(uv, l, y + 1, x);
  const float2 w = of2_uv(uv, l, y, x - 1), e = of2_uv(uv, l, y, x + 1);
  const float2 nw = of2_uv(uv, l, y - 1, x - 1), ne = of2_uv(uv, l, y - 1, x + 1);
  const float2 sw = of2_uv(uv, l, y + 1, x - 1), se = of2_uv(uv, l, y + 1, x + 1);
  const float cu = n.x + s.x + w.x + e.x, cv = n.y + s.y + w.y + e.y;
  const float du = nw.x + ne.x + sw.x + se.x, dv = nw.y + ne.y + sw.y + se.y;
  return make_float2(cu * (1.f / 6.f) + du * (1.f / 12.f), cv * (1.f / 6.f) + dv * (1.f / 12.f));
}

// avg(ws * u) and avg(ws * v): the neighbours' products, same order.
__device__ __forceinline__ float2 of2_avg_wuv(const float2* __restrict__ uv,
                                              const float* __restrict__ ws, const Of2Live l, int y,
                                              int x) {
  float2 t[8];
  float m[8];
  const int dy[8] = {-1, 1, 0, 0, -1, -1, 1, 1};
  const int dx[8] = {0, 0, -1, 1, -1, 1, -1, 1};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    t[i] = of2_uv(uv, l, y + dy[i], x + dx[i]);
    m[i] = of2_ws(ws, l, y + dy[i], x + dx[i]);
  }
  const float cu = m[0] * t[0].x + m[1] * t[1].x + m[2] * t[2].x + m[3] * t[3].x;
  const float cv = m[0] * t[0].y + m[1] * t[1].y + m[2] * t[2].y + m[3] * t[3].y;
  const float du = m[4] * t[4].x + m[5] * t[5].x + m[6] * t[6].x + m[7] * t[7].x;
  const float dv = m[4] * t[4].y + m[5] * t[5].y + m[6] * t[6].y + m[7] * t[7].y;
  return make_float2(cu * (1.f / 6.f) + du * (1.f / 12.f), cv * (1.f / 6.f) + dv * (1.f / 12.f));
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

__global__ void of2_hs_sweep_quadratic(const float4* __restrict__ grad,
                                       const float2* __restrict__ uv_in,
                                       float2* __restrict__ uv_out, const Of2HSParams p) {
  OF2_HS_PIXEL
  const float2 bar = of2_avg_uv(uv_in + base, live, y, x);
  const float4 g = grad[k];
  const float rate = (g.x * bar.x + g.y * bar.y + g.z) / g.w;
  uv_out[k] = of2_live(live, y, x) ? make_float2(bar.x - g.x * rate, bar.y - g.y * rate)
                                   : make_float2(0.f, 0.f);
}

// Charbonnier weights from the chunk's incoming flow: data weight wd of the
// linearized residual, smoothness weight ws of the central-difference flow
// gradient (zero outside the image).
__global__ void of2_hs_weights(const float4* __restrict__ grad, const float2* __restrict__ uv,
                               float* __restrict__ wd, float* __restrict__ ws,
                               const Of2HSParams p) {
  OF2_HS_PIXEL
  const float2* UV = uv + base;
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

__global__ void of2_hs_sweep_charbonnier(const float4* __restrict__ grad,
                                         const float4* __restrict__ coef,
                                         const float* __restrict__ ws,
                                         const float2* __restrict__ uv_in,
                                         float2* __restrict__ uv_out, const Of2HSParams p) {
  OF2_HS_PIXEL
  const float2 a = of2_avg_uv(uv_in + base, live, y, x);
  const float2 b = of2_avg_wuv(uv_in + base, ws + base, live, y, x);
  const float4 c = coef[k];  // (wd, ws, 1/S, inv_denom)
  const float4 g = grad[k];
  const float ub = (c.y * a.x + b.x) * 0.5f * c.z;
  const float vb = (c.y * a.y + b.y) * 0.5f * c.z;
  const float rate = c.x * (g.x * ub + g.y * vb + g.z) * c.w;
  uv_out[k] = of2_live(live, y, x) ? make_float2(ub - g.x * rate, vb - g.y * rate)
                                   : make_float2(0.f, 0.f);
}

// prev, nxt: (B, H, W); it_offset: (B, H, W) or null; flow_init: (B, H, W, 2)
// or null (zeros); flow_out: (B, H, W, 2), distinct from flow_init.  The H
// rows are global rows [row0, row0 + H) of an Hg-row image (whole image:
// 0, H).
// scratch: 6*n2 floats (quadratic) or 12*n2 (Charbonnier), n2 = B*H*W
// rounded up to even so that every float4 plane stays 16-byte aligned;
// 16-byte aligned itself, laid out as grad float4 | flow float2 | coef
// float4 | wd | ws.
// masks: 27 host floats (Sobel-x/8, Sobel-y/8, temporal).  iterations >= 1.
extern "C" int of2_hs_relax(const float* prev, const float* nxt, const float* it_offset,
                            const float* flow_init, float* flow_out, float* scratch, int B, int H,
                            int W, int row0, int Hg, int iterations, int max_sweeps, float alpha2,
                            const float* masks, int robust, float eps_data, float eps_data2,
                            float eps_smooth, float eps_smooth2, void* stream) {
  if (B < 1 || H < 1 || W < 1 || Hg < 1 || iterations < 1 || max_sweeps < 1)
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

  const size_t n = (size_t)B * H * W, n2 = n + (n & 1);
  float4* grad = (float4*)scratch;
  float2* pong = (float2*)(scratch + 4 * n2);
  float4* coef = robust ? (float4*)(scratch + 6 * n2) : nullptr;
  float* wd = robust ? scratch + 10 * n2 : nullptr;
  float* ws = robust ? scratch + 11 * n2 : nullptr;
  // Sweep s reads buf[s % 2] and writes buf[(s + 1) % 2]; the last one
  // lands in flow_out.
  float2* buf[2];
  buf[iterations % 2] = (float2*)flow_out;
  buf[(iterations + 1) % 2] = pong;

  cudaError_t err = flow_init != nullptr
                        ? cudaMemcpyAsync(buf[0], flow_init, 2 * n * sizeof(float),
                                          cudaMemcpyDeviceToDevice, st)
                        : cudaMemsetAsync(buf[0], 0, 2 * n * sizeof(float), st);
  if (err != cudaSuccess) return (int)err;

  const dim3 block(OF2_HS_BX, OF2_HS_BY);
  const dim3 grid((W + OF2_HS_BX - 1) / OF2_HS_BX, (H + OF2_HS_BY - 1) / OF2_HS_BY, B);
  of2_hs_grad_kernel<<<grid, block, 0, st>>>(prev, nxt, it_offset, grad, p, !robust);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int chunk = iterations < max_sweeps ? iterations : max_sweeps;
  for (int s = 0; s < iterations;) {
    const int end = s + chunk < iterations ? s + chunk : iterations;
    if (robust) {
      of2_hs_weights<<<grid, block, 0, st>>>(grad, buf[s % 2], wd, ws, p);
      of2_hs_coef<<<grid, block, 0, st>>>(grad, wd, ws, coef, p);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    for (; s < end; ++s) {
      if (robust)
        of2_hs_sweep_charbonnier<<<grid, block, 0, st>>>(grad, coef, ws, buf[s % 2],
                                                          buf[(s + 1) % 2], p);
      else
        of2_hs_sweep_quadratic<<<grid, block, 0, st>>>(grad, buf[s % 2], buf[(s + 1) % 2], p);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
  }
  return (int)cudaSuccess;
}
