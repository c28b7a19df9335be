// TV-L1 primal-dual iterations of one linearization: one launch for the
// per-pixel constants, then one launch per iteration with ping-pong state.
//
// Layouts: images (B, H, W) float32; flow (B, H, W, 2) float32.  The state
// between launches is the flow (u, v) as one float2 per pixel and the four
// duals (p1x, p1y, p2x, p2y) as one float4 per pixel; the constants are
// (gx, gy, th, g2s) as one float4 and it = warped - prev.
//
// Every arithmetic step is an explicitly rounded intrinsic in the order of
// models/tvl1's plain scan (no FMA contraction), so a launch computes what
// the plain PyTorch ops compute, operation for operation; the threshold step
// evaluates all three branches and selects, as torch.where does.
//
// Boundaries: the duals start at zero (the whole image) and their update at
// the last image row (column) divides a zero forward difference into a zero
// dual, so they stay zero there.  The divergence x[i] - x[i-1] with zero
// outside the image then gives both special cases of the plain _div: the
// first row keeps x[0], the last row is -x[-2].
//
// Bands (spatial TP): the H rows are global rows [row0, row0 + H) of an
// Hg-row image, and the six state planes come in and go out, so a caller
// can run the iterations in chunks with a halo exchange between them.  The
// "live" rows [ylo, yhi) lie inside the global image: gx, gy and the primal
// (u, v) are zero outside them, and the forward differences are zero at
// global row Hg - 1 (band row yfd) and at column W - 1, as in
// kernels/tvl1_sweep.tvl1_relax_band_plain.  Everything past the band edge
// reads as zero; the rows it reaches are the caller's to crop.  The live
// range goes to the kernels as three ints by value.  The whole image is the
// band row0 = 0, Hg = H with zero duals.
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#define OF2_TVL1_TH 16
#define OF2_TVL1_TW 32
#define OF2_TVL1_THREADS 256

struct Of2TVL1Params {
  float sx[9];  // Sobel-x / 8
  float sy[9];  // Sobel-y / 8
  float lt;     // lambda * theta
  float theta;
  float tt;     // tau / theta
  float eps;    // |grad|^2 floor of the threshold step's division
  int H;
  int W;
};

__device__ __forceinline__ bool of2_tvl1_in(int H, int W, int y, int x) {
  return y >= 0 && y < H && x >= 0 && x < W;
}

// cst = (gx, gy, lt * g2, max(g2, eps)) and it = warped - prev, with gx, gy
// the zero-padded Sobel / 8 of warped summed in ops/conv's tap order, zero
// outside the live rows.
__global__ void __launch_bounds__(OF2_TVL1_THREADS)
of2_tvl1_const(const float* __restrict__ prev, const float* __restrict__ warped,
               float4* __restrict__ cst, float* __restrict__ it, const Of2TVL1Params p, int ylo,
               int yhi) {
  const int H = p.H, W = p.W;
  const size_t base = blockIdx.z * (size_t)H * W;
  const float* Wp = warped + base;
  const int oy = blockIdx.y * OF2_TVL1_TH, ox = blockIdx.x * OF2_TVL1_TW;
  for (int i = threadIdx.x; i < OF2_TVL1_TH * OF2_TVL1_TW; i += blockDim.x) {
    const int y = oy + i / OF2_TVL1_TW, x = ox + i % OF2_TVL1_TW;
    if (y >= H || x >= W) continue;
    float gx = 0.f, gy = 0.f;
    for (int t = 0; t < 9; ++t) {
      const int yy = y + t / 3 - 1, xx = x + t % 3 - 1;
      const float v = of2_tvl1_in(H, W, yy, xx) ? Wp[(size_t)yy * W + xx] : 0.f;
      if (p.sx[t] != 0.f) gx = __fadd_rn(gx, __fmul_rn(p.sx[t], v));
      if (p.sy[t] != 0.f) gy = __fadd_rn(gy, __fmul_rn(p.sy[t], v));
    }
    if (y < ylo || y >= yhi) gx = gy = 0.f;
    const float g2 = __fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy));
    const size_t k = base + (size_t)y * W + x;
    cst[k] = make_float4(gx, gy, __fmul_rn(p.lt, g2), fmaxf(g2, p.eps));
    it[k] = __fsub_rn(warped[k], prev[k]);
  }
}

// One iteration over an OF2_TVL1_TH x OF2_TVL1_TW tile: the duals of the
// tile and a one-pixel ring go to shared memory; the primal step runs over
// the tile plus its right column and bottom row (the forward differences
// need them); the dual step then updates the tile.  Live rows [ylo, yhi);
// the forward difference along y exists for live rows below yfd.
__global__ void __launch_bounds__(OF2_TVL1_THREADS)
of2_tvl1_iter(const float4* __restrict__ cst, const float* __restrict__ it,
              const float* __restrict__ u0, const float2* __restrict__ uv_in,
              const float4* __restrict__ p_in, float2* __restrict__ uv_out,
              float4* __restrict__ p_out, const Of2TVL1Params p, int ylo, int yhi, int yfd) {
  constexpr int PW = OF2_TVL1_TW + 2, UW = OF2_TVL1_TW + 1;
  __shared__ float4 s_p[(OF2_TVL1_TH + 2) * PW];
  __shared__ float2 s_uv[(OF2_TVL1_TH + 1) * UW];
  const int H = p.H, W = p.W;
  const size_t base = blockIdx.z * (size_t)H * W;
  const int oy = blockIdx.y * OF2_TVL1_TH, ox = blockIdx.x * OF2_TVL1_TW;

  for (int i = threadIdx.x; i < (OF2_TVL1_TH + 2) * PW; i += blockDim.x) {
    const int y = oy - 1 + i / PW, x = ox - 1 + i % PW;
    s_p[i] = of2_tvl1_in(H, W, y, x) ? p_in[base + (size_t)y * W + x]
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();

  // Primal: threshold step on rho = it + (u - u0u) gx + (v - u0v) gy, then
  // u + du + theta * div(p1), v + dv + theta * div(p2).
  const float neg_lt = -p.lt;
  for (int i = threadIdx.x; i < (OF2_TVL1_TH + 1) * UW; i += blockDim.x) {
    const int a = i / UW, b = i % UW;
    const int y = oy + a, x = ox + b;
    float2 r = make_float2(0.f, 0.f);
    if (y >= ylo && y < yhi && x < W) {
      const size_t k = base + (size_t)y * W + x;
      const float4 c = cst[k];
      const float2 uv = uv_in[k];
      const float rho = __fadd_rn(__fadd_rn(it[k], __fmul_rn(__fsub_rn(uv.x, u0[2 * k]), c.x)),
                                  __fmul_rn(__fsub_rn(uv.y, u0[2 * k + 1]), c.y));
      const bool lo = rho < -c.z, hi = rho > c.z;
      const float lin_u = __fdiv_rn(__fmul_rn(-rho, c.x), c.w);
      const float lin_v = __fdiv_rn(__fmul_rn(-rho, c.y), c.w);
      const float du = lo ? __fmul_rn(p.lt, c.x) : hi ? __fmul_rn(neg_lt, c.x) : lin_u;
      const float dv = lo ? __fmul_rn(p.lt, c.y) : hi ? __fmul_rn(neg_lt, c.y) : lin_v;
      const float4 pc = s_p[(a + 1) * PW + b + 1];
      const float4 pl = s_p[(a + 1) * PW + b];
      const float4 pu = s_p[a * PW + b + 1];
      const float div1 = __fadd_rn(__fsub_rn(pc.x, pl.x), __fsub_rn(pc.y, pu.y));
      const float div2 = __fadd_rn(__fsub_rn(pc.z, pl.z), __fsub_rn(pc.w, pu.w));
      r.x = __fadd_rn(__fadd_rn(uv.x, du), __fmul_rn(p.theta, div1));
      r.y = __fadd_rn(__fadd_rn(uv.y, dv), __fmul_rn(p.theta, div2));
    }
    s_uv[i] = r;
  }
  __syncthreads();

  // Dual: p <- (p + tt grad u) / (1 + tt |grad u|), forward differences
  // zero at the last image column (x) and row (y).
  for (int i = threadIdx.x; i < OF2_TVL1_TH * OF2_TVL1_TW; i += blockDim.x) {
    const int a = i / OF2_TVL1_TW, b = i % OF2_TVL1_TW;
    const int y = oy + a, x = ox + b;
    if (y >= H || x >= W) continue;
    const float2 c = s_uv[a * UW + b];
    const float2 e = s_uv[a * UW + b + 1];
    const float2 s = s_uv[(a + 1) * UW + b];
    const bool live = y >= ylo && y < yhi;
    const bool fx = live && x < W - 1, fy = live && y < yfd;
    const float ux = fx ? __fsub_rn(e.x, c.x) : 0.f, uy = fy ? __fsub_rn(s.x, c.x) : 0.f;
    const float vx = fx ? __fsub_rn(e.y, c.y) : 0.f, vy = fy ? __fsub_rn(s.y, c.y) : 0.f;
    const float nu =
        __fadd_rn(1.f, __fmul_rn(p.tt, sqrtf(__fadd_rn(__fmul_rn(ux, ux), __fmul_rn(uy, uy)))));
    const float nv =
        __fadd_rn(1.f, __fmul_rn(p.tt, sqrtf(__fadd_rn(__fmul_rn(vx, vx), __fmul_rn(vy, vy)))));
    const float4 q = s_p[(a + 1) * PW + b + 1];
    const size_t k = base + (size_t)y * W + x;
    p_out[k] = make_float4(__fdiv_rn(__fadd_rn(q.x, __fmul_rn(p.tt, ux)), nu),
                           __fdiv_rn(__fadd_rn(q.y, __fmul_rn(p.tt, uy)), nu),
                           __fdiv_rn(__fadd_rn(q.z, __fmul_rn(p.tt, vx)), nv),
                           __fdiv_rn(__fadd_rn(q.w, __fmul_rn(p.tt, vy)), nv));
    uv_out[k] = c;
  }
}

// prev, warped: (B, H, W); u0 (the warp point), flow (the start): (B, H, W, 2);
// duals: (B, H, W, 4) as (p1x, p1y, p2x, p2y), or null for zeros; flow_out:
// (B, H, W, 2), duals_out: (B, H, W, 4) or null, each distinct from every
// input.  The H rows are global rows [row0, row0 + H) of an Hg-row image
// (whole image: 0, H).  scratch: 15 * B*H*W floats, 16-byte aligned, laid
// out as cst float4 | duals float4 x 2 | flow float2 | it.  masks: 18 host
// floats (Sobel-x / 8, Sobel-y / 8).  iterations >= 1.
extern "C" int of2_tvl1_relax(const float* prev, const float* warped, const float* u0,
                              const float* flow, const float* duals_in, float* flow_out,
                              float* duals_out, float* scratch, int B, int H, int W, int row0,
                              int Hg, int iterations, const float* masks, float lt, float theta,
                              float tt, float eps, void* stream) {
  if (B < 1 || H < 1 || W < 1 || Hg < 1 || iterations < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Of2TVL1Params p;
  for (int t = 0; t < 9; ++t) {
    p.sx[t] = masks[t];
    p.sy[t] = masks[9 + t];
  }
  p.lt = lt;
  p.theta = theta;
  p.tt = tt;
  p.eps = eps;
  p.H = H;
  p.W = W;

  const size_t n = (size_t)B * H * W;
  float4* cst = (float4*)scratch;
  // The live rows, in band rows: inside the band and the global image.
  const int ylo = row0 < 0 ? -row0 : 0;
  const int yhi = Hg - row0 < H ? Hg - row0 : H;
  const int yfd = Hg - 1 - row0;
  // Iteration s reads uv[s % 2], duals[s % 2] and writes the other two; the
  // last one lands in flow_out (and duals_out when given).
  float2* uv[2];
  uv[iterations % 2] = (float2*)flow_out;
  uv[(iterations + 1) % 2] = (float2*)(scratch + 12 * n);
  float4* duals[2];
  duals[iterations % 2] = duals_out ? (float4*)duals_out : (float4*)(scratch + 4 * n);
  duals[(iterations + 1) % 2] = (float4*)(scratch + 8 * n);
  float* it = scratch + 14 * n;

  cudaError_t err = cudaMemcpyAsync(uv[0], flow, 2 * n * sizeof(float),
                                    cudaMemcpyDeviceToDevice, st);
  if (err != cudaSuccess) return (int)err;
  err = duals_in ? cudaMemcpyAsync(duals[0], duals_in, 4 * n * sizeof(float),
                                   cudaMemcpyDeviceToDevice, st)
                 : cudaMemsetAsync(duals[0], 0, 4 * n * sizeof(float), st);
  if (err != cudaSuccess) return (int)err;

  const dim3 grid((W + OF2_TVL1_TW - 1) / OF2_TVL1_TW, (H + OF2_TVL1_TH - 1) / OF2_TVL1_TH, B);
  of2_tvl1_const<<<grid, OF2_TVL1_THREADS, 0, st>>>(prev, warped, cst, it, p, ylo, yhi);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  for (int s = 0; s < iterations; ++s) {
    of2_tvl1_iter<<<grid, OF2_TVL1_THREADS, 0, st>>>(cst, it, u0, uv[s % 2], duals[s % 2],
                                                     uv[(s + 1) % 2], duals[(s + 1) % 2], p,
                                                     ylo, yhi, yfd);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
