// TV-L1 primal-dual iterations of one linearization, time-tiled: one launch
// computes the per-pixel constants, then each launch runs k iterations on
// 64 x 64 tiles held in shared memory (of2_tile.cuh), and a call of
// `iterations` runs in ceil(iterations / K) such launches of near equal
// k <= K.
//
// Layouts: images (B, H, W) float32; flow (B, H, W, 2) float32 as one float2
// (u, v) per pixel; duals (B, H, W, 4) as one float4 (p1x, p1y, p2x, p2y).
// The constants (gx, gy = Sobel / 8 of warped, th = lambda theta |g|^2,
// max(|g|^2, eps)) are one float4 per pixel and it = warped - prev; a tile
// launch loads them, and u0, into the registers of the thread that owns
// the pixel.
//
// One iteration in the tile, updating in place in two half-steps:
//   primal at (y, x) reads the duals at (y, x), (y, x-1), (y-1, x) and its
//     own (u, v) and writes only its own (u, v);
//   __syncthreads();
//   dual at (y, x) reads (u, v) at (y, x), (y, x+1), (y+1, x) and its own
//     duals and writes only its own duals;
//   __syncthreads();
// so a cell's value goes stale one cell per iteration from the tile's edge
// inward on every side, and a ring of R = k cells keeps the output tile
// exact after k iterations.  A thread walks its column of OF2_ROWS cells and
// keeps (u, v) and the duals of the cell above in registers.
//
// Every arithmetic step is an explicitly rounded intrinsic in the order of
// models/tvl1's plain scan (no FMA contraction, no reciprocal multiply), so
// a launch computes what the plain PyTorch ops compute, operation for
// operation; the threshold step evaluates all three branches and selects,
// as torch.where does.  Tensor cores have no part: FP32 stencils whose
// result depends on per-step rounding, which TF32 would change.
//
// Boundaries: the duals start at zero (the whole image) and their update at
// the last image row (column) divides a zero forward difference into a zero
// dual, so they stay zero there.  The divergence x[i] - x[i-1] with zero
// outside the image then gives both special cases of the plain _div: the
// first row keeps x[0], the last row is -x[-2].  Cells outside the band
// hold zero on every iteration, as the plain band's zero fill does.
//
// Bands (spatial TP): the H rows are global rows [row0, row0 + H) of an
// Hg-row image, and the six state planes come in and go out, so a caller
// can run the iterations in chunks with a halo exchange between them.  The
// "live" rows [ylo, yhi) lie inside the global image: gx, gy and the primal
// (u, v) are zero outside them, and the forward differences are zero at
// global row Hg - 1 (band row yfd) and at column W - 1, as in
// kernels/tvl1_sweep.tvl1_relax_band_plain.  Everything past the band edge
// reads as zero; the rows it reaches are the caller's to crop.  The whole
// image is the band row0 = 0, Hg = H with zero duals.
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "of2_tile.cuh"

#define OF2_TVL1_SMEM (6 * OF2_PLANE * (int)sizeof(float))

struct Of2TVL1Params {
  float sx[9];  // Sobel-x / 8
  float sy[9];  // Sobel-y / 8
  float lt;     // lambda * theta
  float theta;
  float tt;     // tau / theta
  float eps;    // |grad|^2 floor of the threshold step's division
  int H, W;
  int ylo, yhi;  // live band rows
  int yfd;       // the forward difference along y exists for live rows below it
};

#define OF2_TVL1_BX 32
#define OF2_TVL1_BY 8

// cst = (gx, gy, lt * g2, max(g2, eps)) and it = warped - prev, with gx, gy
// the zero-padded Sobel / 8 of warped summed in ops/conv's tap order, zero
// outside the live rows.
__global__ void of2_tvl1_const(const float* __restrict__ prev, const float* __restrict__ warped,
                               float4* __restrict__ cst, float* __restrict__ it,
                               const Of2TVL1Params p) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x, y = blockIdx.y * blockDim.y + threadIdx.y;
  const int H = p.H, W = p.W;
  if (x >= W || y >= H) return;
  const size_t base = blockIdx.z * (size_t)H * W, k = base + (size_t)y * W + x;
  const float* Wp = warped + base;
  float gx = 0.f, gy = 0.f;
  for (int t = 0; t < 9; ++t) {
    const int yy = y + t / 3 - 1, xx = x + t % 3 - 1;
    const float v = yy >= 0 && yy < H && xx >= 0 && xx < W ? Wp[(size_t)yy * W + xx] : 0.f;
    if (p.sx[t] != 0.f) gx = __fadd_rn(gx, __fmul_rn(p.sx[t], v));
    if (p.sy[t] != 0.f) gy = __fadd_rn(gy, __fmul_rn(p.sy[t], v));
  }
  if (y < p.ylo || y >= p.yhi) gx = gy = 0.f;
  const float g2 = __fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy));
  cst[k] = make_float4(gx, gy, __fmul_rn(p.lt, g2), fmaxf(g2, p.eps));
  it[k] = __fsub_rn(warped[k], prev[k]);
}

// `iters` iterations on the tile of block (x, y, batch): the state comes in
// from uv_in, p_in (null: zero duals) and the output tile goes out to
// uv_out, p_out (null: not written).
__global__ void __launch_bounds__(OF2_THREADS, 1)
of2_tvl1_tile(const float4* __restrict__ cst, const float* __restrict__ itp,
              const float* __restrict__ u0, const float* __restrict__ uv_in,
              const float* __restrict__ p_in, float* __restrict__ uv_out,
              float* __restrict__ p_out, const Of2TVL1Params p, int iters) {
  extern __shared__ float of2_smem[];
  float* const su = of2_smem;
  float* const sv = su + OF2_PLANE;
  float* const s1x = sv + OF2_PLANE;
  float* const s1y = s1x + OF2_PLANE;
  float* const s2x = s1y + OF2_PLANE;
  float* const s2y = s2x + OF2_PLANE;
  const int H = p.H, W = p.W, R = iters, T = of2_tile_out(R);
  const size_t base = blockIdx.z * (size_t)H * W;
  const int c = threadIdx.x % OF2_EXT, g0 = threadIdx.x / OF2_EXT * OF2_ROWS;
  const int oy = blockIdx.y * T - R + g0, x = blockIdx.x * T - R + c;
  const bool col_in = x >= 0 && x < W;

#pragma unroll
  for (int j = 0; j < OF2_ROWS; ++j) {
    const int y = oy + j, e = (g0 + j) * OF2_EXT + c;
    const bool in = col_in && y >= 0 && y < H, pin = in && p_in != nullptr;
    const size_t k = in ? base + (size_t)y * W + x : 0;
    of2_cp_async4(su + e, uv_in + 2 * k, in);
    of2_cp_async4(sv + e, uv_in + 2 * k + 1, in);
    const float* q = pin ? p_in + 4 * k : uv_in;
    of2_cp_async4(s1x + e, q, pin);
    of2_cp_async4(s1y + e, q + (pin ? 1 : 0), pin);
    of2_cp_async4(s2x + e, q + (pin ? 2 : 0), pin);
    of2_cp_async4(s2y + e, q + (pin ? 3 : 0), pin);
  }

  // The constants of the tile's cells.
  float gx[OF2_ROWS], gy[OF2_ROWS], th[OF2_ROWS], g2s[OF2_ROWS], it[OF2_ROWS];
  float u0u[OF2_ROWS], u0v[OF2_ROWS];
  unsigned in_m = 0, live_m = 0, fx_m = 0, fy_m = 0;
#pragma unroll
  for (int j = 0; j < OF2_ROWS; ++j) {
    const int y = oy + j;
    gx[j] = gy[j] = th[j] = g2s[j] = it[j] = u0u[j] = u0v[j] = 0.f;
    if (!col_in || y < 0 || y >= H) continue;
    const size_t k = base + (size_t)y * W + x;
    const float4 c4 = cst[k];
    const float2 w = reinterpret_cast<const float2*>(u0)[k];
    gx[j] = c4.x;
    gy[j] = c4.y;
    th[j] = c4.z;
    g2s[j] = c4.w;
    it[j] = itp[k];
    u0u[j] = w.x;
    u0v[j] = w.y;
    const bool live = y >= p.ylo && y < p.yhi;
    in_m |= 1u << j;
    if (live) live_m |= 1u << j;
    if (live && x < W - 1) fx_m |= 1u << j;
    if (live && y < p.yfd) fy_m |= 1u << j;
  }
  of2_cp_async_wait();
  __syncthreads();

  float uu[OF2_ROWS], vv[OF2_ROWS];
#pragma unroll
  for (int j = 0; j < OF2_ROWS; ++j) {
    uu[j] = su[(g0 + j) * OF2_EXT + c];
    vv[j] = sv[(g0 + j) * OF2_EXT + c];
  }
  const float neg_lt = -p.lt;
  for (int s = 0; s < iters; ++s) {
    // Primal: threshold step on rho = it + (u - u0u) gx + (v - u0v) gy, then
    // u + du + theta * div(p1), v + dv + theta * div(p2).
    float p1y_up = g0 > 0 ? s1y[(g0 - 1) * OF2_EXT + c] : 0.f;
    float p2y_up = g0 > 0 ? s2y[(g0 - 1) * OF2_EXT + c] : 0.f;
#pragma unroll
    for (int j = 0; j < OF2_ROWS; ++j) {
      const int e = (g0 + j) * OF2_EXT + c;
      const float c1x = s1x[e], c1y = s1y[e], c2x = s2x[e], c2y = s2y[e];
      const float l1x = c > 0 ? s1x[e - 1] : 0.f, l2x = c > 0 ? s2x[e - 1] : 0.f;
      if (live_m & (1u << j)) {
        const float rho = __fadd_rn(__fadd_rn(it[j], __fmul_rn(__fsub_rn(uu[j], u0u[j]), gx[j])),
                                    __fmul_rn(__fsub_rn(vv[j], u0v[j]), gy[j]));
        const bool lo = rho < -th[j], hi = rho > th[j];
        const float lin_u = __fdiv_rn(__fmul_rn(-rho, gx[j]), g2s[j]);
        const float lin_v = __fdiv_rn(__fmul_rn(-rho, gy[j]), g2s[j]);
        const float du = lo ? __fmul_rn(p.lt, gx[j]) : hi ? __fmul_rn(neg_lt, gx[j]) : lin_u;
        const float dv = lo ? __fmul_rn(p.lt, gy[j]) : hi ? __fmul_rn(neg_lt, gy[j]) : lin_v;
        const float div1 = __fadd_rn(__fsub_rn(c1x, l1x), __fsub_rn(c1y, p1y_up));
        const float div2 = __fadd_rn(__fsub_rn(c2x, l2x), __fsub_rn(c2y, p2y_up));
        uu[j] = __fadd_rn(__fadd_rn(uu[j], du), __fmul_rn(p.theta, div1));
        vv[j] = __fadd_rn(__fadd_rn(vv[j], dv), __fmul_rn(p.theta, div2));
      } else {
        uu[j] = vv[j] = 0.f;
      }
      p1y_up = c1y;
      p2y_up = c2y;
    }
    // Stored after the walk, so no store sits between the walk's loads.
#pragma unroll
    for (int j = 0; j < OF2_ROWS; ++j) {
      su[(g0 + j) * OF2_EXT + c] = uu[j];
      sv[(g0 + j) * OF2_EXT + c] = vv[j];
    }
    __syncthreads();

    // Dual: p <- (p + tt grad u) / (1 + tt |grad u|), forward differences
    // zero at the last image column (x) and row (y).
#pragma unroll
    for (int j = 0; j < OF2_ROWS; ++j) {
      if (!(in_m & (1u << j))) continue;
      const int e = (g0 + j) * OF2_EXT + c;
      const float eu = c + 1 < OF2_EXT ? su[e + 1] : 0.f;
      const float ev = c + 1 < OF2_EXT ? sv[e + 1] : 0.f;
      float bu, bv;  // the cell below
      if (j + 1 < OF2_ROWS) {
        bu = uu[j + 1];
        bv = vv[j + 1];
      } else {
        bu = g0 + OF2_ROWS < OF2_EXT ? su[e + OF2_EXT] : 0.f;
        bv = g0 + OF2_ROWS < OF2_EXT ? sv[e + OF2_EXT] : 0.f;
      }
      const bool fx = fx_m & (1u << j), fy = fy_m & (1u << j);
      const float ux = fx ? __fsub_rn(eu, uu[j]) : 0.f, uy = fy ? __fsub_rn(bu, uu[j]) : 0.f;
      const float vx = fx ? __fsub_rn(ev, vv[j]) : 0.f, vy = fy ? __fsub_rn(bv, vv[j]) : 0.f;
      const float nu =
          __fadd_rn(1.f, __fmul_rn(p.tt, sqrtf(__fadd_rn(__fmul_rn(ux, ux), __fmul_rn(uy, uy)))));
      const float nv =
          __fadd_rn(1.f, __fmul_rn(p.tt, sqrtf(__fadd_rn(__fmul_rn(vx, vx), __fmul_rn(vy, vy)))));
      s1x[e] = __fdiv_rn(__fadd_rn(s1x[e], __fmul_rn(p.tt, ux)), nu);
      s1y[e] = __fdiv_rn(__fadd_rn(s1y[e], __fmul_rn(p.tt, uy)), nu);
      s2x[e] = __fdiv_rn(__fadd_rn(s2x[e], __fmul_rn(p.tt, vx)), nv);
      s2y[e] = __fdiv_rn(__fadd_rn(s2y[e], __fmul_rn(p.tt, vy)), nv);
    }
    __syncthreads();
  }

  // The output tile: rows and columns [R, R + T) of the tile, in the band.
  if (c < R || c >= R + T) return;
#pragma unroll
  for (int j = 0; j < OF2_ROWS; ++j) {
    if (!(in_m & (1u << j)) || g0 + j < R || g0 + j >= R + T) continue;
    const int e = (g0 + j) * OF2_EXT + c;
    const size_t k = base + (size_t)(oy + j) * W + x;
    reinterpret_cast<float2*>(uv_out)[k] = make_float2(uu[j], vv[j]);
    if (p_out != nullptr)
      reinterpret_cast<float4*>(p_out)[k] = make_float4(s1x[e], s1y[e], s2x[e], s2y[e]);
  }
}

// prev, warped: (B, H, W); u0 (the warp point), flow (the start): (B, H, W, 2);
// duals: (B, H, W, 4) as (p1x, p1y, p2x, p2y), or null for zeros; flow_out:
// (B, H, W, 2), duals_out: (B, H, W, 4) or null, each distinct from every
// input.  The H rows are global rows [row0, row0 + H) of an Hg-row image
// (whole image: 0, H).  iterations >= 1 run in ceil(iterations / max_iters)
// tile launches (1 <= max_iters < OF2_EXT / 2).  scratch: 16-byte aligned,
// (5 + 6 * slots) * n2 floats (n2 = B*H*W rounded up to even, slots = tile
// launches - 1, at most 2), laid out as cst float4 | slot float4 duals and
// float2 flow, each slot | it.  masks: 18 host floats (Sobel-x / 8, Sobel-y
// / 8).
extern "C" int of2_tvl1_relax(const float* prev, const float* warped, const float* u0,
                              const float* flow, const float* duals_in, float* flow_out,
                              float* duals_out, float* scratch, int B, int H, int W, int row0,
                              int Hg, int iterations, int max_iters, const float* masks, float lt,
                              float theta, float tt, float eps, void* stream) {
  if (B < 1 || H < 1 || W < 1 || Hg < 1 || iterations < 1 || max_iters < 1 ||
      2 * max_iters >= OF2_EXT)
    return (int)cudaErrorInvalidValue;
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
  // The live rows, in band rows: inside the band and the global image.
  p.ylo = row0 < 0 ? -row0 : 0;
  p.yhi = Hg - row0 < H ? Hg - row0 : H;
  p.yfd = Hg - 1 - row0;

  const size_t n = (size_t)B * H * W, n2 = n + (n & 1);
  const int launches = of2_launches(iterations, max_iters);
  const int slots = launches - 1 < 2 ? launches - 1 : 2;
  float4* cst = (float4*)scratch;
  float* it = scratch + (4 + 6 * slots) * n2;
  const dim3 block(OF2_TVL1_BX, OF2_TVL1_BY);
  const dim3 grid((W + OF2_TVL1_BX - 1) / OF2_TVL1_BX, (H + OF2_TVL1_BY - 1) / OF2_TVL1_BY, B);
  of2_tvl1_const<<<grid, block, 0, st>>>(prev, warped, cst, it, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(of2_tvl1_tile, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             OF2_TVL1_SMEM);
  if (err != cudaSuccess) return (int)err;
  // Launch j reads the state launch j - 1 wrote (j = 0: the caller's) and
  // writes into scratch slot j % 2 (duals, then flow), the last one into
  // flow_out and duals_out.
  const float* uv_in = flow;
  const float* p_in = duals_in;
  for (int j = 0; j < launches; ++j) {
    const bool last = j + 1 == launches;
    float* slot = scratch + (4 + 6 * (j % 2)) * n2;
    float* uv_out = last ? flow_out : slot + 4 * n2;
    float* p_out = last ? duals_out : slot;
    const int k = of2_part(iterations, max_iters, j), T = of2_tile_out(k);
    const dim3 tiles((W + T - 1) / T, (H + T - 1) / T, B);
    of2_tvl1_tile<<<tiles, OF2_THREADS, OF2_TVL1_SMEM, st>>>(cst, it, u0, uv_in, p_in, uv_out,
                                                             p_out, p, k);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    uv_in = uv_out;
    p_in = p_out;
  }
  return (int)cudaSuccess;
}
