// One LK solve per output tile: (warp) -> gradients -> weighted window sums
// -> guarded 2x2 solve, with every intermediate in shared memory.
//
// Shared by lk_fused.cu (residual only, STEP = false) and lk_step_fused.cu
// (warp + residual + accumulate, STEP = true).  CENTERED (the DIS data term)
// carries four more sums, Ix, Iy, It and the in-image count n, and turns
// each product sum into S_ab - S_a S_b / max(n, 1) before the solve
// (ops/window.centered_structure_tensor_sums).
//
// A block owns a TH x TW output tile (the wrapper picks it for r,
// kernels/tile_geometry.lk_tile; TH and TW multiples of OF2_RUN).  With
// window radius r:
//   S: (TH + 2r + 2) x (TW + 2r + 2) source pixels, prev (staged with
//      cp.async) and the (warped) next, zero outside the image;
//   G: (TH + 2r) x (TW + 2r) gradients Ix, Iy, It, zero outside the image,
//      so window sums see zero padding at the border;
//   R: five (CENTERED: nine) row-pass sums, (TH + 2r) x TW each
//      (overwrites S).
// The column pass then reads R and the solve writes (u, v) per pixel.
//
// Every pass is register-blocked (OF2_RUN cells a thread, of2_common.cuh):
// the gradient pass walks a column, the row pass forms the products once
// per gradient cell and the column pass loads each row-pass sum once per
// run.  Each window sum keeps the order of one sum per pixel, taps d = 0..2r
// (rows, then columns), and a pixel's arithmetic does not depend on its tile
// or on its place in a run, so a band and the whole image give the same
// bits.  Leading dimensions that lanes stride over are odd (no bank
// conflicts).
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

#define OF2_LK_THREADS 256
#define OF2_LK_BATCH 4  // cells a thread warps at once

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
  int th;    // output tile rows
  int tw;    // output tile columns
};

// Floats of shared memory (kernels/tile_geometry.lk_tile mirrors this).
static inline size_t of2_lk_smem_floats(int r, int th, int tw, bool centered) {
  const size_t sh = th + 2 * r + 2, sw = tw + 2 * r + 2;
  const size_t gh = th + 2 * r, gw = tw + 2 * r, ldg = gw | 1, ldr = tw + 1;
  const size_t s = 2 * sh * sw, rows = (centered ? 9 : 5) * gh * ldr;
  return 3 * gh * ldg + (s > rows ? s : rows);
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

// RT >= 0: the window radius, fixed at compile time (it must equal p.r);
// RT < 0: any radius.
template <bool STEP, bool CENTERED, bool HALF, int RT>
__global__ void __launch_bounds__(OF2_LK_THREADS, CENTERED ? 3 : 4)
of2_lk_tile_kernel(const float* __restrict__ prev, const float* __restrict__ nxt,
                   const float* __restrict__ flow_in, float* __restrict__ flow_out,
                   const Of2LKParams p) {
  constexpr int NP = CENTERED ? 9 : 5;  // window sums
  constexpr int TAPS = RT >= 0 ? 2 * RT + 1 : 0;
  extern __shared__ float smem[];
  const int r = RT >= 0 ? RT : p.r, H = p.H, W = p.W, th = p.th, tw = p.tw;
  const int sh = th + 2 * r + 2, sw = tw + 2 * r + 2;
  const int gh = th + 2 * r, gw = tw + 2 * r;
  const int ldg = gw | 1, ldr = tw + 1, gplane = gh * ldg, rplane = gh * ldr;
  float* g_ix = smem;
  float* g_iy = g_ix + gplane;
  float* g_it = g_iy + gplane;
  float* s_prev = g_it + gplane;
  float* s_next = s_prev + sh * sw;
  float* rows = s_prev;  // R reuses S once the gradients are taken

  const size_t plane = (size_t)H * W;
  const size_t flow_plane = HALF ? (size_t)(H >> 1) * (W >> 1) : plane;
  const float* P = prev + blockIdx.z * plane;
  const float* N = nxt + blockIdx.z * plane;
  const float* Fin = STEP ? flow_in + 2 * blockIdx.z * flow_plane : nullptr;
  float* Fout = flow_out + 2 * blockIdx.z * plane;
  const int oy = blockIdx.y * th, ox = blockIdx.x * tw;

  // S: prev, copied while the next frame is warped, and (warped) next.
  // Each pixel is warped by its own flow, halo included, as the plain
  // composition warps the whole image first; next is zero outside the band
  // and the image, so S_next - S_prev is the plain version's difference.  A
  // thread takes OF2_LK_BATCH cells at a time with every load unconditional
  // (addresses clamped, results selected), so their loads overlap.
  const int ns = sh * sw;
  for (int i = threadIdx.x; i < ns; i += blockDim.x) {
    const int y = oy - r - 1 + i / sw, x = ox - r - 1 + i % sw;
    const bool in = y >= 0 && y < H && x >= 0 && x < W;
    of2_cp_async4(s_prev + i, in ? P + (size_t)y * W + x : P, in);
  }
  for (int i0 = threadIdx.x; i0 < ns; i0 += OF2_LK_BATCH * blockDim.x) {
    float nv[OF2_LK_BATCH];
#pragma unroll
    for (int b = 0; b < OF2_LK_BATCH; ++b) {
      const int i = i0 + b * blockDim.x;
      const int y = oy - r - 1 + i / sw, x = ox - r - 1 + i % sw;
      const bool live = i < ns && y >= 0 && y < H && x >= 0 && x < W && p.row0 + y >= 0 &&
                        p.row0 + y < p.Hg;
      const int yc = min(max(y, 0), H - 1), xc = min(max(x, 0), W - 1);
      if (STEP) {
        const float2 f = of2_flow_at<HALF>(Fin, H, W, yc, xc);
        nv[b] = of2_warp_gather(N, H, W, xc, yc, live, f.x, f.y, p.max_disp, p.row0, p.Hg);
      } else {
        const float n = N[(size_t)yc * W + xc];
        nv[b] = live ? n : 0.f;
      }
    }
#pragma unroll
    for (int b = 0; b < OF2_LK_BATCH; ++b)
      if (i0 + b * blockDim.x < ns) s_next[i0 + b * blockDim.x] = nv[b];
  }
  of2_cp_async_wait();
  __syncthreads();

  // G: 3x3 stencils, zeroed outside the band and outside the image.  A
  // thread walks OF2_RUN + 2 source rows of three columns and adds each
  // row into the stencils of the (up to three) gradient rows it touches.
  for (int i = threadIdx.x; i < gw * of2_runs(gh); i += blockDim.x) {
    const int gx = i % gw, gy0 = of2_run_start(i / gw, gh);
    float ix[OF2_RUN], iy[OF2_RUN], it[OF2_RUN];
#pragma unroll
    for (int k = 0; k < OF2_RUN; ++k) ix[k] = iy[k] = it[k] = 0.f;
#pragma unroll
    for (int j = 0; j < OF2_RUN + 2; ++j) {
      const int s0 = (gy0 + j) * sw + gx;
      float pv[3], dv[3];
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        pv[q] = s_prev[s0 + q];
        dv[q] = s_next[s0 + q] - pv[q];
      }
#pragma unroll
      for (int k = 0; k < OF2_RUN; ++k) {
        const int m = j - k;  // stencil row
        if (m < 0 || m > 2) continue;
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          ix[k] += p.sx[3 * m + q] * pv[q];
          iy[k] += p.sy[3 * m + q] * pv[q];
          it[k] += p.st[3 * m + q] * dv[q];
        }
      }
    }
    const int x = ox - r + gx;
#pragma unroll
    for (int k = 0; k < OF2_RUN; ++k) {
      const int gy = gy0 + k, y = oy - r + gy;
      const bool in = y >= 0 && y < H && x >= 0 && x < W && p.row0 + y >= 0 && p.row0 + y < p.Hg;
      g_ix[gy * ldg + gx] = in ? ix[k] : 0.f;
      g_iy[gy * ldg + gx] = in ? iy[k] : 0.f;
      g_it[gy * ldg + gx] = in ? it[k] : 0.f;
    }
  }
  __syncthreads();

  // R: row pass of the five products (CENTERED: and of Ix, Iy, It and the
  // in-image indicator) over the window's columns.  Lanes take consecutive
  // rows; a thread forms the products of each of its OF2_RUN + 2r cells once.
  for (int i = threadIdx.x; i < gh * (tw / OF2_RUN); i += blockDim.x) {
    const int gy = i % gh, c0 = (i / gh) * OF2_RUN;
    const int y = oy - r + gy;
    const bool row_in = y >= 0 && y < H && p.row0 + y >= 0 && p.row0 + y < p.Hg;
    const int g0 = gy * ldg + c0;
    float a[NP][OF2_RUN];
#pragma unroll
    for (int c = 0; c < NP; ++c)
#pragma unroll
      for (int k = 0; k < OF2_RUN; ++k) a[c][k] = 0.f;
    of2_run_sum<NP, NP, TAPS>(
        2 * r + 1,
        [&](int j, float (&v)[NP]) {
          const float ix = g_ix[g0 + j], iy = g_iy[g0 + j], it = g_it[g0 + j];
          v[0] = ix * ix;
          v[1] = iy * iy;
          v[2] = ix * iy;
          v[3] = ix * it;
          v[4] = iy * it;
          if (CENTERED) {
            const int x = ox - r + c0 + j;
            v[5] = ix;
            v[6] = iy;
            v[7] = it;
            v[NP - 1] = row_in && x >= 0 && x < W ? 1.f : 0.f;
          }
        },
        [&](int d, const float (&v)[NP], float (&acc)[NP][OF2_RUN], int k) {
          const float w = p.taps[d];
#pragma unroll
          for (int c = 0; c < (CENTERED ? NP - 1 : NP); ++c) acc[c][k] += w * v[c];
          if (CENTERED) acc[NP - 1][k] += v[NP - 1] != 0.f ? w : 0.f;
        },
        a);
#pragma unroll
    for (int c = 0; c < NP; ++c)
#pragma unroll
      for (int k = 0; k < OF2_RUN; ++k) rows[c * rplane + gy * ldr + c0 + k] = a[c][k];
  }
  __syncthreads();

  // Column pass, solve, write.  Lanes take consecutive columns; a thread
  // loads each row-pass sum of its OF2_RUN + 2r rows once.
  for (int i = threadIdx.x; i < tw * (th / OF2_RUN); i += blockDim.x) {
    const int c = i % tw, ty0 = (i / tw) * OF2_RUN;
    float s[NP][OF2_RUN];
#pragma unroll
    for (int q = 0; q < NP; ++q)
#pragma unroll
      for (int k = 0; k < OF2_RUN; ++k) s[q][k] = 0.f;
    of2_run_sum<NP, NP, TAPS>(
        2 * r + 1,
        [&](int j, float (&v)[NP]) {
#pragma unroll
          for (int q = 0; q < NP; ++q) v[q] = rows[q * rplane + (ty0 + j) * ldr + c];
        },
        [&](int d, const float (&v)[NP], float (&acc)[NP][OF2_RUN], int k) {
          const float w = p.taps[d];
#pragma unroll
          for (int q = 0; q < NP; ++q) acc[q][k] += w * v[q];
        },
        s);
    const int x = ox + c;
#pragma unroll
    for (int k = 0; k < OF2_RUN; ++k) {
      const int y = oy + ty0 + k;
      if (y >= H || x >= W) continue;
      float s0 = s[0][k], s1 = s[1][k], s2 = s[2][k], s3 = s[3][k], s4 = s[4][k];
      if (CENTERED) {
        // s[5..8] = sum Ix, Iy, It, n: the per-window covariances
        const float s5 = s[5][k], s6 = s[6][k], s7 = s[7][k];
        const float inv_n = 1.f / fmaxf(s[NP - 1][k], 1.f);
        s0 = s0 - s5 * s5 * inv_n;
        s1 = s1 - s6 * s6 * inv_n;
        s2 = s2 - s5 * s6 * inv_n;
        s3 = s3 - s5 * s7 * inv_n;
        s4 = s4 - s6 * s7 * inv_n;
      }
      // s0..s4 = sum Ix^2, Iy^2, IxIy, IxIt, IyIt; d = -A^-1 b.  Guarded, the
      // products are rounded on their own (no FMA contraction), as the plain
      // version (ops/solve.solve_2x2) rounds them: a rank-one A (a 1x1
      // window) then has det exactly 0 in both, not a contraction's residue
      // that 1/det would blow up.
      float u, v;
      if (p.det_eps > 0.f) {
        const float det = __fsub_rn(__fmul_rn(s0, s1), __fmul_rn(s2, s2));
        const bool safe = fabsf(det) >= p.det_eps;
        const float inv = 1.f / (safe ? det : 1.f);
        u = safe ? __fmul_rn(__fadd_rn(__fmul_rn(-s1, s3), __fmul_rn(s2, s4)), inv) : 0.f;
        v = safe ? __fmul_rn(__fsub_rn(__fmul_rn(s2, s3), __fmul_rn(s0, s4)), inv) : 0.f;
      } else {
        const float det = s0 * s1 - s2 * s2;
        const float inv = 1.f / det;
        u = (-s1 * s3 + s2 * s4) * inv;
        v = (s2 * s3 - s0 * s4) * inv;
      }
      const size_t o = (size_t)y * W + x;
      if (STEP) {
        // Accumulate on the budget-clamped flow, not the border-clamped one.
        const float2 f = of2_flow_at<HALF>(Fin, H, W, y, x);
        u += of2_clamp(f.x, -p.max_disp, p.max_disp);
        v += of2_clamp(f.y, -p.max_disp, p.max_disp);
      }
      Fout[2 * o] = u;
      Fout[2 * o + 1] = v;
    }
  }
}

template <bool STEP, bool CENTERED, bool HALF, int RT>
static int of2_lk_run_r(const float* prev, const float* nxt, const float* flow_in, float* flow_out,
                      int B, int H, int W, const Of2LKParams& p, void* stream) {
  const size_t smem = of2_lk_smem_floats(p.r, p.th, p.tw, CENTERED) * sizeof(float);
  if (smem > OF2_SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(of2_lk_tile_kernel<STEP, CENTERED, HALF, RT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + p.tw - 1) / p.tw, (H + p.th - 1) / p.th, B);
  of2_lk_tile_kernel<STEP, CENTERED, HALF, RT>
      <<<grid, OF2_LK_THREADS, smem, (cudaStream_t)stream>>>(prev, nxt, flow_in, flow_out, p);
  return (int)cudaGetLastError();
}

// The radii of the main paths' windows run a kernel compiled for them
// (PAPER_1080P 15x15, DISConfig() and DIS_REALTIME 9x9, REFERENCE_GPU and
// LKConfig(levels=4, window=19) 19x19); any other radius runs the generic
// one.
template <bool STEP, bool CENTERED, bool HALF>
static int of2_lk_run(const float* prev, const float* nxt, const float* flow_in, float* flow_out,
                      int B, int H, int W, const Of2LKParams& p, void* stream) {
  switch (p.r) {
    case 4:
      return of2_lk_run_r<STEP, CENTERED, HALF, 4>(prev, nxt, flow_in, flow_out, B, H, W, p,
                                                   stream);
    case 7:
      return of2_lk_run_r<STEP, CENTERED, HALF, 7>(prev, nxt, flow_in, flow_out, B, H, W, p,
                                                   stream);
    case 9:
      return of2_lk_run_r<STEP, CENTERED, HALF, 9>(prev, nxt, flow_in, flow_out, B, H, W, p,
                                                   stream);
    default:
      return of2_lk_run_r<STEP, CENTERED, HALF, -1>(prev, nxt, flow_in, flow_out, B, H, W, p,
                                                    stream);
  }
}

// Host side: check the tile, fill the parameters, allow the dynamic shared
// memory, launch, and return the launch status (cudaSuccess == 0).  A tile
// whose sides are not positive multiples of OF2_RUN, or whose shared memory
// exceeds what a block may have, is refused.  half != 0 (STEP only) takes
// the (B, H/2, W/2, 2) coarser flow: even H and W, the whole image.
template <bool STEP>
static int of2_lk_launch(const float* prev, const float* nxt, const float* flow_in,
                         float* flow_out, int B, int H, int W, int row0, int Hg, int r, int th,
                         int tw, const float* taps, const float* masks, float det_eps,
                         float max_disp, int centered, int half, void* stream) {
  if (r < 0 || r > OF2_MAX_R || B < 1 || H < 1 || W < 1 || Hg < 1)
    return (int)cudaErrorInvalidValue;
  if (th < OF2_RUN || tw < OF2_RUN || th % OF2_RUN || tw % OF2_RUN)
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
  p.th = th;
  p.tw = tw;
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
