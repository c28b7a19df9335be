// One Farnebaeck refinement, image formulation, in one pass per output tile:
//   warped  = next backward-warped by the budget-clipped flow
//             (of2_warp_pixel_band; an out-of-image sample keeps the source
//             pixel), zero outside the image; next itself on the first
//             iteration;
//   exp_w   = polynomial expansion of warped (of2_poly.cuh);
//   P       = the five normal-equation products against the previous frame's
//             expansion, with the clipped flow (zero on the first iteration),
//             zero outside the image;
//   flow    = box window of P and the guarded 2x2 solve (of2_win_tile.cuh,
//             shared with win_solve.cu): the total flow, not a residual.
//
// A block owns a TH x TW output tile (the wrapper picks it for the radii,
// kernels/tile_geometry.fb_tile; TH and TW multiples of OF2_RUN).  With
// window radius rw and expansion radius rp it warps (TH + 2(rw + rp)) x
// (TW + 2(rw + rp)) pixels into shared memory (S), takes the vertical
// expansion sums over (TH + 2 rw) rows (T), the horizontal moments, the
// expansion and the products over (TH + 2 rw) x (TW + 2 rw) (P), then the
// window's column pass (V, in the space of S and T) and its row pass and
// the solve.  Every pass is register-blocked (OF2_RUN cells a thread,
// of2_common.cuh) and keeps the plain version's order of each sum (taps
// 0..2r; the window's rows, then its columns), so a pixel's arithmetic does
// not depend on its tile or on its place in a run.  Leading dimensions that
// lanes stride over are odd (no bank conflicts).
//
// Bands (spatial TP): the H rows are global rows [row0, row0 + H) of an
// Hg-row image.  The warp floors and clamps the sample row in global rows;
// the warped frame and the products are zero outside the "live" rows
// [ylo, yhi), those inside the band and the global image, so the expansion
// and the window see the zero padding of the whole image; everything past
// the band edge reads as zero and the rows it reaches are the caller's to
// crop.  The live range goes to the kernel as two ints by value.  The whole
// image is the band row0 = 0, Hg = H.
#include "of2_poly.cuh"
#include "of2_win_tile.cuh"

#define OF2_FB_THREADS 256
#define OF2_FB_BATCH 8  // cells a thread warps at once

struct Of2FBParams {
  Of2PolyTaps poly;
  float det_eps;
  float max_disp;
  int rw;
  int H;
  int W;
  int first;
  int th;  // output tile rows
  int tw;  // output tile columns
};

// Floats of shared memory (kernels/tile_geometry.fb_tile mirrors this).
static inline size_t of2_fb_smem_floats(int rw, int rp, int th, int tw) {
  const size_t ph = th + 2 * rw, pw = tw + 2 * rw, sh = ph + 2 * rp, sw = pw + 2 * rp;
  const size_t ldp = pw | 1, ldt = sw | 1;
  const size_t expand = sh * sw + 3 * ph * ldt, window = 5 * th * ldp;
  return 5 * ph * ldp + (expand > window ? expand : window);
}

// RW, RP >= 0: the window and expansion radii, fixed at compile time (they
// must equal p.rw and p.poly.r); < 0: any radii.
template <int RW, int RP>
__global__ void __launch_bounds__(OF2_FB_THREADS, 3)
of2_fb_step_kernel(const float* __restrict__ nxt, const float* __restrict__ bx1,
                   const float* __restrict__ by1, const float* __restrict__ axx1,
                   const float* __restrict__ ayy1, const float* __restrict__ axy1,
                   const float* __restrict__ flow_in, float* __restrict__ flow_out,
                   const Of2FBParams p, int row0, int Hg, int ylo, int yhi) {
  extern __shared__ float smem[];
  const int rw = RW >= 0 ? RW : p.rw, rp = RP >= 0 ? RP : p.poly.r;
  const int H = p.H, W = p.W, th = p.th, tw = p.tw;
  const int ph = th + 2 * rw, pw = tw + 2 * rw;  // products: ph x pw
  const int sh = ph + 2 * rp, sw = pw + 2 * rp;  // warped: sh x sw
  const int ldp = pw | 1, ldt = sw | 1;
  const int pplane = ph * ldp, tplane = ph * ldt, vplane = th * ldp;
  float* P = smem;         // five planes of ph x pw
  float* S = P + 5 * pplane;
  float* T = S + sh * sw;  // three planes of ph x sw
  float* V = S;            // the window's column pass, once S and T are spent

  const size_t plane = (size_t)H * W, off = blockIdx.z * plane;
  const float* N = nxt + off;
  const float* F = p.first ? nullptr : flow_in + 2 * off;
  const float* e1[5] = {bx1 + off, by1 + off, axx1 + off, ayy1 + off, axy1 + off};
  const int oy = blockIdx.y * th, ox = blockIdx.x * tw;

  // Warped next over the tile and its rw + rp halo, zero outside the live
  // rows.  A thread takes OF2_FB_BATCH cells at a time with every load
  // unconditional (addresses clamped, results selected), so their loads
  // overlap.
  const int ns = sh * sw;
  for (int i0 = threadIdx.x; i0 < ns; i0 += OF2_FB_BATCH * blockDim.x) {
    float sv[OF2_FB_BATCH];
#pragma unroll
    for (int b = 0; b < OF2_FB_BATCH; ++b) {
      const int i = i0 + b * blockDim.x;
      const int y = oy - rw - rp + i / sw, x = ox - rw - rp + i % sw;
      const bool live = i < ns && y >= ylo && y < yhi && x >= 0 && x < W;
      const size_t k = (size_t)min(max(y, 0), H - 1) * W + min(max(x, 0), W - 1);
      if (p.first) {
        const float n = N[k];
        sv[b] = live ? n : 0.f;
      } else {
        sv[b] = of2_warp_gather(N, H, W, x, y, live, F[2 * k], F[2 * k + 1], p.max_disp, row0, Hg);
      }
    }
#pragma unroll
    for (int b = 0; b < OF2_FB_BATCH; ++b)
      if (i0 + b * blockDim.x < ns) S[i0 + b * blockDim.x] = sv[b];
  }
  __syncthreads();

  // Vertical expansion sums T_k = sum_t g_k[t] S[y + t], k = 0, 1, 2: lanes
  // take consecutive columns, a thread walks OF2_RUN + 2 rp rows of one.
  for (int i = threadIdx.x; i < sw * of2_runs(ph); i += blockDim.x) {
    const int x = i % sw, y0 = of2_run_start(i / sw, ph);
    float a[3][OF2_RUN];
    of2_poly_vertical_run<RP>([&](int j, float (&v)[1]) { v[0] = S[(y0 + j) * sw + x]; },
                              p.poly, a);
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int k = 0; k < OF2_RUN; ++k) T[c * tplane + (y0 + k) * ldt + x] = a[c][k];
  }
  __syncthreads();

  // Horizontal moments and the expansion of the warped frame over the tile
  // and its rw halo, into P: lanes take consecutive rows, a thread walks
  // OF2_RUN + 2 rp columns of one.
  for (int i = threadIdx.x; i < ph * of2_runs(pw); i += blockDim.x) {
    const int py = i % ph, px0 = of2_run_start(i / ph, pw);
    const float* t0 = T + py * ldt + px0;
    const float* t1 = t0 + tplane;
    const float* t2 = t1 + tplane;
    of2_poly_moments_run<RP>(
        [&](int j, float (&v)[3]) {
          v[0] = t0[j];
          v[1] = t1[j];
          v[2] = t2[j];
        },
        p.poly, [&](int q, int k, float e) { P[q * pplane + py * ldp + px0 + k] = e; });
  }
  __syncthreads();

  // The products, in place of the expansion: lanes take consecutive columns,
  // so the previous frame's expansion and the flow are read in whole rows;
  // a thread loads two cells at once.
  const int np = ph * pw;
  for (int i0 = threadIdx.x; i0 < np; i0 += 2 * blockDim.x) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      // past the end: recompute the last cell, unwritten (it is updated in place)
      const int i = min(i0 + b * (int)blockDim.x, np - 1);
      const int py = i / pw, px = i % pw;
      const int y = oy - rw + py, x = ox - rw + px;
      const int s0 = py * ldp + px;
      const bool live = y >= ylo && y < yhi && x >= 0 && x < W;
      const size_t o = (size_t)min(max(y, 0), H - 1) * W + min(max(x, 0), W - 1);
      float w[5], e[5], prod[5];
#pragma unroll
      for (int q = 0; q < 5; ++q) {
        w[q] = P[q * pplane + s0];
        e[q] = e1[q][o];
      }
      // The products use the budget-clipped flow, the flow the warp applied.
      const float u = p.first ? 0.f : of2_clamp(F[2 * o], -p.max_disp, p.max_disp);
      const float v = p.first ? 0.f : of2_clamp(F[2 * o + 1], -p.max_disp, p.max_disp);
      of2_fb_products(e, w, u, v, prod);
      if (i0 + b * (int)blockDim.x < np) {
#pragma unroll
        for (int q = 0; q < 5; ++q) P[q * pplane + s0] = live ? prod[q] : 0.f;
      }
    }
  }
  __syncthreads();

  // The window's column pass: lanes take consecutive columns, a thread
  // walks OF2_RUN + 2 rw rows of one.
  for (int i = threadIdx.x; i < pw * (th / OF2_RUN); i += blockDim.x) {
    const int x = i % pw, y0 = (i / pw) * OF2_RUN;
    float a[5][OF2_RUN];
    of2_win_sum_run<RW>(rw, [&](int j, float (&v)[5]) {
#pragma unroll
      for (int c = 0; c < 5; ++c) v[c] = P[c * pplane + (y0 + j) * ldp + x];
    }, a);
#pragma unroll
    for (int c = 0; c < 5; ++c)
#pragma unroll
      for (int k = 0; k < OF2_RUN; ++k) V[c * vplane + (y0 + k) * ldp + x] = a[c][k];
  }
  __syncthreads();

  // The row pass and the solve: lanes take consecutive rows, a thread walks
  // OF2_RUN + 2 rw columns of one.
  float* Fout = flow_out + 2 * off;
  for (int i = threadIdx.x; i < th * (tw / OF2_RUN); i += blockDim.x) {
    const int ty = i % th, tx0 = (i / th) * OF2_RUN;
    float s[5][OF2_RUN];
    of2_win_sum_run<RW>(rw, [&](int j, float (&v)[5]) {
#pragma unroll
      for (int c = 0; c < 5; ++c) v[c] = V[c * vplane + ty * ldp + tx0 + j];
    }, s);
    const int y = oy + ty;
    if (y >= H) continue;
#pragma unroll
    for (int k = 0; k < OF2_RUN; ++k) {
      const int x = ox + tx0 + k;
      if (x >= W) continue;
      const float sk[5] = {s[0][k], s[1][k], s[2][k], s[3][k], s[4][k]};
      const float2 f = of2_win_solve(sk, p.det_eps);
      const size_t o = (size_t)y * W + x;
      Fout[2 * o] = f.x;
      Fout[2 * o + 1] = f.y;
    }
  }
}

// nxt, bx1, by1, axx1, ayy1, axy1: (B, H, W) float32; flow_in, flow_out:
// (B, H, W, 2) float32 (flow_in is not read when first != 0 and may be
// null); the H rows are global rows [row0, row0 + H) of an Hg-row image
// (whole image: 0, H); taps: 3 x (2rp+1) float32; mix: 5 x 6 float32 (axy
// row halved); th x tw: the output tile (kernels/tile_geometry.fb_tile),
// refused unless both are positive multiples of OF2_RUN and its shared
// memory fits a block.
extern "C" int of2_fb_step(const float* nxt, const float* bx1, const float* by1,
                           const float* axx1, const float* ayy1, const float* axy1,
                           const float* flow_in, float* flow_out, int B, int H, int W, int row0,
                           int Hg, int rw, int rp, int th, int tw, const float* taps,
                           const float* mix, float det_eps, float max_disp, int first,
                           void* stream) {
  Of2FBParams p;
  if (rw < 0 || rw > OF2_WT_MAX_R || B < 1 || H < 1 || W < 1 || Hg < 1 || (!first && !flow_in) ||
      th < OF2_RUN || tw < OF2_RUN || th % OF2_RUN || tw % OF2_RUN ||
      !of2_poly_fill(&p.poly, rp, taps, mix))
    return (int)cudaErrorInvalidValue;
  const size_t smem = of2_fb_smem_floats(rw, rp, th, tw) * sizeof(float);
  if (smem > OF2_SMEM_MAX) return (int)cudaErrorInvalidValue;
  p.det_eps = det_eps;
  p.max_disp = max_disp;
  p.rw = rw;
  p.H = H;
  p.W = W;
  p.first = first;
  p.th = th;
  p.tw = tw;
  // FBConfig()'s radii (winsize 15, poly_n 7) run a kernel compiled for
  // them; any other radii run the generic one.
  void (*kernel)(const float*, const float*, const float*, const float*, const float*,
                 const float*, const float*, float*, const Of2FBParams, int, int, int, int) =
      rw == 7 && rp == 3 ? of2_fb_step_kernel<7, 3> : of2_fb_step_kernel<-1, -1>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int ylo = row0 < 0 ? -row0 : 0;
  const int yhi = Hg - row0 < H ? Hg - row0 : H;
  const dim3 grid((W + tw - 1) / tw, (H + th - 1) / th, B);
  kernel<<<grid, OF2_FB_THREADS, smem, (cudaStream_t)stream>>>(
      nxt, bx1, by1, axx1, ayy1, axy1, flow_in, flow_out, p, row0, Hg, ylo, yhi);
  return (int)cudaGetLastError();
}
