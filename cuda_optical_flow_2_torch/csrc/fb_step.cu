// One Farnebaeck refinement, image formulation, in one pass per output tile:
//   warped  = next backward-warped by the budget-clipped flow
//             (of2_warp_pixel_band; an out-of-image sample keeps the source
//             pixel), zero outside the image; next itself on the first
//             iteration;
//   exp_w   = polynomial expansion of warped (of2_poly.cuh);
//   P       = the five normal-equation products against the previous frame's
//             expansion, with the clipped flow (zero on the first iteration),
//             zero outside the image;
//   flow    = box window of P and the guarded 2x2 solve (of2_win_tile.cuh):
//             the total flow, not a residual.
//
// A block owns an OF2_WT_TILE^2 output tile.  With window radius rw and
// expansion radius rp it warps (tile + 2(rw + rp))^2 pixels into shared
// memory, expands and forms the products over (tile + 2 rw)^2, then windows
// and solves.  Shared memory: P, plus the warped tile and the vertical
// expansion sums, whose space the window's column pass reuses.
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

struct Of2FBParams {
  Of2PolyTaps poly;
  float det_eps;
  float max_disp;
  int rw;
  int H;
  int W;
  int first;
};

static inline size_t of2_fb_smem_floats(int rw, int rp) {
  const size_t sw = OF2_WT_TILE + 2 * (rw + rp), ph = OF2_WT_TILE + 2 * rw;
  const size_t expand = sw * sw + 3 * ph * sw, window = of2_wt_v_floats(rw);
  return of2_wt_p_floats(rw) + (expand > window ? expand : window);
}

__global__ void __launch_bounds__(OF2_WT_THREADS)
of2_fb_step_kernel(const float* __restrict__ nxt, const float* __restrict__ bx1,
                   const float* __restrict__ by1, const float* __restrict__ axx1,
                   const float* __restrict__ ayy1, const float* __restrict__ axy1,
                   const float* __restrict__ flow_in, float* __restrict__ flow_out,
                   const Of2FBParams p, int row0, int Hg, int ylo, int yhi) {
  extern __shared__ float smem[];
  const int rw = p.rw, rp = p.poly.r, H = p.H, W = p.W;
  const int ph = OF2_WT_TILE + 2 * rw;  // products: ph x ph
  const int sw = ph + 2 * rp;           // warped: sw x sw
  const int pplane = ph * ph;
  float* P = smem;
  float* S = P + 5 * pplane;
  float* T = S + sw * sw;  // three planes of ph x sw
  float* V = S;            // the window's column pass, once S and T are spent

  const size_t plane = (size_t)H * W, off = blockIdx.z * plane;
  const float* N = nxt + off;
  const float* F = p.first ? nullptr : flow_in + 2 * off;
  const float* e1[5] = {bx1 + off, by1 + off, axx1 + off, ayy1 + off, axy1 + off};
  const int oy = blockIdx.y * OF2_WT_TILE, ox = blockIdx.x * OF2_WT_TILE;

  // Warped next over the tile and its rw + rp halo, zero outside the live rows.
  for (int i = threadIdx.x; i < sw * sw; i += blockDim.x) {
    const int y = oy - rw - rp + i / sw, x = ox - rw - rp + i % sw;
    float v = 0.f;
    if (y >= ylo && y < yhi && x >= 0 && x < W) {
      const size_t k = (size_t)y * W + x;
      v = p.first ? N[k]
                  : of2_warp_pixel_band(N, H, W, x, y, F[2 * k], F[2 * k + 1], p.max_disp, row0,
                                        Hg);
    }
    S[i] = v;
  }
  __syncthreads();
  of2_poly_vertical(S, sw, T, ph, sw, p.poly);
  __syncthreads();

  // Expansion of the warped frame and the products over the tile and its rw halo.
  for (int i = threadIdx.x; i < pplane; i += blockDim.x) {
    const int py = i / ph, px = i % ph;
    const int y = oy - rw + py, x = ox - rw + px;
    float prod[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
    if (y >= ylo && y < yhi && x >= 0 && x < W) {
      const size_t k = (size_t)y * W + x;
      float w[5], e[5];
      of2_poly_pixel(T, ph * sw, sw, py, px, p.poly, w);
#pragma unroll
      for (int c = 0; c < 5; ++c) e[c] = e1[c][k];
      // The products use the budget-clipped flow, the flow the warp applied.
      const float u = p.first ? 0.f : of2_clamp(F[2 * k], -p.max_disp, p.max_disp);
      const float v = p.first ? 0.f : of2_clamp(F[2 * k + 1], -p.max_disp, p.max_disp);
      of2_fb_products(e, w, u, v, prod);
    }
#pragma unroll
    for (int c = 0; c < 5; ++c) P[c * pplane + i] = prod[c];
  }
  __syncthreads();
  of2_window_solve_tile(P, V, rw, oy, ox, H, W, p.det_eps, flow_out + 2 * off);
}

// nxt, bx1, by1, axx1, ayy1, axy1: (B, H, W) float32; flow_in, flow_out:
// (B, H, W, 2) float32 (flow_in is not read when first != 0 and may be
// null); the H rows are global rows [row0, row0 + H) of an Hg-row image
// (whole image: 0, H); taps: 3 x (2rp+1) float32; mix: 5 x 6 float32 (axy
// row halved).
extern "C" int of2_fb_step(const float* nxt, const float* bx1, const float* by1,
                           const float* axx1, const float* ayy1, const float* axy1,
                           const float* flow_in, float* flow_out, int B, int H, int W, int row0,
                           int Hg, int rw, int rp, const float* taps, const float* mix,
                           float det_eps, float max_disp, int first, void* stream) {
  Of2FBParams p;
  if (rw < 0 || rw > OF2_WT_MAX_R || B < 1 || H < 1 || W < 1 || Hg < 1 || (!first && !flow_in) ||
      !of2_poly_fill(&p.poly, rp, taps, mix))
    return (int)cudaErrorInvalidValue;
  p.det_eps = det_eps;
  p.max_disp = max_disp;
  p.rw = rw;
  p.H = H;
  p.W = W;
  p.first = first;
  const size_t smem = of2_fb_smem_floats(rw, rp) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(of2_fb_step_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int ylo = row0 < 0 ? -row0 : 0;
  const int yhi = Hg - row0 < H ? Hg - row0 : H;
  const dim3 grid((W + OF2_WT_TILE - 1) / OF2_WT_TILE, (H + OF2_WT_TILE - 1) / OF2_WT_TILE, B);
  of2_fb_step_kernel<<<grid, OF2_WT_THREADS, smem, (cudaStream_t)stream>>>(
      nxt, bx1, by1, axx1, ayy1, axy1, flow_in, flow_out, p, row0, Hg, ylo, yhi);
  return (int)cudaGetLastError();
}
