// One LK solve per output pixel: (warp) -> gradients -> weighted window sums
// -> guarded 2x2 solve, with every intermediate in shared memory.
//
// Shared by lk_fused.cu (residual only, STEP = false) and lk_step_fused.cu
// (warp + residual + accumulate, STEP = true).  CENTERED (the DIS data term)
// carries four more sums, Ix, Iy, It and the in-image count n, and turns
// each product sum into S_ab - S_a S_b / max(n, 1) before the solve
// (ops/window.centered_structure_tensor_sums).
//
// The two modes lay their blocks out differently; the launch takes (rs, tw,
// seg) for both (the wrapper picks them, kernels/tile_geometry.lk_launch).
//
// Five sums (CENTERED false), a column-strip walker.  A block owns a strip
// of TW output columns and walks down a segment of SEG output rows [y0, y1)
// in steps of RS rows (TW and RS multiples of OF2_RUN; RS * TW / OF2_RUN
// threads).  With window radius r, step j differentiates and row-sums the
// RS rows ga + j RS .. ga + (j + 1) RS - 1, ga = y0 - r, and column-sums
// and solves the RS output rows whose windows are then complete, y0 + j RS
// - 2r .. y0 + (j + 1) RS - 2r - 1 (those in [y0, y1)).  So the window's
// vertical halo is staged once per segment, not once per tile.  Shared
// memory:
//   G: RS x (TW + 2r) gradients Ix, Iy, It of a step's rows, zero outside
//      the image, so window sums see zero padding at the border;
//   R: a ring of 2r + RS rows of the five row-pass sums, TW columns each:
//      row ga + k sits in ring row k % (2r + RS);
//   S: a ring of RS + 2 rows of prev (cp.async) and the (warped) next,
//      TW + 2r + 2 columns, zero outside the image: a step's source rows.
// A step is two phases, one barrier after each: (A) the row pass of step j
// beside the staging of step j + 1's RS new source rows, then (B) the
// column pass and solve of step j beside the gradients of step j + 1.  The
// warp's two dependent loads are issued a phase or more before their use:
// each thread keeps OF2_LK_AHEAD cells of step j + 2 in registers, loading
// their flow and then their four taps after B's column pass (the taps in
// flight under the gradients and the barrier), and blends them in the next
// A; prev (and the residual's next) are cp.async copies waited at A's end.
//
// Nine sums (CENTERED true), one output tile per block: SEG x TW output
// pixels (RS = SEG; both multiples of OF2_RUN), OF2_LK_MAX_THREADS threads.
// Shared memory:
//   S: (SEG + 2r + 2) x (TW + 2r + 2) source pixels, prev (staged with
//      cp.async) and the (warped) next, zero outside the image;
//   G: (SEG + 2r) x (TW + 2r) gradients Ix, Iy, It, zero outside the image;
//   R: eight row-pass sums (the five products, Ix, Iy, It), (SEG + 2r) x TW
//      each (overwrites S).
// The column pass then reads R and the solve writes (u, v) per pixel.  The
// walker does not pay here: the nine sums' registers leave an SM two of its
// blocks, and on an H100 it was slower than this tile at DIS's large levels
// (PERF.md).  The count's row sum is the weights of the window's in-image
// columns in a row inside the image, else 0: the column pass forms it from
// the column and the rows, adding the same weights in the same order as a
// row pass would, so it takes no plane.
//
// Every pass is register-blocked (OF2_RUN cells a thread, of2_common.cuh):
// the gradient pass walks a column, the row pass forms the products once
// per gradient cell and the column pass loads each row-pass sum once per
// run.  Each window sum keeps the order of one sum per pixel, taps d = 0..2r
// (rows, then columns), and a pixel's arithmetic does not depend on its
// block, its step or its place in a run, so a band and the whole image,
// and any strip, segment and tile, give the same bits.  Leading dimensions
// that lanes stride over are odd (no bank conflicts).
//
// Bands (spatial TP, STEP only): the H rows are global rows [row0, row0 + H)
// of an Hg-row image.  The warp samples in global rows, the warped frame is
// zero and the gradients and the centered count are zero outside the global
// image, and everything outside the band reads as zero, as the plain version
// (kernels/lk_step_fused.lk_band_step_plain) computes.  The whole image is
// the band row0 = 0, Hg = H.
#pragma once

#include <type_traits>

#include "of2_common.cuh"

#define OF2_LK_MAX_THREADS 256
#define OF2_LK_MIN_BLOCKS 3  // blocks an SM holds by registers (80 a thread)
#define OF2_LK_BATCH 4       // cells a thread warps at once where none were warped ahead
#define OF2_LK_AHEAD 5       // cells of a later step a thread warps ahead (walker)
#define OF2_LK_PLANES_C 8    // row-pass planes of the centered tile

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
  int rs;    // walker: rows per step; tile: = seg
  int tw;    // strip or tile columns
  int seg;   // walker: output rows a block walks; tile: its rows
};

// The shape of a walker block (kernels/tile_geometry.lk_walk mirrors it).
struct Of2LKWalk {
  int ring;  // rows of R: 2r + rs
  int src;   // rows of S: rs + 2
  int sw;    // columns of S: tw + 2r + 2
  int gw;    // columns of G: tw + 2r
  int ldg;   // leading dimension of G (odd)
  int ldr;   // leading dimension of R (odd)
};

__host__ __device__ __forceinline__ Of2LKWalk of2_lk_walk(int r, int rs, int tw) {
  Of2LKWalk w;
  w.ring = 2 * r + rs;
  w.src = rs + 2;
  w.sw = tw + 2 * r + 2;
  w.gw = tw + 2 * r;
  w.ldg = w.gw | 1;
  w.ldr = tw + 1;
  return w;
}

// Floats of shared memory (kernels/tile_geometry.lk_walk and lk_tile_candidate
// mirror this): the walker's, or the centered tile's of seg x tw.
static inline size_t of2_lk_smem_floats(int r, int rs, int tw, int seg, bool centered) {
  if (centered) {
    const size_t sh = seg + 2 * r + 2, sw = tw + 2 * r + 2;
    const size_t gh = seg + 2 * r, ldg = (tw + 2 * r) | 1, ldr = tw + 1;
    const size_t s = 2 * sh * sw, rows = OF2_LK_PLANES_C * gh * ldr;
    return 3 * gh * ldg + (s > rows ? s : rows);
  }
  const Of2LKWalk w = of2_lk_walk(r, rs, tw);
  return 3 * (size_t)rs * w.ldg + 5 * (size_t)w.ring * w.ldr + 2 * (size_t)w.src * w.sw;
}

// RT >= 0: the window radius, fixed at compile time (it must equal p.r);
// RT < 0: any radius.  Both modes hold OF2_LK_MIN_BLOCKS blocks of
// OF2_LK_MAX_THREADS threads an SM by registers (kernels/tile_geometry
// mirrors it).
template <bool STEP, bool CENTERED, int RT>
__global__ void __launch_bounds__(OF2_LK_MAX_THREADS, OF2_LK_MIN_BLOCKS)
of2_lk_tile_kernel(const float* __restrict__ prev, const float* __restrict__ nxt,
                   const float* __restrict__ flow_in, float* __restrict__ flow_out,
                   const Of2LKParams p) {
  constexpr int TAPS = RT >= 0 ? 2 * RT + 1 : 0;
  extern __shared__ float smem[];
  if constexpr (CENTERED) {
    // The nine-sum tile: one seg x tw output tile per block (see the top).
    constexpr int NR = OF2_LK_PLANES_C;  // row-pass sums: five products, Ix, Iy, It
    const int r = RT >= 0 ? RT : p.r, H = p.H, W = p.W, th = p.seg, tw = p.tw;
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
    const float* P = prev + blockIdx.z * plane;
    const float* N = nxt + blockIdx.z * plane;
    const float* Fin = STEP ? flow_in + 2 * blockIdx.z * plane : nullptr;
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
          const size_t fk = (size_t)yc * W + xc;
          const float2 f = make_float2(Fin[2 * fk], Fin[2 * fk + 1]);
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

    // R: row pass of the five products and of Ix, Iy and It over the window's
    // columns.  Lanes take consecutive rows; a thread forms the products of
    // each of its OF2_RUN + 2r cells once.
    for (int i = threadIdx.x; i < gh * (tw / OF2_RUN); i += blockDim.x) {
      const int gy = i % gh, c0 = (i / gh) * OF2_RUN;
      const int g0 = gy * ldg + c0;
      float a[NR][OF2_RUN];
#pragma unroll
      for (int c = 0; c < NR; ++c)
#pragma unroll
        for (int k = 0; k < OF2_RUN; ++k) a[c][k] = 0.f;
      of2_run_sum<NR, NR, TAPS>(
          2 * r + 1,
          [&](int j, float (&v)[NR]) {
            const float ix = g_ix[g0 + j], iy = g_iy[g0 + j], it = g_it[g0 + j];
            v[0] = ix * ix;
            v[1] = iy * iy;
            v[2] = ix * iy;
            v[3] = ix * it;
            v[4] = iy * it;
            v[5] = ix;
            v[6] = iy;
            v[7] = it;
          },
          [&](int d, const float (&v)[NR], float (&acc)[NR][OF2_RUN], int k) {
            const float w = p.taps[d];
#pragma unroll
            for (int c = 0; c < NR; ++c) acc[c][k] += w * v[c];
          },
          a);
#pragma unroll
      for (int c = 0; c < NR; ++c)
#pragma unroll
        for (int k = 0; k < OF2_RUN; ++k) rows[c * rplane + gy * ldr + c0 + k] = a[c][k];
    }
    __syncthreads();

    // Column pass, solve, write.  Lanes take consecutive columns; a thread
    // loads each row-pass sum of its OF2_RUN + 2r rows once: the five
    // products' sums into s[0..4], then those of Ix, Iy and It into s[5..7],
    // so each run holds fewer registers; s[8] is the in-image count.
    for (int i = threadIdx.x; i < tw * (th / OF2_RUN); i += blockDim.x) {
      const int c = i % tw, ty0 = (i / tw) * OF2_RUN;
      const int x = ox + c;
      float s[9][OF2_RUN];
#pragma unroll
      for (int q = 0; q < 9; ++q)
#pragma unroll
        for (int k = 0; k < OF2_RUN; ++k) s[q][k] = 0.f;
      of2_run_sum<5, 9, TAPS>(
          2 * r + 1,
          [&](int j, float (&v)[5]) {
#pragma unroll
            for (int q = 0; q < 5; ++q) v[q] = rows[q * rplane + (ty0 + j) * ldr + c];
          },
          [&](int d, const float (&v)[5], float (&acc)[9][OF2_RUN], int k) {
            const float w = p.taps[d];
#pragma unroll
            for (int q = 0; q < 5; ++q) acc[q][k] += w * v[q];
          },
          s);
      of2_run_sum<3, 9, TAPS>(
          2 * r + 1,
          [&](int j, float (&v)[3]) {
#pragma unroll
            for (int q = 0; q < 3; ++q) v[q] = rows[(q + 5) * rplane + (ty0 + j) * ldr + c];
          },
          [&](int d, const float (&v)[3], float (&acc)[9][OF2_RUN], int k) {
            const float w = p.taps[d];
#pragma unroll
            for (int q = 0; q < 3; ++q) acc[q + 5][k] += w * v[q];
          },
          s);
      // The count: its row sum in a row inside the image (from 0, each tap's
      // weight where its column is in the image), else 0, then the column sum
      // as the other planes take it; where every window row of the run is
      // inside the image, the run's rows add the same terms, so the sum is
      // taken once.
      float n_row = 0.f;
      for (int d = 0; d <= 2 * r; ++d) {
        const int xd = x - r + d;
        n_row += xd >= 0 && xd < W ? p.taps[d] : 0.f;
      }
      auto row_in = [&](int y) {
        return y >= 0 && y < H && p.row0 + y >= 0 && p.row0 + y < p.Hg;
      };
      const int top = oy + ty0 - r, bottom = top + OF2_RUN - 1 + 2 * r;
      if (row_in(top) && row_in(bottom)) {
        float n = 0.f;
        for (int d = 0; d <= 2 * r; ++d) n += p.taps[d] * n_row;
#pragma unroll
        for (int k = 0; k < OF2_RUN; ++k) s[8][k] = n;
      } else {
#pragma unroll
        for (int k = 0; k < OF2_RUN; ++k) {
          for (int d = 0; d <= 2 * r; ++d)
            s[8][k] += p.taps[d] * (row_in(top + k + d) ? n_row : 0.f);
        }
      }
#pragma unroll
      for (int k = 0; k < OF2_RUN; ++k) {
        const int y = oy + ty0 + k;
        if (y >= H || x >= W) continue;
        // the per-window covariances
        const float s5 = s[5][k], s6 = s[6][k], s7 = s[7][k];
        const float inv_n = 1.f / fmaxf(s[8][k], 1.f);
        const float s0 = s[0][k] - s5 * s5 * inv_n, s1 = s[1][k] - s6 * s6 * inv_n;
        const float s2 = s[2][k] - s5 * s6 * inv_n, s3 = s[3][k] - s5 * s7 * inv_n;
        const float s4 = s[4][k] - s6 * s7 * inv_n;
        // s0..s4 = sum Ix^2, Iy^2, IxIy, IxIt, IyIt; d = -A^-1 b (see the
        // walker's solve)
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
          const size_t fk = (size_t)y * W + x;
          const float2 f = make_float2(Fin[2 * fk], Fin[2 * fk + 1]);
          u += of2_clamp(f.x, -p.max_disp, p.max_disp);
          v += of2_clamp(f.y, -p.max_disp, p.max_disp);
        }
        Fout[2 * o] = u;
        Fout[2 * o + 1] = v;
      }
    }
  } else {
    // The five-sum walker (see the top).
    const int r = RT >= 0 ? RT : p.r, H = p.H, W = p.W, rs = p.rs, tw = p.tw;
    const Of2LKWalk wk = of2_lk_walk(r, rs, tw);
    const int sw = wk.sw, gw = wk.gw, ldg = wk.ldg, ldr = wk.ldr;
    const int gplane = rs * ldg, rplane = wk.ring * ldr;
    float* g_ix = smem;
    float* g_iy = g_ix + gplane;
    float* g_it = g_iy + gplane;
    float* rows = g_it + gplane;
    float* s_prev = rows + 5 * rplane;
    float* s_next = s_prev + wk.src * sw;

    const size_t plane = (size_t)H * W;
    const float* P = prev + blockIdx.z * plane;
    const float* N = nxt + blockIdx.z * plane;
    const float* Fin = STEP ? flow_in + 2 * blockIdx.z * plane : nullptr;
    float* Fout = flow_out + 2 * blockIdx.z * plane;
    const int ox = blockIdx.x * tw, y0 = blockIdx.y * p.seg, y1 = min(y0 + p.seg, H);
    const int ga = y0 - r;  // row-pass (and gradient) row k of the walk: ga + k
    const int nsteps = (y1 - y0 + 2 * r + rs - 1) / rs;
    const int tid = threadIdx.x, nt = blockDim.x;

    // S: the source rows [s0, s0 + n / sw) in S rows (y - ga + 1) % src; the
    // rs new rows of step k start at src_row(k).  prev is copied (cp.async)
    // and so is next for the residual; a step warps next, each pixel by its
    // own flow, halo included, as the plain composition warps the whole
    // image first; next is zero outside the band and the image, so S_next -
    // S_prev is the plain version's difference.  Every warp load is
    // unconditional (addresses clamped, results selected), so a thread's
    // loads overlap.  Cell i of the rows is row i / sw, column i % sw, by a
    // float reciprocal (exact: i + 0.5 lies at least 0.5 from a multiple of
    // sw, far beyond the rounding of i < 2^16 cells).
    const float inv_sw = 1.f / (float)sw;
    auto cell = [&](int i, int& t, int& c) {
      t = __float2int_rd(((float)i + 0.5f) * inv_sw);
      c = i - t * sw;
    };
    auto src_row = [&](int k) { return k == 0 ? ga - 1 : ga + k * rs + 1; };
    auto live_at = [&](int y, int x) {
      return y >= 0 && y < H && x >= 0 && x < W && p.row0 + y >= 0 && p.row0 + y < p.Hg;
    };
    // Copy prev (and the residual's next); warp next's cells [first, n) now,
    // OF2_LK_BATCH a thread at a time.
    auto stage = [&](int s0, int n, int first) {
      const int base = (s0 - ga + 1) % wk.src;
      auto s_at = [&](int t, int c) {
        return (base + t < wk.src ? base + t : base + t - wk.src) * sw + c;
      };
      for (int i = tid; i < n; i += nt) {
        int t, c;
        cell(i, t, c);
        const int y = s0 + t, x = ox - r - 1 + c;
        const bool in = y >= 0 && y < H && x >= 0 && x < W;
        of2_cp_async4(s_prev + s_at(t, c), in ? P + (size_t)y * W + x : P, in);
        if (!STEP) {
          const bool live = live_at(y, x);
          of2_cp_async4(s_next + s_at(t, c), live ? N + (size_t)y * W + x : N, live);
        }
      }
      if (!STEP) return;
      for (int i0 = first + tid; i0 < n; i0 += OF2_LK_BATCH * nt) {
        float nv[OF2_LK_BATCH];
#pragma unroll
        for (int b = 0; b < OF2_LK_BATCH; ++b) {
          int t, c;
          cell(i0 + b * nt, t, c);
          const int y = s0 + t, x = ox - r - 1 + c;
          const int yc = min(max(y, 0), H - 1), xc = min(max(x, 0), W - 1);
          const size_t fk = (size_t)yc * W + xc;
          const float2 f = make_float2(Fin[2 * fk], Fin[2 * fk + 1]);
          nv[b] = of2_warp_gather(N, H, W, xc, yc, i0 + b * nt < n && live_at(y, x), f.x, f.y,
                                  p.max_disp, p.row0, p.Hg);
        }
#pragma unroll
        for (int b = 0; b < OF2_LK_BATCH; ++b) {
          int t, c;
          cell(i0 + b * nt, t, c);
          if (i0 + b * nt < n) s_next[s_at(t, c)] = nv[b];
        }
      }
    };
    // The cells a thread warps ahead, cell tid + b nt of step k's new rows:
    // their taps' values, fractions and validity (bit b).
    float a_tap[OF2_LK_AHEAD][4], a_tx[OF2_LK_AHEAD], a_ty[OF2_LK_AHEAD];
    unsigned a_valid = 0;
    auto ahead_taps = [&](int k) {
      float2 f[OF2_LK_AHEAD];
#pragma unroll
      for (int b = 0; b < OF2_LK_AHEAD; ++b) {
        int t, c;
        cell(tid + b * nt, t, c);
        const int yc = min(max(src_row(k) + t, 0), H - 1);
        const int xc = min(max(ox - r - 1 + c, 0), W - 1);
        const size_t fk = (size_t)yc * W + xc;
        f[b] = make_float2(Fin[2 * fk], Fin[2 * fk + 1]);
      }
      a_valid = 0;
#pragma unroll
      for (int b = 0; b < OF2_LK_AHEAD; ++b) {
        int t, c;
        cell(tid + b * nt, t, c);
        const int yc = min(max(src_row(k) + t, 0), H - 1);
        const int xc = min(max(ox - r - 1 + c, 0), W - 1);
        const Of2WarpTaps w = of2_warp_taps(H, W, xc, yc, f[b].x, f[b].y, p.max_disp, p.row0,
                                            p.Hg);
        a_tap[b][0] = N[w.o00];
        a_tap[b][1] = N[w.o01];
        a_tap[b][2] = N[w.o10];
        a_tap[b][3] = N[w.o11];
        a_tx[b] = w.tx;
        a_ty[b] = w.ty;
        a_valid |= (unsigned)w.valid << b;
      }
    };
    auto ahead_blend = [&](int k) {
      const int n = rs * sw, base = (src_row(k) - ga + 1) % wk.src;
#pragma unroll
      for (int b = 0; b < OF2_LK_AHEAD; ++b) {
        int t, c;
        cell(tid + b * nt, t, c);
        Of2WarpTaps w;
        w.tx = a_tx[b];
        w.ty = a_ty[b];
        w.valid = (a_valid >> b) & 1u;
        const int row = base + t < wk.src ? base + t : base + t - wk.src;
        const bool live = live_at(src_row(k) + t, ox - r - 1 + c);
        if (tid + b * nt < n)
          s_next[row * sw + c] =
              of2_warp_blend(w, a_tap[b][0], a_tap[b][1], a_tap[b][2], a_tap[b][3], live);
      }
    };
    const int ahead = STEP ? min(OF2_LK_AHEAD * nt, rs * sw) : rs * sw;  // cells warped ahead

    // G: 3x3 stencils of step j's rows, zeroed outside the band and outside
    // the image.  A thread walks OF2_RUN + 2 source rows of three columns and
    // adds each row into the stencils of the (up to three) gradient rows it
    // touches.
    auto gradients = [&](int j) {
      for (int i = tid; i < gw * (rs / OF2_RUN); i += nt) {
        const int gx = i % gw, gy0 = (i / gw) * OF2_RUN;
        const int s_first = (j * rs + gy0) % wk.src;
        float ix[OF2_RUN], iy[OF2_RUN], it[OF2_RUN];
#pragma unroll
        for (int k = 0; k < OF2_RUN; ++k) ix[k] = iy[k] = it[k] = 0.f;
#pragma unroll
        for (int jj = 0; jj < OF2_RUN + 2; ++jj) {
          const int srow = s_first + jj < wk.src ? s_first + jj : s_first + jj - wk.src;
          const int s0 = srow * sw + gx;
          float pv[3], dv[3];
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            pv[q] = s_prev[s0 + q];
            dv[q] = s_next[s0 + q] - pv[q];
          }
#pragma unroll
          for (int k = 0; k < OF2_RUN; ++k) {
            const int m = jj - k;  // stencil row
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
          const int gy = gy0 + k, y = ga + j * rs + gy;
          const bool in =
              y >= 0 && y < H && x >= 0 && x < W && p.row0 + y >= 0 && p.row0 + y < p.Hg;
          g_ix[gy * ldg + gx] = in ? ix[k] : 0.f;
          g_iy[gy * ldg + gx] = in ? iy[k] : 0.f;
          g_it[gy * ldg + gx] = in ? it[k] : 0.f;
        }
      }
    };

    // Step 0's rs + 2 source rows and their gradients; step 1's cells ahead.
    stage(src_row(0), (rs + 2) * sw, 0);
    of2_cp_async_wait();
    __syncthreads();
    if (STEP && nsteps > 1) ahead_taps(1);
    gradients(0);
    __syncthreads();

    for (int j = 0; j < nsteps; ++j) {
      // Step j + 1's rs new source rows (step j's gradients are taken, so
      // their S rows are free): the cells warped ahead, the rest now.
      if (j + 1 < nsteps) {
        if (STEP) ahead_blend(j + 1);
        stage(src_row(j + 1), rs * sw, ahead);
      }

      // Beside it, R: row pass of the five products of step j's rows over
      // the window's columns.  A warp takes 4 rows x 8 runs of columns (with
      // the odd ldg, 32 banks); a thread forms the products of each of its
      // OF2_RUN + 2r cells once a run.
      const int runs_w = tw / OF2_RUN, r_first = (j * rs) % wk.ring;
      for (int i = tid; i < rs * runs_w; i += nt) {
        const int q4 = i / OF2_RUN;
        const int gy = i % OF2_RUN + OF2_RUN * (q4 / runs_w), c0 = (q4 % runs_w) * OF2_RUN;
        const int g0 = gy * ldg + c0;
        const int rrow = r_first + gy < wk.ring ? r_first + gy : r_first + gy - wk.ring;
        // The row sums of NC values of each gradient cell (value(ix, iy, it,
        // v)) into planes [q0, q0 + NC) of R.
        auto row_sum = [&](auto nc, int q0, auto value) {
          constexpr int NC = decltype(nc)::value;
          float a[NC][OF2_RUN];
#pragma unroll
          for (int q = 0; q < NC; ++q)
#pragma unroll
            for (int k = 0; k < OF2_RUN; ++k) a[q][k] = 0.f;
          of2_run_sum<NC, NC, TAPS>(
              2 * r + 1,
              [&](int jj, float (&v)[NC]) {
                value(g_ix[g0 + jj], g_iy[g0 + jj], g_it[g0 + jj], v);
              },
              [&](int d, const float (&v)[NC], float (&acc)[NC][OF2_RUN], int k) {
                const float w = p.taps[d];
#pragma unroll
                for (int q = 0; q < NC; ++q) acc[q][k] += w * v[q];
              },
              a);
#pragma unroll
          for (int q = 0; q < NC; ++q)
#pragma unroll
            for (int k = 0; k < OF2_RUN; ++k)
              rows[(q0 + q) * rplane + rrow * ldr + c0 + k] = a[q][k];
        };
        row_sum(std::integral_constant<int, 5>{}, 0,
                [](float ix, float iy, float it, float (&v)[5]) {
                  v[0] = ix * ix;
                  v[1] = iy * iy;
                  v[2] = ix * iy;
                  v[3] = ix * it;
                  v[4] = iy * it;
                });
      }
      of2_cp_async_wait();
      __syncthreads();

      // Column pass, solve, write: step j's output rows in [y0, y1).  Lanes
      // take consecutive columns; a thread loads each row-pass sum of its
      // OF2_RUN + 2r rows once (R's rows wrap once at most).
      const int oy = y0 + j * rs - 2 * r;
      for (int i = tid; i < tw * (rs / OF2_RUN); i += nt) {
        const int c = i % tw, ty0 = (i / tw) * OF2_RUN;
        const int x = ox + c;
        if (oy + ty0 + OF2_RUN <= y0 || oy + ty0 >= y1 || x >= W) continue;
        // ring row of output row oy + ty0's first window row (oy + ty0 - r)
        const int c_first = (j * rs - 2 * r + ty0 + wk.ring) % wk.ring;
        // The column sums of planes [q0, q0 + NC) of R into acc.
        auto column_sum = [&](auto& acc, auto nc, int q0) {
          constexpr int NC = decltype(nc)::value;
#pragma unroll
          for (int q = 0; q < NC; ++q)
#pragma unroll
            for (int k = 0; k < OF2_RUN; ++k) acc[q][k] = 0.f;
          of2_run_sum<NC, NC, TAPS>(
              2 * r + 1,
              [&](int jj, float (&v)[NC]) {
                const int row = c_first + jj < wk.ring ? c_first + jj : c_first + jj - wk.ring;
#pragma unroll
                for (int q = 0; q < NC; ++q) v[q] = rows[(q0 + q) * rplane + row * ldr + c];
              },
              [&](int d, const float (&v)[NC], float (&a)[NC][OF2_RUN], int k) {
                const float w = p.taps[d];
#pragma unroll
                for (int q = 0; q < NC; ++q) a[q][k] += w * v[q];
              },
              acc);
        };
        float s[5][OF2_RUN];
        column_sum(s, std::integral_constant<int, 5>{}, 0);
#pragma unroll
        for (int k = 0; k < OF2_RUN; ++k) {
          const int y = oy + ty0 + k;
          if (y < y0 || y >= y1) continue;
          const float s0 = s[0][k], s1 = s[1][k], s2 = s[2][k], s3 = s[3][k], s4 = s[4][k];
          // s0..s4 = sum Ix^2, Iy^2, IxIy, IxIt, IyIt; d = -A^-1 b.  Guarded,
          // the products are rounded on their own (no FMA contraction), as the
          // plain version (ops/solve.solve_2x2) rounds them: a rank-one A (a
          // 1x1 window) then has det exactly 0 in both, not a contraction's
          // residue that 1/det would blow up.
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
            const size_t fk = (size_t)y * W + x;
            const float2 f = make_float2(Fin[2 * fk], Fin[2 * fk + 1]);
            u += of2_clamp(f.x, -p.max_disp, p.max_disp);
            v += of2_clamp(f.y, -p.max_disp, p.max_disp);
          }
          Fout[2 * o] = u;
          Fout[2 * o + 1] = v;
        }
      }
      // Beside it: the taps of step j + 2's cells warped ahead, and step j +
      // 1's gradients (G was read by step j's row pass).
      if (STEP && j + 2 < nsteps) ahead_taps(j + 2);
      if (j + 1 < nsteps) gradients(j + 1);
      __syncthreads();
    }
  }
}

template <bool STEP, bool CENTERED, int RT>
static int of2_lk_run_r(const float* prev, const float* nxt, const float* flow_in, float* flow_out,
                        int B, int H, int W, const Of2LKParams& p, void* stream) {
  const size_t smem = of2_lk_smem_floats(p.r, p.rs, p.tw, p.seg, CENTERED) * sizeof(float);
  if (smem > OF2_SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(of2_lk_tile_kernel<STEP, CENTERED, RT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + p.tw - 1) / p.tw, (H + p.seg - 1) / p.seg, B);
  const int threads = CENTERED ? OF2_LK_MAX_THREADS : p.rs * p.tw / OF2_RUN;
  of2_lk_tile_kernel<STEP, CENTERED, RT><<<grid, threads, smem, (cudaStream_t)stream>>>(
      prev, nxt, flow_in, flow_out, p);
  return (int)cudaGetLastError();
}

// The radii of the main paths' windows run a kernel compiled for them
// (PAPER_1080P 15x15, DISConfig() and DIS_REALTIME 9x9, REFERENCE_GPU and
// LKConfig(levels=4, window=19) 19x19); any other radius runs the generic
// one.
template <bool STEP, bool CENTERED>
static int of2_lk_run(const float* prev, const float* nxt, const float* flow_in, float* flow_out,
                      int B, int H, int W, const Of2LKParams& p, void* stream) {
  switch (p.r) {
    case 4:
      return of2_lk_run_r<STEP, CENTERED, 4>(prev, nxt, flow_in, flow_out, B, H, W, p, stream);
    case 7:
      return of2_lk_run_r<STEP, CENTERED, 7>(prev, nxt, flow_in, flow_out, B, H, W, p, stream);
    case 9:
      return of2_lk_run_r<STEP, CENTERED, 9>(prev, nxt, flow_in, flow_out, B, H, W, p, stream);
    default:
      return of2_lk_run_r<STEP, CENTERED, -1>(prev, nxt, flow_in, flow_out, B, H, W, p, stream);
  }
}

// Host side: check the block, fill the parameters, allow the dynamic shared
// memory, launch, and return the launch status (cudaSuccess == 0).  A walk
// whose step rows or strip columns are not positive multiples of OF2_RUN,
// whose segment is empty or whose block would exceed OF2_LK_MAX_THREADS
// threads, a centered tile whose sides are not positive multiples of
// OF2_RUN or with rs != seg, and a block whose shared memory exceeds what a
// block may have, are refused.
template <bool STEP>
static int of2_lk_launch(const float* prev, const float* nxt, const float* flow_in,
                         float* flow_out, int B, int H, int W, int row0, int Hg, int r, int rs,
                         int tw, int seg, const float* taps, const float* masks, float det_eps,
                         float max_disp, int centered, void* stream) {
  if (r < 0 || r > OF2_MAX_R || B < 1 || H < 1 || W < 1 || Hg < 1)
    return (int)cudaErrorInvalidValue;
  if (rs < OF2_RUN || tw < OF2_RUN || rs % OF2_RUN || tw % OF2_RUN || seg < 1 ||
      (centered ? rs != seg : rs * tw / OF2_RUN > OF2_LK_MAX_THREADS))
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
  p.rs = rs;
  p.tw = tw;
  p.seg = seg;
  return centered ? of2_lk_run<STEP, true>(prev, nxt, flow_in, flow_out, B, H, W, p, stream)
                  : of2_lk_run<STEP, false>(prev, nxt, flow_in, flow_out, B, H, W, p, stream);
}
