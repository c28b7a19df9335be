// TV-L1 primal-dual iterations of one linearization, time-tiled: one launch
// computes the per-pixel constants, then each launch runs k iterations on
// 64 x 64 tiles held in shared memory (of2_tile.cuh), and a call of
// `iterations` runs in ceil(iterations / K) such launches of near equal
// k <= K.  Where a level's grid of tiles fills the card more than once,
// the tile launches run as thread-block clusters (below).
//
// Layouts: images (B, H, W) float32; flow (B, H, W, 2) float32 as one float2
// (u, v) per pixel; duals (B, H, W, 4) as one float4 (p1x, p1y, p2x, p2y).
// The constants gx, gy = Sobel / 8 of warped are one float2 per pixel and
// it = warped - prev; a tile launch loads them, and u0, into the registers
// of the thread that owns the pixel, which forms th = lambda theta |g|^2
// and max(|g|^2, eps) from gx, gy where it needs them (the same rounded
// steps each time, and two registers a cell fewer than keeping them).
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
// Clusters (of2_cluster.cuh): a cluster of CY CTAs stacked along y, each
// with the 64 x 64 tile above, covers a region of 64 x (64 CY) cells.  A
// cell in a CTA's first (last) row inside the cluster reads the row above
// (below) from a halo row in its own shared memory that the peer CTA fills
// (distributed shared memory): the primal reads p1y, p2y at y - 1, which
// the upper peer stores (st.async) right after its dual half-step computed
// its last row, which it does first; the dual reads u, v at y + 1, which
// the lower peer stores right after its primal half-step computed its
// first row, which the walk does first.  Each store counts its bytes on an
// mbarrier of the receiver, and only the receiver's warps of that row wait
// for the phase; they find it complete most of the time, since the row
// left a whole half-step before.  The rest of a CTA syncs with
// __syncthreads alone: a barrier of the whole cluster at every half-step
// took a third longer than the plain tiles on an H100 (PERF.md §6).
// A peer stores a phase only after the receiver has read the phase before,
// which the data's own order gives: the receiver's next store to it comes
// after those reads, and the peer waits for that store first.  So the
// region iterates as one tile: staleness enters only at the cluster's
// outer edges, the ring of R = k cells lies only there, and the cluster
// writes back the region's inner (64 - 2k) x (64 CY - 2k) pixels, each CTA
// those inside its own tile.  Which CTA computes a cell changes nothing of
// its arithmetic.  One cluster barrier, arrived at before the staging and
// waited for after it, sets the mbarriers up before any peer stores; every
// store into a CTA is waited for before it exits.  Side by side clusters
// (2 x 2, 4 x 2) would cut more ring, but their columns' edge cells belong
// to one lane in each warp, so every warp waited on the peers.  CY = 1 is
// the plain tile and launch.  The wrapper picks the cluster
// (kernels/tile_geometry.tvl1_cluster): clusters where the level's plain
// grid is more than one wave of the card's SMs, else 1 x 1.
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
// image is the band row0 = 0, Hg = H with zero duals.  These boundaries are
// tested by band coordinates, never by tile or cluster coordinates.
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "of2_cluster.cuh"
#include "of2_tile.cuh"

// The six state planes, and in a cluster two halo rows of float2 and two
// mbarriers.
#define OF2_TVL1_SMEM ((6 * OF2_PLANE + 4 * OF2_EXT + 4) * (int)sizeof(float))

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

// cst = (gx, gy) and it = warped - prev, with gx, gy the zero-padded Sobel
// / 8 of warped summed in ops/conv's tap order, zero outside the live rows.
__global__ void of2_tvl1_const(const float* __restrict__ prev, const float* __restrict__ warped,
                               float2* __restrict__ cst, float* __restrict__ it,
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
  cst[k] = make_float2(gx, gy);
  it[k] = __fsub_rn(warped[k], prev[k]);
}

// `iters` iterations on the tile of block (x, y, batch), in a cluster of
// CY blocks stacked along y: the state comes in from uv_in, p_in (null:
// zero duals) and the output region goes out to uv_out, p_out (null: not
// written).
template <int CY>
__global__ void __launch_bounds__(OF2_THREADS, 1)
of2_tvl1_tile(const float2* __restrict__ cst, const float* __restrict__ itp,
              const float* __restrict__ u0, const float* __restrict__ uv_in,
              const float* __restrict__ p_in, float* __restrict__ uv_out,
              float* __restrict__ p_out, const Of2TVL1Params p, int iters) {
  constexpr bool CLUSTER = CY > 1;
  extern __shared__ float of2_smem[];
  float* const su = of2_smem;
  float* const sv = su + OF2_PLANE;
  float* const s1x = sv + OF2_PLANE;
  float* const s1y = s1x + OF2_PLANE;
  float* const s2x = s1y + OF2_PLANE;
  float* const s2y = s2x + OF2_PLANE;
  // In a cluster, the peers' rows next to the tile: (p1y, p2y) of the row
  // above (the primal's) and (u, v) of the row below (the dual's), by
  // column; mbar[UP] and mbar[DOWN] complete a phase when the upper or
  // lower peer's row for a half-step has landed.
  float2* const h_up = reinterpret_cast<float2*>(s2y + OF2_PLANE);
  float2* const h_down = h_up + OF2_EXT;
  uint64_t* const mbar = reinterpret_cast<uint64_t*>(h_down + OF2_EXT);
  enum { UP, DOWN };
  constexpr unsigned ROW_BYTES = OF2_EXT * sizeof(float2);
  // The cluster's region: OF2_EXT x (CY OF2_EXT) cells, its output the
  // inner T x TY; this block is tile ry of it, the cluster's CTA ry.
  const int H = p.H, W = p.W, R = iters, T = of2_tile_out(R);
  const int TY = CY * OF2_EXT - 2 * R;
  const int ry = blockIdx.y % CY;
  const size_t base = blockIdx.z * (size_t)H * W;
  const int c = threadIdx.x % OF2_EXT, g0 = threadIdx.x / OF2_EXT * OF2_ROWS;
  // The thread's first row in the region, and its cells in the band.
  const int Y0 = ry * OF2_EXT + g0;
  const int oy = blockIdx.y / CY * TY - R + Y0, x = blockIdx.x * T - R + c;
  const bool col_in = x >= 0 && x < W;
  // The thread's first (last) row is a peer's halo row, and it reads the
  // peer's row above (below) it.
  const bool at_up = CLUSTER && g0 == 0 && ry > 0;
  const bool at_down = CLUSTER && g0 + OF2_ROWS == OF2_EXT && ry + 1 < CY;
  // The threads that arrive on the barriers, once a phase: column 0 of the
  // first and of the last row.
  const bool up_arrives = at_up && c == 0, down_arrives = at_down && c == 0;

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
  if (at_up) {
    // The first primal's row above: the duals the upper peer staged (zero
    // where the band or the image ends, as there).
    const int ya = oy - 1;
    const bool pin = col_in && ya >= 0 && ya < H && p_in != nullptr;
    const float* q = pin ? p_in + 4 * (base + (size_t)ya * W + x) : uv_in;
    of2_cp_async4(&h_up[c].x, q + (pin ? 1 : 0), pin);
    of2_cp_async4(&h_up[c].y, q + (pin ? 3 : 0), pin);
  }
  if constexpr (CLUSTER) {
    // The upper peer stores its last row's duals after each dual half-step
    // but the last (phases 0 .. iters - 2), the lower peer its first row's
    // (u, v) after each primal half-step (phases 0 .. iters - 1).
    if (threadIdx.x == 0) {
      of2_mbar_init(mbar + UP, 1);
      of2_mbar_init(mbar + DOWN, 1);
      of2_mbar_init_fence();
    }
    __syncthreads();
    if (up_arrives && iters > 1) of2_mbar_expect(mbar + UP, ROW_BYTES);
    if (down_arrives) of2_mbar_expect(mbar + DOWN, ROW_BYTES);
    // Waited for once the staging has landed: no peer stores into this
    // CTA before its barriers are set up.
    of2_cluster_arrive_relaxed();
  }

  // The constants of the tile's cells.
  float gx[OF2_ROWS], gy[OF2_ROWS], it[OF2_ROWS];
  float u0u[OF2_ROWS], u0v[OF2_ROWS];
  unsigned in_m = 0, live_m = 0, fx_m = 0, fy_m = 0;
#pragma unroll
  for (int j = 0; j < OF2_ROWS; ++j) {
    const int y = oy + j;
    gx[j] = gy[j] = it[j] = u0u[j] = u0v[j] = 0.f;
    if (!col_in || y < 0 || y >= H) continue;
    const size_t k = base + (size_t)y * W + x;
    const float2 g = cst[k];
    const float2 w = reinterpret_cast<const float2*>(u0)[k];
    gx[j] = g.x;
    gy[j] = g.y;
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
  if constexpr (CLUSTER) of2_cluster_wait();
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
    if (at_up && s > 0) {
      // The upper peer's last row of the last dual half-step.
      of2_mbar_wait(mbar + UP, (s - 1) & 1);
      if (up_arrives && s + 1 < iters) of2_mbar_expect(mbar + UP, ROW_BYTES);
    }
    float p1y_up = g0 > 0 ? s1y[(g0 - 1) * OF2_EXT + c] : at_up ? h_up[c].x : 0.f;
    float p2y_up = g0 > 0 ? s2y[(g0 - 1) * OF2_EXT + c] : at_up ? h_up[c].y : 0.f;
#pragma unroll
    for (int j = 0; j < OF2_ROWS; ++j) {
      const int e = (g0 + j) * OF2_EXT + c;
      const float c1x = s1x[e], c1y = s1y[e], c2x = s2x[e], c2y = s2y[e];
      const float l1x = c > 0 ? s1x[e - 1] : 0.f, l2x = c > 0 ? s2x[e - 1] : 0.f;
      if (live_m & (1u << j)) {
        const float rho = __fadd_rn(__fadd_rn(it[j], __fmul_rn(__fsub_rn(uu[j], u0u[j]), gx[j])),
                                    __fmul_rn(__fsub_rn(vv[j], u0v[j]), gy[j]));
        const float g2 = __fadd_rn(__fmul_rn(gx[j], gx[j]), __fmul_rn(gy[j], gy[j]));
        const float th = __fmul_rn(p.lt, g2), g2s = fmaxf(g2, p.eps);
        const bool lo = rho < -th, hi = rho > th;
        const float lin_u = __fdiv_rn(__fmul_rn(-rho, gx[j]), g2s);
        const float lin_v = __fdiv_rn(__fmul_rn(-rho, gy[j]), g2s);
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
      // The first row goes to the upper peer at once, a whole half-step
      // before its dual reads it.
      if (j == 0 && at_up)
        of2_st_async2(of2_peer_addr(h_down + c, ry - 1), uu[0], vv[0],
                      of2_peer_addr(mbar + DOWN, ry - 1));
    }
    // Stored after the walk, so no store sits between the walk's loads.
#pragma unroll
    for (int j = 0; j < OF2_ROWS; ++j) {
      su[(g0 + j) * OF2_EXT + c] = uu[j];
      sv[(g0 + j) * OF2_EXT + c] = vv[j];
    }
    __syncthreads();

    // Dual: p <- (p + tt grad u) / (1 + tt |grad u|), forward differences
    // zero at the last image column (x) and row (y).  In a cluster the last
    // row goes first, then to the lower peer.
    if (at_down) {
      // The lower peer's first row of this primal half-step.
      of2_mbar_wait(mbar + DOWN, s & 1);
      if (down_arrives && s + 1 < iters) of2_mbar_expect(mbar + DOWN, ROW_BYTES);
    }
#pragma unroll
    for (int i = 0; i < OF2_ROWS; ++i) {
      const int j = CLUSTER ? (i + OF2_ROWS - 1) % OF2_ROWS : i;
      const int e = (g0 + j) * OF2_EXT + c;
      if (in_m & (1u << j)) {
        const float eu = c + 1 < OF2_EXT ? su[e + 1] : 0.f;
        const float ev = c + 1 < OF2_EXT ? sv[e + 1] : 0.f;
        float bu, bv;  // the cell below
        if (j + 1 < OF2_ROWS) {
          bu = uu[j + 1];
          bv = vv[j + 1];
        } else {
          bu = g0 + OF2_ROWS < OF2_EXT ? su[e + OF2_EXT] : at_down ? h_down[c].x : 0.f;
          bv = g0 + OF2_ROWS < OF2_EXT ? sv[e + OF2_EXT] : at_down ? h_down[c].y : 0.f;
        }
        const bool fx = fx_m & (1u << j), fy = fy_m & (1u << j);
        const float ux = fx ? __fsub_rn(eu, uu[j]) : 0.f, uy = fy ? __fsub_rn(bu, uu[j]) : 0.f;
        const float vx = fx ? __fsub_rn(ev, vv[j]) : 0.f, vy = fy ? __fsub_rn(bv, vv[j]) : 0.f;
        const float nu = __fadd_rn(
            1.f, __fmul_rn(p.tt, sqrtf(__fadd_rn(__fmul_rn(ux, ux), __fmul_rn(uy, uy)))));
        const float nv = __fadd_rn(
            1.f, __fmul_rn(p.tt, sqrtf(__fadd_rn(__fmul_rn(vx, vx), __fmul_rn(vy, vy)))));
        s1x[e] = __fdiv_rn(__fadd_rn(s1x[e], __fmul_rn(p.tt, ux)), nu);
        s1y[e] = __fdiv_rn(__fadd_rn(s1y[e], __fmul_rn(p.tt, uy)), nu);
        s2x[e] = __fdiv_rn(__fadd_rn(s2x[e], __fmul_rn(p.tt, vx)), nv);
        s2y[e] = __fdiv_rn(__fadd_rn(s2y[e], __fmul_rn(p.tt, vy)), nv);
      }
      // The last row goes to the lower peer at once, a whole half-step
      // before its primal reads it (the last half-step's, none reads).
      if (i == 0 && at_down && s + 1 < iters)
        of2_st_async2(of2_peer_addr(h_up + c, ry + 1), s1y[e], s2y[e],
                      of2_peer_addr(mbar + UP, ry + 1));
    }
    __syncthreads();
  }
  // In a cluster every store into this CTA has landed: each was waited for.

  // The output region: rows [R, R + TY) of the region and columns [R, R + T)
  // of the tile, in the band.
  if (c < R || c >= R + T) return;
#pragma unroll
  for (int j = 0; j < OF2_ROWS; ++j) {
    if (!(in_m & (1u << j)) || Y0 + j < R || Y0 + j >= R + TY) continue;
    const int e = (g0 + j) * OF2_EXT + c;
    const size_t k = base + (size_t)(oy + j) * W + x;
    reinterpret_cast<float2*>(uv_out)[k] = make_float2(uu[j], vv[j]);
    if (p_out != nullptr)
      reinterpret_cast<float4*>(p_out)[k] = make_float4(s1x[e], s1y[e], s2x[e], s2y[e]);
  }
}

typedef void (*Of2TVL1Tile)(const float2*, const float*, const float*, const float*,
                            const float*, float*, float*, const Of2TVL1Params, int);

// The tile kernel of a cluster of cx x cy blocks, or null for a shape not
// compiled in.
static Of2TVL1Tile of2_tvl1_tile_for(int cx, int cy) {
  if (cx == 1 && cy == 1) return of2_tvl1_tile<1>;
  if (cx == 1 && cy == 2) return of2_tvl1_tile<2>;
  return nullptr;
}

// A launch of `grid` tile blocks in clusters of cx x cy; attr: its one
// attribute.
static cudaLaunchConfig_t of2_tvl1_cluster_config(dim3 grid, int cx, int cy, cudaStream_t st,
                                                  cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cx;
  attr->val.clusterDim.y = cy;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(OF2_THREADS);
  cfg.dynamicSmemBytes = OF2_TVL1_SMEM;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// One tile launch of `grid` blocks in clusters of cx x cy (1 x 1: a plain
// launch).
static cudaError_t of2_tvl1_launch_tiles(Of2TVL1Tile tile, int cx, int cy, dim3 grid,
                                         cudaStream_t st, const float2* cst, const float* it,
                                         const float* u0, const float* uv_in, const float* p_in,
                                         float* uv_out, float* p_out, const Of2TVL1Params& p,
                                         int k) {
  if (cx * cy == 1) {
    tile<<<grid, OF2_THREADS, OF2_TVL1_SMEM, st>>>(cst, it, u0, uv_in, p_in, uv_out, p_out, p, k);
    return cudaGetLastError();
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = of2_tvl1_cluster_config(grid, cx, cy, st, &attr);
  return cudaLaunchKernelEx(&cfg, tile, cst, it, u0, uv_in, p_in, uv_out, p_out, p, k);
}

// prev, warped: (B, H, W); u0 (the warp point), flow (the start): (B, H, W, 2);
// duals: (B, H, W, 4) as (p1x, p1y, p2x, p2y), or null for zeros; flow_out:
// (B, H, W, 2), duals_out: (B, H, W, 4) or null, each distinct from every
// input.  The H rows are global rows [row0, row0 + H) of an Hg-row image
// (whole image: 0, H).  iterations >= 1 run in ceil(iterations / max_iters)
// tile launches (1 <= max_iters < OF2_EXT / 2), each in clusters of cx x cy
// blocks (1 x 1 or 1 x 2).  scratch: 16-byte aligned,
// (3 + 6 * slots) * n2 floats (n2 = B*H*W rounded up to even, slots = tile
// launches - 1, at most 2), laid out as cst float2 | slot float4 duals and
// float2 flow, each slot | it.  masks: 18 host floats (Sobel-x / 8, Sobel-y
// / 8).
extern "C" int of2_tvl1_relax(const float* prev, const float* warped, const float* u0,
                              const float* flow, const float* duals_in, float* flow_out,
                              float* duals_out, float* scratch, int B, int H, int W, int row0,
                              int Hg, int iterations, int max_iters, const float* masks, float lt,
                              float theta, float tt, float eps, int cx, int cy, void* stream) {
  const Of2TVL1Tile tile = of2_tvl1_tile_for(cx, cy);
  if (B < 1 || H < 1 || W < 1 || Hg < 1 || iterations < 1 || max_iters < 1 ||
      2 * max_iters >= OF2_EXT || tile == nullptr)
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
  float2* cst = (float2*)scratch;
  float* it = scratch + (2 + 6 * slots) * n2;
  const dim3 block(OF2_TVL1_BX, OF2_TVL1_BY);
  const dim3 grid((W + OF2_TVL1_BX - 1) / OF2_TVL1_BX, (H + OF2_TVL1_BY - 1) / OF2_TVL1_BY, B);
  of2_tvl1_const<<<grid, block, 0, st>>>(prev, warped, cst, it, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(tile, cudaFuncAttributeMaxDynamicSharedMemorySize, OF2_TVL1_SMEM);
  if (err != cudaSuccess) return (int)err;
  // Launch j reads the state launch j - 1 wrote (j = 0: the caller's) and
  // writes into scratch slot j % 2 (duals, then flow), the last one into
  // flow_out and duals_out.
  const float* uv_in = flow;
  const float* p_in = duals_in;
  for (int j = 0; j < launches; ++j) {
    const bool last = j + 1 == launches;
    float* slot = scratch + (2 + 6 * (j % 2)) * n2;
    float* uv_out = last ? flow_out : slot + 4 * n2;
    float* p_out = last ? duals_out : slot;
    // Clusters of output regions TX x TY, cx x cy blocks each.
    const int k = of2_part(iterations, max_iters, j);
    const int TX = cx * OF2_EXT - 2 * k, TY = cy * OF2_EXT - 2 * k;
    const dim3 tiles((W + TX - 1) / TX * cx, (H + TY - 1) / TY * cy, B);
    err = of2_tvl1_launch_tiles(tile, cx, cy, tiles, st, cst, it, u0, uv_in, p_in, uv_out, p_out,
                                p, k);
    if (err != cudaSuccess) return (int)err;
    uv_in = uv_out;
    p_in = p_out;
  }
  return (int)cudaSuccess;
}

// Clusters of cx x cy tile blocks the card holds at once
// (cudaOccupancyMaxActiveClusters), or minus the CUDA error.
extern "C" int of2_tvl1_max_clusters(int cx, int cy) {
  const Of2TVL1Tile tile = of2_tvl1_tile_for(cx, cy);
  if (tile == nullptr) return -(int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(tile, cudaFuncAttributeMaxDynamicSharedMemorySize, OF2_TVL1_SMEM);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = of2_tvl1_cluster_config(dim3(cx, cy, 1), cx, cy, 0, &attr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, (const void*)tile, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}
