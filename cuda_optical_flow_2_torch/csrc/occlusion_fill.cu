// The occlusion fill: the side-aware diffusion fill of
// models/consistency.fill_occluded_flow, computed as its plain version
// (kernels/occlusion_fill.fill_occluded_flow_plain) computes it.
//
// Replaces cuda_optical_flow_2_tpu/models/consistency.py:124-205
// fill_occluded_flow, which has no pallas_call: its 96 sweeps are one
// lax.fori_loop that XLA fuses.
//
// Layouts: flow and out (B, H, W, 2) float32 read and written as one float2
// (u, v) per pixel; occ (B, H, W) bool, one byte per pixel; the state is
// three planes (u w, v w, w) of B*H*W floats each, twice (a ping-pong
// pair).  Everything outside the image reads as zero, as the plain
// version's zero-padded _avg3x3 and stencils do.
//
// What bounds it on an H100: bytes, one pass over the flow (8 bytes), the
// mask (1) and the output (8) per pixel, against about 30 FP32 operations
// and two divisions per occluded pixel per sweep.  A sweep in device memory
// would move 24 bytes per pixel (three planes in and out) 96 times, so the
// design keeps the sweeps in shared memory and skips what cannot change:
//
// 1. of2_fill_weights, one launch: 64 x 64 tiles with a ring of 5 cells
//    (four blur rounds and the gradient stencil each read +-1 cell), an
//    output tile of 54 x 54.  It blurs the mask, takes the inward normal
//    and the trust weight, writes the initial state into BOTH buffers of
//    the pair and the output at every pixel (the flow where kept, the
//    initial state where occluded: the result of zero sweeps), and one
//    flag per block: whether its output tile holds an occluded pixel.
// 2. of2_fill_sweep, ceil(iterations / K) launches of near equal k <= K:
//    64 x 64 tiles with a ring of R = k (of2_tile.cuh), the three planes
//    double-buffered in shared memory, k sweeps there, then the occluded
//    pixels of the (64 - 2R)^2 output tile written back, into the other
//    state buffer or, in the last launch, into the output (the final
//    select).  A kept pixel's state never changes and both buffers start
//    equal, so only occluded pixels are written, and a tile whose output
//    area holds none (the weights blocks' flags, read on the device)
//    returns at once: the grid stays fixed and nothing is read on the host,
//    so the call can be captured in a CUDA graph.
//
// Rounding: every product and sum is rounded on its own (__fmul_rn,
// __fadd_rn: nvcc would contract a product and a sum into an FMA), in the
// plain version's order, with its Python constants as float32 (1e-6f,
// 1e-9f, 1.f / 6.f, 1.f / 12.f); division and sqrtf are IEEE without
// fast-math.  Clamps are written x < lo ? lo : x, so NaN passes through as
// torch.maximum / torch.minimum pass it (fmaxf(NaN, 1) would be 1).
// Cells outside the image hold zero on every round and sweep, tested by
// image coordinates, so a pixel's result does not depend on its tile.
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "of2_tile.cuh"

#define OF2_FILL_WRING 5                                  // weights pass ring
#define OF2_FILL_WT (OF2_EXT - 2 * OF2_FILL_WRING)        // its output tile
#define OF2_FILL_BLUR 4                                   // blur rounds of the mask
#define OF2_FILL_WSMEM (2 * OF2_PLANE * (int)sizeof(float))  // the blurred mask, twice
#define OF2_FILL_SSMEM (6 * OF2_PLANE * (int)sizeof(float))  // three planes, twice

struct Of2FillDims {
  int H, W;
  int fh, fw;  // the weights pass's grid of flags per image
  size_t n;    // B * H * W: the stride between state planes
};

__device__ __forceinline__ bool of2_fill_in(const Of2FillDims d, int y, int x) {
  return y >= 0 && y < d.H && x >= 0 && x < d.W;
}

// One row of a window: the cells left of, at and right of column c of tile
// row q of a plane, zero outside the tile.
struct Of2FillRow {
  float l, m, r;
};

__device__ __forceinline__ Of2FillRow of2_fill_row(const float* __restrict__ s, int q, int c) {
  if (q < 0 || q >= OF2_EXT) return {0.f, 0.f, 0.f};
  const float* row = s + q * OF2_EXT;
  return {c > 0 ? row[c - 1] : 0.f, row[c], c + 1 < OF2_EXT ? row[c + 1] : 0.f};
}

// models/horn_schunck._avg3x3 of the middle cell: cross (n, s, w, e) * 1/6
// plus diagonals (nw, ne, sw, se) * 1/12, summed in that order.
__device__ __forceinline__ float of2_fill_avg(const Of2FillRow t, const Of2FillRow m,
                                              const Of2FillRow b) {
  const float cross = __fadd_rn(__fadd_rn(__fadd_rn(t.m, b.m), m.l), m.r);
  const float diag = __fadd_rn(__fadd_rn(__fadd_rn(t.l, t.r), b.l), b.r);
  return __fadd_rn(__fmul_rn(cross, 1.f / 6.f), __fmul_rn(diag, 1.f / 12.f));
}

// One tap pair of ops/conv.conv2d's shift form with the masks
// [[0.5, 0, -0.5]] (or its transpose): zeros + 0.5 a + -0.5 b, the zero
// tap skipped; the caller negates.
__device__ __forceinline__ float of2_fill_diff(float a, float b) {
  return __fadd_rn(__fadd_rn(0.f, __fmul_rn(0.5f, a)), __fmul_rn(-0.5f, b));
}

// The weights pass on the tile of block (x, y, batch): state planes s0 and
// s1 (both), out, and the block's flag.
__global__ void __launch_bounds__(OF2_THREADS, 1)
of2_fill_weights(const float2* __restrict__ flow, const unsigned char* __restrict__ occ,
                 float* __restrict__ s0, float* __restrict__ s1, float2* __restrict__ out,
                 unsigned char* __restrict__ flags, const Of2FillDims d, float neg_beta) {
  extern __shared__ float of2_smem[];  // the blurred mask, double-buffered
  const int R = OF2_FILL_WRING, T = OF2_FILL_WT;
  const size_t base = blockIdx.z * (size_t)d.H * d.W;
  const int c = threadIdx.x % OF2_EXT, g0 = threadIdx.x / OF2_EXT * OF2_ROWS;
  const int oy = blockIdx.y * T - R + g0, x = blockIdx.x * T - R + c;

  float occf[OF2_ROWS];
  unsigned in_m = 0;
#pragma unroll
  for (int j = 0; j < OF2_ROWS; ++j) {
    const int y = oy + j;
    const bool in = of2_fill_in(d, y, x);
    occf[j] = in && occ[base + (size_t)y * d.W + x] ? 1.f : 0.f;
    if (in) in_m |= 1u << j;
    of2_smem[(g0 + j) * OF2_EXT + c] = occf[j];
  }
  __syncthreads();
  // m = 0.5 * _avg3x3(m) + 0.5 * occf, four times; zero outside the image
  for (int r = 0; r < OF2_FILL_BLUR; ++r) {
    const float* cm = of2_smem + (r & 1) * OF2_PLANE;
    float* nm = of2_smem + ((r + 1) & 1) * OF2_PLANE;
    Of2FillRow t = of2_fill_row(cm, g0 - 1, c), m = of2_fill_row(cm, g0, c);
    float o[OF2_ROWS];
#pragma unroll
    for (int j = 0; j < OF2_ROWS; ++j) {
      const Of2FillRow b = of2_fill_row(cm, g0 + j + 1, c);
      o[j] = in_m & (1u << j)
                 ? __fadd_rn(__fmul_rn(0.5f, of2_fill_avg(t, m, b)), __fmul_rn(0.5f, occf[j]))
                 : 0.f;
      t = m;
      m = b;
    }
#pragma unroll
    for (int j = 0; j < OF2_ROWS; ++j) nm[(g0 + j) * OF2_EXT + c] = o[j];
    __syncthreads();
  }

  // The output tile: rows and columns [R, R + T) of the tile, in the image.
  const float* m4 = of2_smem + (OF2_FILL_BLUR & 1) * OF2_PLANE;
  bool occluded = false;
#pragma unroll
  for (int j = 0; j < OF2_ROWS; ++j) {
    const int q = g0 + j, y = oy + j;
    if (!(in_m & (1u << j)) || q < R || q >= R + T || c < R || c >= R + T) continue;
    const float* mr = m4 + q * OF2_EXT;
    const float gx = -of2_fill_diff(mr[c - 1], mr[c + 1]);
    const float gy = -of2_fill_diff(mr[c - OF2_EXT], mr[c + OF2_EXT]);
    const size_t k = base + (size_t)y * d.W + x;
    const float2 u = flow[k];
    const float norm = __fadd_rn(sqrtf(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy))), 1e-6f);
    const float proj = __fdiv_rn(__fadd_rn(__fmul_rn(u.x, gx), __fmul_rn(u.y, gy)), norm);
    float cl = proj < 0.f ? 0.f : proj;
    cl = cl > 30.f ? 30.f : cl;
    const float src_w = expf(__fmul_rn(neg_beta, cl));
    const float trusted = __fmul_rn(__fsub_rn(1.f, occf[j]), src_w);
    const float wu = __fmul_rn(u.x, trusted), wv = __fmul_rn(u.y, trusted);
    s0[k] = s1[k] = wu;
    s0[d.n + k] = s1[d.n + k] = wv;
    s0[2 * d.n + k] = s1[2 * d.n + k] = trusted;
    const bool grow = occf[j] != 0.f;  // keep = (1 - occf) > 0
    out[k] = grow ? make_float2(wu, wv) : u;
    occluded |= grow;
  }
  const int any = __syncthreads_or(occluded);
  if (threadIdx.x == 0) flags[((size_t)blockIdx.z * d.fh + blockIdx.y) * d.fw + blockIdx.x] = any;
}

// `sweeps` sweeps on the tile of block (x, y, batch) from the state planes
// cur into nxt, or with out into the output.
__global__ void __launch_bounds__(OF2_THREADS, 1)
of2_fill_sweep(const float* __restrict__ cur, float* __restrict__ nxt, float2* __restrict__ out,
               const unsigned char* __restrict__ occ, const unsigned char* __restrict__ flags,
               const Of2FillDims d, int sweeps) {
  extern __shared__ float of2_smem[];  // buffer b: plane p at of2_smem + (3b + p) planes
  const int R = sweeps, T = of2_tile_out(R);
  const int ty = blockIdx.y * T, tx = blockIdx.x * T;
  {
    // The weights blocks under the output tile; without an occluded pixel
    // there, no output pixel changes and both buffers already hold it.
    const int wy = ty / OF2_FILL_WT, wx = tx / OF2_FILL_WT;
    const int nx = (min(tx + T, d.W) - 1) / OF2_FILL_WT - wx + 1;
    const int ny = (min(ty + T, d.H) - 1) / OF2_FILL_WT - wy + 1;
    const int t = threadIdx.x;
    const bool hit = t < nx * ny &&
                     flags[((size_t)blockIdx.z * d.fh + wy + t / nx) * d.fw + wx + t % nx] != 0;
    if (!__syncthreads_or(hit)) return;
  }
  const size_t base = blockIdx.z * (size_t)d.H * d.W;
  const int c = threadIdx.x % OF2_EXT, g0 = threadIdx.x / OF2_EXT * OF2_ROWS;
  const int oy = ty - R + g0, x = tx - R + c;

  unsigned grow_m = 0;
#pragma unroll
  for (int j = 0; j < OF2_ROWS; ++j) {
    const int y = oy + j, e = (g0 + j) * OF2_EXT + c;
    const bool in = of2_fill_in(d, y, x);
    const size_t k = in ? base + (size_t)y * d.W + x : 0;
#pragma unroll
    for (int p = 0; p < 3; ++p) of2_cp_async4(of2_smem + p * OF2_PLANE + e, cur + p * d.n + k, in);
    if (in && occ[k]) grow_m |= 1u << j;
  }
  of2_cp_async_wait();
  // the second buffer starts equal: only occluded cells are written below
#pragma unroll
  for (int j = 0; j < OF2_ROWS; ++j)
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      const int e = p * OF2_PLANE + (g0 + j) * OF2_EXT + c;
      of2_smem[3 * OF2_PLANE + e] = of2_smem[e];
    }
  __syncthreads();

  for (int s = 0; s < sweeps; ++s) {
    const float* cb = of2_smem + (s & 1) * 3 * OF2_PLANE;
    float* nb = of2_smem + ((s + 1) & 1) * 3 * OF2_PLANE;
    if (grow_m) {
      Of2FillRow t[3], m[3];
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        t[p] = of2_fill_row(cb + p * OF2_PLANE, g0 - 1, c);
        m[p] = of2_fill_row(cb + p * OF2_PLANE, g0, c);
      }
      float o[OF2_ROWS][3];
#pragma unroll
      for (int j = 0; j < OF2_ROWS; ++j) {
        Of2FillRow b[3];
#pragma unroll
        for (int p = 0; p < 3; ++p) b[p] = of2_fill_row(cb + p * OF2_PLANE, g0 + j + 1, c);
        if (grow_m & (1u << j)) {
          // a newly reached pixel takes the normalized average and a weight
          // of at least 1; the rest keep theirs
          const float den = of2_fill_avg(t[2], m[2], b[2]);
          if (den > 1e-9f) {  // so clip(den, 1e-9) is den
            const float w = m[2].m;
            o[j][0] = __fdiv_rn(of2_fill_avg(t[0], m[0], b[0]), den);
            o[j][1] = __fdiv_rn(of2_fill_avg(t[1], m[1], b[1]), den);
            o[j][2] = w < 1.f ? 1.f : w;
          } else {
#pragma unroll
            for (int p = 0; p < 3; ++p) o[j][p] = m[p].m;
          }
        }
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          t[p] = m[p];
          m[p] = b[p];
        }
      }
#pragma unroll
      for (int j = 0; j < OF2_ROWS; ++j) {
        if (!(grow_m & (1u << j))) continue;
#pragma unroll
        for (int p = 0; p < 3; ++p) nb[p * OF2_PLANE + (g0 + j) * OF2_EXT + c] = o[j][p];
      }
    }
    __syncthreads();
  }

  // The occluded cells of the output tile: rows and columns [R, R + T).
  if (c < R || c >= R + T) return;
  const float* fb = of2_smem + (sweeps & 1) * 3 * OF2_PLANE;
#pragma unroll
  for (int j = 0; j < OF2_ROWS; ++j) {
    const int q = g0 + j;
    if (!(grow_m & (1u << j)) || q < R || q >= R + T) continue;
    const int e = q * OF2_EXT + c;
    const size_t k = base + (size_t)(oy + j) * d.W + x;
    if (out != nullptr) {
      out[k] = make_float2(fb[e], fb[OF2_PLANE + e]);
    } else {
#pragma unroll
      for (int p = 0; p < 3; ++p) nxt[p * d.n + k] = fb[p * OF2_PLANE + e];
    }
  }
}

// flow, out: (B, H, W, 2), 8-byte aligned; occ: (B, H, W) bytes (0 or 1);
// scratch: 6 * B * H * W floats (two buffers of three planes); flags: B *
// ceil(H / 54) * ceil(W / 54) bytes.  neg_beta = -beta as float32;
// iterations >= 0 (0: the weights pass alone); sweep launches run at most
// max_tile sweeps (1 <= max_tile < OF2_EXT / 2).
extern "C" int of2_occlusion_fill(const float* flow, const unsigned char* occ, float* out,
                                  float* scratch, unsigned char* flags, int B, int H, int W,
                                  int iterations, int max_tile, float neg_beta, void* stream) {
  if (B < 1 || H < 1 || W < 1 || iterations < 0 || max_tile < 1 || 2 * max_tile >= OF2_EXT)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaFuncSetAttribute(of2_fill_sweep,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         OF2_FILL_SSMEM);
  if (err != cudaSuccess) return (int)err;
  const Of2FillDims d = {H, W, (H + OF2_FILL_WT - 1) / OF2_FILL_WT,
                         (W + OF2_FILL_WT - 1) / OF2_FILL_WT, (size_t)B * H * W};
  float* buf[2] = {scratch, scratch + 3 * d.n};
  of2_fill_weights<<<dim3(d.fw, d.fh, B), OF2_THREADS, OF2_FILL_WSMEM, st>>>(
      (const float2*)flow, occ, buf[0], buf[1], (float2*)out, flags, d, neg_beta);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int launches = of2_launches(iterations, max_tile);
  for (int i = 0; i < launches; ++i) {
    const int k = of2_part(iterations, max_tile, i), T = of2_tile_out(k);
    const dim3 tiles((W + T - 1) / T, (H + T - 1) / T, B);
    of2_fill_sweep<<<tiles, OF2_THREADS, OF2_FILL_SSMEM, st>>>(
        buf[i % 2], buf[(i + 1) % 2], i + 1 == launches ? (float2*)out : nullptr, occ, flags, d,
        k);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
