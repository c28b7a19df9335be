// Box-window sums of five planes and the guarded 2x2 solve: five (B, H, W)
// planes -> (B, H, W, 2) flow.
//
// Replaces cuda_optical_flow_2_tpu/kernels/win_solve.py window_solve.
// Bound by bytes on an H100: 20 bytes in and 8 out per pixel against
// 10 (window - 1) adds and ~12 operations of solve.  A block owns a th x tw
// output tile (the wrapper picks it for the radius,
// kernels/tile_geometry.win_tile; both multiples of OF2_RUN).  It stages the
// five planes over the tile and its rw halo in shared memory with cp.async
// (zero outside the image): a row of 16-byte copies where the image rows
// allow (vec: W % 4 == 0, planes and flow 16-byte aligned), else 4-byte
// ones.  Then the window's column pass (lanes on consecutive columns, a
// thread sums OF2_RUN rows of one from registers) into V, and its row pass
// and the solve (lanes on consecutive rows, a thread OF2_RUN columns of
// one), both of2_win_tile.cuh's, which the fused FB step runs too; every sum
// keeps the plain version's order, so the flow is bit-equal to
// window_solve_plain.
#include "of2_win_tile.cuh"

#define OF2_WS_THREADS 256
// FBConfig()'s winsize 15 (rw = 7) runs a kernel compiled for its taps; any
// other radius the generic one.
#define OF2_WS_COMPILED_R 7

// Staged column j of a tile row holds image column ox - rw - lead + j:
// lead = (-rw) mod 4 puts the first staged column on a multiple of 4 (ox is
// one), so with W % 4 == 0 every 16-byte copy lies wholly inside or wholly
// outside the image row.  Leading dimensions: P's a multiple of 4 (16-byte
// rows); V's 4 times an odd number, so the row pass reads V as float4 and
// the eight lanes of each quarter warp, on eight consecutive rows, hit
// distinct banks.  kernels/tile_geometry.win_tile mirrors these.
__host__ __device__ __forceinline__ int of2_ws_lead(int rw) { return (4 - (rw & 3)) & 3; }
__host__ __device__ __forceinline__ int of2_ws_ldp(int rw, int tw) {
  return (of2_ws_lead(rw) + tw + 2 * rw + 3) & ~3;
}
__host__ __device__ __forceinline__ int of2_ws_ldv(int rw, int tw) {
  return (((tw + 2 * rw + 3) >> 2) | 1) << 2;
}
static inline size_t of2_ws_smem_floats(int rw, int th, int tw) {
  const size_t ph = th + 2 * rw;
  return 5 * ph * of2_ws_ldp(rw, tw) + 5 * (size_t)th * of2_ws_ldv(rw, tw);
}

// cp.async of 16 bytes (src 16-byte aligned), zero-filled when !valid.
__device__ __forceinline__ void of2_cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// RW >= 0: the radius, fixed at compile time (it must equal rw_); < 0: any.
template <int RW>
__global__ void __launch_bounds__(OF2_WS_THREADS, 3)
of2_window_solve_kernel(const float* __restrict__ p11, const float* __restrict__ p12,
                        const float* __restrict__ p22, const float* __restrict__ h1,
                        const float* __restrict__ h2, float* __restrict__ flow, int H, int W,
                        int rw_, int th, int tw, int vec, float det_eps) {
  extern __shared__ __align__(16) float smem[];
  const int rw = RW >= 0 ? RW : rw_;
  const int ph = th + 2 * rw, pw = tw + 2 * rw;
  const int lead = of2_ws_lead(rw), ldp = of2_ws_ldp(rw, tw), ldv = of2_ws_ldv(rw, tw);
  const int pplane = ph * ldp, vplane = th * ldv;
  float* P = smem;  // five planes of ph x ldp
  float* V = P + 5 * pplane;  // five planes of th x ldv
  const size_t plane = (size_t)H * W, off = blockIdx.z * plane;
  const float* src[5] = {p11 + off, p12 + off, p22 + off, h1 + off, h2 + off};
  const int oy = blockIdx.y * th, ox = blockIdx.x * tw;
  const int xa = ox - rw - lead;

  if (vec) {
    const int nq = ldp / 4;
    for (int i = threadIdx.x; i < ph * nq; i += blockDim.x) {
      const int y = i / nq, q = i - y * nq;
      const int gy = oy - rw + y, gx = xa + 4 * q;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const size_t k = in ? (size_t)gy * W + gx : 0;
#pragma unroll
      for (int c = 0; c < 5; ++c) of2_cp_async16(P + c * pplane + y * ldp + 4 * q, src[c] + k, in);
    }
  } else {
    for (int i = threadIdx.x; i < ph * ldp; i += blockDim.x) {
      const int y = i / ldp, x = i - y * ldp;
      const int gy = oy - rw + y, gx = xa + x;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const size_t k = in ? (size_t)gy * W + gx : 0;
#pragma unroll
      for (int c = 0; c < 5; ++c) of2_cp_async4(P + c * pplane + i, src[c] + k, in);
    }
  }
  of2_cp_async_wait();
  __syncthreads();

  // The column pass: lanes take consecutive columns, a thread walks
  // OF2_RUN + 2 rw rows of one.
  for (int i = threadIdx.x; i < pw * (th / OF2_RUN); i += blockDim.x) {
    const int x = i % pw, y0 = (i / pw) * OF2_RUN;
    const float* col = P + y0 * ldp + lead + x;
    float a[5][OF2_RUN];
    of2_win_sum_run<RW>(rw, [&](int j, float (&v)[5]) {
#pragma unroll
      for (int c = 0; c < 5; ++c) v[c] = col[c * pplane + j * ldp];
    }, a);
#pragma unroll
    for (int c = 0; c < 5; ++c)
#pragma unroll
      for (int k = 0; k < OF2_RUN; ++k) V[c * vplane + (y0 + k) * ldv + x] = a[c][k];
  }
  __syncthreads();

  // The row pass and the solve: lanes take consecutive rows, a thread walks
  // OF2_RUN + 2 rw columns of one, four at a time (the span's cells come in
  // order, j = 0, 1, ..., from float4 loads); with vec its four pixels go
  // out as two float4 stores (32 bytes, one whole sector).
  float2* out = reinterpret_cast<float2*>(flow) + off;
  for (int i = threadIdx.x; i < th * (tw / OF2_RUN); i += blockDim.x) {
    const int ty = i % th, tx0 = (i / th) * OF2_RUN;
    const float* row = V + ty * ldv + tx0;
    float s[5][OF2_RUN];
    float4 q[5];
    of2_win_sum_run<RW>(rw, [&](int j, float (&v)[5]) {
      const int m = j & 3;
#pragma unroll
      for (int c = 0; c < 5; ++c) {
        if (m == 0) q[c] = *reinterpret_cast<const float4*>(row + c * vplane + j);
        v[c] = m == 0 ? q[c].x : m == 1 ? q[c].y : m == 2 ? q[c].z : q[c].w;
      }
    }, s);
    const int y = oy + ty;
    if (y >= H) continue;
    float2 f[OF2_RUN];
#pragma unroll
    for (int k = 0; k < OF2_RUN; ++k) {
      const float sk[5] = {s[0][k], s[1][k], s[2][k], s[3][k], s[4][k]};
      f[k] = of2_win_solve(sk, det_eps);
    }
    float2* o = out + (size_t)y * W + ox + tx0;
    if (vec) {  // W % 4 == 0: the four pixels lie in the image or all past it
      if (ox + tx0 >= W) continue;
      reinterpret_cast<float4*>(o)[0] = make_float4(f[0].x, f[0].y, f[1].x, f[1].y);
      reinterpret_cast<float4*>(o)[1] = make_float4(f[2].x, f[2].y, f[3].x, f[3].y);
    } else {
#pragma unroll
      for (int k = 0; k < OF2_RUN; ++k)
        if (ox + tx0 + k < W) o[k] = f[k];
    }
  }
}

// p11, p12, p22, h1, h2: (B, H, W) float32, contiguous; flow: (B, H, W, 2)
// float32; th x tw: the output tile (kernels/tile_geometry.win_tile),
// refused unless both are positive multiples of OF2_RUN and its shared
// memory fits a block.
extern "C" int of2_window_solve(const float* p11, const float* p12, const float* p22,
                                const float* h1, const float* h2, float* flow, int B, int H,
                                int W, int rw, int th, int tw, float det_eps, void* stream) {
  if (rw < 0 || rw > OF2_WT_MAX_R || B < 1 || B > 65535 || H < 1 || W < 1 || th < OF2_RUN ||
      tw < OF2_RUN || th % OF2_RUN || tw % OF2_RUN)
    return (int)cudaErrorInvalidValue;
  const size_t smem = of2_ws_smem_floats(rw, th, tw) * sizeof(float);
  if (smem > OF2_SMEM_MAX) return (int)cudaErrorInvalidValue;
  const void* ptrs[6] = {p11, p12, p22, h1, h2, flow};
  int vec = W % 4 == 0;
  for (const void* p : ptrs) vec = vec && (reinterpret_cast<size_t>(p) % 16 == 0);
  void (*kernel)(const float*, const float*, const float*, const float*, const float*, float*,
                 int, int, int, int, int, int, float) =
      rw == OF2_WS_COMPILED_R ? of2_window_solve_kernel<OF2_WS_COMPILED_R>
                              : of2_window_solve_kernel<-1>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + tw - 1) / tw, (H + th - 1) / th, B);
  kernel<<<grid, OF2_WS_THREADS, smem, (cudaStream_t)stream>>>(p11, p12, p22, h1, h2, flow, H, W,
                                                               rw, th, tw, vec, det_eps);
  return (int)cudaGetLastError();
}
