// Farnebaeck polynomial expansion of whole images: (B, H, W) -> five planes.
//
// Replaces cuda_optical_flow_2_tpu/kernels/poly_exp_fused.py
// poly_expansion_kernel.  Bound by bytes on an H100: 4 bytes in and 20 out
// per pixel against ~190 FP32 operations.  A block owns a 20 x 128 output
// tile at every radius.  It stages the tile and its r halo in shared
// memory with cp.async (zero outside the image), takes the vertical sums
// (lanes on consecutive columns, a thread walks OF2_RUN rows) and then the
// moments and the mixing (lanes on consecutive runs of one row, so a warp
// reads a whole row of the vertical sums as float4 and writes each output
// plane as 512 contiguous bytes, float4 per thread).  Both passes are
// of2_poly.cuh's, which the fused FB step runs too.  Small blocks that hold
// no state between phases leave several resident on each SM, so one block's
// loads and stores overlap another's passes.
#include "of2_poly.cuh"

#define OF2_PE_TW 128  // output tile columns: 32 lanes x OF2_RUN
// Output tile rows, a multiple of OF2_RUN, at every radius: 20 were the
// fastest of 8-32 in a sweep at 1080x1920 and poly_n 7 on an H100; on an
// 812 x 3840 band 12, 20 and 24 rows tied.
#define OF2_PE_TH 20
#define OF2_PE_THREADS 256

__host__ __device__ constexpr int of2_pe_round4(int n) { return (n + 3) & ~3; }

// Floats of shared memory for radius r: the staged source (TH + 2r) x
// (TW + 2r), then three planes of vertical sums TH x ldt, ldt the source
// width rounded up to a multiple of 4.
constexpr size_t of2_pe_smem_floats(int r) {
  return of2_pe_round4((OF2_PE_TH + 2 * r) * (OF2_PE_TW + 2 * r)) +
         3 * (size_t)OF2_PE_TH * of2_pe_round4(OF2_PE_TW + 2 * r);
}
static_assert(OF2_PE_TH % OF2_RUN == 0, "a thread's vertical run lies inside the tile");
static_assert(of2_pe_smem_floats(OF2_POLY_MAX_R) * sizeof(float) <= OF2_SMEM_MAX,
              "the largest radius fits a block's shared memory");

// FBConfig()'s poly_n = 7 (r = 3) runs a kernel compiled for its taps; any
// other radius the generic one.
#define OF2_PE_COMPILED_R 3

// RP >= 0: the radius, fixed at compile time (it must equal p.r); < 0: any
// radius.  vec: the output planes take float4 stores (W % 4 == 0, aligned).
template <int RP>
__global__ void __launch_bounds__(OF2_PE_THREADS)
of2_poly_exp_kernel(const float* __restrict__ img, float* __restrict__ out, int H, int W, int vec,
                    const Of2PolyTaps p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int th = OF2_PE_TH;
  const int r = RP >= 0 ? RP : p.r;
  const int sw = OF2_PE_TW + 2 * r, sh = th + 2 * r, ldt = of2_pe_round4(sw);
  const int tplane = th * ldt;
  float* S = smem;                           // sh x sw source
  float* T = smem + of2_pe_round4(sh * sw);  // three planes of th x ldt
  const size_t plane = (size_t)H * W;
  const size_t outs = gridDim.z * plane;  // one output plane (B, H, W)
  const float* I = img + blockIdx.z * plane;
  const int oy = blockIdx.y * th, ox = blockIdx.x * OF2_PE_TW;

  for (int i = threadIdx.x; i < sh * sw; i += blockDim.x) {
    const int y = oy - r + i / sw, x = ox - r + i % sw;
    const bool in = y >= 0 && y < H && x >= 0 && x < W;
    of2_cp_async4(S + i, I + (size_t)min(max(y, 0), H - 1) * W + min(max(x, 0), W - 1), in);
  }
  of2_cp_async_wait();
  __syncthreads();

  for (int i = threadIdx.x; i < sw * (th / OF2_RUN); i += blockDim.x) {
    const int x = i % sw, y0 = (i / sw) * OF2_RUN;
    float a[3][OF2_RUN];
    of2_poly_vertical_run<RP>([&](int j, float (&v)[1]) { v[0] = S[(y0 + j) * sw + x]; }, p,
                              a);
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int k = 0; k < OF2_RUN; ++k) T[c * tplane + (y0 + k) * ldt + x] = a[c][k];
  }
  __syncthreads();

  constexpr int RUNS = OF2_PE_TW / OF2_RUN;
  for (int i = threadIdx.x; i < th * RUNS; i += blockDim.x) {
    const int ty = i / RUNS, tx0 = (i % RUNS) * OF2_RUN;
    const int y = oy + ty, x0 = ox + tx0;
    if (y >= H || x0 >= W) continue;
    const float* t0 = T + ty * ldt + tx0;
    float e[5][OF2_RUN];
    if constexpr (RP >= 0) {
      // the run's span of each plane in registers, read as float4
      constexpr int NV = (OF2_RUN + 2 * RP + 3) / 4;
      float span[3][4 * NV];
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int q = 0; q < NV; ++q) {
          const float4 v = *reinterpret_cast<const float4*>(t0 + c * tplane + 4 * q);
          span[c][4 * q] = v.x;
          span[c][4 * q + 1] = v.y;
          span[c][4 * q + 2] = v.z;
          span[c][4 * q + 3] = v.w;
        }
      of2_poly_moments_run<RP>(
          [&](int j, float (&v)[3]) {
            v[0] = span[0][j];
            v[1] = span[1][j];
            v[2] = span[2][j];
          },
          p, [&](int q, int k, float v) { e[q][k] = v; });
    } else {
      of2_poly_moments_run<RP>(
          [&](int j, float (&v)[3]) {
            v[0] = t0[j];
            v[1] = t0[tplane + j];
            v[2] = t0[2 * tplane + j];
          },
          p, [&](int q, int k, float v) { e[q][k] = v; });
    }
    float* o = out + blockIdx.z * plane + (size_t)y * W + x0;
    if (vec) {  // W % 4 == 0: the run lies inside the row
#pragma unroll
      for (int q = 0; q < 5; ++q)
        *reinterpret_cast<float4*>(o + q * outs) = make_float4(e[q][0], e[q][1], e[q][2], e[q][3]);
    } else {
#pragma unroll
      for (int q = 0; q < 5; ++q)
#pragma unroll
        for (int k = 0; k < OF2_RUN; ++k)
          if (x0 + k < W) o[q * outs + k] = e[q][k];
    }
  }
}

// 1 when radius r runs the kernel compiled for its taps, 0 when the generic one.
extern "C" int of2_poly_exp_compiled(int r) { return r == OF2_PE_COMPILED_R; }

// img: (B, H, W) float32; out: (5, B, H, W) float32, planes (bx, by, axx, ayy,
// axy); taps: 3 x (2r+1) float32; mix: 5 x 6 float32 (axy row halved).
extern "C" int of2_poly_exp(const float* img, float* out, int B, int H, int W, int r,
                            const float* taps, const float* mix, void* stream) {
  Of2PolyTaps p;
  if (B < 1 || H < 1 || W < 1 || !of2_poly_fill(&p, r, taps, mix))
    return (int)cudaErrorInvalidValue;
  const size_t smem = of2_pe_smem_floats(r) * sizeof(float);
  void (*kernel)(const float*, float*, int, int, int, const Of2PolyTaps) =
      of2_poly_exp_compiled(r) ? of2_poly_exp_kernel<OF2_PE_COMPILED_R> : of2_poly_exp_kernel<-1>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = W % 4 == 0 && (size_t)out % 16 == 0;
  const dim3 grid((W + OF2_PE_TW - 1) / OF2_PE_TW, (H + OF2_PE_TH - 1) / OF2_PE_TH, B);
  kernel<<<grid, OF2_PE_THREADS, smem, (cudaStream_t)stream>>>(img, out, H, W, vec, p);
  return (int)cudaGetLastError();
}
