// Joint bilateral pre-filter: spatial Gaussian x range Gaussian on the
// guide, over the taps inside the image, normalized by the total weight.
//
// Replaces cuda_optical_flow_2_tpu/kernels/bilateral_tap.py bilateral_kernel
// and bilateral_kernel_band.  Bound by operations on an H100: one exp per
// tap (81 at the reference's 9x9), which the special-function units issue 16
// per clock per SM, an eighth of the FP32 rate.  So a tap should cost the
// exp and little else:
//   - each weight is one ex2.approx of a pre-scaled argument,
//       wgt = 2^(k^2 * nc + lw[m][n]),  nc = -log2(e) / (2 sigma_range^2),
//     lw = log2(range_norm * spatial tap) from the host: the range
//     normalization and the spatial tap ride in the exponent (they change
//     only rounding: range_norm cancels in num / den);
//   - a thread owns OF2_RUN outputs along a row (of2_run_sum) and loads each
//     (guide, image) pair of a tap row's span once from shared memory;
//   - no tap is tested against the image: a position outside the global
//     image is staged with a +inf guide, whose k^2 * nc is -inf and whose
//     weight 2^-inf is exactly +0, so it adds exactly nothing to num and
//     den, as the plain version's masked weight does.  Every tile runs the
//     same loop, so a pixel's arithmetic does not depend on its tile (spatial
//     TP stays bit-equal to the whole image);
//   - the reference's r = 4 (window 9, OF2_BL_COMPILED_R) runs a kernel
//     compiled for its 9 taps a row; any other radius up to 15 runs the
//     generic one.
// Each output sums its taps in row-major order.
//
// Bands (spatial TP): the H rows are global rows [row0, row0 + H) of an
// Hg-row image.  A tap counts when its global row and its column lie in the
// image; a counted tap outside the band reads image and guide as zero, and a
// pixel whose global row lies outside the image is written as zero, as
// ops/bilateral.bilateral_filter_band computes.  The whole image is the band
// row0 = 0, Hg = H.
#include "of2_common.cuh"

#define OF2_BL_MAX_R 15  // window <= 31
#define OF2_BL_MAX_TAPS ((2 * OF2_BL_MAX_R + 1) * (2 * OF2_BL_MAX_R + 1))
#define OF2_BL_TILE 32  // output tile: 32 rows (a warp's lanes) x 32 columns
#define OF2_BL_THREADS (OF2_BL_TILE * OF2_BL_TILE / OF2_RUN)
#define OF2_BL_COMPILED_R 4  // BilateralConfig()'s window 9

struct Of2BilateralParams {
  float lw[OF2_BL_MAX_TAPS];  // log2(range_norm * spatial), (2r+1)^2 row-major, used part
  float nc;                   // -log2(e) / (2 sigma_range^2)
  int r;
  int H;
  int W;
  int row0;  // global row of band row 0
  int Hg;    // global image height
};

// Bytes of shared memory: the staged (guide, image) pairs of the tile and its
// r halo, leading dimension odd, then the (2r+1)^2 log-weights.
static inline size_t of2_bl_smem_bytes(int r) {
  const size_t s = OF2_BL_TILE + 2 * r;
  return s * (s | 1) * sizeof(float2) + (2 * r + 1) * (2 * r + 1) * sizeof(float);
}

// 2^x as one MUFU.EX2: about 2 ulp; 2^-inf = +0; results below 2^-126 flush to +0.
__device__ __forceinline__ float of2_ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// R >= 0: the radius, fixed at compile time (it must equal p.r); < 0: any radius.
template <int R>
__global__ void __launch_bounds__(OF2_BL_THREADS)
of2_bilateral_kernel(const float* __restrict__ img, const float* __restrict__ guide,
                     float* __restrict__ out, const Of2BilateralParams p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int TAPS = R >= 0 ? 2 * R + 1 : 0;
  const int r = R >= 0 ? R : p.r, side = 2 * r + 1;
  const int H = p.H, W = p.W, row0 = p.row0, Hg = p.Hg;
  const int sh = OF2_BL_TILE + 2 * r, ld = sh | 1;
  float2* S = reinterpret_cast<float2*>(smem);  // (guide, image), sh x ld
  float* LW = smem + 2 * sh * ld;               // side x side
  const size_t plane = (size_t)H * W;
  const float* I = img + blockIdx.z * plane;
  const float* G = guide + blockIdx.z * plane;
  const int oy = blockIdx.y * OF2_BL_TILE, ox = blockIdx.x * OF2_BL_TILE;

  for (int i = threadIdx.x; i < side * side; i += blockDim.x) LW[i] = p.lw[i];
  for (int i = threadIdx.x; i < sh * sh; i += blockDim.x) {
    const int y = oy - r + i / sh, x = ox - r + i % sh;  // band row, column
    float2* s = S + (i / sh) * ld + i % sh;
    if (row0 + y < 0 || row0 + y >= Hg || x < 0 || x >= W) {
      *s = make_float2(INFINITY, 0.f);  // outside the image: weight exactly 0
    } else {
      // inside the image; zero outside the band
      const bool in = y >= 0 && y < H;
      const size_t k = (size_t)min(max(y, 0), H - 1) * W + x;
      of2_cp_async4(&s->x, G + k, in);
      of2_cp_async4(&s->y, I + k, in);
    }
  }
  of2_cp_async_wait();
  __syncthreads();

  // lanes take consecutive rows (odd ld: no bank conflicts), a thread a run
  // of OF2_RUN columns
  const int ty = threadIdx.x % OF2_BL_TILE, tx0 = threadIdx.x / OF2_BL_TILE * OF2_RUN;
  const float nc = p.nc;
  float g0[OF2_RUN];
#pragma unroll
  for (int k = 0; k < OF2_RUN; ++k) g0[k] = S[(ty + r) * ld + tx0 + k + r].x;
  float acc[2][OF2_RUN];  // num, den
#pragma unroll
  for (int k = 0; k < OF2_RUN; ++k) acc[0][k] = acc[1][k] = 0.f;
  for (int m = 0; m < side; ++m) {
    const float2* row = S + (ty + m) * ld + tx0;
    const float* lw = LW + m * side;
    of2_run_sum<2, 2, TAPS>(
        side,
        [&](int j, float (&v)[2]) {
          const float2 gi = row[j];
          v[0] = gi.x;
          v[1] = gi.y;
        },
        [&](int n, const float (&v)[2], float (&a)[2][OF2_RUN], int k) {
          const float d = v[0] - g0[k];
          const float wgt = of2_ex2(fmaf(d * d, nc, lw[n]));
          a[0][k] = fmaf(v[1], wgt, a[0][k]);
          a[1][k] += wgt;
        },
        acc);
  }
  const int y = oy + ty;
  if (y >= H) return;
  const bool live = row0 + y >= 0 && row0 + y < Hg;
  float* o = out + blockIdx.z * plane + (size_t)y * W + ox + tx0;
#pragma unroll
  for (int k = 0; k < OF2_RUN; ++k)
    if (ox + tx0 + k < W) o[k] = live ? acc[0][k] / acc[1][k] : 0.f;
}

// 1 when radius r runs the kernel compiled for its taps, 0 when the generic one.
extern "C" int of2_bilateral_compiled(int r) { return r == OF2_BL_COMPILED_R; }

// img, guide, out: (B, H, W) float32 (guide may alias img); the H rows are
// global rows [row0, row0 + H) of an Hg-row image (whole image: 0, H);
// spatial: the (2r+1)^2 float32 taps on the host.
extern "C" int of2_bilateral(const float* img, const float* guide, float* out, int B, int H,
                             int W, int row0, int Hg, int r, const float* spatial,
                             float range_norm, float inv_2s2, void* stream) {
  if (r < 0 || r > OF2_BL_MAX_R || B < 1 || H < 1 || W < 1 || Hg < 1)
    return (int)cudaErrorInvalidValue;
  Of2BilateralParams p;
  const int taps = (2 * r + 1) * (2 * r + 1);
  for (int t = 0; t < OF2_BL_MAX_TAPS; ++t)
    p.lw[t] = t < taps ? (float)log2((double)range_norm * (double)spatial[t]) : 0.f;
  p.nc = (float)(-(double)inv_2s2 / log(2.0));
  p.r = r;
  p.H = H;
  p.W = W;
  p.row0 = row0;
  p.Hg = Hg;
  void (*kernel)(const float*, const float*, float*, const Of2BilateralParams) =
      of2_bilateral_compiled(r) ? of2_bilateral_kernel<OF2_BL_COMPILED_R>
                                : of2_bilateral_kernel<-1>;
  const size_t smem = of2_bl_smem_bytes(r);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + OF2_BL_TILE - 1) / OF2_BL_TILE, (H + OF2_BL_TILE - 1) / OF2_BL_TILE, B);
  kernel<<<grid, OF2_BL_THREADS, smem, (cudaStream_t)stream>>>(img, guide, out, p);
  return (int)cudaGetLastError();
}
