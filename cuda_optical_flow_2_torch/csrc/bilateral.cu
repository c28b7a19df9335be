// Joint bilateral pre-filter: spatial Gaussian x range Gaussian on the
// guide, over the taps inside the image, normalized by the total weight.
// One block per OF2_BL_TILE_H x OF2_BL_TILE_W output tile; the tile plus an
// r-pixel halo of image and guide is staged in shared memory once.
//
// Bands (spatial TP): the H rows are global rows [row0, row0 + H) of an
// Hg-row image.  A tap counts when its global row and its column lie in the
// image; a counted tap outside the band reads image and guide as zero, and a
// pixel whose global row lies outside the image is written as zero, as
// ops/bilateral.bilateral_filter_band computes.  The whole image is the band
// row0 = 0, Hg = H.
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#define OF2_BL_MAX_R 15  // window <= 31: (2r+1)^2 spatial taps in the parameters
#define OF2_BL_MAX_TAPS ((2 * OF2_BL_MAX_R + 1) * (2 * OF2_BL_MAX_R + 1))
#define OF2_BL_TILE_H 16
#define OF2_BL_TILE_W 32
#define OF2_BL_THREADS 256
#define OF2_BL_SH (OF2_BL_TILE_H + 2 * OF2_BL_MAX_R)
#define OF2_BL_SW (OF2_BL_TILE_W + 2 * OF2_BL_MAX_R)

struct Of2BilateralParams {
  float spatial[OF2_BL_MAX_TAPS];  // (2r+1)^2 row-major float32 taps, used part
  float range_norm;                // 1 / (2 pi sigma_range^2)
  float inv_2s2;                   // 1 / (2 sigma_range^2)
  int r;
  int H;
  int W;
  int row0;  // global row of band row 0
  int Hg;    // global image height
};

__global__ void __launch_bounds__(OF2_BL_THREADS)
of2_bilateral_kernel(const float* __restrict__ img, const float* __restrict__ guide,
                     float* __restrict__ out, const Of2BilateralParams p) {
  __shared__ float s_img[OF2_BL_SH * OF2_BL_SW];
  __shared__ float s_gd[OF2_BL_SH * OF2_BL_SW];
  const int r = p.r, H = p.H, W = p.W;
  const int side = 2 * r + 1;
  const int sh = OF2_BL_TILE_H + 2 * r, sw = OF2_BL_TILE_W + 2 * r;
  const size_t plane = (size_t)H * W;
  const float* I = img + blockIdx.z * plane;
  const float* G = guide + blockIdx.z * plane;
  const int oy = blockIdx.y * OF2_BL_TILE_H, ox = blockIdx.x * OF2_BL_TILE_W;

  for (int i = threadIdx.x; i < sh * sw; i += blockDim.x) {
    const int y = oy - r + i / sw, x = ox - r + i % sw;
    const bool in = y >= 0 && y < H && x >= 0 && x < W;
    s_img[i] = in ? I[(size_t)y * W + x] : 0.f;
    s_gd[i] = in ? G[(size_t)y * W + x] : 0.f;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < OF2_BL_TILE_H * OF2_BL_TILE_W; i += blockDim.x) {
    const int ty = i / OF2_BL_TILE_W, tx = i % OF2_BL_TILE_W;
    const int y = oy + ty, x = ox + tx;
    if (y >= H || x >= W) continue;
    float* o = out + blockIdx.z * plane + (size_t)y * W + x;
    if (p.row0 + y < 0 || p.row0 + y >= p.Hg) {
      *o = 0.f;
      continue;
    }
    const float g0 = s_gd[(ty + r) * sw + tx + r];
    float num = 0.f, den = 0.f;
    for (int m = 0; m < side; ++m) {
      const int yy = p.row0 + y + m - r;
      if (yy < 0 || yy >= p.Hg) continue;  // the tap's position, not a guide value, masks it
      const float* srow_i = s_img + (ty + m) * sw + tx;
      const float* srow_g = s_gd + (ty + m) * sw + tx;
      for (int n = 0; n < side; ++n) {
        const int xx = x + n - r;
        if (xx < 0 || xx >= W) continue;
        const float k = srow_g[n] - g0;
        // ops/bilateral's order: range_norm * exp(...) * spatial tap.
        // expf, not __expf: the tolerance assumes the accurate exp.
        const float wgt = p.range_norm * expf(-(k * k) * p.inv_2s2) * p.spatial[m * side + n];
        num += srow_i[n] * wgt;
        den += wgt;
      }
    }
    *o = num / den;
  }
}

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
  for (int t = 0; t < OF2_BL_MAX_TAPS; ++t) p.spatial[t] = t < taps ? spatial[t] : 0.f;
  p.range_norm = range_norm;
  p.inv_2s2 = inv_2s2;
  p.r = r;
  p.H = H;
  p.W = W;
  p.row0 = row0;
  p.Hg = Hg;
  const dim3 grid((W + OF2_BL_TILE_W - 1) / OF2_BL_TILE_W, (H + OF2_BL_TILE_H - 1) / OF2_BL_TILE_H,
                  B);
  of2_bilateral_kernel<<<grid, OF2_BL_THREADS, 0, (cudaStream_t)stream>>>(img, guide, out, p);
  return (int)cudaGetLastError();
}
