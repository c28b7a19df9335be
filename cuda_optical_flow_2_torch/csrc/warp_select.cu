// Standalone bilinear backward warp with the flow clipped to +-max_disp;
// out-of-bounds samples keep the source pixel.  One thread per pixel, a
// direct four-tap gather (of2_common.cuh); on a row band (spatial TP) the
// sample row and the bounds test are global.
#include "of2_common.cuh"

__global__ void of2_warp_kernel(const float* __restrict__ img, const float* __restrict__ flow,
                                float* __restrict__ out, int H, int W, int row0, int Hg,
                                float max_disp) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  const size_t plane = (size_t)H * W;
  const float* I = img + blockIdx.z * plane;
  const size_t k = (size_t)y * W + x;
  const float* F = flow + 2 * (blockIdx.z * plane + k);
  out[blockIdx.z * plane + k] = of2_warp_pixel_band(I, H, W, x, y, F[0], F[1], max_disp, row0, Hg);
}

// img, out: (B, H, W) float32; flow: (B, H, W, 2) float32.  The H rows are
// global rows [row0, row0 + H) of an Hg-row image (whole image: 0, H).
extern "C" int of2_warp_select(const float* img, const float* flow, float* out, int B, int H,
                               int W, int row0, int Hg, float max_disp, void* stream) {
  if (B < 1 || H < 1 || W < 1 || Hg < 1) return (int)cudaErrorInvalidValue;
  const dim3 block(32, 8);
  const dim3 grid((W + 31) / 32, (H + 7) / 8, B);
  of2_warp_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(img, flow, out, H, W, row0, Hg,
                                                            max_disp);
  return (int)cudaGetLastError();
}
