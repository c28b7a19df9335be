// Farnebaeck polynomial expansion of whole images: (B, H, W) -> five planes.
// One block per OF2_PE_TILE x OF2_PE_TILE output tile stages the tile plus an
// r-pixel halo in shared memory (zero outside the image), runs the three
// vertical passes into shared memory, then the six horizontal moments and the
// mixing per pixel (of2_poly.cuh).
#include "of2_poly.cuh"

#define OF2_PE_TILE 32
#define OF2_PE_THREADS 256

static inline size_t of2_pe_smem_floats(int r) {
  const size_t sw = OF2_PE_TILE + 2 * r;
  return sw * sw + 3 * (size_t)OF2_PE_TILE * sw;
}

__global__ void __launch_bounds__(OF2_PE_THREADS)
of2_poly_exp_kernel(const float* __restrict__ img, float* __restrict__ out, int H, int W,
                    const Of2PolyTaps p) {
  extern __shared__ float smem[];
  const int r = p.r, sw = OF2_PE_TILE + 2 * r;
  float* s = smem;            // sw x sw source
  float* t = s + sw * sw;     // three planes of OF2_PE_TILE x sw
  const size_t plane = (size_t)H * W;
  const size_t outs = gridDim.z * plane;  // one output plane (B, H, W)
  const float* I = img + blockIdx.z * plane;
  const int oy = blockIdx.y * OF2_PE_TILE, ox = blockIdx.x * OF2_PE_TILE;

  for (int i = threadIdx.x; i < sw * sw; i += blockDim.x) {
    const int y = oy - r + i / sw, x = ox - r + i % sw;
    s[i] = (y >= 0 && y < H && x >= 0 && x < W) ? I[(size_t)y * W + x] : 0.f;
  }
  __syncthreads();
  of2_poly_vertical(s, sw, t, OF2_PE_TILE, sw, p);
  __syncthreads();
  for (int i = threadIdx.x; i < OF2_PE_TILE * OF2_PE_TILE; i += blockDim.x) {
    const int ty = i / OF2_PE_TILE, tx = i % OF2_PE_TILE;
    const int y = oy + ty, x = ox + tx;
    if (y >= H || x >= W) continue;
    float e[5];
    of2_poly_pixel(t, OF2_PE_TILE * sw, sw, ty, tx, p, e);
    const size_t k = blockIdx.z * plane + (size_t)y * W + x;
#pragma unroll
    for (int c = 0; c < 5; ++c) out[c * outs + k] = e[c];
  }
}

// img: (B, H, W) float32; out: (5, B, H, W) float32, planes (bx, by, axx, ayy,
// axy); taps: 3 x (2r+1) float32; mix: 5 x 6 float32 (axy row halved).
extern "C" int of2_poly_exp(const float* img, float* out, int B, int H, int W, int r,
                            const float* taps, const float* mix, void* stream) {
  Of2PolyTaps p;
  if (B < 1 || H < 1 || W < 1 || !of2_poly_fill(&p, r, taps, mix))
    return (int)cudaErrorInvalidValue;
  const size_t smem = of2_pe_smem_floats(r) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(of2_poly_exp_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + OF2_PE_TILE - 1) / OF2_PE_TILE, (H + OF2_PE_TILE - 1) / OF2_PE_TILE, B);
  of2_poly_exp_kernel<<<grid, OF2_PE_THREADS, smem, (cudaStream_t)stream>>>(img, out, H, W, p);
  return (int)cudaGetLastError();
}
