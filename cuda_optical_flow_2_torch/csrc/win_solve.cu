// Box-window sums of five planes and the guarded 2x2 solve: five (B, H, W)
// planes -> (B, H, W, 2) flow.  One block per tile stages the five planes
// with an rw-pixel halo in shared memory (zero outside the image), then the
// column and row passes and the solve of of2_win_tile.cuh.
#include "of2_win_tile.cuh"

__global__ void __launch_bounds__(OF2_WT_THREADS)
of2_window_solve_kernel(const float* __restrict__ p11, const float* __restrict__ p12,
                        const float* __restrict__ p22, const float* __restrict__ h1,
                        const float* __restrict__ h2, float* __restrict__ flow, int H, int W,
                        int rw, float det_eps) {
  extern __shared__ float smem[];
  const int pw = OF2_WT_TILE + 2 * rw, pplane = pw * pw;
  float* P = smem;
  float* V = P + 5 * pplane;
  const size_t plane = (size_t)H * W, off = blockIdx.z * plane;
  const float* src[5] = {p11 + off, p12 + off, p22 + off, h1 + off, h2 + off};
  const int oy = blockIdx.y * OF2_WT_TILE, ox = blockIdx.x * OF2_WT_TILE;

  for (int i = threadIdx.x; i < pplane; i += blockDim.x) {
    const int y = oy - rw + i / pw, x = ox - rw + i % pw;
    const bool in = y >= 0 && y < H && x >= 0 && x < W;
    const size_t k = in ? (size_t)y * W + x : 0;
#pragma unroll
    for (int c = 0; c < 5; ++c) P[c * pplane + i] = in ? src[c][k] : 0.f;
  }
  __syncthreads();
  of2_window_solve_tile(P, V, rw, oy, ox, H, W, det_eps, flow + 2 * off);
}

// p11, p12, p22, h1, h2: (B, H, W) float32; flow: (B, H, W, 2) float32.
extern "C" int of2_window_solve(const float* p11, const float* p12, const float* p22,
                                const float* h1, const float* h2, float* flow, int B, int H,
                                int W, int rw, float det_eps, void* stream) {
  if (rw < 0 || rw > OF2_WT_MAX_R || B < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (of2_wt_p_floats(rw) + of2_wt_v_floats(rw)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(of2_window_solve_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + OF2_WT_TILE - 1) / OF2_WT_TILE, (H + OF2_WT_TILE - 1) / OF2_WT_TILE, B);
  of2_window_solve_kernel<<<grid, OF2_WT_THREADS, smem, (cudaStream_t)stream>>>(
      p11, p12, p22, h1, h2, flow, H, W, rw, det_eps);
  return (int)cudaGetLastError();
}
