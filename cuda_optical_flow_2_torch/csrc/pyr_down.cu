// Gaussian pyramid step: 3x3 binomial blur with zero padding and a 2x
// subsample centred on source (2i, 2j), one thread per output pixel.
#include <cuda_runtime.h>
#include <stddef.h>

// The plain version's order: per column tap, the three row taps summed
// left to right, then the three column sums left to right.  The taps are
// powers of two, so every product is exact and a contracted FMA rounds as
// the separate multiply and add do: the result equals the plain version's.
// Only rows < 2*OH and columns < 2*OW are image (the crop of an odd size);
// the rest reads as zero.
__global__ void of2_pyr_down_kernel(const float* __restrict__ x, float* __restrict__ out, int OH,
                                    int OW, long long sb, long long sh, long long sw) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= OH || j >= OW) return;
  const float k[3] = {0.25f, 0.5f, 0.25f};  // constants.BINOMIAL_1D
  const float* X = x + blockIdx.z * sb;
  float acc = 0.f;
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const int c = 2 * j + q - 1;
    float col = 0.f;
    if (c >= 0 && c < 2 * OW) {
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        const int r = 2 * i + p - 1;
        const float v = (r >= 0 && r < 2 * OH) ? X[r * sh + c * sw] : 0.f;
        col = p == 0 ? k[p] * v : col + k[p] * v;
      }
    }
    acc = q == 0 ? k[q] * col : acc + k[q] * col;
  }
  out[((size_t)blockIdx.z * OH + i) * OW + j] = acc;
}

// x: B planes of (2*OH [+1], 2*OW [+1]) float32 at element strides
// (sb, sh, sw), so strided views (one flow component) need no copy;
// out: (B, OH, OW) float32, contiguous.
extern "C" int of2_pyr_down(const float* x, float* out, int B, int OH, int OW, long long sb,
                            long long sh, long long sw, void* stream) {
  if (B < 1 || OH < 1 || OW < 1) return (int)cudaErrorInvalidValue;
  const dim3 block(32, 8);
  const dim3 grid((OW + 31) / 32, (OH + 7) / 8, B);
  of2_pyr_down_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(x, out, OH, OW, sb, sh, sw);
  return (int)cudaGetLastError();
}
