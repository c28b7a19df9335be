// k x k median of (B, H, W) float32 planes with edge-replicated borders
// (OpenCV's BORDER_REPLICATE), k = 3 or 5: TV-L1's flow cleaning.
//
// Replaces cuda_optical_flow_2_tpu/ops/median.py _median_network (no
// pallas_call: a min/max elimination that XLA fuses, O(k^4) exchanges).
// Bound by bytes on an H100: 4 bytes in and 4 out per pixel.  A block owns a
// 16 x 64 output tile; it stages the tile and its r = k / 2 halo in shared
// memory, each source row and column clamped to the image (that clamp is
// the edge replication).  A thread owns OF2_MED_RUN outputs down one column:
// it loads the (OF2_MED_RUN + k - 1) x k values they span into registers
// once, so the outputs share the k (k - 1) values they have in common, and
// runs a compare-exchange selection network on each output's k^2 values.
// The networks are Paeth's / Devillard's opt_med9 (19 exchanges) and
// opt_med25 (99 exchanges); only the median's side of each exchange is
// live at the end, so the compiler keeps 30 and 174 of the min/max
// operations.  A selection returns one of its inputs, so the result is
// bit-equal to torch.median (and to the JAX network) for any finite or
// infinite input.  NaN: every exchange takes min.NaN / max.NaN (NaN if
// either input is NaN, as torch.median, jnp.minimum and jnp.maximum do;
// fminf/fmaxf would drop it), and every input reaches the median through
// some chain of exchanges, so a window holding a NaN yields NaN.
//
// Input and output take element strides (batch, row, column), so TV-L1's
// flow.movedim(-1, 0) view goes in without a copy and the output can keep
// the (H, W, 2) layout of the flow.
#include <cuda_runtime.h>
#include <stddef.h>

#define OF2_MED_TW 64    // output tile columns: a lane per column
#define OF2_MED_RUN 4    // outputs per thread, down one column
#define OF2_MED_TY 4     // threads per column
#define OF2_MED_TH (OF2_MED_RUN * OF2_MED_TY)  // output tile rows
#define OF2_MED_THREADS (OF2_MED_TW * OF2_MED_TY)

__device__ __forceinline__ float of2_min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float of2_max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// The selection networks: X(a, b) leaves the smaller of v[a], v[b] in v[a]
// and the larger in v[b]; after the last exchange v[k*k / 2] is the median.
// tests/test_torch_median_select.py reads these two tables from this file
// and runs them in numpy.
// BEGIN OF2_MED9_NET
#define OF2_MED9_NET(X)                                                                    \
  X(1, 2) X(4, 5) X(7, 8) X(0, 1) X(3, 4) X(6, 7) X(1, 2) X(4, 5) X(7, 8) X(0, 3) X(5, 8) \
  X(4, 7) X(3, 6) X(1, 4) X(2, 5) X(4, 7) X(4, 2) X(6, 4) X(4, 2)
// END OF2_MED9_NET
// BEGIN OF2_MED25_NET
#define OF2_MED25_NET(X)                                                                   \
  X(0, 1) X(3, 4) X(2, 4) X(2, 3) X(6, 7) X(5, 7) X(5, 6) X(9, 10) X(8, 10) X(8, 9)        \
  X(12, 13) X(11, 13) X(11, 12) X(15, 16) X(14, 16) X(14, 15) X(18, 19) X(17, 19)          \
  X(17, 18) X(21, 22) X(20, 22) X(20, 21) X(23, 24) X(2, 5) X(3, 6) X(0, 6) X(0, 3)        \
  X(4, 7) X(1, 7) X(1, 4) X(11, 14) X(8, 14) X(8, 11) X(12, 15) X(9, 15) X(9, 12)          \
  X(13, 16) X(10, 16) X(10, 13) X(20, 23) X(17, 23) X(17, 20) X(21, 24) X(18, 24)          \
  X(18, 21) X(19, 22) X(8, 17) X(9, 18) X(0, 18) X(0, 9) X(10, 19) X(1, 19) X(1, 10)       \
  X(11, 20) X(2, 20) X(2, 11) X(12, 21) X(3, 21) X(3, 12) X(13, 22) X(4, 22) X(4, 13)      \
  X(14, 23) X(5, 23) X(5, 14) X(15, 24) X(6, 24) X(6, 15) X(7, 16) X(7, 19) X(13, 21)      \
  X(15, 23) X(7, 13) X(7, 15) X(1, 9) X(3, 11) X(5, 17) X(11, 17) X(9, 17) X(4, 10)        \
  X(6, 12) X(7, 14) X(4, 6) X(4, 7) X(12, 14) X(10, 14) X(6, 7) X(10, 12) X(6, 10)         \
  X(6, 17) X(12, 17) X(7, 17) X(7, 10) X(12, 18) X(7, 12) X(10, 18) X(12, 20) X(10, 20)    \
  X(10, 12)
// END OF2_MED25_NET

#define OF2_MED_CX(a, b)                         \
  {                                              \
    const float lo_ = of2_min_nan(v[a], v[b]);   \
    v[b] = of2_max_nan(v[a], v[b]);              \
    v[a] = lo_;                                  \
  }

template <int K>
__device__ __forceinline__ float of2_median_of(float (&v)[K * K]) {
  if constexpr (K == 3) {
    OF2_MED9_NET(OF2_MED_CX)
  } else {
    static_assert(K == 5, "networks for k = 3 and 5");
    OF2_MED25_NET(OF2_MED_CX)
  }
  return v[K * K / 2];
}

template <int K>
__global__ void __launch_bounds__(OF2_MED_THREADS)
of2_median_kernel(const float* __restrict__ x, float* __restrict__ out, int H, int W,
                  long long sb, long long sh, long long sw, long long ob, long long oh,
                  long long ow) {
  constexpr int R = K / 2;
  constexpr int SH = OF2_MED_TH + 2 * R, SW = OF2_MED_TW + 2 * R;
  __shared__ float S[SH][SW];
  const float* X = x + blockIdx.z * sb;
  const int oy = blockIdx.y * OF2_MED_TH, ox = blockIdx.x * OF2_MED_TW;
  const int tid = threadIdx.y * OF2_MED_TW + threadIdx.x;
#pragma unroll
  for (int i = tid; i < SH * SW; i += OF2_MED_THREADS) {
    const int y = min(max(oy - R + i / SW, 0), H - 1);
    const int c = min(max(ox - R + i % SW, 0), W - 1);
    S[i / SW][i % SW] = X[y * sh + c * sw];
  }
  __syncthreads();

  const int tx = threadIdx.x, ty0 = threadIdx.y * OF2_MED_RUN;
  const int gx = ox + tx;
  if (gx >= W) return;
  float w[OF2_MED_RUN + K - 1][K];
#pragma unroll
  for (int j = 0; j < OF2_MED_RUN + K - 1; ++j)
#pragma unroll
    for (int d = 0; d < K; ++d) w[j][d] = S[ty0 + j][tx + d];
  float* O = out + blockIdx.z * ob + gx * ow;
#pragma unroll
  for (int k = 0; k < OF2_MED_RUN; ++k) {
    const int gy = oy + ty0 + k;
    if (gy >= H) break;
    float v[K * K];
#pragma unroll
    for (int j = 0; j < K; ++j)
#pragma unroll
      for (int d = 0; d < K; ++d) v[j * K + d] = w[k + j][d];
    O[gy * oh] = of2_median_of<K>(v);
  }
}

// x: B planes of (H, W) float32 at element strides (sb, sh, sw); out: the
// same shape at strides (ob, oh, ow); k: 3 or 5 (kernels/median_select.SIZES).
extern "C" int of2_median(const float* x, float* out, int B, int H, int W, int k, long long sb,
                          long long sh, long long sw, long long ob, long long oh, long long ow,
                          void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || (k != 3 && k != 5))
    return (int)cudaErrorInvalidValue;
  const dim3 block(OF2_MED_TW, OF2_MED_TY);
  const dim3 grid((W + OF2_MED_TW - 1) / OF2_MED_TW, (H + OF2_MED_TH - 1) / OF2_MED_TH, B);
  if (k == 3)
    of2_median_kernel<3><<<grid, block, 0, (cudaStream_t)stream>>>(x, out, H, W, sb, sh, sw, ob,
                                                                   oh, ow);
  else
    of2_median_kernel<5><<<grid, block, 0, (cudaStream_t)stream>>>(x, out, H, W, sb, sh, sw, ob,
                                                                   oh, ow);
  return (int)cudaGetLastError();
}
