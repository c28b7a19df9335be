// The coarse-to-fine flow handoff: one pyramid octave of
// ops/resize.upsample_flow, (B, h, w, 2) -> (B, H, W, 2) with H in {2h, 2h + 1}
// and W in {2w, 2w + 1}, bit for bit.
//
// It replaces no Pallas kernel: the JAX package leaves ops/resize.upsample_flow
// to XLA, which fuses it.  Eager PyTorch runs the plain version as about 19
// launches per handoff (two narrow-and-cat pairs, four scalar products, two
// sums and a stack per axis, the doubling, the cat of an odd side), each
// writing a whole tensor of the coarse or the fine size.
//
// What bounds it on an H100: bytes.  An output pixel writes its (u, v), 8
// bytes, and reads a quarter of a coarse pixel, 2 bytes: about 10 bytes
// moved against 17 flops, far below the card's 20 flops per byte.  The
// design: one thread per 2x2 block of output pixels, which all interpolate
// between the same 3x3 coarse neighbourhood (edges clamped).  The thread
// reads it as nine float2 loads, neighbouring threads on neighbouring coarse
// pixels, so the overlap between threads is served by L1 and each coarse
// byte comes from device memory about once.  It interpolates the rows first,
// then the columns, then doubles, each product and sum rounded on its own
// (of2_lerp_quarter: __fmul_rn / __fadd_rn, no FMA), the plain version's
// order.  Each of its two output rows is one 16-byte store of (u, v, u, v),
// neighbouring threads on neighbouring 16 bytes, so a warp writes 512
// contiguous bytes per row.  An odd W puts every other row off a 16-byte
// boundary, so that path stores float2 pairs.  An odd last row or column
// repeats the one before it, written by the thread that owns that one.  No
// shared memory: the work is in the stores.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "of2_common.cuh"

template <bool VEC>
__device__ __forceinline__ void of2_store_up2x_row(float* row, int x, float4 o, bool extra) {
  if (VEC) {
    *reinterpret_cast<float4*>(row + 4 * x) = o;
  } else {
    reinterpret_cast<float2*>(row)[2 * x] = make_float2(o.x, o.y);
    reinterpret_cast<float2*>(row)[2 * x + 1] = make_float2(o.z, o.w);
  }
  if (extra) reinterpret_cast<float2*>(row)[2 * x + 2] = make_float2(o.z, o.w);
}

// Thread (bx, by) of plane b writes output rows 2 by, 2 by + 1 and columns
// 2 bx, 2 bx + 1 (and row 2h or column 2w where the target is odd).
template <bool VEC>
__global__ void of2_upsample_flow_kernel(const float2* __restrict__ c, float* __restrict__ out,
                                         int h, int w, int H, int W) {
  const int bx = blockIdx.x * blockDim.x + threadIdx.x;
  const int by = blockIdx.y * blockDim.y + threadIdx.y;
  if (by >= h || bx >= w) return;
  const float2* C = c + (size_t)blockIdx.z * h * w;
  const int ys[3] = {max(by - 1, 0), by, min(by + 1, h - 1)};
  const int xs[3] = {max(bx - 1, 0), bx, min(bx + 1, w - 1)};
  float2 v[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) v[i][j] = C[(size_t)ys[i] * w + xs[j]];
  }
  const bool extra = W == 2 * w + 1 && bx == w - 1;
#pragma unroll
  for (int ry = 0; ry < 2; ++ry) {
    // rows: the centre row against the one above (even output row) or below
    float2 r[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      r[j] = make_float2(of2_lerp_quarter(v[1][j].x, v[2 * ry][j].x),
                         of2_lerp_quarter(v[1][j].y, v[2 * ry][j].y));
    }
    // columns: the centre column against the one left (even) or right (odd)
    const float4 o = make_float4(__fmul_rn(of2_lerp_quarter(r[1].x, r[0].x), 2.f),
                                 __fmul_rn(of2_lerp_quarter(r[1].y, r[0].y), 2.f),
                                 __fmul_rn(of2_lerp_quarter(r[1].x, r[2].x), 2.f),
                                 __fmul_rn(of2_lerp_quarter(r[1].y, r[2].y), 2.f));
    const int y = 2 * by + ry;
    float* plane = out + (size_t)blockIdx.z * H * W * 2;
    of2_store_up2x_row<VEC>(plane + (size_t)y * W * 2, bx, o, extra);
    if (ry == 1 && y + 1 == H - 1)
      of2_store_up2x_row<VEC>(plane + (size_t)(y + 1) * W * 2, bx, o, extra);
  }
}

// c: (B, h, w, 2) float32, contiguous, 8-byte aligned; out: (B, H, W, 2)
// float32, contiguous.  H must be 2h or 2h + 1 and W 2w or 2w + 1.
extern "C" int of2_upsample_flow(const float* c, float* out, int B, int h, int w, int H, int W,
                                 void* stream) {
  if (B < 1 || B > 65535 || h < 1 || w < 1 || (H != 2 * h && H != 2 * h + 1) ||
      (W != 2 * w && W != 2 * w + 1) || (uintptr_t)c % 8 != 0 || (uintptr_t)out % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 block(32, 8);
  const dim3 grid((w + 31) / 32, (h + 7) / 8, B);
  const float2* c2 = reinterpret_cast<const float2*>(c);
  if (W % 2 == 0 && (uintptr_t)out % 16 == 0)
    of2_upsample_flow_kernel<true><<<grid, block, 0, (cudaStream_t)stream>>>(c2, out, h, w, H, W);
  else
    of2_upsample_flow_kernel<false><<<grid, block, 0, (cudaStream_t)stream>>>(c2, out, h, w, H, W);
  return (int)cudaGetLastError();
}
