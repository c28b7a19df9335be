// The time-tiled tile shared by the relaxation kernels (tvl1_sweep.cu,
// hs_sweep.cu): one block owns a tile of OF2_EXT x OF2_EXT cells in shared
// memory, an output tile of T x T pixels plus a ring of R cells on all four
// sides (T = OF2_EXT - 2R), and runs k iterations on it before writing the
// output tile back.  An iteration reads the neighbours at +-1 row and column,
// so a ring cell's value goes stale one cell per iteration from the tile's
// edge inward and R = k keeps the output tile exact; cells outside the band
// or the image hold their boundary values on every iteration, tested by
// their band coordinates, so a pixel's arithmetic does not depend on which
// tile computes it.
//
// Thread (c, g) of the OF2_THREADS owns column c and the OF2_ROWS cells
// g * OF2_ROWS + j, j < OF2_ROWS, of the tile for the whole launch: their
// per-pixel constants stay in its registers, and a warp reads 32 adjacent
// floats of a plane at once (conflict-free).
//
// The state is staged with cp.async: 4-byte copies from the state planes
// in device memory straight into shared memory, zero-filled (source size 0)
// for cells outside the band.
#pragma once

#include "of2_common.cuh"

#define OF2_EXT 64
#define OF2_ROWS 4
#define OF2_THREADS (OF2_EXT * OF2_EXT / OF2_ROWS)
#define OF2_PLANE (OF2_EXT * OF2_EXT)

// The output tile's side for a ring of `ring` cells (2 * ring < OF2_EXT).
__host__ __device__ __forceinline__ int of2_tile_out(int ring) { return OF2_EXT - 2 * ring; }

// Part j of n items split into ceil(n / k) launches as evenly as possible.
__host__ __forceinline__ int of2_launches(int n, int k) { return (n + k - 1) / k; }
__host__ __forceinline__ int of2_part(int n, int k, int j) {
  const int parts = of2_launches(n, k);
  return n / parts + (j < n % parts ? 1 : 0);
}
