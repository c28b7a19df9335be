// LK residual flow between prev and (already warped) next: Sobel Ix, Iy,
// temporal It, five weighted window sums and the guarded 2x2 solve, one
// column strip per block walked down a segment of rows, centered one tile
// per block (of2_lk_tile.cuh).
#include "of2_lk_tile.cuh"

// prev, nxt: (B, H, W) float32; flow: (B, H, W, 2) float32 output.
// taps: 2r+1 host floats; masks: 27 host floats (Sobel-x, Sobel-y, temporal).
// centered != 0: the mean-normalized (DIS) sums.  rs, tw, seg: rows per
// step, strip columns and segment rows, or centered a seg x tw tile with rs
// = seg (kernels/tile_geometry.lk_launch).
extern "C" int of2_lk_residual(const float* prev, const float* nxt, float* flow, int B, int H,
                               int W, int r, int rs, int tw, int seg, const float* taps,
                               const float* masks, float det_eps, int centered, void* stream) {
  return of2_lk_launch<false>(prev, nxt, nullptr, flow, B, H, W, 0, H, r, rs, tw, seg, taps,
                              masks, det_eps, 0.f, centered, stream);
}
