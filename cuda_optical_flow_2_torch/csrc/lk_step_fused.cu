// One LK level iteration: clip the flow to +-max_disp, warp next by it,
// solve the residual against prev and add it to the clipped flow, one
// column strip per block walked down a segment of rows, centered one tile
// per block (of2_lk_tile.cuh).
// On a row band (spatial TP) the warp and the image masks act on global
// rows.
#include "of2_lk_tile.cuh"

// prev, nxt: (B, H, W) float32; flow_in, flow_out: (B, H, W, 2) float32,
// distinct buffers.  The H rows are global rows [row0, row0 + H) of an
// Hg-row image (the whole image: row0 = 0, Hg = H).  taps: 2r+1 host
// floats; masks: 27 host floats.
// centered != 0: the mean-normalized (DIS) sums.  rs, tw, seg: rows per
// step, strip columns and segment rows, or centered a seg x tw tile with rs
// = seg (kernels/tile_geometry.lk_launch).
extern "C" int of2_lk_level_step(const float* prev, const float* nxt, const float* flow_in,
                                 float* flow_out, int B, int H, int W, int row0, int Hg, int r,
                                 int rs, int tw, int seg, const float* taps, const float* masks,
                                 float det_eps, float max_disp, int centered, void* stream) {
  return of2_lk_launch<true>(prev, nxt, flow_in, flow_out, B, H, W, row0, Hg, r, rs, tw, seg,
                             taps, masks, det_eps, max_disp, centered, stream);
}
