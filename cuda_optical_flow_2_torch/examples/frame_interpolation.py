"""Flow-based frame interpolation: synthesize the midpoint between two frames.

The classic downstream application of dense flow (slow-motion / frame-rate
upconversion): estimate bidirectional flow, backward-warp each frame halfway
along its flow, and blend; occluded pixels (forward-backward inconsistent)
fall back to the better-exposed side: two pyramidal flow estimates, two
warps, the occlusion test and the blend, eager on the device.

Run: python -m cuda_optical_flow_2_torch.examples.frame_interpolation [--device cpu]
"""
from pathlib import Path

import numpy as np
import torch

import cuda_optical_flow_2_torch as of
from cuda_optical_flow_2_torch.cli import device_from_flag
from cuda_optical_flow_2_torch.examples import run
from cuda_optical_flow_2_torch.models import FBConfig, fb_consistency
from cuda_optical_flow_2_torch.ops.warp import warp_bilinear
from cuda_optical_flow_2_torch.utils import io, viz


def interpolate_midpoint(prev, nxt, config):
    """Synthesize the frame halfway between ``prev`` and ``nxt``.

    Backward-warp semantics (out(x) = src(x + flow)): the midpoint pixel x
    came from prev at x + 0.5*F_bw(x) and from nxt at x + 0.5*F_fw(x) (the
    flows are sampled at x: the standard splat-free approximation, fine at
    half-step for smooth motion).  Cycle-inconsistent pixels take the side
    whose flow is locally trustworthy (the one with the smaller cycle
    residual) instead of a ghosted blend.
    """
    flow_fw = of.pyramidal_flow(prev, nxt, config)  # prev -> nxt
    flow_bw = of.pyramidal_flow(nxt, prev, config)  # nxt -> prev
    from_prev = warp_bilinear(prev, 0.5 * flow_bw)
    from_next = warp_bilinear(nxt, 0.5 * flow_fw)
    # Cycle residual of each field: res_fw gates from_next (built on F_fw),
    # res_bw gates from_prev (built on F_bw).
    res_fw = fb_consistency(flow_fw, flow_bw)
    res_bw = fb_consistency(flow_bw, flow_fw)
    consistent = torch.maximum(res_fw, res_bw) < 1.0
    fallback = torch.where(res_bw <= res_fw, from_prev, from_next)
    mid = torch.where(consistent, 0.5 * (from_prev + from_next), fallback)
    return mid, flow_fw


def main(device="cuda", out_dir="/tmp"):
    dev = device_from_flag(str(device))
    # three frames of known constant motion: frame 1 IS the ground-truth
    # midpoint of frames 0 and 2
    frames = io.synthetic_sequence(3, 240, 320, velocity=(2.0, 1.0))
    f0, f1, f2 = (torch.from_numpy(f.astype(np.float32)).to(dev) for f in frames)

    cfg = FBConfig(levels=3, iterations=2)
    mid, flow = interpolate_midpoint(f0, f2, cfg)

    inner = (slice(30, -30), slice(30, -30))
    err = float((mid[inner] - f1[inner]).abs().mean())
    base = float((f0[inner] - f1[inner]).abs().mean())
    print(f"midpoint synthesis mean error: {err:.2f} gray levels "
          f"(naive frame-hold baseline: {base:.2f})")
    assert err < 0.25 * base, "interpolation should beat hold"

    out = Path(out_dir)
    viz.write_png(str(out / "interp_mid.png"),
                  np.clip(mid.cpu().numpy(), 0, 255).astype(np.uint8))
    viz.write_png(str(out / "interp_flow.png"), viz.flow_to_color(flow.cpu().numpy()))
    print(f"wrote {out / 'interp_mid.png'} and {out / 'interp_flow.png'}")
    return {"error": err, "hold_error": base}


if __name__ == "__main__":
    run(main, __doc__)
