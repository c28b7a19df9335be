"""Flow with quality signals: Farnebäck flow + occlusion + confidence masks.

Run: python -m cuda_optical_flow_2_torch.examples.flow_quality [--device cpu]
"""
from pathlib import Path

import numpy as np
import torch

import cuda_optical_flow_2_torch as of
from cuda_optical_flow_2_torch.cli import device_from_flag
from cuda_optical_flow_2_torch.examples import run
from cuda_optical_flow_2_torch.models import (
    FBConfig,
    confidence_mask,
    consistent_flow,
)
from cuda_optical_flow_2_torch.utils import io, viz


def main(device="cuda", out_dir="/tmp"):
    dev = device_from_flag(str(device))
    frames = io.synthetic_sequence(2, 240, 320, velocity=(2.0, 1.0))
    prev, nxt = (torch.from_numpy(f.astype(np.float32)).to(dev) for f in frames)

    cfg = FBConfig(levels=3, iterations=2)
    flow, occluded = consistent_flow(prev, nxt, cfg)
    trusted = confidence_mask(prev, of.LKConfig(window=15), threshold=1.0)

    flow_np = flow.cpu().numpy()
    occ = occluded.cpu().numpy()
    conf = trusted.cpu().numpy()
    good = conf & ~occ
    median = np.median(flow_np[30:-30, 30:-30], axis=(0, 1))
    print("median flow:", median)
    print(f"trusted pixels: {good.mean():.1%} "
          f"(occluded {occ.mean():.1%}, low-texture {(~conf).mean():.1%})")

    out = Path(out_dir)
    viz.write_png(str(out / "flow_quality.png"), viz.flow_to_color(flow_np))
    viz.write_png(str(out / "flow_quality_mask.png"), (good * 255).astype(np.uint8))
    print(f"wrote {out / 'flow_quality.png'} and _mask.png")
    return {"median_flow": median, "trusted": float(good.mean()),
            "occluded": float(occ.mean()), "low_texture": float((~conf).mean())}


if __name__ == "__main__":
    run(main, __doc__)
