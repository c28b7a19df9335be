"""Minimal example: dense flow for one frame pair, written as a color PNG.

Run: python -m cuda_optical_flow_2_torch.examples.basic [--device cpu]
"""
from pathlib import Path

import numpy as np
import torch

import cuda_optical_flow_2_torch as of
from cuda_optical_flow_2_torch.cli import device_from_flag
from cuda_optical_flow_2_torch.examples import run
from cuda_optical_flow_2_torch.utils import io, viz


def main(device="cuda", out_dir="/tmp"):
    dev = device_from_flag(str(device))
    frames = io.synthetic_sequence(2, 480, 640, velocity=(3.0, 1.0))
    prev, nxt = (torch.from_numpy(f.astype(np.float32)).to(dev) for f in frames)

    config = of.LKConfig(levels=4, window=15, temporal_kernel="gauss3")
    flow = of.pyramidal_lk_jit(prev, nxt, config).cpu().numpy()

    median = np.median(flow[40:-40, 40:-40], axis=(0, 1))
    print("median flow:", median)
    out = Path(out_dir)
    viz.write_png(str(out / "flow_basic.png"), viz.flow_to_color(flow))
    io.write_flo(str(out / "flow_basic.flo"), flow)
    print(f"wrote {out / 'flow_basic.png'} and .flo")
    return {"median_flow": median}


if __name__ == "__main__":
    run(main, __doc__)
