"""Streaming example: carried device state + native prefetching frame source.

Run: python -m cuda_optical_flow_2_torch.examples.streaming_video [--device cpu]
"""
import torch

import cuda_optical_flow_2_torch as of
from cuda_optical_flow_2_torch.cli import device_from_flag
from cuda_optical_flow_2_torch.examples import run
from cuda_optical_flow_2_torch.models import streaming
from cuda_optical_flow_2_torch.utils.native import FrameStream


def main(device="cuda", out_dir="/tmp"):
    dev = device_from_flag(str(device))
    config = of.LKConfig(levels=3, window=11, temporal_kernel="gauss3")
    medians = {}
    with FrameStream.synthetic(10, 240, 320, vx=2.0, vy=1.0) as src:
        for i, flow in streaming.process_sequence((f for _, f in src), config, device=dev):
            medians[i] = float(torch.hypot(flow[..., 0], flow[..., 1]).quantile(0.5))
            print(f"frame {i}: median |flow| = {medians[i]:.3f}")
    return {"median_speed": medians}


if __name__ == "__main__":
    run(main, __doc__)
