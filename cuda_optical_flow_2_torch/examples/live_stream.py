"""Unbounded live-style streaming with decode-failure recovery.

The twin of the reference's while(true) webcam loop (main.cu:222-275): an
unbounded native FrameStream (nframes=None) feeds process_sequence until
stopped; memory stays bounded by the prefetch ring and the carried state
(one pyramid + one flow), and a glitched frame would be skipped with the
warm state re-seeded.

Run: python -m cuda_optical_flow_2_torch.examples.live_stream [--device cpu]
(Ctrl-C to stop early)
"""

import time

import torch

import cuda_optical_flow_2_torch as of
from cuda_optical_flow_2_torch.cli import device_from_flag
from cuda_optical_flow_2_torch.examples import run
from cuda_optical_flow_2_torch.models import streaming
from cuda_optical_flow_2_torch.utils.native import FrameStream

FRAMES = 120  # stop after this many (the stream itself is unbounded)


def main(device="cuda", out_dir="/tmp"):
    dev = device_from_flag(str(device))
    config = of.LKConfig(levels=1, window=15)  # warm serving configuration
    t0 = time.perf_counter()
    n = 0
    medians = {}
    with FrameStream.synthetic(None, 480, 640, vx=2.0, vy=1.0) as src:
        flows = streaming.process_sequence(
            (f for _, f in src), config, warm_start=True, device=dev
        )
        for i, flow in flows:
            n += 1
            if n % 30 == 0:
                m = flow[40:-40, 40:-40].reshape(-1, 2).quantile(0.5, dim=0).tolist()
                medians[i] = m
                fps = n / (time.perf_counter() - t0)
                print(f"frame {i}: median flow ({m[0]:.2f}, {m[1]:.2f})  "
                      f"{fps:.1f} fps end-to-end")
            if n >= FRAMES:
                break
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        fps = n / (time.perf_counter() - t0)
        print(f"stream stats: decoded={src.decoded} failed={src.failed}")
    return {"frames": n, "fps": fps, "median_flow": medians,
            "decoded": src.decoded, "failed": src.failed}


if __name__ == "__main__":
    run(main, __doc__)
