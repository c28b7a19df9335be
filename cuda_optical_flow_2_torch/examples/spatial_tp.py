"""Tensor-parallel example: ONE frame's rows sharded across the mesh with
halo exchange (for frames too large for a single card).

Run: python -m cuda_optical_flow_2_torch.examples.spatial_tp [--device cpu] [--shards n]
(``--shards n``, default 3: a mesh that lists the device n times, real
shards with real halos on one card or on the CPU).

The Farnebäck part takes the kernels on the card (``use_pallas`` by
device, as ``sharded_batch`` does), so it runs the band step and the
expansion kernels; the JAX twin pins ``use_pallas=False``.  The LK part
keeps its ``use_pallas=False``.
"""
import numpy as np
import torch

import cuda_optical_flow_2_torch as of
from cuda_optical_flow_2_torch import parallel
from cuda_optical_flow_2_torch.cli import device_from_flag
from cuda_optical_flow_2_torch.examples import run
from cuda_optical_flow_2_torch.models import FBConfig
from cuda_optical_flow_2_torch.utils import io


def main(device="cuda", out_dir="/tmp", shards=3):
    dev = device_from_flag(str(device))
    n = 3 if shards is None else shards
    h = 128 * n  # rows divisible by n_shards * 2^(levels-1)
    frames = io.synthetic_sequence(2, h, 256, velocity=(2.0, 1.0))
    prev, nxt = (torch.from_numpy(f.astype(np.float32)).to(dev) for f in frames)
    mesh = parallel.make_mesh(axis_name="space", devices=[dev] * n)
    config = of.LKConfig(levels=3, window=11, temporal_kernel="gauss3",
                         max_displacement=8, use_pallas=False)
    flow = parallel.spatial_pyramidal_lk(prev, nxt, config, mesh)
    print(f"one {h}x256 frame over {n} row shards ->", tuple(flow.shape))
    median = flow[64:-64, 32:-32].reshape(-1, 2).quantile(0.5, dim=0).tolist()
    print("median flow:", median)

    # The other model families shard the same way (model-generic TP):
    fb_flow = parallel.spatial_pyramidal_fb(
        prev, nxt,
        FBConfig(levels=2, iterations=2, winsize=11, use_pallas=dev.type == "cuda",
                 max_displacement=8),
        mesh,
    )
    fb_median = fb_flow[64:-64, 32:-32].reshape(-1, 2).quantile(0.5, dim=0).tolist()
    print("farneback median:", fb_median)
    return {"shape": tuple(flow.shape), "median_flow": median, "fb_median_flow": fb_median}


if __name__ == "__main__":
    run(main, __doc__, shards="row shards (default 3)")
