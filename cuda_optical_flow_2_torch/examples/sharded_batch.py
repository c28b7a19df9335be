"""Data-parallel example: a frame-pair batch sharded over a mesh of devices.

Run: python -m cuda_optical_flow_2_torch.examples.sharded_batch [--device cpu] [--shards n]
(by default the mesh holds every CUDA device; ``--shards n`` lists the
device n times, e.g. n shards on one card, or n on the CPU).
"""
import numpy as np
import torch

import cuda_optical_flow_2_torch as of
from cuda_optical_flow_2_torch import parallel
from cuda_optical_flow_2_torch.cli import device_from_flag
from cuda_optical_flow_2_torch.examples import run
from cuda_optical_flow_2_torch.utils import io


def main(device="cuda", out_dir="/tmp", shards=None):
    dev = device_from_flag(str(device))
    if shards is None:
        mesh = parallel.make_mesh() if dev.type == "cuda" else parallel.make_mesh(devices=[dev])
    else:
        mesh = parallel.make_mesh(devices=[dev] * shards)
    n = mesh.shape["batch"]
    frames = io.synthetic_sequence(2 * n + 1, 128, 160, velocity=(2.0, 1.0))
    prev = torch.from_numpy(np.stack(frames[:-1]).astype(np.float32))
    nxt = torch.from_numpy(np.stack(frames[1:]).astype(np.float32))

    config = of.LKConfig(levels=3, window=11, temporal_kernel="gauss3",
                         use_pallas=dev.type == "cuda")
    flow = parallel.sharded_pyramidal_lk(prev[: 2 * n], nxt[: 2 * n], config, mesh)
    print(f"{2 * n} pairs over {n} devices ->", tuple(flow.shape), flow.device)
    median = flow[:, 24:-24, 24:-24].reshape(-1, 2).quantile(0.5, dim=0).tolist()
    return {"shape": tuple(flow.shape), "shards": n, "median_flow": median}


if __name__ == "__main__":
    run(main, __doc__, shards="mesh size (default: the CUDA device count; 1 on the CPU)")
