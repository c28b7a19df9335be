"""Warm streaming that survives a scene cut (RecoveryConfig).

The recommended serving configuration (shallow pyramid + warm start)
tracks large motion by seeding each pair with the previous pair's flow.  A
content cut breaks the premise: the seed describes the OLD scene's motion
and a single level cannot re-acquire from it; without recovery, one cut
loses lock for the rest of the stream.

``RecoveryConfig`` arms an on-device acquisition check in every warm step
(seed-warped vs zero-flow photometric residual at the coarse level); an
invalid seed is dropped and the pair re-solves over a deeper pyramid.
This example streams two scenes moving in opposite directions with a hard
cut in the middle, printing the per-pair flow error for both policies.

Run: python -m cuda_optical_flow_2_torch.examples.scene_cut_recovery [--device cpu]
"""

import numpy as np
import torch

import cuda_optical_flow_2_torch as of
from cuda_optical_flow_2_torch.cli import device_from_flag
from cuda_optical_flow_2_torch.examples import run
from cuda_optical_flow_2_torch.models import streaming


def banded_texture(rng, h, w):
    base = rng.random((h, w)).astype(np.float32)
    t = np.pad(base, 1, mode="wrap")
    t = sum(t[i:i + h, j:j + w] for i in range(3) for j in range(3)) / 9
    return (t - t.min()) / (np.ptp(t) + 1e-6) * 255


def main(device="cuda", out_dir="/tmp"):
    dev = device_from_flag(str(device))
    rng = np.random.default_rng(0)
    h, w = 96, 128
    scene_a, scene_b = banded_texture(rng, h, w), banded_texture(rng, h, w)
    # scene A: 5 px/frame leftward; CUT; scene B: 5 px/frame rightward
    frames = [np.roll(scene_a, -5 * t, axis=1) for t in range(5)]
    frames += [np.roll(scene_b, 5 * t, axis=1) for t in range(5)]
    frames = [torch.from_numpy(f.astype(np.float32)).to(dev) for f in frames]
    truth_u = {i: -5.0 for i in range(1, 5)} | {i: 5.0 for i in range(6, 10)}

    config = of.LKConfig(levels=1, window=11, iterations=2)  # serving depth
    recovery = streaming.RecoveryConfig(levels=3)

    epes = {}
    for label, rec in (("plain warm", None), ("with recovery", recovery)):
        print(f"{label}:")
        epes[label] = {}
        for i, flow in streaming.process_sequence(
            frames, config, warm_start=True, recovery=rec
        ):
            f = flow[20:-20, 20:-20]
            if i in truth_u:
                epe = float(torch.hypot(f[..., 0] - truth_u[i], f[..., 1]).mean())
                epes[label][i] = epe
                note = "  <- post-cut" if i > 5 else ""
                print(f"  pair {i}: EPE {epe:6.2f}px{note}")
            else:
                print(f"  pair {i}: (cut frame - no correspondence)")
    print("post-cut pairs recover to sub-pixel EPE only with recovery")
    return {"epe": epes}


if __name__ == "__main__":
    run(main, __doc__)
