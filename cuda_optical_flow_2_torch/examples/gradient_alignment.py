"""Differentiable alignment: fit a global affine motion by gradient descent.

The op library's plain path is plain torch, so model-based alignment is
autograd + ``torch.optim.Adam`` over the photometric error of the
differentiable backward warp (ops/warp.py), with no solver code.  The dense
pyramidal flow seeds the optimizer (its median translation starts the
affine fit inside the warp's basin of convergence), the gradient steps then
refine to sub-pixel.  Everything differentiated runs the plain path
(``use_pallas=False``): the CUDA kernels carry no gradient.

Run: python -m cuda_optical_flow_2_torch.examples.gradient_alignment [--device cpu]
"""
import numpy as np
import torch

import cuda_optical_flow_2_torch as of
from cuda_optical_flow_2_torch.cli import device_from_flag
from cuda_optical_flow_2_torch.examples import run
from cuda_optical_flow_2_torch.ops.warp import warp_bilinear
from cuda_optical_flow_2_torch.utils import io

A_SCALE = 100.0  # an optimizer step on an A-coef moves u by ~x/A_SCALE px,
# comparable to a step on the translation: without it adam's uniform
# per-param step size lets the linear terms overshoot by +-(lr * width) px.
STEPS = 400
LR = 5e-2


def affine_flow(params: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(6,) scaled affine params -> dense (H, W, 2) flow:
    [u, v] = (A / A_SCALE) @ [x, y] + t."""
    a11, a12, a21, a22, tx, ty = params
    ys, xs = torch.meshgrid(
        torch.arange(h, device=params.device), torch.arange(w, device=params.device),
        indexing="ij",
    )
    u = (a11 * xs + a12 * ys) / A_SCALE + tx
    v = (a21 * xs + a22 * ys) / A_SCALE + ty
    return torch.stack([u, v], dim=-1).to(torch.float32)


def shifted_pair(h: int, w: int, true_shift):
    """(prev, nxt) numpy frames: nxt bilinearly samples the same texture at
    x + shift, so the truth is sub-pixel exact."""
    base = io.synthetic_sequence(1, h + 16, w + 16, velocity=(0, 0))[0]
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    prev = base[8 : 8 + h, 8 : 8 + w].astype(np.float32)
    sx, sy = xs + true_shift[0] + 8, ys + true_shift[1] + 8
    x0, y0 = np.floor(sx).astype(int), np.floor(sy).astype(int)
    fx, fy = sx - x0, sy - y0
    nxt = (
        base[y0, x0] * (1 - fx) * (1 - fy)
        + base[y0, x0 + 1] * fx * (1 - fy)
        + base[y0 + 1, x0] * (1 - fx) * fy
        + base[y0 + 1, x0 + 1] * fx * fy
    ).astype(np.float32)
    return prev, nxt


def photometric_loss(params, prev, nxt):
    """Mean squared error of nxt warped by the affine flow against prev,
    the border the warp clamps at cropped."""
    h, w = prev.shape[-2:]
    warped = warp_bilinear(nxt, affine_flow(params, h, w))
    return torch.mean((warped[8:-8, 8:-8] - prev[8:-8, 8:-8]) ** 2)


def main(device="cuda", out_dir="/tmp"):
    dev = device_from_flag(str(device))
    # Content sampled at x + shift appears to MOVE by -shift: the flow (and
    # the affine fit) should recover (-3.6, +2.2).
    true_shift = (3.6, -2.2)
    true_flow = (-true_shift[0], -true_shift[1])
    h, w = 160, 192
    prev, nxt = (torch.from_numpy(a).to(dev) for a in shifted_pair(h, w, true_shift))

    # Seed: median of the dense pyramidal flow (coarse but in-basin).
    dense = of.pyramidal_lk(prev, nxt, of.LKConfig(levels=3, window=11, use_pallas=False))
    seed = dense[16:-16, 16:-16].reshape(-1, 2).quantile(0.5, dim=0)
    params = torch.tensor([0.0, 0.0, 0.0, 0.0, float(seed[0]), float(seed[1])],
                          device=dev, requires_grad=True)
    print(f"dense-flow seed: ({float(seed[0]):+.3f}, {float(seed[1]):+.3f})"
          f"  truth: ({true_flow[0]:+.3f}, {true_flow[1]:+.3f})")

    # optax.adam's defaults
    opt = torch.optim.Adam([params], lr=LR, betas=(0.9, 0.999), eps=1e-8)
    for _ in range(STEPS):
        opt.zero_grad()
        val = photometric_loss(params, prev, nxt)
        val.backward()
        opt.step()
    tx, ty = params.detach()[4:].tolist()
    mse = float(val.detach())
    print(f"after {STEPS} adam steps: ({tx:+.3f}, {ty:+.3f})  mse {mse:.4f}")
    err = float(np.hypot(tx - true_flow[0], ty - true_flow[1]))
    print(f"translation error: {err:.3f} px")
    assert err < 0.1, err
    return {"seed": seed.tolist(), "translation": (tx, ty), "error": err, "mse": mse}


if __name__ == "__main__":
    run(main, __doc__)
