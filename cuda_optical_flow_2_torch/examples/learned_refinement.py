"""Learned flow refinement: train a CNN on top of the differentiable pipeline.

The modern production pattern is classic-coarse + learned-residual: a cheap
dense flow (here pyramidal LK) plus a small network that corrects its
systematic errors.  The learned component is a ``torch.nn`` module over a
feature stack of [prev, warped next, coarse flow], trained with
``torch.optim.Adam``, one train step per batch.

Training data is synthesized with EXACT ground truth, no dataset needed:
draw a random texture ``nxt`` and a random smooth flow ``d``; under the
framework's convention prev(x) = nxt(x + d), so ``prev = warp(nxt, d)``
gives a pair whose true flow IS ``d``.

``refine_net_state_from_flax`` carries the JAX twin's flax parameters into
the module, so both compute the same network.

Run: python -m cuda_optical_flow_2_torch.examples.learned_refinement [--device cpu]
"""
import math

import numpy as np
import torch
from torch import nn

import cuda_optical_flow_2_torch as of
from cuda_optical_flow_2_torch.cli import device_from_flag
from cuda_optical_flow_2_torch.examples import run
from cuda_optical_flow_2_torch.ops.warp import warp_bilinear

H, W = 64, 80
CFG = of.LKConfig(levels=2, window=9, iterations=1, use_pallas=False)
STEPS = 250
LR = 2e-3


def make_pair(rng: np.random.Generator):
    """(prev, nxt, true_flow): random texture warped by a random smooth flow."""
    tex = rng.normal(0, 1, (H + 8, W + 8))
    k = np.ones(5) / 5.0  # cheap smoothing: trackable blobs, not white noise
    for ax in (0, 1):
        tex = np.apply_along_axis(np.convolve, ax, tex, k, mode="same")
    nxt = 127.0 + 300.0 * tex[4:-4, 4:-4]
    # smooth flow: global translation + low-frequency sinusoidal deformation
    tx, ty = rng.uniform(-2.5, 2.5, 2)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    u = tx + 0.7 * np.sin(2 * np.pi * ys / H) * np.cos(2 * np.pi * xs / W)
    v = ty + 0.7 * np.cos(2 * np.pi * ys / H) * np.sin(2 * np.pi * xs / W)
    flow = np.stack([u, v], -1).astype(np.float32)
    prev = warp_bilinear(torch.from_numpy(nxt.astype(np.float32)), torch.from_numpy(flow))
    return prev.numpy(), nxt.astype(np.float32), flow


class RefineNet(nn.Module):
    """3-conv residual head; zero-init output so training starts AT the
    classic flow (delta = 0) and can only improve from there.  The hidden
    convs start as flax's ``nn.Conv`` does: LeCun-normal kernels (a normal
    truncated at two standard deviations, variance 1 / fan_in), zero
    biases."""

    def __init__(self, feats: int = 16, generator: torch.Generator | None = None):
        super().__init__()
        self.convs = nn.ModuleList([
            nn.Conv2d(4, feats, 3, padding=1),
            nn.Conv2d(feats, feats, 3, padding=1),
            nn.Conv2d(feats, 2, 3, padding=1),
        ])
        with torch.no_grad():
            for conv in self.convs[:-1]:
                fan_in = conv.weight[0].numel()
                # truncated standard normal's standard deviation at +-2: 0.8796
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(conv.weight, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
                conv.bias.zero_()
            self.convs[-1].weight.zero_()
            self.convs[-1].bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 4, H, W) features -> (B, 2, H, W) flow correction."""
        for conv in self.convs[:-1]:
            x = torch.relu(conv(x))
        return self.convs[-1](x)


def refine_net_state_from_flax(params) -> dict:
    """The ``RefineNet`` state_dict of a flax ``RefineNet`` param tree (with
    or without its ``"params"`` level) of numpy arrays: kernels HWIO ->
    OIHW, biases as they are.  Flax convolves NHWC features, this module
    NCHW ones; both correlate without flipping the kernel."""
    params = params.get("params", params)
    state = {}
    for i in range(3):
        layer = params[f"Conv_{i}"]
        kernel = np.asarray(layer["kernel"], np.float32)
        state[f"convs.{i}.weight"] = torch.from_numpy(np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)))
        state[f"convs.{i}.bias"] = torch.from_numpy(np.asarray(layer["bias"], np.float32).copy())
    return state


def features(prev, nxt, coarse):
    """(..., 4, H, W) input stack: the two (normalized) frames aligned by
    the coarse flow, plus the coarse flow itself (channels u, v)."""
    aligned = warp_bilinear(nxt, coarse)
    return torch.stack(
        [prev / 255.0, aligned / 255.0, coarse[..., 0], coarse[..., 1]], dim=-3
    )


def epe(flow, truth):
    d = flow - truth
    return torch.sqrt(torch.sum(d * d, -1) + 1e-12).mean()


def refine(net, feats, coarse):
    """coarse + the network's correction, in the flow layout (..., H, W, 2)."""
    return coarse + net(feats).movedim(-3, -1)


def main(device="cuda", out_dir="/tmp"):
    dev = device_from_flag(str(device))
    rng = np.random.default_rng(3)
    # Data is free (synthesized with exact truth), so generalization comes
    # from set size, not regularization tricks: 32 pairs is plenty for a
    # 3-conv head (8 overfits).
    train = [make_pair(rng) for _ in range(32)]
    test = [make_pair(rng) for _ in range(4)]

    def batch(pairs):
        prev, nxt, truth = (torch.from_numpy(np.stack(a)).to(dev) for a in zip(*pairs))
        coarse = of.pyramidal_lk(prev, nxt, CFG)
        return features(prev, nxt, coarse), coarse, truth

    tr_feats, tr_coarse, tr_truth = batch(train)
    te_feats, te_coarse, te_truth = batch(test)

    net = RefineNet(generator=torch.Generator().manual_seed(0)).to(dev)
    # optax.adam's defaults
    opt = torch.optim.Adam(net.parameters(), lr=LR, betas=(0.9, 0.999), eps=1e-8)

    base_te = float(epe(te_coarse, te_truth))
    for step in range(STEPS):
        opt.zero_grad()
        loss = epe(refine(net, tr_feats, tr_coarse), tr_truth)
        loss.backward()
        opt.step()
        if step % 100 == 0:
            print(f"step {step:4d}  train EPE {float(loss.detach()):.4f}")

    with torch.no_grad():
        refined_te = float(epe(refine(net, te_feats, te_coarse), te_truth))
    print(f"held-out EPE: coarse {base_te:.4f} -> refined {refined_te:.4f} "
          f"({100 * (1 - refined_te / base_te):.0f}% better)")
    assert refined_te < 0.85 * base_te, (base_te, refined_te)
    return {"coarse_epe": base_te, "refined_epe": refined_te, "train_epe": float(loss.detach())}


if __name__ == "__main__":
    run(main, __doc__)
