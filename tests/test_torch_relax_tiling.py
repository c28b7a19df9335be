"""The ring of the time-tiled relaxation kernels, pinned on the plain versions.

The CUDA kernels of ``kernels/tvl1_sweep`` and ``kernels/hs_sweep`` run k
iterations (sweeps) per launch on a tile with a ring of ``ring(k)`` cells
and write back only the cells inside the ring.  Here, in plain PyTorch on
the CPU: the plain relaxation run on a 2-D crop that carries that ring
reproduces the whole image's result on the crop's interior bit for bit,
and with one cell less it does not.  The constants (TV-L1's Sobel terms,
HS's gradients and Charbonnier weights) come whole from launches of their
own, so the crops take them from the whole image.
"""

import numpy as np
import pytest
import torch

from cuda_optical_flow_2_torch.kernels import hs_sweep, tvl1_sweep
from cuda_optical_flow_2_torch.models import horn_schunck as hs

H, W = 48, 64
TILE = 64  # csrc/of2_tile.cuh OF2_EXT
Y0, Y1, X0, X1 = 20, 30, 24, 40  # the crop's interior, R <= 8 cells from every edge
TV = dict(lambda_=0.15, theta=0.3, tau=0.25)


def _frames(seed: int):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    prev = 128 + 60 * np.sin(xx / 3.1) * np.cos(yy / 4.3) + rng.normal(0, 2, (H, W))
    nxt = 128 + 60 * np.sin((xx - 1.5) / 3.1) * np.cos((yy - 0.7) / 4.3) + rng.normal(0, 2, (H, W))
    return (torch.as_tensor(a.astype(np.float32)) for a in (prev, nxt))


def _planes(seed: int, n: int, scale: float):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.normal(0, scale, (H, W)).astype(np.float32)) for _ in range(n)]


def _window(r: int, interior: bool) -> tuple[int, int, int, int]:
    """The crop [y0, y1) x [x0, x1) around the interior (a crop flush with
    the image's top-left corner when ``interior`` is false: no ring there)."""
    if interior:
        return Y0 - r, Y1 + r, X0 - r, X1 + r
    return 0, Y1 + r, 0, X1 + r


def _crop(x: torch.Tensor, win) -> torch.Tensor:
    y0, y1, x0, x1 = win
    return x[y0:y1, x0:x1]


def _inner(x: torch.Tensor, win) -> torch.Tensor:
    """The interior's cells of a result computed on crop ``win``."""
    y0, _, x0, _ = win
    return x[Y0 - y0 : Y1 - y0, X0 - x0 : X1 - x0]


def _tvl1(k: int, r: int, interior: bool) -> tuple:
    """(whole image, crop) interiors of k primal-dual steps from warm duals,
    the constants from the whole image."""
    prev, warped = _frames(1)
    u, v, p1x, p1y, p2x, p2y = _planes(2, 6, 0.3)
    u0 = torch.stack(_planes(3, 2, 0.5), dim=-1)
    kw = dict(lambda_=TV["lambda_"], theta=TV["theta"], eps=1e-6)
    whole_c = tvl1_sweep.band_constants(prev, warped, u0, 0, H, **kw)
    state = (u, v, p1x, p1y, p2x, p2y)
    step = dict(iterations=k, lambda_=TV["lambda_"], theta=TV["theta"], tau=TV["tau"])
    whole = tvl1_sweep.primal_dual_band(whole_c, state, 0, H, **step)
    win = _window(r, interior)
    consts = tuple(_crop(c, win) for c in whole_c)
    part = tvl1_sweep.primal_dual_band(consts, tuple(_crop(x, win) for x in state), win[0], H,
                                       **step)
    return (torch.stack([x[Y0:Y1, X0:X1] for x in whole]),
            torch.stack([_inner(x, win) for x in part]))


def _hs(k: int, r: int, interior: bool, robust: bool) -> tuple:
    """(whole image, crop) interiors of k HS sweeps from a random flow: the
    gradients (and the Charbonnier chunk's weights) from the whole image."""
    prev, nxt = _frames(4)
    ix, iy, it = hs_sweep._gradients(prev, nxt, "gauss3", None)
    uv = torch.stack(_planes(5, 2, 0.5), dim=-1)
    win = _window(r, interior)
    crop = [_crop(x, win) for x in (uv, ix, iy, it)]
    if robust:
        weights = hs._robust_weights(uv, ix, iy, it, 10.0, (3.0, 0.1))
        whole = hs._robust_sweeps(uv, ix, iy, it, weights, k)
        part = hs._robust_sweeps(*crop, tuple(_crop(w, win) for w in weights), k)
    else:
        whole = hs._quadratic_relax(uv, ix, iy, it, k, 10.0)
        part = hs._quadratic_relax(*crop, k, 10.0)
    return whole[Y0:Y1, X0:X1], _inner(part, win)


def _run(kind: str, k: int, r: int, interior: bool) -> tuple:
    if kind == "tvl1":
        return _tvl1(k, r, interior)
    return _hs(k, r, interior, robust=kind == "hs charbonnier")


_RING = {"tvl1": tvl1_sweep.ring, "hs quadratic": hs_sweep.ring, "hs charbonnier": hs_sweep.ring}


@pytest.mark.parametrize("interior", [True, False], ids=["interior", "corner"])
@pytest.mark.parametrize("k", [4, 8])
@pytest.mark.parametrize("kind", ["tvl1", "hs quadratic", "hs charbonnier"])
def test_ring_keeps_interior_exact(kind, k, interior):
    r = _RING[kind](k)
    assert 2 * r < TILE
    whole, part = _run(kind, k, r, interior)
    assert torch.equal(whole, part)


@pytest.mark.parametrize("k", [4, 8])
@pytest.mark.parametrize("kind", ["tvl1", "hs quadratic", "hs charbonnier"])
def test_ring_one_cell_less_is_stale(kind, k):
    whole, part = _run(kind, k, _RING[kind](k) - 1, True)
    assert float((whole - part).abs().max()) > 0.0


@pytest.mark.parametrize("iterations", [1, 7, 8, 13, 14, 30, 100])
def test_launch_split(iterations):
    parts = tvl1_sweep.launch_iterations(iterations)
    k = tvl1_sweep.ITERS_PER_LAUNCH
    assert sum(parts) == iterations
    assert len(parts) == -(-iterations // k)
    assert max(parts) - min(parts) <= 1 and max(parts) <= k
    assert 2 * tvl1_sweep.ring(k) < TILE and 2 * hs_sweep.ring(hs_sweep.SWEEPS_PER_LAUNCH) < TILE
