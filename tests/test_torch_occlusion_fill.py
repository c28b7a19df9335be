"""The occlusion fill's kernel module against the parent's plain fill and JAX (CPU).

``kernels/occlusion_fill`` runs the fill of ``models.consistency
.fill_occluded_flow`` as CUDA launches (the weights on 64 x 64 tiles with a
ring of ``WEIGHTS_RING`` cells, then k <= K sweeps per launch on tiles with a
ring of ``ring(k)`` cells, skipping tiles with no occluded pixel); the card
holds the kernel to the plain version (``chip_smoke.py``).  Here, on the CPU:

- the rings, pinned on the plain version: the weights and k sweeps computed
  on a crop that carries the ring reproduce the whole image's on the crop's
  interior bit for bit, and with one cell less they do not;
- the skip: a crop with no occluded pixel keeps its state through 96 sweeps,
  and kept pixels never change;
- the plain version, moved into the kernel module, is bitwise the parent's
  ``fill_occluded_flow`` body (NaN and -0.0 under the mask included);
- on CPU tensors the kernel path is the plain fill: within 1e-4 px of JAX's
  ``fill_occluded_flow`` (tests/test_torch_consistency.py's bound), with no
  launch; ``consistent_flow`` hands ``config.use_pallas`` to the fill.
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cuda_optical_flow_2_tpu.models import consistency as jc

import cuda_optical_flow_2_torch as tof
from cuda_optical_flow_2_torch.kernels import _build, occlusion_fill
from cuda_optical_flow_2_torch.models import consistency as tc
from cuda_optical_flow_2_torch.models.horn_schunck import _DXC, _DYC, _avg3x3
from cuda_optical_flow_2_torch.ops.clip import clip
from cuda_optical_flow_2_torch.ops.conv import stencil2d
from cuda_optical_flow_2_torch.utils.io import synthetic_sequence

FILL_TOL = 1e-4  # px, tests/test_torch_consistency.py
H, W = 48, 64
TILE = 64  # csrc/of2_tile.cuh OF2_EXT
Y0, Y1, X0, X1 = 20, 30, 24, 40  # the crop's interior, 8 cells or more from every edge


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _scene(seed: int, density: float = 0.3, h: int = H, w: int = W):
    """A random flow and a mask of random blobs, with a NaN and -0.0 under
    the mask and a NaN at a kept pixel."""
    rng = np.random.default_rng(seed)
    flow = rng.normal(0, 2, (h, w, 2)).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    occ = np.zeros((h, w), bool)
    while occ.mean() < density:
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(1.5, 5)
        occ |= (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
    under = np.argwhere(occ)
    flow[tuple(under[0])] = [np.nan, 1.0]
    flow[tuple(under[1])] = [-0.0, -0.0]
    flow[tuple(under[len(under) // 2])] = [-0.0, 2.0]
    kept = np.argwhere(~occ)
    flow[tuple(kept[len(kept) // 3])] = [0.5, np.nan]
    return torch.from_numpy(flow), torch.from_numpy(occ)


def _bits(x: torch.Tensor) -> torch.Tensor:
    """The float32 bits: equal bits are equal values, NaN and -0.0 included."""
    return x.contiguous().view(torch.int32)


def _parent_fill(flow, occ, iterations=96, beta=1.0):
    """The parent's ``models.consistency.fill_occluded_flow`` body, as it was."""
    u = flow.to(torch.float32)
    occf = occ.to(torch.float32)
    m = occf
    for _ in range(4):
        m = 0.5 * _avg3x3(m) + 0.5 * occf
    gx = -stencil2d(m, _DXC)
    gy = -stencil2d(m, _DYC)
    norm = torch.sqrt(gx * gx + gy * gy) + 1e-6
    proj = (u[..., 0] * gx + u[..., 1] * gy) / norm
    src_w = torch.exp(-beta * clip(proj, 0.0, 30.0))
    trusted = (1.0 - occf) * src_w
    keep = (1.0 - occf) > 0
    grow = ~keep
    state = torch.stack([u[..., 0] * trusted, u[..., 1] * trusted, trusted])
    for _ in range(iterations):
        avg = _avg3x3(state)
        den = avg[2]
        filled = den > 1e-9
        reached = torch.cat([avg[:2] / clip(den, 1e-9), clip(state[2:], 1.0)])
        state = torch.where(grow & filled, reached, state)
    return torch.where(keep[..., None], u, state[:2].movedim(0, -1))


def _window(r: int) -> tuple[int, int, int, int]:
    return Y0 - r, Y1 + r, X0 - r, X1 + r


def _crop(x: torch.Tensor, win) -> torch.Tensor:
    y0, y1, x0, x1 = win
    return x[..., y0:y1, x0:x1]


def _inner(x: torch.Tensor, win) -> torch.Tensor:
    y0, _, x0, _ = win
    return x[..., Y0 - y0 : Y1 - y0, X0 - x0 : X1 - x0]


def _sweeps(k: int, r: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(whole image, crop) interiors of k sweeps from the whole image's
    weights: the sweep launch's tile with a ring of r cells."""
    flow, occ = _scene(1)
    _, keep, state = occlusion_fill.fill_weights_plain(flow, occ)
    # start a few sweeps in, so that weight has reached the occluded cells
    state = occlusion_fill.fill_sweeps_plain(state, ~keep, 3)
    whole = occlusion_fill.fill_sweeps_plain(state, ~keep, k)
    win = _window(r)
    part = occlusion_fill.fill_sweeps_plain(_crop(state, win), _crop(~keep, win), k)
    return _bits(whole[:, Y0:Y1, X0:X1]), _bits(_inner(part, win))


def _weights(r: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(whole image, crop) interiors of the weights pass's state: the weights
    launch's tile with a ring of r cells."""
    flow, occ = _scene(2)
    whole = occlusion_fill.fill_weights_plain(flow, occ)[2]
    win = _window(r)
    part = occlusion_fill.fill_weights_plain(_crop(flow.movedim(-1, 0), win).movedim(0, -1),
                                             _crop(occ, win))[2]
    return _bits(whole[:, Y0:Y1, X0:X1]), _bits(_inner(part, win))


@pytest.mark.parametrize("k", [1, 5, 8])
def test_sweep_ring_keeps_interior_exact(k):
    r = occlusion_fill.ring(k)
    assert 2 * r < TILE
    whole, part = _sweeps(k, r)
    assert torch.equal(whole, part)


@pytest.mark.parametrize("k", [1, 5, 8])
def test_sweep_ring_one_cell_less_is_stale(k):
    whole, part = _sweeps(k, occlusion_fill.ring(k) - 1)
    assert not torch.equal(whole, part)


def test_weights_ring_keeps_interior_exact():
    whole, part = _weights(occlusion_fill.WEIGHTS_RING)
    assert torch.equal(whole, part)


def test_weights_ring_one_cell_less_is_stale():
    whole, part = _weights(occlusion_fill.WEIGHTS_RING - 1)
    assert not torch.equal(whole, part)


def test_rings_match_the_source():
    """The module's constants are the CUDA source's."""
    src = (_build.SOURCES_DIR / "occlusion_fill.cu").read_text()
    assert int(re.search(r"#define OF2_FILL_WRING (\d+)", src).group(1)) == \
        occlusion_fill.WEIGHTS_RING
    assert "const int R = sweeps, T = of2_tile_out(R);" in src
    assert 2 * occlusion_fill.ring(occlusion_fill.SWEEPS_PER_LAUNCH) < TILE


def test_skip_is_exact():
    """A crop with no occluded pixel keeps its state through 96 sweeps, and
    the kept pixels of the whole image never change: a tile with no occluded
    pixel in its output area may return without writing."""
    flow, occ = _scene(3, density=0.15)
    _, keep, state = occlusion_fill.fill_weights_plain(flow, occ)
    clear = None
    for y in range(0, H - 12):
        for x in range(0, W - 12):
            if not occ[y : y + 12, x : x + 12].any():
                clear = (y, y + 12, x, x + 12)
                break
        if clear:
            break
    assert clear is not None
    part = _crop(state, clear)
    assert torch.equal(_bits(occlusion_fill.fill_sweeps_plain(part, _crop(~keep, clear), 96)),
                       _bits(part))
    after = occlusion_fill.fill_sweeps_plain(state, ~keep, 96)
    assert torch.equal(_bits(after[:, keep]), _bits(state[:, keep]))
    assert not torch.equal(_bits(after[:, ~keep]), _bits(state[:, ~keep]))  # it filled


@pytest.mark.parametrize("beta", [0.0, 1.0])
@pytest.mark.parametrize("iterations", [0, 1, 7, 8, 9, 96])
def test_plain_is_the_parents_fill(iterations, beta):
    flow, occ = _scene(4)
    want = _parent_fill(flow, occ, iterations, beta)
    got = occlusion_fill.fill_occluded_flow_plain(flow, occ, iterations, beta)
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(tc.fill_occluded_flow(flow, occ, iterations, beta)), _bits(want))
    assert torch.equal(_bits(tc.fill_occluded_flow(flow, occ, iterations, beta,
                                                   use_pallas=False)), _bits(want))
    assert torch.equal(_bits(got[~occ]), _bits(flow[~occ]))
    assert flow[occ].isnan().any() and (_bits(flow[occ]) == _bits(torch.tensor(-0.0))).any()


@pytest.mark.parametrize("beta", [0.0, 1.0])
def test_kernel_path_on_cpu_matches_jax_without_launch(beta):
    flow, occ = _scene(5, density=0.2, h=40, w=56)
    flow = torch.nan_to_num(flow)  # JAX's fill against the port's: finite values
    want = np.asarray(jax.jit(jc.fill_occluded_flow, static_argnums=(2, 3))(
        jnp.asarray(flow.numpy()), jnp.asarray(occ.numpy()), 96, beta))
    before = occlusion_fill.fill_occluded_flow_kernel.launches
    got = tc.fill_occluded_flow(flow, occ, beta=beta, use_pallas=True)
    assert occlusion_fill.fill_occluded_flow_kernel.launches == before
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FILL_TOL)
    assert torch.equal(got[~occ], flow[~occ])


def test_consistent_flow_fill_on_cpu_matches_jax_without_launch():
    """consistent_flow(fill=True) is JAX's fill of its own flow and mask."""
    frames = synthetic_sequence(2, 64, 96, velocity=(2.0, 1.0))
    p, n = (torch.from_numpy(f).float() for f in frames)
    cfg = tof.LKConfig(levels=2, window=9)
    flow, occ = tc.consistent_flow(p, n, cfg)
    before = occlusion_fill.fill_occluded_flow_kernel.launches
    filled, occ_f = tc.consistent_flow(p, n, cfg, fill=True)
    assert occlusion_fill.fill_occluded_flow_kernel.launches == before
    assert torch.equal(occ_f, occ) and bool(occ.any())
    want = np.asarray(jax.jit(jc.fill_occluded_flow)(jnp.asarray(flow.numpy()),
                                                     jnp.asarray(occ.numpy())))
    np.testing.assert_allclose(filled.numpy(), want, rtol=0, atol=FILL_TOL)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_consistent_flow_hands_use_pallas_to_the_fill(monkeypatch, use_pallas):
    calls = []
    real = tc.fill_occluded_flow

    def spy(flow, occ, *args, **kwargs):
        calls.append(kwargs)
        return real(flow, occ, *args, **kwargs)

    monkeypatch.setattr(tc, "fill_occluded_flow", spy)
    frames = synthetic_sequence(2, 32, 48, velocity=(1.0, 0.5))
    p, n = (torch.from_numpy(f).float() for f in frames)
    tc.consistent_flow(p, n, tof.LKConfig(levels=2, window=9, use_pallas=use_pallas), fill=True)
    assert calls == [{"use_pallas": use_pallas}]


def test_off_cpu_tensors_launch_or_raise():
    """No fallback: a tensor that is not on the CPU goes to the kernel, which
    takes CUDA tensors only (meta tensors stand in for another device), and
    raises under autograd before it launches."""
    flow = torch.empty((24, 40, 2), device="meta")
    occ = torch.empty((24, 40), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tc.fill_occluded_flow(flow, occ)
    with pytest.raises(RuntimeError, match="no gradient"):
        occlusion_fill.fill_occluded_flow_kernel(flow.requires_grad_(), occ)
