"""Gradients through the port's plain path against ``jax.grad`` (CPU).

The JAX package differentiates its XLA path (``use_pallas=False``;
tests/test_differentiability.py).  The port's plain path is plain torch, so
``torch.autograd`` runs through it.  Where the two can differ is a tie:
``jnp.clip``, ``jnp.maximum`` and ``jnp.minimum`` send half the gradient to
an argument that equals the bound, ``Tensor.clamp`` and ``Tensor.median``
send all of it to one.  The port clips with ``ops.clip.clip``
(``torch.maximum`` / ``torch.minimum``) and takes the median by JAX's
min/max network, and the cases below put inputs on those ties: integer
flows that land on the image border, tied median windows, and TV-L1's first
warp from zero flow (every 5x5 window of the zero flow is a 25-way tie).

The CUDA kernels carry no gradient, as the Pallas kernels carry none: a
wrapper given a non-CPU tensor that requires grad raises (``meta`` tensors
stand in for CUDA ones here; the card checks it in chip_smoke.py).

Tolerances: gradients are held relative to max |g| at 2e-5; the float32
pipelines show at most 3.2e-6 (TV-L1; LK 2.1e-6, FB 2.6e-6) against 1.9e-2
for TV-L1 through ``Tensor.median``.  The warp and the median alone are the
same float32 operations on both sides: 1e-6 absolute (errors of 0.5 and
more before the repairs).  Forward values of the repaired sites are
``torch.equal`` to the old expressions.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cuda_optical_flow_2_tpu as jof
from cuda_optical_flow_2_tpu.models import dis as jdis
from cuda_optical_flow_2_tpu.models import farneback as jfb
from cuda_optical_flow_2_tpu.models import horn_schunck as jhs
from cuda_optical_flow_2_tpu.models import pyramidal_flow as jpyramidal_flow
from cuda_optical_flow_2_tpu.models import tvl1 as jtvl1
from cuda_optical_flow_2_tpu.ops import median as jmedian
from cuda_optical_flow_2_tpu.ops import warp as jwarp

import cuda_optical_flow_2_torch as tof
from cuda_optical_flow_2_torch import interop
from cuda_optical_flow_2_torch.kernels import (
    _build, bilateral_tap, fb_step_fused, hs_sweep, lk_fused, lk_step_fused, median_select,
    poly_exp_fused, pyr_down, tvl1_sweep, warp_select, win_solve,
)
from cuda_optical_flow_2_torch.ops.clip import clip
from cuda_optical_flow_2_torch.ops.gradients import gradient_magnitude
from cuda_optical_flow_2_torch.ops.median import median_filter
from cuda_optical_flow_2_torch.ops.warp import warp_bilinear, warp_bilinear_band
from cuda_optical_flow_2_torch.utils.io import synthetic_sequence

GRAD_RTOL = 2e-5  # of max |g|, whole pipelines
OP_ATOL = 1e-6    # warp and median alone

# The JAX test's four configs (tests/test_differentiability.py) and DIS.
# jit makes LK, HS, FB and DIS quick; jit of TV-L1's gradient compiles for
# minutes (its 5x5 median network unrolled per warp), so it runs eagerly.
FAMILIES = {
    "lk": (jof.LKConfig(levels=2, window=9, iterations=2, use_pallas=False),
           interop.lk_config_from_jax, True),
    "hs": (jhs.HSConfig(levels=2, iterations=10, use_pallas=False),
           interop.hs_config_from_jax, True),
    "fb": (jfb.FBConfig(levels=2, iterations=2, use_pallas=False),
           interop.fb_config_from_jax, True),
    "tvl1_median5": (jtvl1.TVL1Config(levels=2, warps=1, iterations=5, median_filtering=5,
                                      use_pallas=False),
                     interop.tvl1_config_from_jax, False),
    "dis": (jdis.DISConfig(levels=2, use_pallas=False), interop.dis_config_from_jax, True),
}


def _pair():
    fr = synthetic_sequence(2, 48, 64, velocity=(1.0, 0.5), noise=0.0)
    return fr[0].astype(np.float32), fr[1].astype(np.float32)


def _torch_grad(fn, *arrays):
    """Gradients of the scalar fn(*tensors) for each numpy input."""
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    fn(*ts).backward()
    return [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("family", FAMILIES)
def test_family_gradient_matches_jax(family):
    """d mean(u) / d next through each family's pyramid, as jax.grad has it."""
    jcfg, convert, use_jit = FAMILIES[family]
    p, n = _pair()
    jp = jnp.asarray(p)

    def jloss(x):
        return jnp.mean(jpyramidal_flow(jp, x, jcfg)[..., 0])

    grad = jax.grad(jloss)
    want = np.asarray((jax.jit(grad) if use_jit else grad)(jnp.asarray(n)))
    tcfg = convert(jcfg)
    (got,) = _torch_grad(lambda x: tof.pyramidal_flow(torch.from_numpy(p), x, tcfg)[..., 0].mean(), n)
    assert np.isfinite(got).all() and np.abs(got).max() > 0
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= GRAD_RTOL * scale, (np.abs(got - want).max(), scale)


def test_lk_gradient_matches_finite_differences():
    """autograd through the whole pyramidal LK == central differences."""
    p, n = (torch.from_numpy(a) for a in _pair())
    cfg = tof.LKConfig(levels=2, window=9, iterations=1, use_pallas=False)

    def loss(nxt):
        return torch.sum(tof.pyramidal_lk(p, nxt, cfg)[10:-10, 10:-10, 0] ** 2)

    x = n.clone().requires_grad_(True)
    loss(x).backward()
    rng = np.random.default_rng(0)
    eps = 0.05
    with torch.no_grad():
        for _ in range(4):
            y, xx = int(rng.integers(8, 40)), int(rng.integers(8, 56))
            e = torch.zeros_like(n)
            e[y, xx] = eps
            fd = (float(loss(n + e)) - float(loss(n - e))) / (2 * eps)
            np.testing.assert_allclose(float(x.grad[y, xx]), fd, rtol=0.05, atol=5e-4)


def _border_case(h=9, w=12, seed=0):
    """An image, integer flows whose samples land on every border (x + u in
    {0, w - 1}, y + v in {0, h - 1}) or inside, and loss weights."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (h, w)).astype(np.float32)
    ys, xs = np.mgrid[0:h, 0:w]
    tx = rng.choice([0, w - 1, 3], size=(h, w))
    ty = rng.choice([0, h - 1, 4], size=(h, w))
    flow = np.stack([tx - xs, ty - ys], -1).astype(np.float32)
    flow[0, :, 0] = 0.0  # zero flow on the borders too
    flow[:, 0, 1] = 0.0
    wts = rng.normal(size=(h, w)).astype(np.float32)
    return img, flow, wts


@pytest.mark.parametrize("form", ["whole", "band"])
def test_warp_gradients_at_the_border_match_jax(form):
    """Image and flow gradients of the bilinear warp where samples sit on
    the border: the clip's bound is a tie, half its gradient in JAX."""
    img, flow, wts = _border_case()
    if form == "whole":
        def jfn(a, f):
            return jnp.sum(jwarp.warp_bilinear(a, f) * wts)

        def tfn(a, f):
            return torch.sum(warp_bilinear(a, f) * torch.from_numpy(wts))
    else:
        # output rows [2, 7) of the 9-row image; the band holds every row a
        # sample reaches (the band warp's contract)
        flow, wts = flow[2:7], wts[2:7]

        def jfn(a, f):
            return jnp.sum(jwarp.warp_bilinear_band(a, f, 0, 2, 9) * wts)

        def tfn(a, f):
            return torch.sum(warp_bilinear_band(a, f, 0, 2, 9) * torch.from_numpy(wts))

    want = jax.grad(jfn, argnums=(0, 1))(jnp.asarray(img), jnp.asarray(flow))
    got = _torch_grad(tfn, img, flow)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w_), rtol=0, atol=OP_ATOL)


@pytest.mark.parametrize("size", [3, 5])
@pytest.mark.parametrize("case", ["all_tied", "partly_tied"])
def test_median_gradient_matches_jax(size, case):
    """The plain median's gradient is the min/max network's: a tie splits
    it between the tied inputs as JAX's network does."""
    rng = np.random.default_rng(size)
    if case == "all_tied":
        x = np.full((2, 7, 8), 3.0, np.float32)
    else:
        x = rng.integers(0, 3, (2, 7, 8)).astype(np.float32)
    wts = rng.normal(size=x.shape).astype(np.float32)
    want = jax.grad(lambda a: jnp.sum(jmedian.median_filter(a, size) * wts))(jnp.asarray(x))
    (got,) = _torch_grad(lambda a: torch.sum(median_filter(a, size) * torch.from_numpy(wts)), x)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=OP_ATOL)


def test_gradient_magnitude_is_sqrt_with_a_finite_derivative():
    """TV-L1's dual step divides by 1 + tt |grad u|: the values are sqrt's
    bit for bit, the derivative JAX's where ``jnp.sqrt``'s is finite, and 0
    where gx = gy = 0 (sqrt's is infinite there: NaN under jax.grad)."""
    ax = np.array([0.0, -0.0, 1.5, 0.0, 3e-20, np.inf, np.nan, 0.0, 3.0], np.float32)
    ay = np.array([0.0, 0.0, 0.0, -2.0, 0.0, 1.0, 0.0, -0.0, 4.0], np.float32)
    gx, gy = torch.tensor(ax, requires_grad=True), torch.tensor(ay, requires_grad=True)
    mag = gradient_magnitude(gx, gy)
    assert _equal(mag.detach(), torch.sqrt(gx * gx + gy * gy).detach())
    mag.sum().backward()
    jgx, jgy = jax.grad(lambda a, b: jnp.sum(jnp.sqrt(a * a + b * b)), argnums=(0, 1))(
        jnp.asarray(ax), jnp.asarray(ay))
    zero = (mag == 0).numpy()
    for got, want in ((gx.grad.numpy(), np.asarray(jgx)), (gy.grad.numpy(), np.asarray(jgy))):
        assert zero.sum() == 3 and (got[zero] == 0).all() and not np.isfinite(want[zero]).any()
        ok = np.isfinite(want)
        np.testing.assert_allclose(got[ok], want[ok], rtol=1e-6)


def test_tvl1_gradient_is_finite_where_the_flow_is_locally_constant():
    """At 96x128 with two warps the median leaves flat flow patches, where
    |grad u| = 0: through sqrt the gradient was NaN at 3103 pixels (the JAX
    package's is NaN too: 32165 of 32400 pixels at 135x240 with one warp)."""
    fr = synthetic_sequence(2, 96, 128, velocity=(2.0, 1.0), period=48)
    p, n = fr[0].astype(np.float32), fr[1].astype(np.float32)
    cfg = tof.TVL1Config(levels=2, warps=2, iterations=10, use_pallas=False)
    (g,) = _torch_grad(lambda x: tof.pyramidal_flow(torch.from_numpy(p), x, cfg)[..., 0].mean(), n)
    assert np.isfinite(g).all() and np.abs(g).max() > 0


def _old_warp(img, flow):
    """ops.warp.warp_bilinear before the repair (clamp at the bounds)."""
    h, w = img.shape[-2:]
    ys = torch.arange(h, dtype=torch.float32)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.float32)[None, :].expand(h, w)
    fx, fy = xs + flow[..., 0], ys + flow[..., 1]
    valid = (fx >= 0) & (fx <= w - 1) & (fy >= 0) & (fy <= h - 1)
    zero = torch.zeros_like(fx)
    fx_c = torch.where(valid, fx, zero).clamp(0.0, w - 1)
    fy_c = torch.where(valid, fy, zero).clamp(0.0, h - 1)
    x0, y0 = torch.floor(fx_c), torch.floor(fy_c)
    tx, ty = fx_c - x0, fy_c - y0
    x0i, y0i = x0.long(), y0.long()
    x1i, y1i = (x0i + 1).clamp(max=w - 1), (y0i + 1).clamp(max=h - 1)
    v = [img[yi, xi] for yi in (y0i, y1i) for xi in (x0i, x1i)]
    top = v[0] + tx * (v[1] - v[0])
    bot = v[2] + tx * (v[3] - v[2])
    return torch.where(valid, top + ty * (bot - top), img)


def _equal(a, b):
    nan = a.isnan()
    return torch.equal(nan, b.isnan()) and torch.equal(a[~nan], b[~nan])


# The bounds of each repaired site: (lo, hi) of clip, as clamp had them.
SITES = {
    "warp_x": (0.0, 11.0), "warp_y_band": (0.0, 8.0), "max_displacement": (-4.0, 4.0),
    "hs_charbonnier_floor": (1e-12, None), "tvl1_epsilon": (1e-6, None),
    "window_count": (1.0, None), "fill_projection": (0.0, 30.0), "fill_weight": (1e-9, None),
    "tracking_border": (0.0, 11.0),
}


@pytest.mark.parametrize("site", SITES)
def test_repaired_site_forward_is_unchanged(site):
    """clip(x, lo, hi) is torch.equal to the clamp it replaced, on values at
    and around the bounds, signed zeros, infinities and NaN."""
    lo, hi = SITES[site]
    rng = np.random.default_rng(1)
    vals = [0.0, -0.0, 1.0, -1.0, 1e-13, 1e-7, 30.0, 31.0, -5.0, 12.0,
            np.inf, -np.inf, np.nan, *rng.normal(0, 10, 64)]
    vals += [b for b in (lo, hi) if b is not None]
    x = torch.tensor(np.asarray(vals, np.float32))
    old = x.clamp(lo, hi) if hi is not None else torch.clamp_min(x, lo)
    assert _equal(clip(x, lo, hi), old)


def test_warp_and_median_forward_are_unchanged():
    """The repaired warp and the median network give the old values: the
    warp against a copy of the clamp form, the median against
    ``Tensor.median`` of the same stack, NaN and +-inf windows included."""
    img, flow, _ = _border_case()
    rng = np.random.default_rng(2)
    flow = flow + rng.normal(0, 2, flow.shape).astype(np.float32)
    flow[3, 4] = np.nan
    img_t, flow_t = torch.from_numpy(img), torch.from_numpy(flow)
    assert _equal(warp_bilinear(img_t, flow_t), _old_warp(img_t, flow_t))
    x = torch.from_numpy(rng.normal(size=(2, 9, 9)).astype(np.float32))
    x[0, 2, 2], x[1, 5, 5], x[1, 7, 1], x[0, 0, 8] = np.nan, np.inf, -np.inf, -0.0
    for size in (3, 5):
        r = size // 2
        xp = torch.nn.functional.pad(x[None], (r, r, r, r), mode="replicate")[0]
        stack = torch.stack([xp[:, dy:dy + 9, dx:dx + 9] for dy in range(size)
                             for dx in range(size)])
        assert _equal(median_filter(x, size), stack.median(dim=0).values)


def test_require_cuda_refuses_tensors_that_require_grad():
    """The check every wrapper runs before a launch: a kernel's output is
    written through a raw pointer, so under autograd it would come back
    detached; it raises and names the plain path instead."""
    t = torch.zeros(4, 4, requires_grad=True)
    with pytest.raises(RuntimeError, match="use_pallas=False"):
        _build.require_cuda(torch.zeros(4, 4), t)
    with torch.no_grad():  # no graph is recorded: only the device is wrong
        with pytest.raises(ValueError, match="CUDA or CPU"):
            _build.require_cuda(t)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        _build.require_cuda(t.detach())


def _meta(*shape):
    return torch.zeros(shape, device="meta", requires_grad=True)


LK = tof.LKConfig(levels=2, window=9)
FB = tof.FBConfig(levels=2, winsize=9)
WRAPPERS = {
    "lk_residual": lambda: lk_fused.lk_residual(_meta(16, 16), _meta(16, 16), LK),
    "lk_level_step": lambda: lk_step_fused.lk_level_step(
        _meta(16, 16), _meta(16, 16), _meta(16, 16, 2), LK),
    "lk_band_step": lambda: lk_step_fused.lk_band_step(
        _meta(16, 16), _meta(16, 16), _meta(16, 16, 2), 0, LK, 16),
    "warp_bilinear_select": lambda: warp_select.warp_bilinear_select(
        _meta(16, 16), _meta(16, 16, 2)),
    "warp_bilinear_select_band": lambda: warp_select.warp_bilinear_select_band(
        _meta(16, 16), _meta(16, 16, 2), 0, 16),
    "pyr_down": lambda: pyr_down.pyr_down(_meta(16, 16)),
    "bilateral_kernel": lambda: bilateral_tap.bilateral_kernel(_meta(16, 16)),
    "bilateral_kernel_band": lambda: bilateral_tap.bilateral_kernel_band(_meta(16, 16), 0, 16),
    "hs_relax": lambda: hs_sweep.hs_relax(
        _meta(16, 16), _meta(16, 16), None, iterations=2, alpha=1.0, temporal_kernel="diff2"),
    "hs_relax_band": lambda: hs_sweep.hs_relax_band(
        _meta(16, 16), _meta(16, 16), None, 0, 16, sweeps=2, alpha=1.0,
        temporal_kernel="diff2"),
    "poly_expansion_kernel": lambda: poly_exp_fused.poly_expansion_kernel(_meta(16, 16)),
    "window_solve": lambda: win_solve.window_solve(*(_meta(16, 16) for _ in range(5)), window=5),
    "fb_level_step": lambda: fb_step_fused.fb_level_step(
        _meta(16, 16), tuple(_meta(16, 16) for _ in range(5)), None, FB, True),
    "fb_band_step": lambda: fb_step_fused.fb_band_step(
        _meta(16, 16), tuple(_meta(16, 16) for _ in range(5)), None, 0, FB, 16, True),
    "tvl1_relax": lambda: tvl1_sweep.tvl1_relax(
        _meta(16, 16), _meta(16, 16), _meta(16, 16, 2), _meta(16, 16, 2), iterations=2,
        lambda_=0.15, theta=0.3, tau=0.25, eps=1e-6),
    "tvl1_relax_band": lambda: tvl1_sweep.tvl1_relax_band(
        _meta(16, 16), _meta(16, 16), _meta(16, 16, 2), tuple(_meta(16, 16) for _ in range(6)),
        0, 16, iterations=2, lambda_=0.15, theta=0.3, tau=0.25, eps=1e-6),
    "median_filter_kernel": lambda: median_select.median_filter_kernel(_meta(2, 16, 16)),
}


@pytest.mark.parametrize("name", WRAPPERS)
def test_kernel_wrapper_refuses_grad_off_the_cpu(name):
    """Every kernel wrapper, given a non-CPU tensor that requires grad,
    raises before it builds or launches anything (no fallback to the plain
    version, no detached result)."""
    with pytest.raises(RuntimeError, match="carry no gradient"):
        WRAPPERS[name]()
