"""The port's band functions of spatial TP against the JAX package (CPU).

``parallel.spatial.halo_exchange``, the plain band ops
(``ops.warp.warp_bilinear_band``, ``ops.bilateral.bilateral_filter_band``)
and the plain versions of the six band kernels (``lk_band_step`` in both
modes, ``warp_bilinear_select_band``, ``bilateral_kernel_band``,
``hs_relax_band`` quadratic and Charbonnier, ``tvl1_relax_band`` with
carried duals, ``fb_band_step`` first and warm), which the wrappers take
for CPU tensors.  Each band is cut as ``parallel/spatial.py`` cuts a shard's:
the kept rows plus a halo, zero-filled beyond the image, so ``row0`` is
negative on the top band; an interior band and both global edges are held.
The CUDA kernels are held to these plain versions on the card by
chip_smoke.py.

Tolerances, on the kept rows: the band warp bit-equal to JAX's (the same
global-row floor and fraction); the bilateral band 1e-4 on intensities
0-255, as tests/test_pallas.py holds the band kernel (exp differs by an ulp
between the two libraries); the band kernels 2e-4 for flow and 1e-4 for
intensities, as tests/test_torch_kernels.py holds the whole-image kernels;
the band forms at ``row0 = 0, h_global = H`` bit-equal to the whole-image
plain versions, whose arithmetic they repeat.  ``tvl1_relax_band``: 1e-4 px
against the Pallas band kernel, which folds ``u0`` into the residual before
the iterations (another rounding order) and rounds ``sqrt`` and division as
XLA does (4.2e-5 px seen here).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import cuda_optical_flow_2_tpu as jof
from cuda_optical_flow_2_tpu.kernels import bilateral_tap as jbilateral_tap
from cuda_optical_flow_2_tpu.kernels import fb_step_fused as jfb_step_fused
from cuda_optical_flow_2_tpu.kernels import hs_sweep as jhs_sweep
from cuda_optical_flow_2_tpu.kernels import tvl1_sweep as jtvl1_sweep
from cuda_optical_flow_2_tpu.kernels import lk_step_fused as jlk_step_fused
from cuda_optical_flow_2_tpu.kernels import warp_select as jwarp_select
from cuda_optical_flow_2_tpu.ops import bilateral as jbilateral
from cuda_optical_flow_2_tpu.ops import warp as jwarp

from cuda_optical_flow_2_torch.interop import fb_config_from_jax, lk_config_from_jax
from cuda_optical_flow_2_torch.kernels import (
    bilateral_tap,
    fb_step_fused,
    hs_sweep,
    lk_step_fused,
    poly_exp_fused,
    tvl1_sweep,
    warp_select,
)
from cuda_optical_flow_2_torch.ops import bilateral, warp
from cuda_optical_flow_2_torch.parallel.spatial import halo_exchange

FLOW_TOL = 2e-4
IMG_TOL = 1e-4
TVL1_BAND_TOL = 1e-4
TVL1_KW = dict(lambda_=0.15, theta=0.3, tau=0.25, eps=1e-6)
H, W = 64, 48
# (lo, hi) kept rows: the top edge, an interior band, the bottom edge
BANDS = [(0, 24), (20, 44), (40, 64)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _j(a):
    return jnp.asarray(np.asarray(a, np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(
        np.asarray(got, np.float32), np.asarray(want, np.float32), rtol=tol, atol=tol
    )


def _band(x, lo, hi, halo):
    """Rows [lo - halo, hi + halo) of x, zero beyond the image."""
    out = np.zeros((hi - lo + 2 * halo,) + x.shape[1:], np.float32)
    a, b = max(lo - halo, 0), min(hi + halo, x.shape[0])
    out[a - (lo - halo) : b - (lo - halo)] = x[a:b]
    return out


def _frames(seed=0):
    """Random 0-255 frames and a smooth flow of up to ~3.5 px: the TPU
    select warp is exact only while the flow varies smoothly (its row
    correction, ``c_max``), and random flow would hold the Pallas kernels
    to that TPU limit rather than to their function."""
    rng = np.random.default_rng(seed)
    prev, nxt = (rng.integers(0, 256, (H, W)).astype(np.float32) for _ in range(2))
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    u = 3.0 * np.sin(2 * np.pi * ys / H + seed) * np.cos(np.pi * xs / W)
    v = 2.5 * np.cos(2 * np.pi * xs / W) * np.sin(np.pi * ys / H + seed) - 1.0
    return prev, nxt, np.stack([u, v], -1).astype(np.float32)


# --- halo_exchange ------------------------------------------------------


@pytest.mark.parametrize("boundary", ["zero", "edge"])
def test_halo_exchange_matches_numpy(boundary):
    x = np.arange(8 * 4 * 6, dtype=np.float32).reshape(8, 4, 6)
    out = np.stack(
        [b.numpy() for b in halo_exchange([_t(blk) for blk in x], 2, 1, boundary=boundary)]
    )
    assert out.shape == (8, 7, 6)
    if boundary == "zero":
        pad_top, pad_bottom = np.zeros((4, 6), np.float32), np.zeros((4, 6), np.float32)
    else:
        pad_top, pad_bottom = np.repeat(x[0, :1], 4, 0), np.repeat(x[-1, -1:], 4, 0)
    padded = np.concatenate([pad_top[None], x, pad_bottom[None]])
    for i in range(8):
        np.testing.assert_array_equal(out[i, :2], padded[i, -2:])
        np.testing.assert_array_equal(out[i, 2:6], x[i])
        np.testing.assert_array_equal(out[i, 6:], padded[i + 2, :1])


def test_halo_exchange_flow_rows_and_height_limit():
    flow = [_t(np.full((3, 5, 2), i, np.float32)) for i in range(4)]
    out = halo_exchange(flow, 1, 1, row_axis=-3, boundary="edge")
    assert [tuple(o.shape) for o in out] == [(5, 5, 2)] * 4
    assert float(out[1][0].max()) == 0.0 and float(out[1][-1].min()) == 2.0
    assert float(out[0][0].max()) == 0.0 and float(out[3][-1].min()) == 3.0
    with pytest.raises(ValueError, match="exceeds block height 3"):
        halo_exchange(flow, 4, 0, row_axis=-3)


# --- the plain band ops -------------------------------------------------


@pytest.mark.parametrize("lo,hi", BANDS)
def test_warp_bilinear_band_matches_jax_and_whole_image(lo, hi):
    """The HS warp's layout: the image band has the warp halo (d + 2 rows
    beyond the flow's r_out = 2), the output covers the flow's rows."""
    _, img, flow = _frames()
    r_out, r_img = 2, 2 + 4 + 2
    img_b, flow_b = _band(img, lo, hi, r_img), _band(flow, lo, hi, r_out)
    args = (lo - r_img, lo - r_out, H)
    got = warp.warp_bilinear_band(_t(img_b), _t(flow_b), *args).numpy()
    want = np.asarray(jwarp.warp_bilinear_band(_j(img_b), _j(flow_b), *args))
    keep = slice(r_out, r_out + hi - lo)
    np.testing.assert_array_equal(got[keep], want[keep])
    whole = warp.warp_bilinear(_t(img), _t(flow)).numpy()
    np.testing.assert_array_equal(got[keep], whole[lo:hi])


@pytest.mark.parametrize("lo,hi", BANDS)
def test_bilateral_filter_band_matches_jax_and_whole_image(lo, hi):
    img, _, _ = _frames(1)
    r = 4
    band = _band(img, lo, hi, r)
    got = bilateral.bilateral_filter_band(_t(band), lo - r, H, 9, 2.0, 10.0).numpy()
    want = np.asarray(jbilateral.bilateral_filter_band(_j(band), lo - r, H, 9, 2.0, 10.0))
    keep = slice(r, r + hi - lo)
    _close(got[keep], want[keep], IMG_TOL)
    whole = bilateral.bilateral_filter(_t(img), None, 9, 2.0, 10.0).numpy()
    np.testing.assert_array_equal(got[keep], whole[lo:hi])
    # rows beyond the image come out zero
    outside = (np.arange(band.shape[0]) + lo - r < 0) | (np.arange(band.shape[0]) + lo - r >= H)
    assert not got[outside].any()


# --- the band kernels' plain versions against the Pallas band kernels ----


@pytest.mark.parametrize("centered", [False, True], ids=["lk", "centered"])
def test_lk_band_step_matches_pallas_interpret(centered):
    """Halo r_img = r_grad + d + 2, as the TP level step exchanges; the
    flow's variation stays inside the TPU kernel's d_local (7)."""
    prev, nxt, flow = _frames(2)
    jcfg = jof.LKConfig(levels=1, window=9, max_displacement=4.0, window_weights="tri")
    cfg = lk_config_from_jax(jcfg)
    halo = 9 // 2 + 2 + 4 + 2
    for lo, hi in BANDS:
        pb, nb, fb = (_band(x, lo, hi, halo) for x in (prev, nxt, flow))
        got = lk_step_fused.lk_band_step(_t(pb), _t(nb), _t(fb), lo - halo, cfg, H, centered)
        want = jlk_step_fused.lk_band_step(
            _j(pb), _j(nb), _j(fb), lo - halo, jcfg, H, interpret=True, centered=centered
        )
        keep = slice(halo, halo + hi - lo)
        _close(got.numpy()[keep], np.asarray(want)[keep], FLOW_TOL)


def test_warp_bilinear_select_band_matches_pallas_interpret():
    _, img, flow = _frames(3)
    halo = 4 + 2
    for lo, hi in BANDS:
        ib, fb = _band(img, lo, hi, halo), _band(flow, lo, hi, halo)
        got = warp_select.warp_bilinear_select_band(_t(ib), _t(fb), lo - halo, H, 4)
        want = jwarp_select.warp_bilinear_select_band(
            _j(ib), _j(fb), lo - halo, H, max_displacement=4, interpret=True
        )
        keep = slice(halo, halo + hi - lo)
        _close(got.numpy()[keep], np.asarray(want)[keep], IMG_TOL)


def test_bilateral_kernel_band_matches_pallas_interpret():
    img, _, _ = _frames(4)
    r = 4
    for lo, hi in BANDS:
        band = _band(img, lo, hi, r)
        got = bilateral_tap.bilateral_kernel_band(_t(band), lo - r, H, 9, 2.0, 10.0)
        want = jbilateral_tap.bilateral_kernel_band(
            _j(band), lo - r, H, 9, 2.0, 10.0, interpret=True
        )
        keep = slice(r, r + hi - lo)
        _close(got.numpy()[keep], np.asarray(want)[keep], IMG_TOL)


@pytest.mark.parametrize("robust", [None, (3.0, 0.1)], ids=["quadratic", "charbonnier"])
def test_hs_relax_band_matches_pallas_interpret(robust):
    """One chunk of 8 sweeps, halo sweeps + 2 as the TP relaxation
    exchanges; a warm start inside the band."""
    prev, nxt, flow = _frames(5)
    halo = 8 + 2
    kw = dict(sweeps=8, alpha=8.0, temporal_kernel="gauss3", robust=robust)
    for lo, hi in BANDS:
        pb, nb, fb = (_band(x, lo, hi, halo) for x in (prev, nxt, flow * 0.25))
        got = hs_sweep.hs_relax_band(_t(pb), _t(nb), _t(fb), lo - halo, H, **kw)
        want = jhs_sweep.hs_relax_band(_j(pb), _j(nb), _j(fb), lo - halo, H, interpret=True, **kw)
        keep = slice(halo, halo + hi - lo)
        _close(got.numpy()[keep], np.asarray(want)[keep], FLOW_TOL)


def _tvl1_state(seed):
    """A warm six-plane state: a smooth flow and small nonzero duals."""
    _, _, flow = _frames(seed)
    rng = np.random.default_rng(seed + 100)
    duals = [rng.normal(0, 0.05, (H, W)).astype(np.float32) for _ in range(4)]
    return [flow[..., 0] * 0.5, flow[..., 1] * 0.5] + duals


def test_tvl1_relax_band_matches_pallas_interpret():
    """One chunk of 8 iterations with carried duals, halo iterations + 2 as
    the TP level exchanges; the warp point is the smooth flow."""
    prev, warped, flow = _frames(10)
    state = _tvl1_state(10)
    halo = 8 + 2
    for lo, hi in BANDS:
        pb, wb, fb = (_band(x, lo, hi, halo) for x in (prev, warped, flow))
        sb = [_band(x, lo, hi, halo) for x in state]
        got = tvl1_sweep.tvl1_relax_band(_t(pb), _t(wb), _t(fb), tuple(_t(x) for x in sb),
                                         lo - halo, H, iterations=8, **TVL1_KW)
        want = jtvl1_sweep.tvl1_relax_band(_j(pb), _j(wb), _j(fb), tuple(_j(x) for x in sb),
                                           lo - halo, H, iterations=8, interpret=True, **TVL1_KW)
        keep = slice(halo, halo + hi - lo)
        assert len(got) == 6
        for g, w_ in zip(got, want):
            _close(g.numpy()[keep], np.asarray(w_)[keep], TVL1_BAND_TOL)


@pytest.mark.parametrize("first", [True, False], ids=["first", "warm"])
def test_fb_band_step_matches_pallas_interpret(first):
    """Halo band_margin + d + 2, as the fused TP level exchanges; the prev
    expansion is of the whole frame, cut into the band."""
    prev, nxt, flow = _frames(11)
    jcfg = jof.FBConfig(max_displacement=4)
    cfg = fb_config_from_jax(jcfg)
    exp1 = [x.numpy() for x in poly_exp_fused.poly_expansion_plain(_t(prev), 7, 1.5)]
    halo = fb_step_fused.band_margin(cfg) + 4 + 2
    assert halo == jfb_step_fused.band_margin(jcfg) + 4 + 2 == 18
    for lo, hi in BANDS:
        nb, fb = _band(nxt, lo, hi, halo), _band(flow, lo, hi, halo)
        eb = [_band(x, lo, hi, halo) for x in exp1]
        got = fb_step_fused.fb_band_step(_t(nb), tuple(_t(x) for x in eb), _t(fb), lo - halo,
                                         cfg, H, first)
        want = jfb_step_fused.fb_band_step(_j(nb), tuple(_j(x) for x in eb), _j(fb), lo - halo,
                                           jcfg, H, first=first, interpret=True)
        keep = slice(halo, halo + hi - lo)
        _close(got.numpy()[keep], np.asarray(want)[keep], FLOW_TOL)


# --- band forms at (0, H) are the whole-image plain versions -------------


@pytest.mark.parametrize("centered", [False, True], ids=["lk", "centered"])
def test_lk_band_step_whole_band_is_level_step(centered):
    prev, nxt, flow = (_t(x) for x in _frames(6))
    cfg = lk_config_from_jax(jof.LKConfig(levels=1, window=11, max_displacement=2.0))
    torch.testing.assert_close(
        lk_step_fused.lk_band_step_plain(prev, nxt, flow * 2, 0, cfg, H, centered),
        lk_step_fused.lk_level_step_plain(prev, nxt, flow * 2, cfg, centered), rtol=0, atol=0,
    )


def test_warp_and_bilateral_whole_band_are_whole_image():
    img, _, flow = (_t(x) for x in _frames(7))
    torch.testing.assert_close(
        warp_select.warp_bilinear_select_band_plain(img, flow * 3, 0, H, 5),
        warp_select.warp_bilinear_select_plain(img, flow * 3, 5), rtol=0, atol=0,
    )
    torch.testing.assert_close(
        bilateral_tap.bilateral_kernel_band_plain(img, 0, H, 7, 1.5, 8.0),
        bilateral_tap.bilateral_kernel_plain(img, 7, 1.5, 8.0), rtol=0, atol=0,
    )


@pytest.mark.parametrize("robust,offset", [(None, False), ((3.0, 0.1), True)],
                         ids=["quadratic", "charbonnier_offset"])
def test_hs_relax_band_whole_band_is_relax(robust, offset):
    prev, nxt, flow = (_t(x) for x in _frames(8))
    off = torch.linspace(-2, 2, H * W).reshape(H, W) if offset else None
    kw = dict(alpha=10.0, temporal_kernel="dt3", it_offset=off, robust=robust)
    torch.testing.assert_close(
        hs_sweep.hs_relax_band_plain(prev, nxt, flow * 0.1, 0, H, sweeps=16, **kw),
        hs_sweep.hs_relax_plain(prev, nxt, flow * 0.1, iterations=16, **kw), rtol=0, atol=0,
    )


def test_tvl1_relax_band_whole_band_is_relax():
    """Zero duals at (0, H): the whole-image scan, and the chunk keeps the
    duals it ends with."""
    prev, warped, flow = (_t(x) for x in _frames(12))
    zero = torch.zeros(H, W)
    out = tvl1_sweep.tvl1_relax_band_plain(prev, warped, flow, (flow[..., 0], flow[..., 1]) +
                                           (zero,) * 4, 0, H, iterations=14, **TVL1_KW)
    torch.testing.assert_close(
        torch.stack(out[:2], -1),
        tvl1_sweep.tvl1_relax_plain(prev, warped, flow, flow, iterations=14, **TVL1_KW),
        rtol=0, atol=0,
    )
    assert all(bool(d.abs().sum() > 0) for d in out[2:])


@pytest.mark.parametrize("first", [True, False], ids=["first", "warm"])
def test_fb_band_step_whole_band_is_level_step(first):
    prev, nxt, flow = (_t(x) for x in _frames(13))
    cfg = fb_config_from_jax(jof.FBConfig(max_displacement=3, winsize=11))
    exp1 = poly_exp_fused.poly_expansion_plain(prev, 7, 1.5)
    torch.testing.assert_close(
        fb_step_fused.fb_band_step_plain(nxt, exp1, flow, 0, cfg, H, first),
        fb_step_fused.fb_level_step_plain(nxt, exp1, flow, cfg, first), rtol=0, atol=0,
    )


# --- dispatch -----------------------------------------------------------


def test_band_wrappers_take_plain_on_cpu_and_count_nothing():
    prev, nxt, flow = (_t(x) for x in _frames(9))
    cfg = lk_config_from_jax(jof.LKConfig(levels=1, window=9))
    wrappers = (lk_step_fused.lk_band_step, warp_select.warp_bilinear_select_band,
                bilateral_tap.bilateral_kernel_band, hs_sweep.hs_relax_band)
    before = [fn.launches for fn in wrappers]
    torch.testing.assert_close(
        lk_step_fused.lk_band_step(prev, nxt, flow, -3, cfg, 50),
        lk_step_fused.lk_band_step_plain(prev, nxt, flow, -3, cfg, 50), rtol=0, atol=0)
    kw = dict(sweeps=5, alpha=8.0, temporal_kernel="gauss3")
    torch.testing.assert_close(hs_sweep.hs_relax_band(prev, nxt, None, 7, 80, **kw),
                               hs_sweep.hs_relax_band_plain(prev, nxt, None, 7, 80, **kw),
                               rtol=0, atol=0)
    warp_select.warp_bilinear_select_band(prev, flow, 3, 70)
    bilateral_tap.bilateral_kernel_band(prev, 3, 70)
    assert [fn.launches for fn in wrappers] == before


def test_band_wrappers_raise_off_cpu_and_cuda():
    meta = torch.empty(16, 16, device="meta")
    meta_flow = torch.empty(16, 16, 2, device="meta")
    cfg = lk_config_from_jax(jof.LKConfig(levels=1, window=9))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        lk_step_fused.lk_band_step(meta, meta, meta_flow, 0, cfg, 16)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        warp_select.warp_bilinear_select_band(meta, meta_flow, 0, 16)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        bilateral_tap.bilateral_kernel_band(meta, 0, 16)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        hs_sweep.hs_relax_band(meta, meta, None, 0, 16, sweeps=4, alpha=8.0,
                               temporal_kernel="gauss3")
    with pytest.raises(ValueError, match="one chunk"):
        hs_sweep.hs_relax_band(meta, meta, None, 0, 16, sweeps=hs_sweep.MAX_SWEEPS + 1,
                               alpha=8.0, temporal_kernel="gauss3")


def test_tvl1_and_fb_band_wrappers_take_plain_on_cpu_and_raise_off_it():
    prev, nxt, flow = (_t(x) for x in _frames(14))
    state = tuple(_t(x) for x in _tvl1_state(14))
    cfg = fb_config_from_jax(jof.FBConfig(max_displacement=4))
    exp1 = poly_exp_fused.poly_expansion_plain(prev, 7, 1.5)
    before = (tvl1_sweep.tvl1_relax_band.launches, fb_step_fused.fb_band_step.launches)
    kw = dict(iterations=5, **TVL1_KW)
    for g, w_ in zip(tvl1_sweep.tvl1_relax_band(prev, nxt, flow, state, -4, 60, **kw),
                     tvl1_sweep.tvl1_relax_band_plain(prev, nxt, flow, state, -4, 60, **kw)):
        torch.testing.assert_close(g, w_, rtol=0, atol=0)
    torch.testing.assert_close(fb_step_fused.fb_band_step(nxt, exp1, flow, 7, cfg, 90),
                               fb_step_fused.fb_band_step_plain(nxt, exp1, flow, 7, cfg, 90),
                               rtol=0, atol=0)
    assert (tvl1_sweep.tvl1_relax_band.launches, fb_step_fused.fb_band_step.launches) == before
    meta = torch.empty(16, 16, device="meta")
    meta_flow = torch.empty(16, 16, 2, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tvl1_sweep.tvl1_relax_band(meta, meta, meta_flow, (meta,) * 6, 0, 16, **kw)
    with pytest.raises(ValueError, match="one chunk"):
        tvl1_sweep.tvl1_relax_band(meta, meta, meta_flow, (meta,) * 6, 0, 16,
                                   iterations=tvl1_sweep.MAX_ITERS + 1, **TVL1_KW)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fb_step_fused.fb_band_step(meta, (meta,) * 5, meta_flow, 0, cfg, 16)
    with pytest.raises(ValueError, match="box window"):
        fb_step_fused.fb_band_step(meta, (meta,) * 5, meta_flow, 0,
                                   fb_config_from_jax(jof.FBConfig(gaussian_window=True)), 16)
