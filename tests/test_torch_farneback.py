"""The port's Farnebäck family against the JAX package (CPU).

On CPU tensors the three FB kernel wrappers (``poly_exp_fused``,
``win_solve``, ``fb_step_fused``) take their plain versions; these tests hold
those versions to the JAX Pallas kernels in interpret mode at about 48x64,
and the whole pyramidal pipeline to the JAX package's XLA twin
(``use_pallas=False``, the semantic arbiter).  The CUDA kernels are held to
the plain versions on the card by chip_smoke.py.

Tolerances: the expansion constants exactly equal; expansion planes rtol
1e-4, atol 1e-3 on 0-255 intensities (float order of ~60 taps); products and
solves rtol/atol 1e-5 relative to their scale; flows atol 1e-4 px against
the XLA twin at 96x128 (the port repeats its float order), 1e-3 px against
the Pallas kernels in interpret mode (their box sums take another order);
translation recovery 0.1 px (median) and 0.35 px (mean end-point error), the
limits of tests/test_farneback.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cuda_optical_flow_2_tpu import config as jconfig
from cuda_optical_flow_2_tpu.kernels import fb_step_fused as jfb_step
from cuda_optical_flow_2_tpu.kernels import poly_exp_fused as jpoly_kernel
from cuda_optical_flow_2_tpu.kernels import win_solve as jwin_solve
from cuda_optical_flow_2_tpu.models import farneback as jfb
from cuda_optical_flow_2_tpu.ops import poly_exp as jpoly

import cuda_optical_flow_2_torch as tof
from cuda_optical_flow_2_torch.interop import fb_config_from_jax
from cuda_optical_flow_2_torch.kernels import (
    fb_step_fused,
    poly_exp_fused,
    pyr_down,
    warp_select,
    win_solve,
)
from cuda_optical_flow_2_torch.models import farneback as tfb
from cuda_optical_flow_2_torch.ops import poly_exp as tpoly
from cuda_optical_flow_2_torch.utils.io import synthetic_sequence

POLY_RTOL, POLY_ATOL = 1e-4, 1e-3
FLOW_TOL = 1e-4
KERNEL_FLOW_TOL = 1e-3

WRAPPERS = (
    poly_exp_fused.poly_expansion_kernel,
    win_solve.window_solve,
    fb_step_fused.fb_level_step,
    warp_select.warp_bilinear_select,
    pyr_down.pyr_down,
)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _j(a):
    return jnp.asarray(np.asarray(a, np.float32))


def _np(x):
    return np.asarray(x, np.float32)


def _close_flow(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _pair(h, w, velocity=(1.5, -1.0), period=24, seed=0):
    fr = synthetic_sequence(2, h, w, velocity=velocity, period=period, seed=seed)
    return fr[0].astype(np.float32), fr[1].astype(np.float32)


def _smooth_flow(h, w, amp):
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    u = amp * np.sin(2 * np.pi * ys / h) * np.cos(np.pi * xs / w)
    v = amp * np.cos(2 * np.pi * xs / w) * np.sin(np.pi * ys / h) - 0.5
    return np.stack([u, v], -1).astype(np.float32)


def _planes(rng, shape):
    """Five normal-equation planes with g11, g22 >= 0, and an all-zero patch
    (det == 0) in the corner."""
    pl = [rng.normal(0, 30, shape).astype(np.float32) for _ in range(5)]
    pl[0], pl[2] = np.abs(pl[0]), np.abs(pl[2])
    for p in pl[:3]:
        p[..., :6, :6] = 0.0
    return pl


# --- ops.poly_exp -----------------------------------------------------------


@pytest.mark.parametrize("n,sigma", [(3, 0.8), (5, 1.1), (7, 1.5), (31, 5.0)])
def test_expansion_constants_equal_to_jax(n, sigma):
    np.testing.assert_array_equal(tpoly.gaussian_1d(n, sigma), jpoly.gaussian_1d(n, sigma))
    np.testing.assert_array_equal(tpoly.mixing_matrix(n, sigma), jpoly.mixing_matrix(n, sigma))
    taps, mix = tpoly.poly_taps(n, sigma)
    g = jpoly.gaussian_1d(n, sigma)
    o = np.arange(n) - n // 2
    np.testing.assert_array_equal(taps, np.stack([g, g * o, g * o * o]).astype(np.float32))
    want = jpoly.mixing_matrix(n, sigma).astype(np.float32)
    want[np.abs(jpoly.mixing_matrix(n, sigma)) < 1e-15] = 0.0
    want[4] *= np.float32(0.5)
    np.testing.assert_array_equal(mix, want)
    with pytest.raises(ValueError):
        tpoly.gaussian_1d(n + 1, sigma)


@pytest.mark.parametrize("n,sigma", [(5, 1.1), (7, 1.5)])
def test_poly_expansion_matches_jax(rng, n, sigma):
    f = rng.integers(0, 256, (2, 37, 53)).astype(np.float32)
    want = jpoly.poly_expansion(_j(f), n, sigma)
    got = tpoly.poly_expansion(_t(f), n, sigma)
    assert len(got) == 5
    for g, w in zip(got, want):
        assert tuple(g.shape) == f.shape and g.dtype == torch.float32
        np.testing.assert_allclose(_np(g), _np(w), rtol=POLY_RTOL, atol=POLY_ATOL)


def test_poly_expansion_takes_uint8():
    f = np.arange(24 * 30, dtype=np.uint8).reshape(24, 30)
    got = tpoly.poly_expansion(torch.from_numpy(f), 5, 1.1)
    want = tpoly.poly_expansion(_t(f), 5, 1.1)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


# --- kernel #9: poly_expansion_kernel ----------------------------------------


@pytest.mark.parametrize("n,sigma", [(5, 1.1), (7, 1.5)])
def test_poly_expansion_kernel_matches_pallas_interpret(rng, n, sigma):
    f = rng.integers(0, 256, (48, 64)).astype(np.float32)
    want = jpoly_kernel.poly_expansion_kernel(_j(f), n, sigma, interpret=True)
    got = poly_exp_fused.poly_expansion_kernel(_t(f), n, sigma)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=POLY_RTOL, atol=POLY_ATOL)


# --- products and solve ------------------------------------------------------


def test_fb_normal_eq_products_matches_jax(rng):
    shape = (2, 19, 23)
    e1 = [rng.normal(0, 20, shape).astype(np.float32) for _ in range(5)]
    e2 = [rng.normal(0, 20, shape).astype(np.float32) for _ in range(5)]
    u, v = (rng.normal(0, 3, shape).astype(np.float32) for _ in range(2))
    want = jfb.fb_normal_eq_products([_j(x) for x in e1], [_j(x) for x in e2], _j(u), _j(v))
    got = tfb.fb_normal_eq_products([_t(x) for x in e1], [_t(x) for x in e2], _t(u), _t(v))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-5, atol=1e-5 * np.abs(_np(w)).max())


@pytest.mark.parametrize("det_eps", [1e-6, 0.0, -1.0], ids=["guarded", "zero", "negative"])
def test_solve_normal_eqs_matches_jax(rng, det_eps):
    """det == 0 in a corner patch: zero flow when guarded, the raw division
    (inf/NaN) for det_eps <= 0, in both packages."""
    sums = np.stack(_planes(rng, (2, 17, 21)))
    want = _np(jfb.solve_normal_eqs(_j(sums), det_eps))
    got = _np(tfb.solve_normal_eqs(_t(sums), det_eps))
    assert got.shape == (2, 17, 21, 2)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    assert np.isfinite(got).all() == (det_eps > 0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, equal_nan=True)


# --- kernel #10: window_solve ------------------------------------------------


@pytest.mark.parametrize(
    "window,det_eps", [(15, 1e-6), (9, 0.0), (33, 1e-6)], ids=["w15", "w9_unguarded", "w33"]
)
def test_window_solve_matches_pallas_interpret(rng, window, det_eps):
    pl = _planes(rng, (48, 64))
    want = _np(jwin_solve.window_solve(*(_j(p) for p in pl), window=window, det_eps=det_eps,
                                       interpret=True))
    got = _np(win_solve.window_solve(*(_t(p) for p in pl), window, det_eps))
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_allclose(got, want, rtol=KERNEL_FLOW_TOL, atol=KERNEL_FLOW_TOL,
                               equal_nan=True)


def test_window_solve_plain_is_window_sum_then_solve(rng):
    pl = [_t(p) for p in _planes(rng, (2, 20, 30))]
    want = jfb.solve_normal_eqs(jfb.window_sum(jnp.stack([_j(p) for p in pl]), 11), 1e-6)
    _close_flow(win_solve.window_solve_plain(*pl, 11, 1e-6), want, FLOW_TOL)


# --- kernel #8: fb_level_step ------------------------------------------------


@pytest.mark.parametrize("first", [True, False], ids=["first", "warm"])
def test_fb_level_step_matches_pallas_interpret(first):
    """The flow varies by well under the TPU kernel's d_local inside a tile,
    so its select-warp is exact and both compute the same function."""
    p, n = _pair(48, 64, velocity=(1.0, 0.5))
    jcfg = jfb.FBConfig(levels=1, iterations=1, winsize=9, poly_n=5, poly_sigma=1.1,
                        max_displacement=4)
    flow = _smooth_flow(48, 64, 1.5)
    exp1 = jpoly.poly_expansion(_j(p), jcfg.poly_n, jcfg.poly_sigma)
    want = jfb_step.fb_level_step(_j(n), exp1, _j(flow), jcfg, first=first, interpret=True)
    tcfg = fb_config_from_jax(jcfg)
    got = fb_step_fused.fb_level_step(
        _t(n), tuple(_t(e) for e in exp1), None if first else _t(flow), tcfg, first=first
    )
    assert tuple(got.shape) == (48, 64, 2)
    _close_flow(got, want, KERNEL_FLOW_TOL)


@pytest.mark.parametrize("first", [True, False], ids=["first", "warm"])
def test_fb_level_step_plain_is_one_xla_iteration(first):
    """The plain version against one iteration of the JAX image path
    (``fb_level_image`` with ``iterations=1``), flow beyond the budget."""
    p, n = _pair(40, 56, velocity=(1.0, 0.5))
    jcfg = jfb.FBConfig(levels=1, iterations=1, max_displacement=3, use_pallas=False)
    flow = None if first else _smooth_flow(40, 56, 6.0)
    exp1 = jpoly.poly_expansion(_j(p), jcfg.poly_n, jcfg.poly_sigma)
    want = jfb.fb_level_image(_j(n), exp1, None if first else _j(flow), jcfg)
    got = fb_step_fused.fb_level_step(
        _t(n), tuple(_t(e) for e in exp1), None if first else _t(flow),
        fb_config_from_jax(jcfg), first=first,
    )
    _close_flow(got, want, FLOW_TOL)


@pytest.mark.parametrize("first", [True, False], ids=["first", "warm"])
def test_fb_level_step_plain_in_float64_is_the_same_iteration(first):
    """``dtype=torch.float64`` (the reference chip_smoke.py holds the FB
    33/31 case against) keeps float64 throughout and computes the JAX
    iteration of the test above, within the same tolerance.  Warm, the
    float32 sample coordinate 55 + 5e-7 of the last column rounds to 55,
    inside the image, and float64's is outside (the source pixel is kept):
    the pixels that reach it through the window and the expansion (radii 7
    and 3), 11 columns on each side, are left out."""
    p, n = _pair(40, 56, velocity=(1.0, 0.5))
    jcfg = jfb.FBConfig(levels=1, iterations=1, max_displacement=3, use_pallas=False)
    flow = None if first else _smooth_flow(40, 56, 6.0)
    exp1 = jpoly.poly_expansion(_j(p), jcfg.poly_n, jcfg.poly_sigma)
    want = jfb.fb_level_image(_j(n), exp1, None if first else _j(flow), jcfg)
    exp64 = tpoly.poly_expansion(_t(p).double(), jcfg.poly_n, jcfg.poly_sigma)
    got = fb_step_fused.fb_level_step_plain(
        _t(n).double(), exp64, None if first else _t(flow).double(), fb_config_from_jax(jcfg),
        first=first, dtype=torch.float64,
    )
    assert got.dtype == torch.float64 and all(e.dtype == torch.float64 for e in exp64)
    cols = slice(0, None) if first else slice(11, -11)
    _close_flow(got.float()[:, cols], np.asarray(want)[:, cols], FLOW_TOL)


@pytest.mark.parametrize(
    "kw,fused",
    [({}, True), ({"winsize": 33, "poly_n": 31}, True), ({"gaussian_window": True}, False),
     ({"winsize": 35}, False), ({"poly_n": 33}, False)],
    ids=["default", "limits", "gaussian", "window35", "poly33"],
)
def test_fb_step_supported_from_config(kw, fused):
    assert fb_step_fused.supported(tof.FBConfig(**kw)) is fused


# --- models.farneback --------------------------------------------------------


def test_fb_config_matches_jax():
    t_fields = [(f.name, f.default) for f in dataclasses.fields(tfb.FBConfig)]
    j_fields = [(f.name, f.default) for f in dataclasses.fields(jfb.FBConfig)]
    assert t_fields == j_fields
    for bad in ({"levels": 0}, {"iterations": 0}, {"poly_n": 4}, {"poly_n": 1},
                {"winsize": 10}, {"poly_sigma": 0.0}, {"c_max": -1}, {"warp_planes": "flow"}):
        with pytest.raises(ValueError):
            jfb.FBConfig(**bad)
        with pytest.raises(ValueError):
            tfb.FBConfig(**bad)


@pytest.mark.parametrize(
    "jcfg",
    [jfb.FBConfig(),
     jfb.FBConfig(warp_planes="coeff", gaussian_window=True, poly_n=5, poly_sigma=1.1,
                  prefilter=jconfig.BilateralConfig(window=7), use_pallas=False, det_eps=0.0)],
    ids=["default", "coeff_gaussian_prefilter"],
)
def test_fb_config_from_jax(jcfg):
    got = fb_config_from_jax(jcfg)
    assert isinstance(got, tof.FBConfig)
    assert dataclasses.asdict(got) == dataclasses.asdict(jcfg)
    if jcfg == jfb.FBConfig():
        assert got == tof.FBConfig()


def _both(jcfg):
    t = fb_config_from_jax(jcfg)
    return [dataclasses.replace(t, use_pallas=True), dataclasses.replace(t, use_pallas=False)]


FB_CASES = {
    "image": jfb.FBConfig(levels=2, use_pallas=False),
    "coeff": jfb.FBConfig(levels=2, warp_planes="coeff", use_pallas=False),
    "gaussian_poly5": jfb.FBConfig(levels=2, iterations=2, poly_n=5, poly_sigma=1.1,
                                   winsize=13, gaussian_window=True, use_pallas=False),
    "prefilter": jfb.FBConfig(levels=2, iterations=2, prefilter=jconfig.BilateralConfig(),
                              use_pallas=False),
}


@pytest.mark.parametrize("case", list(FB_CASES))
def test_pyramidal_farneback_matches_jax(case):
    """Both port paths against the XLA twin at 96x128 ((1.5, -1) px motion:
    the 32 px budget clips nothing, and both paths clip alike anyway)."""
    jcfg = FB_CASES[case]
    p, n = _pair(96, 128)
    want = jfb.pyramidal_farneback_jit(_j(p), _j(n), jcfg)
    for tcfg in _both(jcfg):
        got = tof.pyramidal_farneback(_t(p), _t(n), tcfg)
        assert tuple(got.shape) == (96, 128, 2) and got.dtype == torch.float32
        _close_flow(got, want, FLOW_TOL)


def test_batched_pyramidal_farneback_matches_jax():
    p, n = _pair(64, 80)
    p2, n2 = _pair(64, 80, velocity=(-1.0, 0.5), seed=1)
    jcfg = jfb.FBConfig(levels=2, iterations=2, use_pallas=False)
    want = jfb.pyramidal_farneback_jit(_j(np.stack([p, p2])), _j(np.stack([n, n2])), jcfg)
    for tcfg in _both(jcfg):
        got = tof.pyramidal_farneback(_t(np.stack([p, p2])), _t(np.stack([n, n2])), tcfg)
        assert tuple(got.shape) == (2, 64, 80, 2)
        _close_flow(got, want, FLOW_TOL)
    with pytest.raises(ValueError, match="shapes differ"):
        tof.pyramidal_farneback(_t(p), _t(n[:, :40]), tof.FBConfig())


@pytest.mark.parametrize("warp_planes", ["image", "coeff"])
def test_fb_coarse_to_fine_with_init_flow_matches_jax(warp_planes):
    """The streaming warm start: pyramids from fb_preprocess, a coarse seed."""
    p, n = _pair(48, 64, velocity=(1.0, 0.5))
    jcfg = jfb.FBConfig(levels=2, iterations=2, warp_planes=warp_planes, use_pallas=False)
    jp, jn = jfb.fb_preprocess(_j(p), jcfg), jfb.fb_preprocess(_j(n), jcfg)
    init = np.full((24, 32, 2), 0.25, np.float32)
    want = jfb.fb_coarse_to_fine(jp, jn, jcfg, _j(init))
    for tcfg in _both(jcfg):
        tp, tn = tfb.fb_preprocess(_t(p), tcfg), tfb.fb_preprocess(_t(n), tcfg)
        for g, w in zip(tp + tn, jp + jn):
            np.testing.assert_allclose(_np(g), _np(w), rtol=1e-5, atol=1e-4)
        _close_flow(tfb.fb_coarse_to_fine(tp, tn, tcfg, _t(init)), want, FLOW_TOL)


@pytest.mark.parametrize(
    "velocity,shape,levels,margin",
    [((0.7, 0.4), (96, 128), 1, 16), ((5.0, 3.0), (128, 160), 3, 24)],
    ids=["subpixel_single_level", "large_pyramidal"],
)
def test_pyramidal_farneback_recovers_translation(velocity, shape, levels, margin):
    """tests/test_farneback.py's two recovery cases, on the port."""
    p, n = _pair(*shape, velocity=velocity)
    flow = tof.pyramidal_farneback(_t(p), _t(n), tof.FBConfig(levels=levels)).numpy()
    inner = flow[margin:-margin, margin:-margin]
    if levels == 1:
        np.testing.assert_allclose(np.median(inner.reshape(-1, 2), axis=0), velocity, atol=0.1)
    else:
        epe = np.hypot(inner[..., 0] - velocity[0], inner[..., 1] - velocity[1])
        assert epe.mean() < 0.35, epe.mean()


# --- dispatch ------------------------------------------------------------------


def test_fb_cpu_path_launches_nothing():
    p, n = _pair(40, 48)
    before = [fn.launches for fn in WRAPPERS]
    for wp in ("image", "coeff"):
        tof.pyramidal_farneback(_t(p), _t(n), tof.FBConfig(levels=2, iterations=2, warp_planes=wp))
    assert [fn.launches for fn in WRAPPERS] == before


def test_fb_kernel_dispatch_follows_the_config(monkeypatch):
    """Which wrapper each stage calls is decided from the config: a Gaussian
    window keeps the expansion and warp wrappers and takes the plain window;
    a window beyond the kernels' limit takes the plain window and step."""
    calls = []

    def recording(name, real):
        def call(*args, **kwargs):
            calls.append(name)
            return real(*args, **kwargs)
        return call

    for mod, name in ((poly_exp_fused, "poly_expansion_kernel"), (win_solve, "window_solve"),
                      (fb_step_fused, "fb_level_step"), (warp_select, "warp_bilinear_select")):
        monkeypatch.setattr(mod, name, recording(name, getattr(mod, name)))
    p, n = _pair(40, 48)
    expect = {
        tof.FBConfig(levels=2, iterations=2): {"poly_expansion_kernel", "fb_level_step"},
        tof.FBConfig(levels=2, iterations=2, warp_planes="coeff"):
            {"poly_expansion_kernel", "window_solve", "warp_bilinear_select"},
        tof.FBConfig(levels=2, iterations=2, gaussian_window=True):
            {"poly_expansion_kernel", "warp_bilinear_select"},
        tof.FBConfig(levels=2, iterations=2, winsize=35):
            {"poly_expansion_kernel", "warp_bilinear_select"},
        tof.FBConfig(levels=2, iterations=2, use_pallas=False): set(),
    }
    for cfg, names in expect.items():
        calls.clear()
        tof.pyramidal_farneback(_t(p), _t(n), cfg)
        assert set(calls) == names, (cfg, calls)


def test_fb_wrappers_raise_off_cpu_and_cuda():
    """Only CPU tensors take the plain versions; anything else launches or raises."""
    meta = torch.empty(16, 16, device="meta")
    cfg = tof.FBConfig()
    with pytest.raises(ValueError, match="CUDA or CPU"):
        poly_exp_fused.poly_expansion_kernel(meta)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        win_solve.window_solve(meta, meta, meta, meta, meta, 15)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fb_step_fused.fb_level_step(meta, (meta,) * 5, None, cfg, first=True)
    with pytest.raises(ValueError, match="poly_n <= 31"):
        poly_exp_fused.poly_expansion_kernel(meta, 33, 6.0)
    with pytest.raises(ValueError, match="window <= 33"):
        win_solve.window_solve(meta, meta, meta, meta, meta, 35)
    with pytest.raises(ValueError, match="box window"):
        fb_step_fused.fb_level_step(meta, (meta,) * 5, None,
                                    tof.FBConfig(gaussian_window=True), first=True)
