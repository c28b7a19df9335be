"""The port's TV-L1 family against the JAX package (CPU).

On CPU tensors ``kernels.tvl1_sweep.tvl1_relax`` takes its plain version
(the primal-dual scan of ``models.tvl1``); these tests hold that version to
the JAX Pallas kernel in interpret mode and to the JAX package's XLA scan,
and the whole pyramidal driver to the JAX package's XLA twin
(``use_pallas=False``).  The CUDA kernel is held to the plain version on the
card by chip_smoke.py.

Tolerances: 1e-5 px for one relaxation, the limit tests/test_tvl1.py holds
the Pallas kernel to its XLA twin; 2e-4 px for whole pipelines, as the
other families (the threshold step's near-ties could flip on float-order
differences, but the 5x5 median between warps absorbs isolated flips);
0.1 px inner EPE and 0.3 px median for translation recovery, the limits of
tests/test_tvl1.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cuda_optical_flow_2_tpu import config as jconfig
from cuda_optical_flow_2_tpu.kernels import tvl1_sweep as jtvl1_sweep
from cuda_optical_flow_2_tpu.models import tvl1 as jtvl1

import cuda_optical_flow_2_torch as tof
from cuda_optical_flow_2_torch.interop import tvl1_config_from_jax
from cuda_optical_flow_2_torch.kernels import pyr_down, tvl1_sweep, warp_select
from cuda_optical_flow_2_torch.models import tvl1 as ttvl1
from cuda_optical_flow_2_torch.utils.io import synthetic_sequence

RELAX_TOL = 1e-5
FLOW_TOL = 2e-4
EPE_TOL = 0.1
MEDIAN_TOL = 0.3
KW = dict(lambda_=0.15, theta=0.3, tau=0.25, eps=1e-6)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _j(a):
    return jnp.asarray(np.asarray(a, np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(
        np.asarray(got, np.float32), np.asarray(want, np.float32), rtol=tol, atol=tol
    )


def _pair(h, w, velocity=(1.0, 0.5), period=24, seed=0):
    fr = synthetic_sequence(2, h, w, velocity=velocity, period=period, seed=seed)
    return fr[0].astype(np.float32), fr[1].astype(np.float32)


def _both(jcfg):
    t = tvl1_config_from_jax(jcfg)
    return [dataclasses.replace(t, use_pallas=True), dataclasses.replace(t, use_pallas=False)]


# --- config ---------------------------------------------------------------


def test_tvl1_config_matches_jax():
    t_fields = [(f.name, f.default) for f in dataclasses.fields(ttvl1.TVL1Config)]
    j_fields = [(f.name, f.default) for f in dataclasses.fields(jtvl1.TVL1Config)]
    assert t_fields == j_fields
    assert dataclasses.asdict(tof.TVL1_REALTIME) == dataclasses.asdict(jtvl1.TVL1_REALTIME)
    assert tvl1_sweep.MAX_ITERS == jtvl1_sweep.MAX_ITERS
    for bad in ({"tau": 0.5}, {"lambda_": 0.0}, {"warps": 0}, {"epsilon": 0.0},
                {"median_filtering": 4}, {"median_filtering": -3}):
        with pytest.raises(ValueError):
            jtvl1.TVL1Config(**bad)
        with pytest.raises(ValueError):
            ttvl1.TVL1Config(**bad)


@pytest.mark.parametrize(
    "jcfg",
    [jtvl1.TVL1Config(),
     jtvl1.TVL1Config(warps=2, median_filtering=0, prefilter=jconfig.BilateralConfig(window=7),
                      use_pallas=False)],
    ids=["default", "prefilter_no_median"],
)
def test_tvl1_config_from_jax(jcfg):
    got = tvl1_config_from_jax(jcfg)
    assert isinstance(got, tof.TVL1Config)
    assert dataclasses.asdict(got) == dataclasses.asdict(jcfg)


# --- the plain scan's stencils -----------------------------------------------


def test_fwd_diff_and_div_match_jax(rng):
    u, px, py = (rng.standard_normal((17, 23)).astype(np.float32) for _ in range(3))
    for dim in (-1, -2):
        _close(ttvl1._fwd_diff(_t(u), dim), jtvl1._fwd_diff(_j(u), dim), 0.0)
    _close(ttvl1._div(_t(px), _t(py)), jtvl1._div(_j(px), _j(py)), 0.0)
    # the negative-adjoint identity <div p, u> = -<p, grad u>
    lhs = float((ttvl1._div(_t(px), _t(py)) * _t(u)).sum())
    rhs = -float((_t(px) * ttvl1._fwd_diff(_t(u), -1)).sum()
                 + (_t(py) * ttvl1._fwd_diff(_t(u), -2)).sum())
    np.testing.assert_allclose(lhs, rhs, rtol=1e-4)


# --- kernel #7: tvl1_relax -----------------------------------------------------


def test_tvl1_relax_matches_pallas_interpret(monkeypatch):
    """The plain version against the Pallas kernel itself, interpret mode, at
    the odd size of tests/test_tvl1.py: 20 iterations = a full 14-iteration
    chunk and a remainder of 6 there."""
    monkeypatch.setenv("OF2_PALLAS_INTERPRET", "1")
    p, n = _pair(67, 93)
    u0 = np.zeros((67, 93, 2), np.float32)
    want = jtvl1_sweep.tvl1_relax(_j(p), _j(n), _j(u0), _j(u0), iterations=20, interpret=True,
                                  **KW)
    got = tvl1_sweep.tvl1_relax(_t(p), _t(n), _t(u0), _t(u0), iterations=20, **KW)
    assert tuple(got.shape) == (67, 93, 2) and got.dtype == torch.float32
    _close(got, want, RELAX_TOL)


@pytest.mark.parametrize(
    "shape,iterations,warm",
    [((40, 56), 14, False), ((2, 33, 45), 9, True), ((31, 64), 30, True)],
    ids=["cold_one_chunk", "warm_batch2", "warm_30"],
)
def test_tvl1_relax_matches_xla_scan(shape, iterations, warm):
    """Against ``models/tvl1.tvl1_level``'s XLA scan, linearized at a flow u0
    and started from another flow (the duals from zero)."""
    rng = np.random.default_rng(2)
    frames = [_pair(*shape[-2:], seed=s) for s in range(shape[0] if len(shape) == 3 else 1)]
    p = np.stack([f[0] for f in frames]).reshape(shape)
    n = np.stack([f[1] for f in frames]).reshape(shape)
    u0 = (rng.normal(0, 1, shape + (2,)) if warm else np.zeros(shape + (2,))).astype(np.float32)
    flow = u0 + (rng.normal(0, 0.2, u0.shape).astype(np.float32) if warm else 0)
    jcfg = jtvl1.TVL1Config(levels=1, warps=1, iterations=iterations, use_pallas=False)
    want = jtvl1.tvl1_level(_j(p), _j(n), _j(u0), _j(flow), jcfg)
    got = tvl1_sweep.tvl1_relax(_t(p), _t(n), _t(u0), _t(flow), iterations=iterations, **KW)
    _close(got, want, RELAX_TOL)


def test_tvl1_wrappers_cpu_plain_and_no_launches():
    p, n = _pair(24, 32)
    u0 = np.full((24, 32, 2), 0.3, np.float32)
    wrappers = (tvl1_sweep.tvl1_relax, warp_select.warp_bilinear_select, pyr_down.pyr_down)
    before = [fn.launches for fn in wrappers]
    args = (_t(p), _t(n), _t(u0), _t(u0))
    torch.testing.assert_close(tvl1_sweep.tvl1_relax(*args, iterations=7, **KW),
                               tvl1_sweep.tvl1_relax_plain(*args, iterations=7, **KW),
                               rtol=0, atol=0)
    tof.pyramidal_tvl1(_t(p), _t(n), tof.TVL1Config(levels=2, warps=2, iterations=5))
    assert [fn.launches for fn in wrappers] == before


def test_tvl1_relax_raises_off_cpu_and_cuda():
    """Only CPU tensors take the plain version; anything else launches or raises."""
    meta = torch.empty(16, 16, device="meta")
    flow = torch.empty(16, 16, 2, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tvl1_sweep.tvl1_relax(meta, meta, flow, flow, iterations=4, **KW)


# --- models.tvl1 -----------------------------------------------------------------


@pytest.mark.parametrize(
    "kw",
    [dict(levels=2, warps=2, iterations=15),
     dict(levels=3, warps=3, iterations=10, median_filtering=0),
     dict(levels=2, warps=1, iterations=14, median_filtering=3, lambda_=0.3, theta=0.2)],
    ids=["median5", "no_median", "median3"],
)
def test_pyramidal_tvl1_matches_jax(kw):
    """Both port paths against the JAX XLA twin; a (2, 1) px motion stays
    inside the 32 px budget, so the kernel path's clip changes nothing."""
    p, n = _pair(96, 128, velocity=(2.0, 1.0))
    jcfg = jtvl1.TVL1Config(use_pallas=False, **kw)
    want = jtvl1.pyramidal_tvl1_jit(_j(p), _j(n), jcfg)
    for tcfg in _both(jcfg):
        got = tof.pyramidal_tvl1(_t(p), _t(n), tcfg)
        assert tuple(got.shape) == (96, 128, 2)
        _close(got, want, FLOW_TOL)


def test_pyramidal_tvl1_recovers_translation_like_jax():
    """tests/test_tvl1.py's translation case: EPE under 0.1 px inside a 24 px
    margin, in both packages, which agree."""
    p, n = _pair(128, 160, velocity=(2.0, 1.0))
    jcfg = jtvl1.TVL1Config(levels=3, warps=3, iterations=20, use_pallas=False)
    want = np.asarray(jtvl1.pyramidal_tvl1_jit(_j(p), _j(n), jcfg))
    got = tof.pyramidal_tvl1(_t(p), _t(n), tvl1_config_from_jax(jcfg)).numpy()
    for flow in (want, got):
        c = flow[24:-24, 24:-24]
        assert float(np.hypot(c[..., 0] - 2, c[..., 1] - 1).mean()) < EPE_TOL
    _close(got, want, FLOW_TOL)


def test_tvl1_realtime_preset_tracks_motion():
    """tests/test_tvl1.py's preset case: TVL1_REALTIME cut to 2 levels on a
    noise-free 128x96 pair; inner median within 0.3 px of (2, 1)."""
    fr = synthetic_sequence(2, 128, 96, velocity=(2.0, 1.0), noise=0.0)
    cfg = dataclasses.replace(tof.TVL1_REALTIME, levels=2)
    flow = tof.pyramidal_tvl1(_t(fr[0]), _t(fr[1]), cfg).numpy()
    m = np.median(flow[24:-24, 24:-24].reshape(-1, 2), axis=0)
    np.testing.assert_allclose(m, [2.0, 1.0], atol=MEDIAN_TOL)


def test_tvl1_prefilter_and_init_flow_match_jax():
    """tvl1_preprocess with the bilateral prefilter, then tvl1_coarse_to_fine
    warm-started from a coarse flow."""
    p, n = _pair(48, 64, velocity=(1.0, 0.5))
    jcfg = jtvl1.TVL1Config(levels=2, warps=2, iterations=10,
                            prefilter=jconfig.BilateralConfig(), use_pallas=False)
    jp, jn = jtvl1.tvl1_preprocess(_j(p), jcfg), jtvl1.tvl1_preprocess(_j(n), jcfg)
    init = np.full((24, 32, 2), 0.25, np.float32)
    c2f = jax.jit(jtvl1.tvl1_coarse_to_fine, static_argnames=("config",))
    want = c2f(jp, jn, jcfg, _j(init))
    for tcfg in _both(jcfg):
        tp, tn = ttvl1.tvl1_preprocess(_t(p), tcfg), ttvl1.tvl1_preprocess(_t(n), tcfg)
        _close(ttvl1.tvl1_coarse_to_fine(tp, tn, tcfg, _t(init)), want, FLOW_TOL)


def test_batched_pyramidal_tvl1_matches_single():
    p, n = _pair(48, 64)
    cfg = tof.TVL1Config(levels=2, warps=2, iterations=8)
    batch = tof.pyramidal_tvl1(_t(np.stack([p, n])), _t(np.stack([n, p])), cfg)
    torch.testing.assert_close(batch[0], tof.pyramidal_tvl1(_t(p), _t(n), cfg), rtol=0, atol=1e-6)
    torch.testing.assert_close(batch[1], tof.pyramidal_tvl1(_t(n), _t(p), cfg), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="shapes differ"):
        tof.pyramidal_tvl1(_t(p), _t(n[:, :32]), cfg)
