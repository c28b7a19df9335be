"""The port's Horn-Schunck family against the JAX package (CPU).

On CPU tensors ``kernels.hs_sweep.hs_relax`` takes its plain version (the
relaxation loops of ``models.horn_schunck``); these tests hold that version
to the JAX Pallas kernel in interpret mode and the whole pyramidal driver to
the JAX package's XLA twin (``use_pallas=False``).  The CUDA kernel is held
to the plain version on the card by chip_smoke.py.

Tolerances: atol/rtol 1e-4 px for one relaxation, as tests/test_horn_schunck.py
compares the Pallas kernel with its XLA twin; 2e-4 px for whole pipelines,
as tests/test_torch_kernels.py; 0.15 px for translation recovery, the limit
of tests/test_horn_schunck.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cuda_optical_flow_2_tpu import config as jconfig
from cuda_optical_flow_2_tpu.kernels import hs_sweep as jhs_sweep
from cuda_optical_flow_2_tpu.models import horn_schunck as jhs
from cuda_optical_flow_2_tpu.ops import conv as jconv

import cuda_optical_flow_2_torch as tof
from cuda_optical_flow_2_torch.interop import hs_config_from_jax
from cuda_optical_flow_2_torch.kernels import hs_sweep, pyr_down, warp_select
from cuda_optical_flow_2_torch.models import horn_schunck as ths
from cuda_optical_flow_2_torch.ops import conv as tconv
from cuda_optical_flow_2_torch.utils.io import synthetic_sequence

RELAX_TOL = 1e-4
FLOW_TOL = 2e-4
TRANSLATION_TOL = 0.15


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _j(a):
    return jnp.asarray(np.asarray(a, np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(
        np.asarray(got, np.float32), np.asarray(want, np.float32), rtol=tol, atol=tol
    )


def _pair(h, w, velocity=(0.8, -0.5), period=24, seed=0):
    fr = synthetic_sequence(2, h, w, velocity=velocity, period=period, seed=seed)
    return fr[0].astype(np.float32), fr[1].astype(np.float32)


# --- ops.conv.stencil2d -----------------------------------------------------


@pytest.mark.parametrize(
    "mask",
    [np.array([[0.5, 0.0, -0.5]], np.float32), np.array([[0.5], [0.0], [-0.5]], np.float32),
     jhs.HS_AVG_3X3],
    ids=["dxc", "dyc", "hs_avg"],
)
def test_stencil2d_matches_jax(rng, mask):
    x = rng.normal(0, 3, (2, 23, 31)).astype(np.float32)
    _close(tconv.stencil2d(_t(x), mask), jconv.stencil2d(_j(x), mask), 1e-5)


def test_hs_avg_matches_stencil_and_jax(rng):
    x = rng.normal(0, 3, (19, 26)).astype(np.float32)
    np.testing.assert_array_equal(ths.HS_AVG_3X3, jhs.HS_AVG_3X3)
    _close(ths._avg3x3(_t(x)), jhs._avg3x3(_j(x)), 1e-5)
    _close(ths._avg3x3(_t(x)), tconv.stencil2d(_t(x), ths.HS_AVG_3X3), 1e-5)


# --- kernel #6: hs_relax ----------------------------------------------------


@pytest.mark.parametrize(
    "batch,shape,iterations,robust,with_init,with_offset",
    [
        (2, (40, 48), 20, None, False, False),
        (1, (40, 48), 20, None, True, True),
        (2, (40, 48), 20, (3.0, 0.1), True, True),
        (1, (33, 45), 16, (3.0, 0.1), False, False),
    ],
    ids=["quadratic_batch2", "quadratic_init_offset", "charbonnier_batch2_init_offset",
         "charbonnier_one_chunk_odd"],
)
def test_hs_relax_matches_pallas_interpret(batch, shape, iterations, robust, with_init,
                                           with_offset):
    """20 iterations = one full chunk of 16 and a remainder of 4: in
    Charbonnier mode the weights are refreshed between them."""
    rng = np.random.default_rng(1)
    frames = [_pair(*shape, seed=s) for s in range(batch)]
    p = np.stack([f[0] for f in frames]).reshape((batch,) + shape if batch > 1 else shape)
    n = np.stack([f[1] for f in frames]).reshape(p.shape)
    f0 = rng.normal(0, 1, p.shape + (2,)).astype(np.float32) if with_init else None
    off = rng.normal(0, 5, p.shape).astype(np.float32) if with_offset else None
    want = jhs_sweep.hs_relax(
        _j(p), _j(n), None if f0 is None else _j(f0), iterations=iterations, alpha=10.0,
        temporal_kernel="gauss3", interpret=True,
        it_offset=None if off is None else _j(off), robust=robust,
    )
    got = hs_sweep.hs_relax(
        _t(p), _t(n), None if f0 is None else _t(f0), iterations=iterations, alpha=10.0,
        temporal_kernel="gauss3", it_offset=None if off is None else _t(off), robust=robust,
    )
    assert tuple(got.shape) == p.shape + (2,) and got.dtype == torch.float32
    _close(got, want, RELAX_TOL)


@pytest.mark.parametrize("with_init", [False, True])
def test_hs_relax_zero_iterations_is_identity(with_init):
    p, n = _pair(12, 16)
    f0 = np.full((12, 16, 2), 0.5, np.float32) if with_init else None
    want = jhs_sweep.hs_relax(_j(p), _j(n), None if f0 is None else _j(f0), iterations=0,
                              alpha=10.0, temporal_kernel="gauss3")
    got = hs_sweep.hs_relax(_t(p), _t(n), None if f0 is None else _t(f0), iterations=0,
                            alpha=10.0, temporal_kernel="gauss3")
    _close(got, want, 0.0)


def test_hs_wrappers_cpu_plain_and_no_launches():
    p, n = _pair(24, 32)
    wrappers = (hs_sweep.hs_relax, warp_select.warp_bilinear_select, pyr_down.pyr_down)
    before = [fn.launches for fn in wrappers]
    kw = dict(iterations=18, alpha=8.0, temporal_kernel="dt3", robust=(3.0, 0.1))
    torch.testing.assert_close(hs_sweep.hs_relax(_t(p), _t(n), None, **kw),
                               hs_sweep.hs_relax_plain(_t(p), _t(n), None, **kw), rtol=0, atol=0)
    tof.pyramidal_hs(_t(p), _t(n), tof.HSConfig(levels=2, iterations=5))
    assert [fn.launches for fn in wrappers] == before


def test_hs_relax_raises_off_cpu_and_cuda():
    """Only CPU tensors take the plain version; anything else launches or raises."""
    meta = torch.empty(16, 16, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        hs_sweep.hs_relax(meta, meta, None, iterations=4, alpha=10.0, temporal_kernel="gauss3")


# --- models.horn_schunck ----------------------------------------------------


def test_hs_config_matches_jax():
    t_fields = [(f.name, f.default) for f in dataclasses.fields(ths.HSConfig)]
    j_fields = [(f.name, f.default) for f in dataclasses.fields(jhs.HSConfig)]
    assert t_fields == j_fields
    for bad in ({"alpha": 0.0}, {"iterations": 0}, {"levels": 0}, {"c_max": -1},
                {"penalty": "huber"}, {"eps_smooth": 0.0}):
        with pytest.raises(ValueError):
            jhs.HSConfig(**bad)
        with pytest.raises(ValueError):
            ths.HSConfig(**bad)
    kw = dict(levels=2, prefilter=jconfig.BilateralConfig(window=5), max_displacement=8, c_max=2)
    want = jhs.lk_preproc_config(jhs.HSConfig(**kw))
    tkw = dict(kw, prefilter=tof.BilateralConfig(window=5))
    assert dataclasses.asdict(ths.lk_preproc_config(ths.HSConfig(**tkw))) == dataclasses.asdict(want)


@pytest.mark.parametrize(
    "jcfg",
    [jhs.HSConfig(),
     jhs.HSConfig(penalty="charbonnier", eps_data=2.0, eps_smooth=0.2, alpha=20.0,
                  prefilter=jconfig.BilateralConfig(window=7), use_pallas=False)],
    ids=["default", "charbonnier_prefilter"],
)
def test_hs_config_from_jax(jcfg):
    got = hs_config_from_jax(jcfg)
    assert isinstance(got, tof.HSConfig)
    assert dataclasses.asdict(got) == dataclasses.asdict(jcfg)
    if jcfg == jhs.HSConfig():
        assert got == tof.HSConfig()


def _both(jcfg):
    t = hs_config_from_jax(jcfg)
    return [dataclasses.replace(t, use_pallas=True), dataclasses.replace(t, use_pallas=False)]


@pytest.mark.parametrize("penalty", ["quadratic", "charbonnier"])
def test_pyramidal_hs_matches_jax(penalty):
    """Two levels, 40 sweeps per level (two Charbonnier chunks and a
    remainder); a (2, 1) px motion stays inside the 32 px warp budget, so the
    kernel path's clamp changes nothing and both port paths meet the twin."""
    p, n = _pair(64, 80, velocity=(2.0, 1.0))
    jcfg = jhs.HSConfig(levels=2, iterations=40, penalty=penalty, use_pallas=False)
    want = jhs.pyramidal_hs_jit(_j(p), _j(n), jcfg)
    for tcfg in _both(jcfg):
        got = tof.pyramidal_hs(_t(p), _t(n), tcfg)
        assert tuple(got.shape) == (64, 80, 2)
        _close(got, want, FLOW_TOL)


@pytest.mark.parametrize("penalty", ["quadratic", "charbonnier"])
def test_pyramidal_hs_recovers_translation_like_jax(penalty):
    """The card's HS check at a reduced size: the default HSConfig (3 levels,
    100 sweeps) on a period-24 texture moving (2, 1) px; both packages
    recover it, and agree."""
    p, n = _pair(128, 160, velocity=(2.0, 1.0))
    jcfg = jhs.HSConfig(penalty=penalty, use_pallas=False)
    want = np.asarray(jhs.pyramidal_hs_jit(_j(p), _j(n), jcfg))
    got = tof.pyramidal_hs(_t(p), _t(n), hs_config_from_jax(jcfg)).numpy()
    for flow in (want, got):
        m = np.median(flow[24:-24, 24:-24].reshape(-1, 2), axis=0)
        np.testing.assert_allclose(m, [2.0, 1.0], atol=TRANSLATION_TOL)
    _close(got, want, FLOW_TOL)


def test_hs_with_prefilter_and_init_flow_matches_jax():
    """hs_preprocess with the bilateral prefilter, then hs_coarse_to_fine
    warm-started from a coarse flow."""
    p, n = _pair(48, 64, velocity=(1.0, 0.5))
    jcfg = jhs.HSConfig(levels=2, iterations=12, prefilter=jconfig.BilateralConfig(),
                        use_pallas=False)
    jp, jn = jhs.hs_preprocess(_j(p), jcfg), jhs.hs_preprocess(_j(n), jcfg)
    init = np.full((24, 32, 2), 0.25, np.float32)
    want = jhs.hs_coarse_to_fine(jp, jn, jcfg, _j(init))
    for tcfg in _both(jcfg):
        tp, tn = ths.hs_preprocess(_t(p), tcfg), ths.hs_preprocess(_t(n), tcfg)
        for g, w in zip(tp + tn, jp + jn):
            _close(g, w, RELAX_TOL)
        _close(ths.hs_coarse_to_fine(tp, tn, tcfg, _t(init)), want, FLOW_TOL)


def test_horn_schunck_single_scale_matches_jax():
    p, n = _pair(96, 128, velocity=(0.7, 0.4))
    jcfg = jhs.HSConfig(alpha=8.0, iterations=200, levels=1, use_pallas=False)
    want = np.asarray(jhs.horn_schunck(_j(p), _j(n), jcfg))
    got = tof.horn_schunck(_t(p), _t(n), hs_config_from_jax(jcfg)).numpy()
    _close(got, want, FLOW_TOL)
    m = np.median(got[16:-16, 16:-16].reshape(-1, 2), axis=0)
    np.testing.assert_allclose(m, [0.7, 0.4], atol=TRANSLATION_TOL)


def test_batched_pyramidal_hs_matches_single():
    p, n = _pair(48, 64)
    cfg = tof.HSConfig(levels=2, iterations=20, penalty="charbonnier")
    batch = tof.pyramidal_hs(_t(np.stack([p, n])), _t(np.stack([n, p])), cfg)
    torch.testing.assert_close(batch[0], tof.pyramidal_hs(_t(p), _t(n), cfg), rtol=0, atol=1e-6)
    torch.testing.assert_close(batch[1], tof.pyramidal_hs(_t(n), _t(p), cfg), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="shapes differ"):
        tof.pyramidal_hs(_t(p), _t(n[:, :32]), cfg)
