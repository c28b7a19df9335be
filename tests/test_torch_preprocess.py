"""The port's prefilter, pyramid and the REFERENCE_GPU live loop against the
JAX package (CPU).

On CPU tensors each kernel wrapper (``bilateral_tap.bilateral_kernel``,
``pyr_down.pyr_down``) takes its plain version; these tests hold that
version to the JAX op, to the Pallas kernel in interpret mode, and the
whole ``REFERENCE_GPU`` loop to the JAX package's XLA twin.  The CUDA
kernels themselves are held to the plain versions on the card by
chip_smoke.py.

Tolerances: 1e-4 for intensities on 0-255 data (float32 summation order
differs: banded matmuls in JAX, separable slices or a tap loop here); 2e-4
px for flow, as tests/test_torch_kernels.py; the translation checks 0.1 px,
the verify recipe's rule.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cuda_optical_flow_2_tpu as jof
from cuda_optical_flow_2_tpu import constants as jconst
from cuda_optical_flow_2_tpu.kernels import bilateral_tap as jbilateral_tap
from cuda_optical_flow_2_tpu.kernels.pyr_down import pyr_down_pallas
from cuda_optical_flow_2_tpu.models import streaming as jstream
from cuda_optical_flow_2_tpu.models.lucas_kanade import preprocess as jpreprocess
from cuda_optical_flow_2_tpu.ops import bilateral as jbilateral
from cuda_optical_flow_2_tpu.ops import pyramid as jpyr
from cuda_optical_flow_2_tpu.ops import resize as jresize

import cuda_optical_flow_2_torch as tof
from cuda_optical_flow_2_torch import constants as tconst
from cuda_optical_flow_2_torch.interop import flow_state_from_numpy, lk_config_from_jax
from cuda_optical_flow_2_torch.kernels import bilateral_tap, pyr_down
from cuda_optical_flow_2_torch.models import streaming as tstream
from cuda_optical_flow_2_torch.ops import bilateral as tbilateral
from cuda_optical_flow_2_torch.ops import pyramid as tpyr
from cuda_optical_flow_2_torch.ops import resize as tresize
from cuda_optical_flow_2_torch.utils.io import synthetic_sequence

IMG_TOL = 1e-4
FLOW_TOL = 2e-4
TRANSLATION_TOL = 0.1

_jax_pyramid = jax.jit(jof.pyramidal_lk_pyramid, static_argnames=("config",))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _j(a):
    return jnp.asarray(np.asarray(a, np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(
        np.asarray(got, np.float32), np.asarray(want, np.float32), rtol=tol, atol=tol
    )


# --- constants --------------------------------------------------------------


@pytest.mark.parametrize("sigma,size", [(2.0, 9), (1.5, 5), (3.0, -1), (1.0, 8), (4.0, 19)])
def test_generate_gaussian_kernel_equal_to_jax(sigma, size):
    got = tconst.generate_gaussian_kernel(sigma, size)
    want = jconst.generate_gaussian_kernel(sigma, size)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)


# --- kernel #4: pyr_down ----------------------------------------------------


@pytest.mark.parametrize("shape", [(64, 128), (61, 200)])
def test_pyr_down_matches_xla_and_pallas_interpret(rng, shape):
    x = rng.normal(0, 50, shape).astype(np.float32)
    want_xla = np.asarray(jpyr.pyr_down(_j(x), use_pallas=False))
    want_pallas = np.asarray(pyr_down_pallas(_j(x), interpret=True))
    for got in (
        pyr_down.pyr_down(_t(x)),
        tpyr.pyr_down(_t(x)),
        tpyr.pyr_down(_t(x), use_pallas=False),
    ):
        assert tuple(got.shape) == want_xla.shape
        _close(got, want_xla, IMG_TOL)
        _close(got, want_pallas, IMG_TOL)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_build_pyramid_matches_jax(rng, use_pallas):
    x = rng.integers(0, 256, (2, 75, 98)).astype(np.float32)
    want = jpyr.build_pyramid(_j(x), 4)
    got = tpyr.build_pyramid(_t(x), 4, use_pallas=use_pallas)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        _close(g, w, IMG_TOL)


# a 5-tap Gaussian (sigma 1): not the binomial, so both packages take their
# plain forms (JAX: the banded matmuls; the port: strided slices)
_GAUSS5 = np.exp(-0.5 * np.arange(-2, 3) ** 2) / np.exp(-0.5 * np.arange(-2, 3) ** 2).sum()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(64, 128), (2, 61, 75)])
def test_pyr_down_kernel_1d_matches_jax(rng, monkeypatch, shape, dtype):
    """JAX's signature ``pyr_down(x, kernel_1d, use_pallas)``: a non-binomial
    kernel_1d (positional, as a JAX caller passes it) computes JAX's
    function and never reaches kernel #4; the binomial with ``use_pallas``
    does (on the CPU the wrapper then takes its plain version)."""
    x = rng.normal(0, 50, shape).astype(dtype)
    calls = []
    orig = pyr_down.pyr_down
    monkeypatch.setattr(pyr_down, "pyr_down", lambda t: calls.append(t.shape) or orig(t))
    with jax.enable_x64(True):
        want = np.asarray(jpyr.pyr_down(jnp.asarray(x), _GAUSS5))
        want_pyr = [np.asarray(a) for a in jpyr.build_pyramid(jnp.asarray(x), 3, _GAUSS5)]
    tol = IMG_TOL if dtype == np.float32 else 1e-9
    for use_pallas in (True, False):
        got = tpyr.pyr_down(torch.from_numpy(x), _GAUSS5, use_pallas)
        assert got.dtype == torch.from_numpy(x).dtype and tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
        pyr = tpyr.build_pyramid(torch.from_numpy(x), 3, _GAUSS5, use_pallas)
        assert [tuple(g.shape) for g in pyr] == [w.shape for w in want_pyr]
        for g, w in zip(pyr, want_pyr):
            np.testing.assert_allclose(g.numpy(), w, rtol=tol, atol=tol)
    assert calls == []
    tpyr.pyr_down(torch.from_numpy(x), tconst.BINOMIAL_1D, True)
    tpyr.build_pyramid(torch.from_numpy(x), 2)
    assert len(calls) == 2
    with pytest.raises(ValueError, match="odd length"):
        tpyr.pyr_down(torch.from_numpy(x), np.ones(4, np.float32) / 4)


def test_pyr_down_takes_strided_views(rng):
    """A flow component (stride 2) gives what its contiguous copy gives,
    and downsample_flow agrees with the JAX package on both paths."""
    flow = rng.normal(0, 3, (45, 62, 2)).astype(np.float32)
    tf = _t(flow)
    torch.testing.assert_close(pyr_down.pyr_down(tf[..., 1]), pyr_down.pyr_down(tf[..., 1].clone()),
                               rtol=0, atol=0)
    want = jresize.downsample_flow(_j(flow), (11, 15))
    for use_pallas in (True, False):
        _close(tresize.downsample_flow(tf, (11, 15), use_pallas), want, IMG_TOL)


# --- kernel #5: bilateral_kernel -------------------------------------------


@pytest.mark.parametrize(
    "shape,window,sigmas", [((64, 80), 9, (2.0, 10.0)), ((3, 40, 48), 5, (1.5, 8.0))]
)
def test_bilateral_matches_jax(rng, shape, window, sigmas):
    img = rng.integers(0, 256, shape).astype(np.float32)
    want = jbilateral.bilateral_filter(_j(img), None, window, *sigmas)
    _close(tbilateral.bilateral_filter(_t(img), None, window, *sigmas), want, IMG_TOL)
    _close(bilateral_tap.bilateral_kernel(_t(img), window, *sigmas), want, IMG_TOL)


def test_bilateral_matches_pallas_interpret(rng):
    img = rng.integers(0, 256, (16, 24)).astype(np.float32)
    want = jbilateral_tap.bilateral_kernel(_j(img), 5, 2.0, 10.0, interpret=True)
    _close(bilateral_tap.bilateral_kernel(_t(img), 5, 2.0, 10.0), want, IMG_TOL)


def test_bilateral_uint8_and_separate_guide(rng):
    img = rng.integers(0, 256, (30, 36)).astype(np.uint8)
    guide = rng.integers(0, 256, (30, 36)).astype(np.float32)
    want = jbilateral.bilateral_filter(jnp.asarray(img), _j(guide), 7, 2.0, 10.0)
    got = bilateral_tap.bilateral_kernel(torch.from_numpy(img), 7, 2.0, 10.0, guide=_t(guide))
    assert got.dtype == torch.float32
    _close(got, want, IMG_TOL)


def test_new_kernel_wrappers_cpu_plain_and_no_launches(rng):
    img = _t(rng.integers(0, 256, (2, 24, 30)).astype(np.float32))
    wrappers = (bilateral_tap.bilateral_kernel, pyr_down.pyr_down)
    before = [fn.launches for fn in wrappers]
    torch.testing.assert_close(bilateral_tap.bilateral_kernel(img, 9),
                               bilateral_tap.bilateral_kernel_plain(img, 9), rtol=0, atol=0)
    torch.testing.assert_close(pyr_down.pyr_down(img), pyr_down.pyr_down_plain(img), rtol=0, atol=0)
    assert [fn.launches for fn in wrappers] == before


def test_new_kernel_wrappers_raise_off_cpu_and_cuda():
    """Only a CPU tensor takes the plain version; over the kernel's window
    limit the wrapper raises rather than falling back."""
    meta = torch.empty(16, 16, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        pyr_down.pyr_down(meta)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        bilateral_tap.bilateral_kernel(meta, 9)
    with pytest.raises(ValueError, match="window"):
        bilateral_tap.bilateral_kernel(meta, bilateral_tap.MAX_WINDOW + 2)


# --- the REFERENCE_GPU live loop --------------------------------------------


def _frames(n, h, w, **kw):
    return synthetic_sequence(n, h, w, **kw).astype(np.float32)


REF_GPU = dataclasses.replace(jof.REFERENCE_GPU, use_pallas=False)


def _both(jcfg):
    t = lk_config_from_jax(jcfg)
    return [dataclasses.replace(t, use_pallas=True), dataclasses.replace(t, use_pallas=False)]


def test_preprocess_prefilter_matches_jax():
    fr = _frames(1, 70, 90)[0]
    want = jpreprocess(_j(fr), REF_GPU)
    for tcfg in _both(REF_GPU):
        got = tof.preprocess(_t(fr), tcfg)
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            _close(g, w, IMG_TOL)


def test_reference_gpu_pyramid_matches_jax():
    fr = _frames(2, 96, 128, period=48)
    want = [np.asarray(f) for f in _jax_pyramid(_j(fr[0]), _j(fr[1]), REF_GPU)]
    for tcfg in _both(REF_GPU):
        got = tof.pyramidal_lk_pyramid(_t(fr[0]), _t(fr[1]), tcfg)
        for g, w in zip(got, want):
            _close(g, w, FLOW_TOL)


def test_reference_gpu_process_sequence_matches_jax():
    """The reference's cold live loop over four frames, device='cpu'."""
    frames = list(_frames(4, 96, 128, velocity=(1.5, 0.5), period=48))
    want = dict(jstream.process_sequence(frames, REF_GPU))
    for tcfg in _both(REF_GPU):
        got = dict(tof.process_sequence(frames, tcfg, device="cpu"))
        assert sorted(got) == sorted(want) == [1, 2, 3]
        for i in want:
            assert got[i].device.type == "cpu"
            _close(got[i], want[i], FLOW_TOL)


def test_prefiltered_lk_recovers_translation_like_jax():
    """The card's translation check, at a reduced size: both packages
    recover (2, 1) with a bilateral prefilter on a period-48 texture."""
    fr = _frames(2, 128, 160, velocity=(2.0, 1.0), period=48)
    jcfg = jof.LKConfig(levels=4, window=19, prefilter=jof.BilateralConfig(), use_pallas=False)
    want = np.asarray(jof.pyramidal_lk_jit(_j(fr[0]), _j(fr[1]), jcfg))
    got = tof.pyramidal_lk(_t(fr[0]), _t(fr[1]), lk_config_from_jax(jcfg)).numpy()
    for flow in (want, got):
        m = np.median(flow[24:-24, 24:-24].reshape(-1, 2), axis=0)
        np.testing.assert_allclose(m, [2.0, 1.0], atol=TRANSLATION_TOL)
    _close(got, want, FLOW_TOL)


def test_warm_serving_loop_carries_the_prefiltered_pyramid():
    frames = list(_frames(4, 64, 96, velocity=(2.0, 1.0), period=24))
    jcfg = jof.LKConfig(levels=1, window=15, prefilter=jof.BilateralConfig(), use_pallas=False)
    rec = jstream.RecoveryConfig(levels=3)
    want = dict(jstream.process_sequence(frames, jcfg, warm_start=True, recovery=rec))
    trec = tstream.RecoveryConfig(levels=3)
    got = dict(tof.process_sequence(frames, lk_config_from_jax(jcfg), True, trec, device="cpu"))
    for i in want:
        _close(got[i], want[i], FLOW_TOL)
    state = tof.init_state(_t(frames[0]), lk_config_from_jax(jcfg), trec)
    expect = jstream.init_state(_j(frames[0]), jcfg, rec)
    for g, w in zip(state.pyramid, expect.pyramid):
        _close(g, w, IMG_TOL)


# --- the device rule ----------------------------------------------------------


def test_arrays_go_to_cuda_unless_cpu_is_asked(monkeypatch):
    """Numpy frames default to the CUDA device: with none they raise rather
    than run on the CPU unasked; device='cpu' gives the JAX package's flows."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    frames = list(_frames(3, 48, 64))
    cfg = tof.LKConfig(levels=2, window=9)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        list(tof.process_sequence(frames, cfg))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        flow_state_from_numpy([frames[0]], None)
    want = dict(jstream.process_sequence(frames, jof.LKConfig(levels=2, window=9)))
    got = dict(tof.process_sequence(frames, cfg, device="cpu"))
    for i in want:
        _close(got[i], want[i], FLOW_TOL)
    # tensors keep their device whatever the default
    got_t = dict(tof.process_sequence([_t(f) for f in frames], cfg))
    for i in want:
        torch.testing.assert_close(got_t[i], got[i], rtol=0, atol=0)
    assert flow_state_from_numpy([frames[0]], None, device="cpu").pyramid[0].device.type == "cpu"
