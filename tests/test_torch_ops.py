"""PyTorch port ops against the JAX package's ops (CPU, small sizes).

The same numpy inputs go through both; JAX gets explicit float32 arrays
(tests/conftest.py turns x64 on for the whole process).  Tolerances:
image-valued ops rtol 1e-5 / atol 1e-4 (float32, summation order differs);
config, constants and integer-valued results exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cuda_optical_flow_2_tpu import config as jcfg
from cuda_optical_flow_2_tpu import constants as jconst
from cuda_optical_flow_2_tpu.ops import conv as jconv
from cuda_optical_flow_2_tpu.ops import gradients as jgrad
from cuda_optical_flow_2_tpu.ops import median as jmed
from cuda_optical_flow_2_tpu.ops import pyramid as jpyr
from cuda_optical_flow_2_tpu.ops import resize as jresize
from cuda_optical_flow_2_tpu.ops import solve as jsolve
from cuda_optical_flow_2_tpu.ops import warp as jwarp
from cuda_optical_flow_2_tpu.ops import window as jwin

from cuda_optical_flow_2_torch import config as tcfg
from cuda_optical_flow_2_torch import constants as tconst
from cuda_optical_flow_2_torch.ops import conv as tconv
from cuda_optical_flow_2_torch.ops import gradients as tgrad
from cuda_optical_flow_2_torch.ops import median as tmed
from cuda_optical_flow_2_torch.ops import pyramid as tpyr
from cuda_optical_flow_2_torch.ops import resize as tresize
from cuda_optical_flow_2_torch.ops import solve as tsolve
from cuda_optical_flow_2_torch.ops import warp as twarp
from cuda_optical_flow_2_torch.ops import window as twin

RTOL, ATOL = 1e-5, 1e-4


def _j(a):
    return jnp.asarray(np.asarray(a, np.float32))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(
        np.asarray(got, np.float32), np.asarray(want, np.float32), rtol=rtol, atol=atol
    )


def _img(rng, *shape):
    return rng.integers(0, 256, shape).astype(np.float32)


# --- config and constants: exact ---------------------------------------


@pytest.mark.parametrize(
    "name", ["LKConfig", "BilateralConfig", "REFERENCE_GPU", "REFERENCE_CPU", "PAPER_1080P"]
)
def test_config_equal_to_jax(name):
    j, t = getattr(jcfg, name), getattr(tcfg, name)
    if isinstance(j, type):
        j, t = j(), t()
    assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


@pytest.mark.parametrize(
    "bad",
    [
        {"window": 8}, {"levels": 0}, {"iterations": 0}, {"c_max": -1}, {"d_local": 0},
        {"warp_mode": "cubic"}, {"temporal_kernel": "dt5"}, {"window_method": "fft"},
        {"window_weights": "hann"},
    ],
)
def test_config_validation_matches_jax(bad):
    with pytest.raises(ValueError):
        jcfg.LKConfig(**bad)
    with pytest.raises(ValueError):
        tcfg.LKConfig(**bad)


def test_constants_equal_to_jax():
    for name, mask in tconst.MASKS.items():
        assert mask.dtype == jconst.MASKS[name].dtype
        np.testing.assert_array_equal(mask, jconst.MASKS[name])
    np.testing.assert_array_equal(tconst.BINOMIAL_1D, jconst.BINOMIAL_1D)
    # every uppercase array of the JAX module has an equal counterpart
    arrays = [n for n in dir(jconst) if n.isupper() and isinstance(getattr(jconst, n), np.ndarray)]
    assert len(arrays) >= 15
    for name in arrays:
        got, want = getattr(tconst, name), getattr(jconst, name)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
        assert name in tconst.__all__


# --- stencils ------------------------------------------------------------


@pytest.mark.parametrize("mask", ["sobel_x", "dt3", "gauss3"])
def test_conv2d_matches_jax(rng, mask):
    x = _img(rng, 2, 23, 31)
    m = tconst.MASKS[mask]
    _close(tconv.conv2d(_t(x), m), jconv.conv2d(_j(x), m))


def test_sep_conv2d_matches_jax(rng):
    x = _img(rng, 29, 37)
    col, row = np.array([1.0, 2.0, 3.0, 2.0, 1.0]), np.array([0.5, 1.0, 0.25])
    _close(tconv.sep_conv2d(_t(x), col, row), jconv.sep_conv2d(_j(x), col, row))


# taps that float32 does not hold exactly: a tap rounded to float32 moves a
# float64 sum by ~1e-8 relative, far past the 1e-12 these cases hold
_FINE_MASK = np.array([[0.1, 1 / 3, 0.1], [0.2, -0.7, 1 / 7], [0.05, 0.3, 0.1]])
_FINE_COL, _FINE_ROW = np.array([0.1, 1 / 3, 0.4, 1 / 7, 0.1]), np.array([0.3, 1 / 3, 0.2])


@pytest.mark.parametrize("op", ["conv2d", "sep_conv2d"])
@pytest.mark.parametrize(
    "in_dtype,dtype",
    [(np.float64, None), (np.int32, None), (np.int32, "float64"), (np.float32, "float64")],
    ids=["f64", "int", "int_to_f64", "f32_to_f64"],
)
def test_conv_dtype_matches_jax_x64(rng, op, in_dtype, dtype):
    """JAX's keyword-only ``dtype`` (the accumulation and output dtype;
    None keeps a floating input's dtype, else float32), with the taps built
    in that dtype, under x64 on the JAX side."""
    x = rng.integers(0, 256, (2, 19, 23)).astype(in_dtype)
    args = (_FINE_MASK,) if op == "conv2d" else (_FINE_COL, _FINE_ROW)
    tdt = None if dtype is None else getattr(torch, dtype)
    got = getattr(tconv, op)(torch.from_numpy(x), *args, dtype=tdt)
    with jax.enable_x64(True):
        jdt = None if dtype is None else getattr(jnp, dtype)
        want = np.asarray(getattr(jconv, op)(jnp.asarray(x), *args, dtype=jdt))
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12 if want.dtype == np.float64 else 1e-6,
                               atol=1e-9 if want.dtype == np.float64 else 1e-3)


@pytest.mark.parametrize("kernel", ["dt3", "gauss3", "delta"])
@pytest.mark.parametrize("normalize", [True, False])
def test_gradients_match_jax(rng, kernel, normalize):
    p, n = _img(rng, 24, 40), _img(rng, 24, 40)
    for got, want in zip(
        tgrad.spatial_gradients(_t(p), normalize), jgrad.spatial_gradients(_j(p), normalize)
    ):
        _close(got, want)
    _close(
        tgrad.temporal_gradient(_t(p), _t(n), kernel, normalize),
        jgrad.temporal_gradient(_j(p), _j(n), kernel, normalize),
    )


# --- window sums and solve -----------------------------------------------


@pytest.mark.parametrize("weights", ["box", "tri", "gauss"])
@pytest.mark.parametrize("window", [5, 15, 19])
def test_window_taps_and_sum_match_jax(rng, weights, window):
    np.testing.assert_array_equal(
        twin.window_weight_taps(window, weights), jwin.window_weight_taps(window, weights)
    )
    x = rng.normal(0, 50, (2, 30, 41)).astype(np.float32)
    _close(
        twin.window_sum(_t(x), window, weights=weights),
        jwin.window_sum(_j(x), window, weights=weights),
        atol=1e-3,  # sums of ~window^2 values of magnitude ~50
    )


def test_structure_tensor_sums_match_jax(rng):
    ix, iy, it = (rng.normal(0, 20, (26, 33)).astype(np.float32) for _ in range(3))
    got = twin.structure_tensor_sums(_t(ix), _t(iy), _t(it), 9, weights="tri")
    want = jwin.structure_tensor_sums(_j(ix), _j(iy), _j(it), 9, weights="tri")
    for g, w in zip(got, want):
        _close(g, w, rtol=1e-5, atol=1e-2)  # products ~400, 81-tap sums


@pytest.mark.parametrize("method", ["cumsum", "reduce_window"])
def test_unported_window_methods_raise(method):
    """Both backends are ported now (they match the JAX package below); only
    an unknown method raises, as in the JAX package."""
    twin.window_sum(torch.zeros(8, 8), 3, method=method)
    with pytest.raises(ValueError, match="method"):
        twin.window_sum(torch.zeros(8, 8), 3, method=method + "_typo")


@pytest.mark.parametrize("method", ["cumsum", "reduce_window"])
@pytest.mark.parametrize("window,shape", [(3, (2, 30, 41)), (9, (26, 33)), (15, (12, 19))],
                         ids=["3x3_batch2", "9x9", "15x15_wider_than_tall"])
def test_window_sum_backends_match_jax(rng, method, window, shape):
    """Box sums of ~window^2 values of magnitude ~50: the integral image's
    float32 prefix sums (up to ~1e4 here) cost a few ulps of that size."""
    x = rng.normal(0, 50, shape).astype(np.float32)
    got = twin.window_sum(_t(x), window, method)
    _close(got, jwin.window_sum(_j(x), window, method), atol=2e-3)
    _close(got, twin.window_sum(_t(x), window), atol=2e-3)  # the sep_conv backend


@pytest.mark.parametrize("with_valid", [False, True])
@pytest.mark.parametrize("weights", ["box", "tri"])
def test_centered_structure_tensor_sums_match_jax(rng, with_valid, weights):
    """Products ~400 and 81-tap sums, centered: S_ab - S_a S_b / n cancels,
    so the tolerance is the raw sums' (atol 1e-2) plus that cancellation."""
    ix, iy, it = (rng.normal(0, 20, (26, 33)).astype(np.float32) for _ in range(3))
    valid = (rng.random((26, 33)) > 0.2) if with_valid else None
    got = twin.centered_structure_tensor_sums(
        _t(ix), _t(iy), _t(it), 9, valid=None if valid is None else torch.from_numpy(valid),
        weights=weights,
    )
    want = jwin.centered_structure_tensor_sums(
        _j(ix), _j(iy), _j(it), 9, valid=None if valid is None else jnp.asarray(valid),
        weights=weights,
    )
    for g, w in zip(got, want):
        _close(g, w, rtol=1e-4, atol=2e-2)


@pytest.mark.parametrize("size", [1, 3, 5])
@pytest.mark.parametrize("shape", [(19, 26), (2, 23, 31)])
def test_median_filter_bit_equal_to_jax(rng, size, shape):
    """An odd count's median is one of its inputs: sort-based selection and
    the JAX min/max network agree exactly (ties and repeated values too)."""
    x = rng.normal(0, 3, shape).astype(np.float32)
    x[..., :4, :4] = 1.5  # a flat patch: ties
    got = tmed.median_filter(_t(x), size).numpy()
    np.testing.assert_array_equal(got, np.asarray(jmed.median_filter(_j(x), size), np.float32))


def test_median_filter_rejects_even_size():
    for size in (0, 4):
        with pytest.raises(ValueError, match="odd"):
            tmed.median_filter(torch.zeros(8, 8), size)


def test_solve_matches_jax(rng):
    sums = [rng.normal(0, 10, (17, 19)).astype(np.float32) for _ in range(5)]
    sums[0][0, :3] = sums[1][0, :3] = sums[2][0, :3] = 0.0  # det == 0
    _close(
        tsolve.solve_2x2(*map(_t, sums), eps=1e-3), jsolve.solve_2x2(*map(_j, sums), eps=1e-3),
        rtol=1e-4,  # 1/det amplifies the float order of det
    )
    got = tsolve.solve_2x2_unguarded(*map(_t, sums)).numpy()
    want = np.asarray(jsolve.solve_2x2_unguarded(*map(_j, sums)), np.float32)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    _close(got[fin], want[fin], rtol=1e-4)


# --- warps ---------------------------------------------------------------


def _flow(rng, h, w, amp):
    f = rng.normal(0, amp, (h, w, 2)).astype(np.float32)
    f[0, 0] = [np.nan, 0.0]
    f[1, 1] = [0.0, np.inf]
    return f


def test_warp_bilinear_matches_jax(rng):
    img = _img(rng, 2, 20, 27)
    flow = np.stack([_flow(rng, 20, 27, 6.0), _flow(rng, 20, 27, 6.0)])
    _close(twarp.warp_bilinear(_t(img), _t(flow)), jwarp.warp_bilinear(_j(img), _j(flow)))


def test_warp_nearest_matches_jax_exactly(rng):
    img = _img(rng, 21, 25)
    flow = _flow(rng, 21, 25, 6.0)
    np.testing.assert_array_equal(
        twarp.warp_nearest(_t(img), _t(flow)).numpy(),
        np.asarray(jwarp.warp_nearest(_j(img), _j(flow)), np.float32),
    )


# --- pyramid and resize --------------------------------------------------


@pytest.mark.parametrize("shape", [(32, 48), (33, 47), (2, 35, 50)])
def test_build_pyramid_matches_jax(rng, shape):
    x = _img(rng, *shape)
    got = tpyr.build_pyramid(_t(x), 3)
    want = jpyr.build_pyramid(_j(x), 3)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("target", [(24, 34), (25, 35), (24, 35)])
def test_upsample_flow_matches_jax(rng, target):
    """The pyramid octaves take the exact 2x stencil; any other size (DIS's
    finest_level > 1) the bilinear resize, jax.image.resize's function."""
    f = rng.normal(0, 3, (12, 17, 2)).astype(np.float32)
    _close(tresize.upsample_flow(_t(f), target), jresize.upsample_flow(_j(f), target))
    _close(tresize.upsample_flow(_t(f), (40, 60)), jresize.upsample_flow(_j(f), (40, 60)))


def test_downsample_flow_matches_jax(rng):
    f = rng.normal(0, 3, (2, 45, 66, 2)).astype(np.float32)
    _close(tresize.downsample_flow(_t(f), (11, 16)), jresize.downsample_flow(_j(f), (11, 16)))
    with pytest.raises(ValueError):
        tresize.downsample_flow(_t(f), (30, 16))
