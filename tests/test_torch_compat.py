"""The port's bug-exact profiles (``models/compat.py``) and its numpy oracle
copies against the JAX package, and the port's ``pyramidal_lk_exact``
against the ten golden fields of ``tests/golden/``.

The JAX side runs as its own tests run it: on CPU with x64 on
(``tests/conftest.py``), so its solve is float64 like the port's.  Integer
stages are exactly equal; the CPU profile's flows (exact integer sums,
float64 solve) within 1e-6 with equal NaN/inf patterns; the GPU profile's
(float32 window sums in another order) within the 2e-3 of
``tests/test_compat.py``.
"""

import os
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import make_translating_pair
from cuda_optical_flow_2_tpu.models import compat as jcompat
from cuda_optical_flow_2_tpu.oracle import cpu_reference as jcpu
from cuda_optical_flow_2_tpu.oracle import gpu_reference as jgpu
from cuda_optical_flow_2_torch import constants as tconst
from cuda_optical_flow_2_torch.models import compat as tcompat
from cuda_optical_flow_2_torch.oracle import cpu_reference as tcpu
from cuda_optical_flow_2_torch.oracle import gpu_reference as tgpu

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
MASKS = {"dx": tconst.DX_3X3, "dy": tconst.DY_3X3, "gauss": tconst.GAUS_KERNEL_3X3,
         "dt": tconst.DT_3X3}
CPU_TOL = 1e-6
GPU_TOL = 2e-3  # float32 window sums in another order (tests/test_compat.py:101-111)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture
def img(rng):
    return rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)


def _assert_flows_close(got, want, tol, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    assert got.dtype == want.dtype == np.float32, what
    fg, fw = np.isfinite(got), np.isfinite(want)
    assert np.array_equal(fg, fw), f"{what}: non-finite patterns differ"
    assert np.array_equal(got[~fg], want[~fw], equal_nan=True), f"{what}: NaN/inf differ"
    np.testing.assert_allclose(got[fg], want[fw], rtol=tol, atol=tol, err_msg=what)


# --- stages against the JAX compat module ---------------------------------


@pytest.mark.parametrize("mask", ["dx", "dy", "gauss"])
def test_conv_u8_equal_to_jax(img, mask):
    got = tcompat.conv_3ch_to_1ch_u8(_t(img), MASKS[mask])
    want = jcompat.conv_3ch_to_1ch_u8(jnp.asarray(img), MASKS[mask])
    assert got.dtype == torch.uint8
    assert np.array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("mask", ["dx", "dt"])
def test_conv_f32_equal_to_jax(img, mask):
    got = tcompat.conv_3ch_1ch_f32(_t(img), MASKS[mask])
    want = jcompat.conv_3ch_1ch_f32(jnp.asarray(img), MASKS[mask])
    # integer-valued taps and pixels: every partial sum is exact in float32
    assert np.array_equal(_np(got), np.asarray(want))


def test_sub_arr_and_downscale_equal_to_jax(rng, img):
    a = rng.integers(0, 256, (33, 47), dtype=np.uint8)
    b = rng.integers(0, 256, (33, 47), dtype=np.uint8)
    assert np.array_equal(_np(tcompat.sub_arr_u8(_t(a), _t(b))),
                          np.asarray(jcompat.sub_arr_u8(jnp.asarray(a), jnp.asarray(b))))
    odd = img[:39, :55]  # odd sides: the decimation drops the last row/column
    assert np.array_equal(_np(tcompat.downscale_gaussian_u8(_t(odd))),
                          np.asarray(jcompat.downscale_gaussian_u8(jnp.asarray(odd))))


def test_pyramid_u8_equal_to_jax(img):
    got = tcompat.build_pyramid_u8(_t(img), 3)
    want = jcompat.build_pyramid_u8(jnp.asarray(img), 3)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        assert g.dtype == torch.uint8 and np.array_equal(_np(g), np.asarray(w))


@pytest.mark.parametrize("window", [1, 9, 19])
def test_srm_i32_equal_to_jax(rng, window):
    a = rng.integers(0, 256, (30, 41), dtype=np.uint8)
    b = rng.integers(0, 256, (30, 41), dtype=np.uint8)
    got = tcompat.srm_1ch_i32(_t(a), _t(b), window)
    want = jcompat.srm_1ch_i32(jnp.asarray(a), jnp.asarray(b), window)
    assert got.dtype == torch.int32
    assert np.array_equal(_np(got), np.asarray(want))


def test_shift_back_equal_to_jax(rng):
    src = rng.integers(0, 256, (16, 20, 3), dtype=np.uint8)
    flows = [np.zeros((16, 20, 2), np.float32),
             rng.normal(0, 2, (8, 10, 2)).astype(np.float32),
             rng.normal(0, 3, (4, 5, 2)).astype(np.float32)]
    got = tcompat.shift_back_exact(_t(src), 0, 3, [_t(f) for f in flows])
    want = jcompat.shift_back_exact(jnp.asarray(src), 0, 3, [jnp.asarray(f) for f in flows])
    assert np.array_equal(_np(got), np.asarray(want))
    assert np.array_equal(_np(got), jcpu.shift_back_pyramid(src, 0, 3, flows))


@pytest.mark.parametrize("profile", ["cpu", "gpu"])
def test_lk_level_exact_matches_jax(profile):
    prev, nxt = make_translating_pair(48, 64, dx=2, dy=1)
    flows = [np.zeros((48, 64, 2), np.float32), np.full((24, 32, 2), 0.6, np.float32)]
    window = 9 if profile == "cpu" else 19
    got = tcompat.lk_level_exact(_t(prev), _t(nxt), [_t(f) for f in flows], 0, 2, window, profile)
    want = jcompat.lk_level_exact(jnp.asarray(prev), jnp.asarray(nxt),
                                  [jnp.asarray(f) for f in flows], 0, 2, window, profile)
    _assert_flows_close(got, want, CPU_TOL if profile == "cpu" else GPU_TOL, profile)


@pytest.mark.parametrize("profile", ["cpu", "gpu"])
@pytest.mark.parametrize("shape,dxy", [((64, 64), (2, 1)), ((96, 128), (1, 1))])
def test_pyramidal_lk_exact_matches_jax(profile, shape, dxy):
    prev, nxt = make_translating_pair(*shape, dx=dxy[0], dy=dxy[1])
    got = tcompat.pyramidal_lk_exact(_t(prev), _t(nxt), levels=2, profile=profile)
    want = jcompat.pyramidal_lk_exact(jnp.asarray(prev), jnp.asarray(nxt), levels=2,
                                      profile=profile)
    for k, (g, w) in enumerate(zip(got, want)):
        _assert_flows_close(g, w, CPU_TOL if profile == "cpu" else GPU_TOL, f"{profile} L{k}")


def test_unknown_profile_raises():
    prev, nxt = make_translating_pair(16, 16)
    with pytest.raises(ValueError, match="unknown profile"):
        tcompat.pyramidal_lk_exact(_t(prev), _t(nxt), levels=1, profile="tpu")


# --- golden fields ---------------------------------------------------------


def _golden(name):
    return np.load(os.path.join(GOLDEN, name))


@pytest.mark.parametrize("profile", ["cpu", "gpu"])
def test_pyramidal_lk_exact_matches_golden(profile):
    """The ten golden files: the pair and each profile's four levels, held as
    tests/test_golden.py holds the JAX compat pipeline (the GPU profile at
    the tolerance of tests/test_compat.py)."""
    prev, nxt = _golden("pair_prev.npy"), _golden("pair_next.npy")
    flows = tcompat.pyramidal_lk_exact(_t(prev), _t(nxt), levels=4, profile=profile)
    tol = CPU_TOL if profile == "cpu" else GPU_TOL
    for k, f in enumerate(flows):
        want = _golden(f"{profile}_flow_L{k}.npy")
        got = _np(f)
        finite = np.isfinite(want).all(axis=-1)
        assert np.array_equal(finite, np.isfinite(got).all(axis=-1)), f"level {k}"
        np.testing.assert_allclose(got[finite], want[finite], rtol=tol, atol=tol,
                                   err_msg=f"level {k}")


# --- the numpy oracle copies -----------------------------------------------


def _oracle_cases(rng):
    img = rng.integers(0, 256, (24, 30, 3), dtype=np.uint8)
    img2 = rng.integers(0, 256, (24, 30, 3), dtype=np.uint8)
    a = rng.integers(0, 256, (20, 22), dtype=np.uint8)
    b = rng.integers(0, 256, (20, 22), dtype=np.uint8)
    sums = [rng.integers(-5000, 5000, (12, 14)).astype(np.int32) for _ in range(5)]
    sums[0][0, 0] = sums[1][0, 0] = sums[2][0, 0] = 0  # det == 0: inf/nan pass through
    fsums = [s.astype(np.float32) * 0.37 for s in sums]
    flows = [np.zeros((24, 30, 2), np.float32), rng.normal(0, 2, (12, 15, 2)).astype(np.float32)]
    prev, nxt = make_translating_pair(32, 32, dx=1, dy=1)
    return {
        "sub_arr": (img, img2),
        "grayscale_avg": (img,),
        "conv_3ch": (img, tconst.GAUS_KERNEL_3X3),
        "conv_3ch_to_1ch": (img, tconst.DX_3X3),
        "downscale_gaussian": (img, tconst.GAUS_KERNEL_3X3),
        "gauss_pyramid": (img, 3),
        "srm_1ch": (a, b, 5, 7),
        "srm_3ch": (img, img2, 5, 5),
        "inverse_matrix": tuple(sums),
        "shift_back_pyramid": (img, 0, 2, flows),
        "calc_optical_flow_pyramid": (tcpu.gauss_pyramid(prev, 2), tcpu.gauss_pyramid(nxt, 2)),
        "bilateral_filter_3ch": (img, img2, 5, 5, 2.0, 20.0),
        "gpu.conv_3ch_1ch_float": (img, tconst.DT_3X3),
        "gpu.srm_1ch_float": (fsums[0], fsums[1], 9, 9),
        "gpu.inverse_matrix_float": tuple(fsums),
        "gpu.gauss_pyramid": (img, 3),
        "gpu.calc_opt_flow_pyramid": (tgpu.gauss_pyramid(prev, 2), tgpu.gauss_pyramid(nxt, 2)),
    }


ORACLE_FNS = [
    "sub_arr", "grayscale_avg", "conv_3ch", "conv_3ch_to_1ch", "downscale_gaussian",
    "gauss_pyramid", "srm_1ch", "srm_3ch", "inverse_matrix", "shift_back_pyramid",
    "calc_optical_flow_pyramid", "bilateral_filter_3ch", "gpu.conv_3ch_1ch_float",
    "gpu.srm_1ch_float", "gpu.inverse_matrix_float", "gpu.gauss_pyramid",
    "gpu.calc_opt_flow_pyramid",
]


@pytest.mark.parametrize("name", ORACLE_FNS)
def test_oracle_copy_equal_to_jax_oracle(rng, name):
    args = _oracle_cases(rng)[name]
    if name.startswith("gpu."):
        fn, jfn = getattr(tgpu, name[4:]), getattr(jgpu, name[4:])
    else:
        fn, jfn = getattr(tcpu, name), getattr(jcpu, name)
    got, want = fn(*args), jfn(*args)
    got = got if isinstance(got, list) else [got]
    want = want if isinstance(want, list) else [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w, equal_nan=g.dtype.kind == "f")


def test_oracle_exports_match_jax():
    assert tcpu.__all__ == jcpu.__all__ and tgpu.__all__ == jgpu.__all__
    assert {f for f in ORACLE_FNS if "." not in f} | {
        "calc_optical_flow"} == set(jcpu.__all__)


def test_port_sources_import_no_jax():
    """No module of the port and not chip_smoke.py imports jax or the JAX
    package (a scan of the sources; test_torch_kernels.py imports them)."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|cuda_optical_flow_2_tpu)\b", re.M)
    files = sorted((ROOT / "cuda_optical_flow_2_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 40
    bad = [str(f.relative_to(ROOT)) for f in files if pat.search(f.read_text())]
    assert not bad, bad
