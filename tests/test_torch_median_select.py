"""TV-L1's median kernel (``kernels.median_select``) on the CPU.

On CPU tensors ``median_filter_kernel`` takes its plain version
(``ops.median.median_filter``); these tests hold it bit for bit to the JAX
package's ``median_filter`` (its min/max network, jitted), check the
dispatch that ``supported`` decides from the config, and run the CUDA
source's own compare-exchange networks in numpy: the tables between the
BEGIN/END markers of ``csrc/median_select.cu``, exhaustively over 0-1
inputs (the 0-1 principle: a comparator network that selects the median of
every 0-1 input selects it for every input) and over random, tied, +-0,
+-inf and NaN windows against ``np.median``.  The CUDA kernel itself is held
to the plain version on the card by chip_smoke.py.

TV-L1 on the kernel path against the JAX package: atol 1e-4 px, the bound
tests/test_tvl1.py holds the JAX kernel path to its XLA twin.
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cuda_optical_flow_2_tpu.models import tvl1 as jtvl1
from cuda_optical_flow_2_tpu.ops import median as jmed

import cuda_optical_flow_2_torch as tof
from cuda_optical_flow_2_torch.interop import tvl1_config_from_jax
from cuda_optical_flow_2_torch.kernels import _build, median_select
from cuda_optical_flow_2_torch.models import tvl1 as ttvl1
from cuda_optical_flow_2_torch.utils.io import synthetic_sequence

SOURCE = _build.SOURCES_DIR / "median_select.cu"
TVL1_TOL = 1e-4
_jmedian = jax.jit(jmed.median_filter, static_argnames=("size",))


def _network(k: int) -> list[tuple[int, int]]:
    """The exchanges of the k x k network, read from the CUDA source."""
    name = f"OF2_MED{k * k}_NET"
    text = SOURCE.read_text()
    body = re.search(rf"// BEGIN {name}\n(.*?)// END {name}\n", text, re.S)
    assert body, f"{name} not delimited in {SOURCE.name}"
    pairs = [(int(a), int(b)) for a, b in re.findall(r"X\((\d+), (\d+)\)", body.group(1))]
    assert pairs and all(0 <= a < k * k and 0 <= b < k * k and a != b for a, b in pairs)
    return pairs


def _run(net, vals: list) -> object:
    """The network on a list of same-shaped arrays (NaN-propagating
    np.minimum / np.maximum, as the kernel's min.NaN / max.NaN)."""
    v = list(vals)
    for a, b in net:
        v[a], v[b] = np.minimum(v[a], v[b]), np.maximum(v[a], v[b])
    return v[len(v) // 2]


def _windows(n: int, rng) -> np.ndarray:
    """(n, 4096) windows of n values: random, few distinct values (ties),
    +-0, +-inf and a few NaN columns."""
    cols = [rng.normal(0, 1, (n, 1024)),
            rng.integers(0, 3, (n, 1024)).astype(np.float64),
            rng.choice([0.0, -0.0, 1.0, -1.0], (n, 1024)),
            rng.choice([np.inf, -np.inf, 0.5, -0.0, 2.0], (n, 1024))]
    x = np.concatenate(cols, axis=1).astype(np.float32)
    x[rng.integers(0, n, 16), rng.integers(0, x.shape[1], 16)] = np.nan
    return x


def _bit_planes(n: int) -> tuple[list[np.ndarray], np.ndarray]:
    """Input j of all 2^n 0-1 inputs as a bit plane: bit i of the plane
    (word i // 64, bit i % 64) is bit j of i; and the wanted median plane:
    bit i set where at least (n + 1) / 2 bits of i are.  n >= 6."""
    words = np.arange(1 << (n - 6), dtype=np.uint64)
    bits = np.arange(64, dtype=np.uint64)
    ones = np.uint64(0xFFFFFFFFFFFFFFFF)

    def pattern(pred) -> np.uint64:
        return np.bitwise_or.reduce(np.where(pred, np.uint64(1) << bits, np.uint64(0)))

    planes = [np.full(words.shape, pattern((bits >> np.uint64(j)) & np.uint64(1)))
              for j in range(6)]
    planes += [np.where((words >> np.uint64(j - 6)) & np.uint64(1), ones, np.uint64(0))
               for j in range(6, n)]
    count_w = sum(((words >> np.uint64(j)) & np.uint64(1)).astype(np.int64) for j in range(n - 6))
    count_b = sum(((bits >> np.uint64(j)) & np.uint64(1)).astype(np.int64) for j in range(6))
    masks = np.array([pattern(count_b + c >= (n + 1) // 2) for c in range(n - 5)], np.uint64)
    return planes, masks[count_w]


@pytest.mark.parametrize("k", [3, 5])
def test_network_in_the_source_is_a_median_selector_0_1(k):
    """All 2^(k^2) 0-1 inputs at once, one bit each in bit planes, where an
    exchange is AND (min) and OR (max): the network's median wire is 1
    exactly where at least (k^2 + 1) / 2 inputs are."""
    v, want = _bit_planes(k * k)
    for a, b in _network(k):
        v[a], v[b] = v[a] & v[b], v[a] | v[b]
    assert np.array_equal(v[k * k // 2], want)


@pytest.mark.parametrize("k,live", [(3, 30), (5, 174)])
def test_network_live_operations(k, live):
    """The min and max operations whose results reach the median wire: what
    the compiler keeps of the exchanges, the kernel's cost per output
    (csrc/median_select.cu, PERF.md)."""
    need, count = {k * k // 2}, 0
    for a, b in reversed(_network(k)):
        hits = (a in need) + (b in need)
        if hits:
            count += hits
            need |= {a, b}
    assert count == live


@pytest.mark.parametrize("k", [3, 5])
def test_network_in_the_source_selects_the_median(k):
    """Random, tied, +-0, +-inf and NaN windows: the network's value equals
    np.median's (a NaN window gives NaN); +-0 compare equal."""
    net = _network(k)
    x = _windows(k * k, np.random.default_rng(k))
    got = _run(net, list(x))
    want = np.median(x, axis=0).astype(np.float32)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(want)
    assert np.array_equal(got[fin], want[fin])


@pytest.mark.parametrize("size", [3, 5])
@pytest.mark.parametrize("shape", [(19, 26), (3, 23, 31), (2, 2, 17, 9)])
def test_median_kernel_on_cpu_equals_jax(size, shape):
    """Sizes 3 and 5, a ragged batch and extra leading dims: bit-equal to
    the JAX package's network (ties from a flat patch included)."""
    x = np.random.default_rng(size).normal(0, 3, shape).astype(np.float32)
    x[..., :4, :4] = 1.5
    got = median_select.median_filter_kernel(torch.from_numpy(x), size).numpy()
    np.testing.assert_array_equal(got, np.asarray(_jmedian(jnp.asarray(x), size=size)))


@pytest.mark.parametrize("size", [3, 5])
def test_median_kernel_on_a_strided_flow_view_equals_jax(size):
    """TV-L1's input: the (2, H, W) ``movedim`` view of an (H, W, 2) flow."""
    f = np.random.default_rng(7).normal(0, 2, (21, 34, 2)).astype(np.float32)
    view = torch.from_numpy(f).movedim(-1, 0)
    assert not view.is_contiguous()
    got = median_select.median_filter_kernel(view, size).numpy()
    want = np.asarray(_jmedian(jnp.asarray(np.moveaxis(f, -1, 0)), size=size))
    np.testing.assert_array_equal(got, want)


def test_supported_sizes_are_the_compiled_networks():
    """3 and 5 are compiled in (a network each in the source); 1 and 7 up go
    to the plain filter."""
    text = SOURCE.read_text()
    assert median_select.SIZES == (3, 5)
    for k in median_select.SIZES:
        assert f"OF2_MED{k * k}_NET" in text
    assert [median_select.supported(k) for k in (1, 3, 5, 7, 9, 11)] == [
        False, True, True, False, False, False]


def test_median_kernel_raises_off_cpu_without_a_kernel():
    """Off the CPU the wrapper launches or raises, never falls back: an
    unsupported size raises first, a non-CUDA device then (no build)."""
    x = torch.empty((2, 8, 8), device="meta")
    with pytest.raises(ValueError, match="sizes"):
        median_select.median_filter_kernel(x, 7)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        median_select.median_filter_kernel(x, 5)


@pytest.mark.parametrize("size,use_pallas,kernel", [
    (5, True, True), (3, True, True), (7, True, False), (5, False, False)])
def test_tvl1_median_dispatch(monkeypatch, size, use_pallas, kernel):
    """``models.tvl1.tvl1_median`` takes the kernel's wrapper on the kernel
    path for a compiled size, else the plain filter; same values either
    way on CPU."""
    calls = []
    real = median_select.median_filter_kernel

    def spy(x, k):
        calls.append(k)
        return real(x, k)

    monkeypatch.setattr(median_select, "median_filter_kernel", spy)
    cfg = tof.TVL1Config(median_filtering=size, use_pallas=use_pallas)
    x = torch.from_numpy(np.random.default_rng(1).normal(0, 1, (2, 15, 22)).astype(np.float32))
    got = ttvl1.tvl1_median(x, cfg)
    assert calls == ([size] if kernel else [])
    assert torch.equal(got, median_select.median_filter_plain(x, size))


def test_tvl1_kernel_path_on_cpu_matches_jax(monkeypatch):
    """The whole TV-L1 kernel path on CPU tensors (one median wrapper call
    per warp) against the JAX package's XLA path."""
    calls = []
    real = median_select.median_filter_kernel
    monkeypatch.setattr(median_select, "median_filter_kernel",
                        lambda x, k: calls.append(k) or real(x, k))
    fr = synthetic_sequence(2, 64, 96, velocity=(2.0, 1.0), period=24, seed=0)
    p, n = (f.astype(np.float32) for f in fr)
    jcfg = jtvl1.TVL1Config(levels=2, warps=2, iterations=10, use_pallas=False)
    want = np.asarray(jtvl1.pyramidal_tvl1_jit(jnp.asarray(p), jnp.asarray(n), jcfg))
    cfg = dataclasses.replace(tvl1_config_from_jax(jcfg), use_pallas=True)
    got = tof.pyramidal_tvl1(torch.from_numpy(p), torch.from_numpy(n), cfg).numpy()
    assert calls == [5] * (cfg.levels * cfg.warps)
    np.testing.assert_allclose(got, want, rtol=0, atol=TVL1_TOL)
