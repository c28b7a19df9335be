"""The port's structure-tensor confidence against the JAX package (CPU).

The same numpy frames (made from a seed, the isolated bright squares of
tests/test_confidence.py, a ramp edge, a ``synthetic_sequence`` frame) go
through ``models.confidence`` of both packages (JAX jitted).

Tolerances: ``min_eigenvalue`` rtol 1e-5, atol 1e-4 (float order of the
window sums); ``confidence_mask`` equal outside pixels within that tolerance
of the threshold; ``good_features`` points and their order equal, scores at
the ``min_eigenvalue`` tolerance.  The squares pattern is symmetric and
gives exact score ties, whose order (lowest pixel index first, as
``lax.top_k``) the stable sort must keep.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cuda_optical_flow_2_tpu as jof
from cuda_optical_flow_2_tpu.models import confidence as jconf

import cuda_optical_flow_2_torch as tof
from cuda_optical_flow_2_torch.interop import lk_config_from_jax
from cuda_optical_flow_2_torch.models import confidence as tconf
from cuda_optical_flow_2_torch.utils.io import synthetic_sequence

RTOL, ATOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Torch on one thread: small plain ops spread over every core contend
    under several pytest workers (see tests/test_torch_spatial.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _squares():
    img = np.zeros((96, 128), np.float32)
    for cy, cx in [(30, 40), (30, 90), (70, 64)]:
        img[cy - 6 : cy + 6, cx - 6 : cx + 6] = 255.0
    return img


def _frame(name):
    rng = np.random.default_rng(0)
    if name == "squares":
        return _squares()
    if name == "texture":
        return rng.integers(0, 256, (64, 96)).astype(np.float32)
    if name == "half_flat":
        f = np.zeros((64, 96), np.float32)
        f[:, 48:] = rng.integers(0, 256, (64, 48))
        return f
    if name == "ramp_edge":
        xs = np.arange(96, dtype=np.float32)
        return np.broadcast_to(np.clip((xs - 48) * 20, 0, 255), (64, 96)).copy()
    return synthetic_sequence(1, 72, 104, period=24, seed=2)[0].astype(np.float32)


FRAMES = ["squares", "texture", "half_flat", "ramp_edge", "synthetic"]
CONFIGS = {
    "w9": jof.LKConfig(levels=2, window=9, use_pallas=False),
    "w15_raw": jof.LKConfig(levels=2, window=15, normalize_gradients=False, use_pallas=False),
}


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
@pytest.mark.parametrize("frame", FRAMES)
def test_min_eigenvalue_and_mask_match_jax(frame, cfg):
    img, jcfg = _frame(frame), CONFIGS[cfg]
    want = np.asarray(jconf.min_eigenvalue(jnp.asarray(img), jcfg))
    got = tconf.min_eigenvalue(torch.from_numpy(img), lk_config_from_jax(jcfg))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    thr = 1.0
    mask = tof.confidence_mask(torch.from_numpy(img), lk_config_from_jax(jcfg), threshold=thr)
    sure = np.abs(want - thr) > ATOL + RTOL * abs(thr)
    np.testing.assert_array_equal(
        mask.numpy()[sure], np.asarray(jconf.confidence_mask(jnp.asarray(img), jcfg, thr))[sure])


def test_min_eigenvalue_batched_matches_jax():
    imgs = np.stack([_frame("texture"), _frame("half_flat")])
    jcfg = CONFIGS["w9"]
    np.testing.assert_allclose(
        tconf.min_eigenvalue(torch.from_numpy(imgs), lk_config_from_jax(jcfg)).numpy(),
        np.asarray(jconf.min_eigenvalue(jnp.asarray(imgs), jcfg)), rtol=RTOL, atol=ATOL)


GF_CASES = {
    # (frame, window, n_points, min_distance)
    "squares_ties": ("squares", 9, 12, 5),
    "squares_wide": ("squares", 9, 40, 3),
    "texture": ("texture", 9, 50, 7),
    "synthetic": ("synthetic", 15, 30, 4),
    "fewer_peaks_than_points": ("ramp_edge", 9, 20, 7),
}


@pytest.mark.parametrize("case", sorted(GF_CASES))
def test_good_features_match_jax(case):
    name, window, n, md = GF_CASES[case]
    img = _frame(name)
    jcfg = jof.LKConfig(levels=2, window=window, iterations=2, use_pallas=False)
    jp, js = jax.jit(lambda f: jconf.good_features(f, jcfg, n, min_distance=md))(jnp.asarray(img))
    jp, js = np.asarray(jp), np.asarray(js)
    tp, ts = tof.good_features(torch.from_numpy(img), lk_config_from_jax(jcfg), n, md)
    assert tp.shape == (n, 2) and ts.shape == (n,) and tp.dtype == ts.dtype == torch.float32
    np.testing.assert_array_equal(tp.numpy(), jp)
    np.testing.assert_allclose(ts.numpy(), js, rtol=RTOL, atol=ATOL)
    if case == "squares_ties":
        pos = js[js > 0]
        assert len(pos) > len(np.unique(pos))  # the case exercises exact ties


def test_stable_sort_orders_ties_as_top_k():
    """Why the candidates come from a stable sort, not torch.topk."""
    x = np.array([1, 3, 3, 0, 3, 2, 3], np.float32)
    want = np.asarray(jax.lax.top_k(jnp.asarray(x), 5)[1])
    got = torch.sort(torch.from_numpy(x), descending=True, stable=True).indices[:5]
    np.testing.assert_array_equal(got.numpy(), want)
