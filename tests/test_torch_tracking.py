"""The port's sparse point tracking against the JAX package (CPU).

The same numpy flows, points and ``synthetic_sequence`` frames go through
``models.tracking`` of both packages (JAX jitted, ``use_pallas=False``).

Tolerances: ``sample_flow`` and ``advect_points`` atol 1e-5 (four bilinear
taps in float32), liveness equal; ``track_sequence`` and ``track_points``
positions within 1e-3 px of JAX's (whole pipelines per pair, accumulated
over the sequence), liveness and yielded frame indices equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import cuda_optical_flow_2_tpu as jof
from cuda_optical_flow_2_tpu.models import FBConfig as JFBConfig
from cuda_optical_flow_2_tpu.models import tracking as jtr

import cuda_optical_flow_2_torch as tof
from cuda_optical_flow_2_torch.interop import fb_config_from_jax, lk_config_from_jax
from cuda_optical_flow_2_torch.models import tracking as ttr
from cuda_optical_flow_2_torch.utils.io import synthetic_sequence

POINT_TOL = 1e-5
TRACK_TOL = 1e-3

JCFG = jof.LKConfig(levels=3, window=11, temporal_kernel="gauss3", iterations=2,
                    use_pallas=False)
CFG = lk_config_from_jax(JCFG)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Torch on one thread: small plain ops spread over every core contend
    under several pytest workers (see tests/test_torch_spatial.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flow_and_points(seed=0, h=16, w=24, n=40):
    rng = np.random.default_rng(seed)
    flow = rng.normal(0, 3, (h, w, 2)).astype(np.float32)
    pts = np.stack([rng.uniform(-3, w + 2, n), rng.uniform(-3, h + 2, n)], -1).astype(np.float32)
    pts[:3] = [[0.0, 0.0], [w - 1.0, h - 1.0], [3.5, 2.25]]
    return flow, pts


def test_sample_flow_matches_jax():
    flow, pts = _flow_and_points()
    want = np.asarray(jtr.sample_flow(jnp.asarray(flow), jnp.asarray(pts)))
    got = tof.sample_flow(torch.from_numpy(flow), torch.from_numpy(pts))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=POINT_TOL)


def test_sample_flow_nan_point_samples_nan():
    flow, _ = _flow_and_points()
    got = tof.sample_flow(torch.from_numpy(flow), torch.tensor([[np.nan, 3.0], [2.0, 1.0]]))
    assert bool(torch.isnan(got[0]).all()) and bool(torch.isfinite(got[1]).all())


def test_advect_points_matches_jax():
    flow, pts = _flow_and_points(seed=1)
    alive = np.random.default_rng(2).random(len(pts)) < 0.8
    for a in (None, alive):
        want_p, want_a = jtr.advect_points(
            jnp.asarray(flow), jnp.asarray(pts), None if a is None else jnp.asarray(a))
        got_p, got_a = tof.advect_points(torch.from_numpy(flow), torch.from_numpy(pts),
                                         None if a is None else torch.from_numpy(a))
        np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=0, atol=POINT_TOL)
        np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    # dead points stay frozen
    got_p, _ = tof.advect_points(torch.from_numpy(flow), torch.from_numpy(pts),
                                 torch.from_numpy(alive))
    np.testing.assert_array_equal(got_p.numpy()[~alive], pts[~alive])


@pytest.mark.parametrize("warm_start", [True, False])
def test_track_sequence_matches_jax(warm_start):
    """A translating sequence with a point that leaves the image."""
    frames = synthetic_sequence(6, 96, 128, velocity=(2.0, 1.0), noise=0.0)
    stack = np.stack(frames).astype(np.float32)
    pts0 = np.asarray([[40.0, 40.0], [64.0, 30.0], [90.0, 60.0], [126.0, 10.0]], np.float32)
    jp, ja = jtr.track_sequence(jnp.asarray(stack), pts0, JCFG, warm_start=warm_start)
    jp, ja = np.asarray(jp), np.asarray(ja)
    tp, ta = ttr.track_sequence(stack, pts0, CFG, warm_start=warm_start, device="cpu")
    assert tp.shape == (5, 4, 2) and ta.shape == (5, 4) and ta.dtype == torch.bool
    np.testing.assert_allclose(tp.numpy(), jp, rtol=0, atol=TRACK_TOL)
    np.testing.assert_array_equal(ta.numpy(), ja)
    assert not ja[-1, 3] and ja[:, :3].all()
    # a tensor keeps its device, the points follow it
    tp2, _ = ttr.track_sequence(torch.from_numpy(stack), torch.from_numpy(pts0), CFG,
                                warm_start=warm_start)
    assert torch.equal(tp2, tp)


def test_track_sequence_model_generic_matches_jax():
    frames = synthetic_sequence(3, 64, 96, velocity=(1.5, -1.0), noise=0.0)
    stack = np.stack(frames).astype(np.float32)
    pts0 = np.asarray([[48.0, 32.0], [20.0, 40.0]], np.float32)
    jcfg = JFBConfig(levels=2, iterations=1, use_pallas=False)
    jp, ja = jtr.track_sequence(jnp.asarray(stack), pts0, jcfg, warm_start=False)
    tp, ta = ttr.track_sequence(stack, pts0, fb_config_from_jax(jcfg), warm_start=False,
                                device="cpu")
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=TRACK_TOL)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))


@pytest.mark.parametrize("lost", [None, 2])
def test_track_points_matches_jax(lost):
    """The generator against JAX's, with and without a decode failure (a None
    frame pairs across the gap), and against track_sequence."""
    frames = list(synthetic_sequence(5, 96, 128, velocity=(2.0, 1.0), noise=0.0))
    seq = frames if lost is None else frames[:lost] + [None] + frames[lost + 1:]
    pts0 = np.asarray([[50.0, 40.0], [20.0, 70.0]], np.float32)
    want = list(jtr.track_points(seq, pts0, JCFG, warm_start=True))
    got = list(ttr.track_points(seq, pts0, CFG, warm_start=True, device="cpu"))
    assert [i for i, _, _ in got] == [i for i, _, _ in want]
    for (_, gp, ga), (_, wp, wa) in zip(got, want):
        np.testing.assert_allclose(gp.numpy(), np.asarray(wp), rtol=0, atol=TRACK_TOL)
        np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))
    if lost is None:
        tp, _ = ttr.track_sequence(np.stack(frames), pts0, CFG, device="cpu")
        for t, (_, gp, _) in enumerate(got):
            np.testing.assert_allclose(gp.numpy(), tp[t].numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("entry", ["track_points", "track_sequence"])
def test_points_must_be_n_by_2(entry):
    frames = np.zeros((2, 32, 32), np.float32)
    with pytest.raises(ValueError, match="points"):
        if entry == "track_points":
            list(ttr.track_points(list(frames), np.zeros((3,), np.float32), CFG, device="cpu"))
        else:
            ttr.track_sequence(frames, np.zeros((3, 3), np.float32), CFG, device="cpu")


def test_arrays_need_a_device_without_cuda():
    """Numpy frames go to the card unless device='cpu' is passed; without a
    card the entry points raise instead of running on the CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the frames would go there")
    frames = synthetic_sequence(2, 32, 32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttr.track_sequence(frames, np.zeros((1, 2), np.float32), CFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        list(ttr.track_points(list(frames), np.zeros((1, 2), np.float32), CFG))
