"""The port's LK pipeline and serving loop against the JAX package (CPU).

Same numpy frames through both.  JAX runs its XLA twin (``use_pallas=False``),
the semantic arbiter; the port runs both its settings: ``use_pallas=False``
(the same composition) and ``use_pallas=True`` (its kernels' plain versions
on CPU tensors, which add the budget clamp; every flow here stays inside
``max_displacement``, so both must agree with the twin).  Flow tolerance
atol 2e-3 as tests/test_pallas.py compares whole pipelines.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cuda_optical_flow_2_tpu as jof
from cuda_optical_flow_2_tpu.models import streaming as jstream
from cuda_optical_flow_2_tpu.utils.io import synthetic_sequence as j_synthetic_sequence

import cuda_optical_flow_2_torch as tof
from cuda_optical_flow_2_torch.interop import flow_state_from_numpy, lk_config_from_jax
from cuda_optical_flow_2_torch.kernels import lk_fused, lk_step_fused, upsample_flow, warp_select
from cuda_optical_flow_2_torch.models import streaming as tstream
from cuda_optical_flow_2_torch.utils.io import synthetic_sequence

ATOL = 2e-3

# Jitted: one compile per shape and config instead of one per op.
_jax_pyramid = jax.jit(jof.pyramidal_lk_pyramid, static_argnames=("config",))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(
        np.asarray(got, np.float32), np.asarray(want, np.float32), rtol=atol, atol=atol
    )


def _frames(n, h, w, **kw):
    return synthetic_sequence(n, h, w, **kw).astype(np.float32)


def _both(jcfg):
    """The port config for each of its two paths."""
    t = lk_config_from_jax(jcfg)
    return [dataclasses.replace(t, use_pallas=True), dataclasses.replace(t, use_pallas=False)]


@pytest.mark.parametrize("kw", [{}, {"velocity": (1.5, -0.5), "period": 21, "seed": 3}])
def test_synthetic_sequence_equal_to_jax(kw):
    np.testing.assert_array_equal(synthetic_sequence(3, 40, 56, **kw),
                                  j_synthetic_sequence(3, 40, 56, **kw))


ENTRY = jof.LKConfig(levels=4, window=19, use_pallas=False)
PAPER_SHAPED = dataclasses.replace(jof.PAPER_1080P, use_pallas=False)


@pytest.mark.parametrize(
    "jcfg,shape",
    [(ENTRY, (96, 128)), (PAPER_SHAPED, (160, 192)), (PAPER_SHAPED, (150, 190))],
    ids=["entry", "paper1080p_shaped", "paper1080p_shaped_odd"],
)
def test_pyramidal_lk_pyramid_matches_jax(jcfg, shape):
    # Period 48: the default 16 px texture is 1 px at the fifth level, where
    # it aliases and the flow becomes sensitive to float order (JAX jitted
    # and eager differ by ~1e-2 there).
    fr = _frames(2, *shape, period=48)
    want = [np.asarray(f) for f in _jax_pyramid(jnp.asarray(fr[0]), jnp.asarray(fr[1]), jcfg)]
    for tcfg in _both(jcfg):
        got = tof.pyramidal_lk_pyramid(torch.from_numpy(fr[0]), torch.from_numpy(fr[1]), tcfg)
        assert [tuple(g.shape) for g in got] == [w.shape for w in want]
        for g, w in zip(got, want):
            _close(g, w)


def test_pyramidal_lk_matches_jax_on_random_pair(rng):
    """The entry point's own input: a random-integer pair at the entry config."""
    p, n = (rng.integers(0, 256, (64, 80)).astype(np.float32) for _ in range(2))
    want = jof.pyramidal_lk_jit(jnp.asarray(p), jnp.asarray(n), ENTRY)
    for tcfg in _both(ENTRY):
        got = tof.pyramidal_lk(torch.from_numpy(p), torch.from_numpy(n), tcfg)
        err = np.abs(got.numpy() - np.asarray(want, np.float32))
        # Random pairs are ill-conditioned in places: the median/p99 form of
        # tests/test_pallas.py, since 1/det amplifies float order there.
        assert np.median(err) < 2e-3 and np.percentile(err, 99) < 0.1, (
            np.median(err), np.percentile(err, 99))


@pytest.mark.parametrize(
    "overrides",
    [
        {"iterations": 2, "window_weights": "gauss"},
        {"warp_mode": "nearest"},
        {"warp_mode": "none"},
        {"temporal_kernel": "gauss3", "normalize_gradients": False, "window_weights": "box"},
    ],
    ids=["iterations2", "nearest", "no_warp", "reference_cpu_like"],
)
def test_lk_variants_match_jax(overrides):
    jcfg = jof.LKConfig(levels=3, window=11, use_pallas=False, **overrides)
    fr = _frames(2, 64, 96)
    want = jof.pyramidal_lk_jit(jnp.asarray(fr[0]), jnp.asarray(fr[1]), jcfg)
    for tcfg in _both(jcfg):
        _close(tof.pyramidal_lk(torch.from_numpy(fr[0]), torch.from_numpy(fr[1]), tcfg), want)


def test_recovers_translation():
    fr = _frames(2, 96, 128, velocity=(2.0, 1.0))
    cfg = tof.LKConfig(levels=3, window=11, temporal_kernel="gauss3", iterations=2)
    flow = tof.pyramidal_lk(torch.from_numpy(fr[0]), torch.from_numpy(fr[1]), cfg)
    m = flow[24:-24, 24:-24].reshape(-1, 2).median(dim=0).values.numpy()
    np.testing.assert_allclose(m, [2.0, 1.0], atol=0.1)


def test_compose_flow_pyramid_matches_jax(rng):
    pyr = [rng.normal(0, 1, (h, w, 2)).astype(np.float32) for h, w in [(37, 50), (18, 25), (9, 12)]]
    for level in (0, 1):
        _close(
            tof.compose_flow_pyramid([torch.from_numpy(f) for f in pyr], level),
            jof.compose_flow_pyramid([jnp.asarray(f) for f in pyr], level), atol=1e-5,
        )


def test_batched_frames_match_single():
    fr = _frames(3, 48, 64)
    cfg = tof.LKConfig(levels=2, window=9)
    batch = tof.pyramidal_lk(torch.from_numpy(fr[:2]), torch.from_numpy(fr[1:]), cfg)
    for b in range(2):
        single = tof.pyramidal_lk(torch.from_numpy(fr[b]), torch.from_numpy(fr[b + 1]), cfg)
        torch.testing.assert_close(batch[b], single, rtol=1e-5, atol=1e-5)


def test_pipeline_rejects_bad_inputs():
    """Too small a frame for the pyramid raises; REFERENCE_GPU, with its
    bilateral prefilter, is no bad input: it runs and matches the JAX package."""
    with pytest.raises(ValueError, match="pyramid levels"):
        tof.pyramidal_lk(torch.zeros(8, 8), torch.zeros(8, 8), tof.LKConfig(levels=4))
    jcfg = dataclasses.replace(jof.REFERENCE_GPU, use_pallas=False)
    fr = _frames(2, 64, 80, period=48)
    want = jof.pyramidal_lk_jit(jnp.asarray(fr[0]), jnp.asarray(fr[1]), jcfg)
    for tcfg in _both(jcfg):
        _close(tof.pyramidal_lk(torch.from_numpy(fr[0]), torch.from_numpy(fr[1]), tcfg), want)


def test_interop_config_round_trip():
    assert lk_config_from_jax(jof.REFERENCE_GPU) == tof.REFERENCE_GPU
    assert lk_config_from_jax(jof.PAPER_1080P) == tof.PAPER_1080P


# --- streaming ------------------------------------------------------------


def _cut_frames(h, w):
    """Translation at (2, 1) px/frame, then a cut to another scene and motion."""
    a = _frames(4, h, w, velocity=(2.0, 1.0))
    b = _frames(2, h, w, velocity=(-1.0, 1.5), period=23, seed=1)
    return [*a, *b]


SERVE = jof.LKConfig(levels=1, window=15, use_pallas=False)
RECOVERY = jstream.RecoveryConfig(levels=3)


@pytest.mark.parametrize("frame_index", [3, 4], ids=["warm_track", "scene_cut"])
def test_streaming_step_matches_jax(frame_index):
    """One warm step with recovery from the same carried state: a tracked pair
    and the pair across the cut (which must re-acquire deep on both sides)."""
    frames = _cut_frames(96, 128)
    trec = tstream.RecoveryConfig(**dataclasses.asdict(RECOVERY))
    jstate = jstream.init_state(jnp.asarray(frames[0]), SERVE, RECOVERY)
    for f in frames[1:frame_index]:
        jstate, _ = jstream.step(jstate, jnp.asarray(f), SERVE, True, RECOVERY)
    tstate = flow_state_from_numpy(jstate.pyramid, jstate.flow, device="cpu")
    jnew, jflow = jstream.step(jstate, jnp.asarray(frames[frame_index]), SERVE, True, RECOVERY)
    for tcfg in _both(SERVE):
        tnew, tflow = tstream.step(tstate, torch.from_numpy(frames[frame_index]), tcfg, True, trec)
        _close(tflow, jflow)
        _close(tnew.flow, jnew.flow)
        assert len(tnew.pyramid) == len(jnew.pyramid) == 3
    if frame_index == 4:  # the cut: the flow is the cold deep solve
        cold = jof.pyramidal_lk_jit(jnp.asarray(frames[3]), jnp.asarray(frames[4]),
                                dataclasses.replace(SERVE, levels=3))
        _close(jflow, cold, atol=1e-5)


def test_process_sequence_matches_jax():
    """Warm serving with recovery over a cut and a dropped (None) frame."""
    frames = _cut_frames(64, 96)
    frames.insert(3, None)
    trec = tstream.RecoveryConfig(**dataclasses.asdict(RECOVERY))
    want = dict(jstream.process_sequence(frames, SERVE, warm_start=True, recovery=RECOVERY))
    tcfg = lk_config_from_jax(SERVE)
    got = dict(tstream.process_sequence(
        (None if f is None else torch.from_numpy(f) for f in frames), tcfg,
        warm_start=True, recovery=trec,
    ))
    assert sorted(got) == sorted(want) == [1, 2, 4, 5, 6]
    for i in want:
        _close(got[i], want[i])


def test_streaming_cold_and_errors():
    frames = _frames(3, 48, 64)
    cfg = tof.LKConfig(levels=2, window=9)
    got = dict(tof.process_sequence((torch.from_numpy(f) for f in frames), cfg))
    want = dict(jstream.process_sequence(list(frames), jof.LKConfig(levels=2, window=9)))
    for i in want:
        _close(got[i], want[i])
    state = tof.init_state(torch.from_numpy(frames[0]), cfg)
    with pytest.raises(ValueError, match="warm_start"):
        tof.step(state, torch.from_numpy(frames[1]), cfg, recovery=tof.RecoveryConfig())
    with pytest.raises(TypeError, match="LKConfig"):
        tof.init_state(torch.from_numpy(frames[0]), jof.LKConfig())
    assert list(tof.process_sequence([None, None], cfg)) == []


def test_serving_loop_cpu_launches_nothing():
    wrappers = (lk_fused.lk_residual, lk_step_fused.lk_level_step, warp_select.warp_bilinear_select)
    before = [fn.launches for fn in wrappers]
    frames = _cut_frames(48, 64)
    list(tof.process_sequence((torch.from_numpy(f) for f in frames), lk_config_from_jax(SERVE),
                              warm_start=True, recovery=tof.RecoveryConfig()))
    assert [fn.launches for fn in wrappers] == before


# --- fused_half_upsample: accepted, and the same route either way ---------


def _route(monkeypatch):
    """Spies on the coarse-to-fine handoff and the LK step: the target
    shape of each handoff, in order, and for each step whether it was given
    a flow of another size than its frames (or ``flow_half``)."""
    handoffs, half_steps = [], []
    orig_handoff, orig_step = upsample_flow.handoff, lk_step_fused.lk_level_step

    def handoff(flow, shape, use_pallas):
        handoffs.append(tuple(shape))
        return orig_handoff(flow, shape, use_pallas)

    def step(prev, nxt, flow, *args, **kw):
        half_steps.append(tuple(flow.shape[-3:-1]) != tuple(prev.shape[-2:])
                          or kw.get("flow_half", False))
        return orig_step(prev, nxt, flow, *args, **kw)

    monkeypatch.setattr(upsample_flow, "handoff", handoff)
    monkeypatch.setattr(lk_step_fused, "lk_level_step", step)
    return handoffs, half_steps


@pytest.mark.parametrize(
    "cfg,entry,steps",
    [
        (tof.PAPER_1080P, tof.pyramidal_lk, 4),
        (tof.REFERENCE_GPU, tof.pyramidal_lk, 3),
        (tof.DISConfig(), tof.pyramidal_dis, 9),
        (tof.DIS_REALTIME, tof.pyramidal_dis, 7),
    ],
    ids=["PAPER_1080P", "REFERENCE_GPU", "DISConfig", "DIS_REALTIME"],
)
def test_fused_half_upsample_levels_and_bits(monkeypatch, cfg, entry, steps):
    """72x96 has 1080x1920's level parities (72, 36, 18, 9, 4 rows): with
    the flag on, as off, each finer level takes the coarser flow through
    one handoff (DIS_REALTIME's last one to the unsolved level 0), and no
    step is given a half-size flow: 4 of PAPER_1080P's levels, 3 of
    REFERENCE_GPU's, 4 of DIS's.  The flow is bit-equal to the flag off."""
    fr = _frames(2, 72, 96, velocity=(2.0, 1.0), period=24)
    p, n = torch.from_numpy(fr[0]), torch.from_numpy(fr[1])
    handoffs, half_steps = _route(monkeypatch)
    on = entry(p, n, dataclasses.replace(cfg, fused_half_upsample=True))
    assert len(handoffs) == cfg.levels - 1 and handoffs[-1] == (72, 96)
    assert [h for h, _ in handoffs] == sorted(h for h, _ in handoffs)  # coarse to fine
    assert half_steps == [False] * steps
    route = list(handoffs)
    handoffs.clear()
    half_steps.clear()
    off = entry(p, n, cfg)
    assert handoffs == route and half_steps == [False] * steps
    torch.testing.assert_close(on, off, rtol=0, atol=0)


def test_fused_half_upsample_warm_stream(monkeypatch):
    """A warm LK stream (levels=3) with the flag on: the cold first pair
    hands its flow over to levels 1 and 0; a warm pair enters the coarsest
    level with the previous flow at its own resolution (a handoff to the
    same shape) and then hands over to levels 1 and 0; no step is given a
    half-size flow.  The route and the flows are the flag off's."""
    frames = [torch.from_numpy(f) for f in _frames(4, 64, 96, velocity=(2.0, 1.0), period=24)]
    cfg = tof.LKConfig(levels=3, window=11)
    handoffs, half_steps = _route(monkeypatch)
    on = dict(tof.process_sequence(frames, dataclasses.replace(cfg, fused_half_upsample=True),
                                   warm_start=True))
    assert handoffs == [(32, 48), (64, 96)] + [(16, 24), (32, 48), (64, 96)] * 2
    assert half_steps == [False] * 8
    route = list(handoffs)
    handoffs.clear()
    off = dict(tof.process_sequence(frames, cfg, warm_start=True))
    assert handoffs == route
    assert sorted(on) == sorted(off) == [1, 2, 3]
    for i in on:
        torch.testing.assert_close(on[i], off[i], rtol=0, atol=0)
