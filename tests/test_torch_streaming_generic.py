"""The port's model-generic entry points against the JAX package (CPU).

``models.pyramidal_flow`` and the streaming loop (``init_state``, ``step``,
``process_sequence``) dispatch on the config type over the five families
(LK, HS, FB, TV-L1, DIS).  The same numpy frames go through the JAX package's streaming
(its XLA twin, ``use_pallas=False``) and through both port paths.  A config
of no ported family, the JAX package's included, raises ``TypeError``.

Tolerances: flows atol/rtol 2e-4 px, as tests/test_torch_horn_schunck.py
compares whole HS pipelines; the FB, TV-L1 and DIS pipelines meet it with
margin.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import cuda_optical_flow_2_tpu as jof
from cuda_optical_flow_2_tpu.models import dis as jdis
from cuda_optical_flow_2_tpu.models import farneback as jfb
from cuda_optical_flow_2_tpu.models import horn_schunck as jhs
from cuda_optical_flow_2_tpu.models import streaming as jstream
from cuda_optical_flow_2_tpu.models import tvl1 as jtvl1

import cuda_optical_flow_2_torch as tof
from cuda_optical_flow_2_torch.interop import (
    dis_config_from_jax,
    fb_config_from_jax,
    flow_state_from_numpy,
    hs_config_from_jax,
    lk_config_from_jax,
    tvl1_config_from_jax,
)
from cuda_optical_flow_2_torch.kernels import (
    fb_step_fused,
    hs_sweep,
    lk_fused,
    lk_step_fused,
    poly_exp_fused,
    pyr_down,
    tvl1_sweep,
    warp_select,
    win_solve,
)
from cuda_optical_flow_2_torch.models import pyramidal_flow
from cuda_optical_flow_2_torch.models import streaming as tstream
from cuda_optical_flow_2_torch.utils.io import synthetic_sequence

FLOW_TOL = 2e-4

# (JAX config, the port's conversion) per family, small enough for the CPU.
FAMILIES = {
    "lk": (jof.LKConfig(levels=2, window=9, use_pallas=False), lk_config_from_jax),
    "hs": (jhs.HSConfig(levels=2, iterations=20, use_pallas=False), hs_config_from_jax),
    "fb": (jfb.FBConfig(levels=2, iterations=2, use_pallas=False), fb_config_from_jax),
    "tvl1": (jtvl1.TVL1Config(levels=2, warps=2, iterations=10, use_pallas=False),
             tvl1_config_from_jax),
    "dis": (jdis.DISConfig(levels=2, use_pallas=False), dis_config_from_jax),
}
# The serving configurations: one tracking level, a deeper recovery pyramid.
SERVING = {
    "hs": jhs.HSConfig(levels=1, iterations=30, use_pallas=False),
    "fb": jfb.FBConfig(levels=1, iterations=1, use_pallas=False),
    "tvl1": jtvl1.TVL1Config(levels=1, warps=2, iterations=10, use_pallas=False),
    "dis": jdis.DISConfig(levels=1, use_pallas=False),
}
CONVERT = {"hs": hs_config_from_jax, "fb": fb_config_from_jax, "tvl1": tvl1_config_from_jax,
           "dis": dis_config_from_jax}
STREAMED = list(SERVING)
RECOVERY = jstream.RecoveryConfig(levels=2)

WRAPPERS = (
    poly_exp_fused.poly_expansion_kernel,
    win_solve.window_solve,
    fb_step_fused.fb_level_step,
    warp_select.warp_bilinear_select,
    pyr_down.pyr_down,
    hs_sweep.hs_relax,
    tvl1_sweep.tvl1_relax,
    lk_fused.lk_residual,
    lk_step_fused.lk_level_step,
)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, tol=FLOW_TOL):
    np.testing.assert_allclose(
        np.asarray(got, np.float32), np.asarray(want, np.float32), rtol=tol, atol=tol
    )


def _both(tcfg):
    return [dataclasses.replace(tcfg, use_pallas=True), dataclasses.replace(tcfg, use_pallas=False)]


def _cut_frames(h, w):
    """Translation at (1, 0.5) px/frame, then a cut to another scene and motion."""
    a = synthetic_sequence(4, h, w, velocity=(1.0, 0.5), period=24)
    b = synthetic_sequence(2, h, w, velocity=(-1.0, 1.0), period=19, seed=1)
    return [f.astype(np.float32) for f in (*a, *b)]


# --- pyramidal_flow ------------------------------------------------------------


@pytest.mark.parametrize("family", list(FAMILIES))
def test_pyramidal_flow_dispatches_like_jax(family):
    jcfg, convert = FAMILIES[family]
    fr = synthetic_sequence(2, 48, 64, velocity=(1.0, 0.5), period=24).astype(np.float32)
    want = jof.models.pyramidal_flow(jnp.asarray(fr[0]), jnp.asarray(fr[1]), jcfg)
    direct = {"lk": tof.pyramidal_lk, "hs": tof.pyramidal_hs, "fb": tof.pyramidal_farneback,
              "tvl1": tof.pyramidal_tvl1, "dis": tof.pyramidal_dis}
    for tcfg in _both(convert(jcfg)):
        got = pyramidal_flow(_t(fr[0]), _t(fr[1]), tcfg)
        torch.testing.assert_close(got, direct[family](_t(fr[0]), _t(fr[1]), tcfg),
                                   rtol=0, atol=0)
        _close(got, want)
    assert tof.pyramidal_flow is pyramidal_flow


@pytest.mark.parametrize(
    "config",
    [jof.LKConfig(), jfb.FBConfig(), jof.TVL1Config(), jdis.DISConfig(), object()],
    ids=["jax_lk", "jax_fb", "jax_tvl1", "jax_dis", "object"],
)
def test_foreign_configs_raise_type_error(config):
    """A JAX config (any family) or anything else is not the port's: the
    error names the five families and the interop converters."""
    frame = torch.zeros(32, 32)
    with pytest.raises(TypeError, match="convert a JAX config"):
        pyramidal_flow(frame, frame, config)
    with pytest.raises(TypeError, match="LKConfig, HSConfig, FBConfig, TVL1Config or DISConfig"):
        tof.init_state(frame, config)
    state = tof.init_state(frame, tof.LKConfig(levels=2))
    with pytest.raises(TypeError, match="interop"):
        tof.step(state, frame, config)
    with pytest.raises(TypeError):
        list(tof.process_sequence([frame, frame], config))


# --- streaming ------------------------------------------------------------------


@pytest.mark.parametrize("family", STREAMED)
def test_process_sequence_cold_matches_jax(family):
    jcfg, convert = FAMILIES[family]
    frames = _cut_frames(48, 64)[:3]
    want = dict(jstream.process_sequence(frames, jcfg))
    for tcfg in _both(convert(jcfg)):
        got = dict(tof.process_sequence(frames, tcfg, device="cpu"))
        assert sorted(got) == sorted(want) == [1, 2]
        for i in want:
            _close(got[i], want[i])


@pytest.mark.parametrize("family", STREAMED)
def test_warm_process_sequence_with_recovery_matches_jax(family):
    """Warm serving with recovery over a cut and a dropped (None) frame."""
    jcfg = SERVING[family]
    frames = _cut_frames(48, 64)
    frames.insert(3, None)
    trec = tstream.RecoveryConfig(**dataclasses.asdict(RECOVERY))
    want = dict(jstream.process_sequence(frames, jcfg, warm_start=True, recovery=RECOVERY))
    for tcfg in _both(CONVERT[family](jcfg)):
        got = dict(tof.process_sequence(
            (None if f is None else _t(f) for f in frames), tcfg, warm_start=True, recovery=trec,
        ))
        assert sorted(got) == sorted(want) == [1, 2, 4, 5, 6]
        for i in want:
            _close(got[i], want[i])


@pytest.mark.parametrize("family", STREAMED)
@pytest.mark.parametrize("frame_index", [2, 4], ids=["warm_track", "scene_cut"])
def test_step_matches_jax(family, frame_index):
    """One warm step with recovery from the same carried state: a tracked
    pair and the pair across the cut (which re-acquires deep)."""
    jcfg = SERVING[family]
    frames = _cut_frames(48, 64)
    trec = tstream.RecoveryConfig(**dataclasses.asdict(RECOVERY))
    jstate = jstream.init_state(jnp.asarray(frames[0]), jcfg, RECOVERY)
    for f in frames[1:frame_index]:
        jstate, _ = jstream.step(jstate, jnp.asarray(f), jcfg, True, RECOVERY)
    tstate = flow_state_from_numpy(jstate.pyramid, jstate.flow, device="cpu")
    jnew, jflow = jstream.step(jstate, jnp.asarray(frames[frame_index]), jcfg, True, RECOVERY)
    for tcfg in _both(CONVERT[family](jcfg)):
        tnew, tflow = tstream.step(tstate, _t(frames[frame_index]), tcfg, True, trec)
        _close(tflow, jflow)
        _close(tnew.flow, jnew.flow)
        assert len(tnew.pyramid) == len(jnew.pyramid) == RECOVERY.levels
        for g, w in zip(tnew.pyramid, jnew.pyramid):
            _close(g, w, 1e-4)


@pytest.mark.parametrize("family", STREAMED)
def test_init_state_carries_the_family_pyramid(family):
    jcfg = SERVING[family]
    frame = _cut_frames(48, 64)[0]
    want = jstream.init_state(jnp.asarray(frame), jcfg, RECOVERY)
    got = tof.init_state(_t(frame), CONVERT[family](jcfg),
                         tstream.RecoveryConfig(**dataclasses.asdict(RECOVERY)))
    assert got.flow is None and len(got.pyramid) == len(want.pyramid) == 2
    for g, w in zip(got.pyramid, want.pyramid):
        _close(g, w, 1e-4)


@pytest.mark.parametrize("family", STREAMED)
def test_streaming_cpu_launches_nothing(family):
    before = [fn.launches for fn in WRAPPERS]
    tcfg = CONVERT[family](SERVING[family])
    list(tof.process_sequence(_cut_frames(32, 48), dataclasses.replace(tcfg, use_pallas=True),
                              warm_start=True, recovery=tof.RecoveryConfig(levels=2),
                              device="cpu"))
    assert [fn.launches for fn in WRAPPERS] == before
