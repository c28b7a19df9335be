"""The port's DIS family against the JAX package (CPU).

On CPU tensors the ``centered`` modes of ``kernels.lk_fused.lk_residual`` and
``kernels.lk_step_fused.lk_level_step`` take their plain versions (the LK
ops with ``ops.window.centered_structure_tensor_sums``); these tests hold
them to the JAX Pallas kernels in interpret mode and to the JAX package's
XLA composition, the refinement to the JAX ``_refine``, and the whole
pyramidal driver to the JAX package's XLA twin (``use_pallas=False``).  The
CUDA kernels are held to the plain versions on the card by chip_smoke.py.

Tolerances: 1e-5 px for one centered residual or refinement, the limit
tests/test_dis.py holds the Pallas kernels to the XLA twin; 2e-4 px for the
fused step (a warp and a solve, as tests/test_torch_kernels.py) and for
whole pipelines; 0.15 px inner EPE and 0.3 px median for translation
recovery, the limits of tests/test_dis.py; 0.1 px at the worst pixel for
OpenCV's PRESET_MEDIUM, whose 150 steps amplify float order (its test).
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cuda_optical_flow_2_tpu import config as jconfig
from cuda_optical_flow_2_tpu.kernels import lk_fused as jlk_fused
from cuda_optical_flow_2_tpu.kernels import lk_step_fused as jlk_step_fused
from cuda_optical_flow_2_tpu.models import dis as jdis

import cuda_optical_flow_2_torch as tof
from cuda_optical_flow_2_torch.interop import dis_config_from_jax
from cuda_optical_flow_2_torch.kernels import hs_sweep, lk_fused, lk_step_fused, warp_select
from cuda_optical_flow_2_torch.models import dis as tdis
from cuda_optical_flow_2_torch.utils.io import synthetic_sequence

# OpenCV's DIS PRESET_MEDIUM: the fields of the benchmark's dis_opencv_medium_1080p
OPENCV_MEDIUM = json.loads((Path(__file__).resolve().parents[1] / "flowbench" / "configs" /
                            "dis_opencv_medium_1080p.json").read_text())["fields"]
KERNEL_TOL = 1e-5
FLOW_TOL = 2e-4
PRESET_TOL = 0.1
EPE_TOL = 0.15
MEDIAN_TOL = 0.3


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _j(a):
    return jnp.asarray(np.asarray(a, np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(
        np.asarray(got, np.float32), np.asarray(want, np.float32), rtol=tol, atol=tol
    )


def _pair(h, w, velocity=(1.0, 0.5), period=16, bright=0.0):
    fr = synthetic_sequence(2, h, w, velocity=velocity, period=period)
    return fr[0].astype(np.float32), fr[1].astype(np.float32) + bright


def _epe(flow, dx, dy, margin=16):
    f = np.asarray(flow)
    e = np.hypot(f[..., 0] - dx, f[..., 1] - dy)
    return float(e[margin:-margin, margin:-margin].mean())


def _both(jcfg):
    t = dis_config_from_jax(jcfg)
    return [dataclasses.replace(t, use_pallas=True), dataclasses.replace(t, use_pallas=False)]


# --- config ---------------------------------------------------------------


def test_dis_config_matches_jax():
    t_fields = [(f.name, f.default) for f in dataclasses.fields(tdis.DISConfig)]
    j_fields = [(f.name, f.default) for f in dataclasses.fields(jdis.DISConfig)]
    assert t_fields == j_fields
    assert dataclasses.asdict(tof.DIS_REALTIME) == dataclasses.asdict(jdis.DIS_REALTIME)
    for bad in ({"levels": 0}, {"finest_level": 5}, {"window": 4}, {"window": 1},
                {"iterations": 0}, {"refine_iterations": -1}, {"refine_alpha": 0.0},
                {"refine_penalty": "huber"}, {"refine_eps_data": 0.0},
                {"refine_eps_smooth": -1.0}, {"temporal_kernel": "nope"},
                {"window_weights": "hann"}, {"c_max": -1}, {"d_local": 0}):
        with pytest.raises(ValueError):
            jdis.DISConfig(**bad)
        with pytest.raises(ValueError):
            tdis.DISConfig(**bad)


@pytest.mark.parametrize(
    "jcfg",
    [jdis.DISConfig(),
     jdis.DISConfig(levels=3, finest_level=2, window=11, refine_penalty="charbonnier",
                    window_weights="tri", prefilter=jconfig.BilateralConfig(window=5),
                    fused_half_upsample=True, use_pallas=False)],
    ids=["default", "charbonnier_prefilter"],
)
def test_dis_config_from_jax_and_lk_view(jcfg):
    got = dis_config_from_jax(jcfg)
    assert isinstance(got, tof.DISConfig)
    assert dataclasses.asdict(got) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(tdis._lk_like(got)) == dataclasses.asdict(jdis._lk_like(jcfg))


# --- the centered modes of kernels #1 and #2 -----------------------------------


def test_centered_residual_matches_pallas_interpret(monkeypatch):
    """The plain centered residual against the Pallas kernel itself
    (interpret mode, odd size, as tests/test_dis.py)."""
    monkeypatch.setenv("OF2_PALLAS_INTERPRET", "1")
    p, n = _pair(67, 93)
    jcfg = jdis.DISConfig(levels=1)
    want = jlk_fused.lk_residual(_j(p), _j(n), jdis._lk_like(jcfg), interpret=True,
                                 centered=True)
    got = lk_fused.lk_residual(_t(p), _t(n), tdis._lk_like(dis_config_from_jax(jcfg)),
                               centered=True)
    _close(got, want, KERNEL_TOL)


@pytest.mark.parametrize(
    "window,weights,tk,with_bright",
    [(9, "box", "dt3", False), (7, "tri", "gauss3", True), (11, "gauss", "delta", False)],
)
def test_centered_residual_matches_xla_twin(window, weights, tk, with_bright):
    """Against ``models/dis._dis_residual_xla``, batched; a +25 brightness
    offset on the next frame cancels in the centered sums."""
    p, n = _pair(40, 56, bright=25.0 if with_bright else 0.0)
    p, n = np.stack([p, n]), np.stack([n, p])
    jcfg = jdis.DISConfig(levels=1, window=window, window_weights=weights, temporal_kernel=tk,
                          use_pallas=False)
    want = jdis._dis_residual_xla(_j(p), _j(n), jcfg)
    tcfg = dis_config_from_jax(jcfg)
    got = lk_fused.lk_residual(_t(p), _t(n), tdis._lk_like(tcfg), centered=True)
    assert tuple(got.shape) == (2, 40, 56, 2)
    _close(got, want, KERNEL_TOL)


def test_centered_level_step_matches_pallas_interpret(monkeypatch):
    """The plain centered step (clip, warp, centered solve, accumulate)
    against the fused Pallas step in interpret mode."""
    monkeypatch.setenv("OF2_PALLAS_INTERPRET", "1")
    p, n = _pair(48, 64, velocity=(2.0, 1.0))
    flow = np.full((48, 64, 2), 0.5, np.float32)
    flow[..., 0] += np.linspace(0, 1.5, 64, dtype=np.float32)
    jcfg = jdis.DISConfig(levels=1)
    want = jlk_step_fused.lk_level_step(_j(p), _j(n), _j(flow), jdis._lk_like(jcfg),
                                        interpret=True, centered=True)
    got = lk_step_fused.lk_level_step(_t(p), _t(n), _t(flow),
                                      tdis._lk_like(dis_config_from_jax(jcfg)), centered=True)
    _close(got, want, FLOW_TOL)


def test_centered_wrappers_cpu_plain_and_no_launches():
    p, n = _pair(24, 32)
    flow = np.full((24, 32, 2), 0.25, np.float32)
    cfg = tdis._lk_like(tof.DISConfig(levels=1))
    wrappers = (lk_fused.lk_residual, lk_step_fused.lk_level_step,
                warp_select.warp_bilinear_select, hs_sweep.hs_relax)
    before = [fn.launches for fn in wrappers]
    centered_before = (lk_fused.lk_residual.launches_centered,
                       lk_step_fused.lk_level_step.launches_centered)
    torch.testing.assert_close(lk_fused.lk_residual(_t(p), _t(n), cfg, centered=True),
                               lk_fused.lk_residual_plain(_t(p), _t(n), cfg, centered=True),
                               rtol=0, atol=0)
    torch.testing.assert_close(
        lk_step_fused.lk_level_step(_t(p), _t(n), _t(flow), cfg, centered=True),
        lk_step_fused.lk_level_step_plain(_t(p), _t(n), _t(flow), cfg, centered=True),
        rtol=0, atol=0,
    )
    tof.pyramidal_dis(_t(p), _t(n), tof.DISConfig(levels=2))
    assert [fn.launches for fn in wrappers] == before
    assert (lk_fused.lk_residual.launches_centered,
            lk_step_fused.lk_level_step.launches_centered) == centered_before


# --- models.dis ------------------------------------------------------------------


@pytest.mark.parametrize(
    "kw",
    [dict(), dict(refine_penalty="charbonnier", refine_alpha=40.0), dict(mean_normalize=False)],
    ids=["quadratic_centered", "charbonnier", "raw"],
)
def test_refine_matches_jax(kw):
    """The refinement alone (clamp, warp, it_offset with the cumsum window
    mean, HS relaxation) from a flow with some pixels over the budget."""
    p, n = _pair(48, 64, velocity=(2.0, 1.0))
    flow = np.full((48, 64, 2), 0.5, np.float32)
    flow[:4, :4] = 40.0
    jcfg = jdis.DISConfig(levels=1, refine_iterations=20, max_displacement=8, use_pallas=False,
                          **kw)
    want = jdis._refine(_j(p), _j(n), _j(flow), jcfg)
    for tcfg in _both(jcfg):
        _close(tdis._refine(_t(p), _t(n), _t(flow), tcfg), want, KERNEL_TOL)


@pytest.mark.parametrize(
    "kw",
    [dict(levels=3),
     dict(levels=3, finest_level=1, refine_penalty="charbonnier", refine_alpha=40.0),
     dict(levels=3, finest_level=2, iterations=3, window=7, window_weights="tri"),
     dict(levels=2, mean_normalize=False, window_method="cumsum", refine_iterations=0),
     dict(levels=2, temporal_kernel="delta", det_eps=0.0, window_method="reduce_window")],
    ids=["default3", "finest1_charbonnier", "finest2_tri", "raw_cumsum_no_refine",
         "delta_unguarded_reduce_window"],
)
def test_pyramidal_dis_matches_jax(kw):
    p, n = _pair(96, 128, velocity=(2.0, 1.0))
    jcfg = jdis.DISConfig(use_pallas=False, **kw)
    want = jdis.pyramidal_dis_jit(_j(p), _j(n), jcfg)
    for tcfg in _both(jcfg):
        got = tof.pyramidal_dis(_t(p), _t(n), tcfg)
        assert tuple(got.shape) == (96, 128, 2)
        _close(got, want, FLOW_TOL)


def _noise_pair(h, w, seed=24):
    """A seeded uint8 noise frame and its copy moved by (2, 1) px, with
    +-3 noise: a texture on which the preset's 25 steps per level converge."""
    rng = np.random.default_rng(seed)
    p = rng.integers(0, 256, (h, w))
    n = np.clip(np.roll(p, (1, 2), axis=(0, 1)) + rng.integers(-3, 4, (h, w)), 0, 255)
    return p.astype(np.float32), n.astype(np.float32)


def test_opencv_medium_preset_matches_jax():
    """OpenCV's DIS PRESET_MEDIUM (the benchmark's configuration file; 7
    levels fit 128x192, level 6 is 2x3): both packages track the motion and
    agree.  Its 25 steps on each of 6 levels amplify float order: on five
    such pairs the float32 reference (``flowbench/reference/dis.py``) moves
    from its float64 run by 8e-5 to 0.073 px at its worst pixel and by at
    most 2.2e-4 px at its median one.  So the median gap is held to
    FLOW_TOL and the largest to PRESET_TOL, above float32's own 0.073."""
    p, n = _noise_pair(128, 192)
    jcfg = jdis.DISConfig(**{**OPENCV_MEDIUM, "use_pallas": False})
    want = np.asarray(jdis.pyramidal_dis_jit(_j(p), _j(n), jcfg))
    np.testing.assert_allclose(np.median(want[16:-16, 16:-16].reshape(-1, 2), axis=0),
                               [2.0, 1.0], atol=MEDIAN_TOL)
    for tcfg in _both(jcfg):
        got = tof.pyramidal_dis(_t(p), _t(n), tcfg).numpy()
        gap = np.hypot(*(got - want).transpose(2, 0, 1))
        assert np.median(gap) <= FLOW_TOL and gap.max() <= PRESET_TOL


def test_pyramidal_dis_recovers_translation_like_jax():
    """tests/test_dis.py's translation case: EPE under 0.15 px, in both
    packages, which agree; a +25 brightness offset moves it by < 0.05 px."""
    p, n = _pair(96, 128, velocity=(2.0, 1.0))
    _, nb = _pair(96, 128, velocity=(2.0, 1.0), bright=25.0)
    jcfg = jdis.DISConfig(levels=3, use_pallas=False)
    want = np.asarray(jdis.pyramidal_dis_jit(_j(p), _j(n), jcfg))
    tcfg = dis_config_from_jax(jcfg)
    got = tof.pyramidal_dis(_t(p), _t(n), tcfg).numpy()
    for flow in (want, got):
        assert _epe(flow, 2.0, 1.0) < EPE_TOL
    _close(got, want, FLOW_TOL)
    bright = tof.pyramidal_dis(_t(p), _t(nb), tcfg).numpy()
    assert abs(_epe(bright, 2.0, 1.0) - _epe(got, 2.0, 1.0)) < 0.05


def test_dis_realtime_preset_tracks_motion():
    """tests/test_dis.py's preset case: DIS_REALTIME cut to 3 levels."""
    p, n = _pair(128, 96, velocity=(2.0, 1.0))
    cfg = dataclasses.replace(tof.DIS_REALTIME, levels=3)
    flow = tof.pyramidal_dis(_t(p), _t(n), cfg).numpy()
    m = np.median(flow[24:-24, 24:-24].reshape(-1, 2), axis=0)
    np.testing.assert_allclose(m, [2.0, 1.0], atol=MEDIAN_TOL)


def test_fused_half_upsample_is_accepted_and_changes_nothing():
    """The port accepts the flag and takes the same route either way: each
    finer level's flow comes through the handoff (``upsample_flow``), then
    the plain-flow steps.  So the flow does not change."""
    p, n = _pair(64, 96, velocity=(2.0, 1.0))
    cfg = tof.DISConfig(levels=2, refine_iterations=2, max_displacement=8)
    half = tof.pyramidal_dis(_t(p), _t(n), dataclasses.replace(cfg, fused_half_upsample=True))
    torch.testing.assert_close(half, tof.pyramidal_dis(_t(p), _t(n), cfg), rtol=0, atol=0)


def test_batched_pyramidal_dis_matches_single():
    p, n = _pair(64, 96, velocity=(1.0, 0.5))
    cfg = tof.DISConfig(levels=2)
    batch = tof.pyramidal_dis(_t(np.stack([p, n])), _t(np.stack([n, p])), cfg)
    torch.testing.assert_close(batch[0], tof.pyramidal_dis(_t(p), _t(n), cfg), rtol=0, atol=1e-5)
    torch.testing.assert_close(batch[1], tof.pyramidal_dis(_t(n), _t(p), cfg), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="pyramid levels"):
        tof.pyramidal_dis(_t(p[:3]), _t(n[:3]), cfg)
