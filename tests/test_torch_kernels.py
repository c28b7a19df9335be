"""The port's kernel modules against the JAX package's kernels (CPU).

On CPU tensors each wrapper takes its kernel's plain PyTorch version; these
tests hold that version to the JAX kernel's semantics.  The CUDA kernels
themselves are held to the plain versions on the card by chip_smoke.py
(tests/conftest.py imports jax, which the card's machine does not have).

Tolerances: atol/rtol 2e-4 for flow, as tests/test_pallas.py compares the
Pallas kernels with their XLA twins; 1e-4 for warped intensities (0-255).
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import cuda_optical_flow_2_tpu as jof
from cuda_optical_flow_2_tpu.kernels import lk_fused as jlk_fused
from cuda_optical_flow_2_tpu.models.lucas_kanade import _lk_residual_xla
from cuda_optical_flow_2_tpu.ops.warp import warp_bilinear as jwarp_bilinear

from cuda_optical_flow_2_torch.interop import lk_config_from_jax
from cuda_optical_flow_2_torch.kernels import _build, lk_fused, lk_step_fused, warp_select

TOL = 2e-4


def _pair(rng, h, w):
    return (rng.integers(0, 256, (h, w)).astype(np.float32) for _ in range(2))


def _smooth_flow(h, w, amp):
    """A smooth field of up to ~amp px that sends border pixels out of bounds."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    u = amp * np.sin(2 * np.pi * ys / h) * np.cos(np.pi * xs / w)
    v = 0.75 * amp * np.cos(2 * np.pi * xs / w) * np.sin(np.pi * ys / h) - 2.0
    return np.stack([u, v], -1).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _j(a):
    return jnp.asarray(np.asarray(a, np.float32))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(
        np.asarray(got, np.float32), np.asarray(want, np.float32), rtol=tol, atol=tol
    )


# --- kernel #1: lk_residual ---------------------------------------------


@pytest.mark.parametrize("weights", ["box", "tri", "gauss"])
def test_lk_residual_matches_pallas_interpret(rng, weights):
    """The plain version against the Pallas kernel itself, interpret mode."""
    prev, nxt = _pair(rng, 61, 77)
    jcfg = jof.LKConfig(levels=1, window=19, window_weights=weights, use_pallas=False)
    want = jlk_fused.lk_residual(_j(prev), _j(nxt), jcfg, interpret=True)
    got = lk_fused.lk_residual(_t(prev), _t(nxt), lk_config_from_jax(jcfg))
    _close(got, want)


@pytest.mark.parametrize(
    "shape,window,tk,norm,weights,eps",
    [
        ((64, 80), 9, "gauss3", True, "tri", 1e-8),
        ((61, 77), 19, "dt3", False, "box", 1e-8),
        ((40, 96), 15, "delta", True, "gauss", 1e-8),
        ((2, 33, 45), 7, "dt3", True, "tri", 1e-8),
    ],
)
def test_lk_residual_matches_xla_twin(rng, shape, window, tk, norm, weights, eps):
    prev, nxt = (rng.integers(0, 256, shape).astype(np.float32) for _ in range(2))
    jcfg = jof.LKConfig(
        levels=1, window=window, temporal_kernel=tk, normalize_gradients=norm,
        window_weights=weights, det_eps=eps,
    )
    want = _lk_residual_xla(_j(prev), _j(nxt), jcfg)
    got = lk_fused.lk_residual(_t(prev), _t(nxt), lk_config_from_jax(jcfg))
    assert tuple(got.shape) == shape + (2,)
    _close(got, want)


def test_lk_residual_det_guard(rng):
    """A flat pair: eps=0 divides by zero (non-finite), the guard gives 0."""
    flat = np.full((24, 24), 7.0, np.float32)
    raw = lk_fused.lk_residual(_t(flat), _t(flat), lk_config_from_jax(jof.LKConfig(det_eps=0.0)))
    assert not torch.isfinite(raw).all()
    guarded = lk_fused.lk_residual(_t(flat), _t(flat), lk_config_from_jax(jof.LKConfig()))
    assert bool((guarded == 0).all())


# --- kernel #2: lk_level_step -------------------------------------------


def _xla_step(prev, nxt, flow, jcfg):
    """The JAX composition the fused step kernel stands for."""
    d = jcfg.max_displacement
    fc = jnp.clip(_j(flow), -d, d)
    return fc + _lk_residual_xla(_j(prev), jwarp_bilinear(_j(nxt), fc), jcfg)


@pytest.mark.parametrize(
    "amp,max_disp,weights",
    [(6.0, 32, "tri"), (14.0, 8, "tri"), (6.0, 32, "gauss"), (20.0, 4, "box")],
)
def test_lk_level_step_matches_xla_composition(rng, amp, max_disp, weights):
    """Out-of-bounds samples at the borders; amp > max_disp puts part of the
    flow over budget, so the clamp and the accumulation base are exercised."""
    prev, nxt = _pair(rng, 48, 64)
    flow = _smooth_flow(48, 64, amp)
    jcfg = jof.LKConfig(levels=1, window=11, max_displacement=max_disp, window_weights=weights)
    want = _xla_step(prev, nxt, flow, jcfg)
    got = lk_step_fused.lk_level_step(_t(prev), _t(nxt), _t(flow), lk_config_from_jax(jcfg))
    _close(got, want)
    if amp > max_disp:
        assert np.abs(flow).max() > max_disp  # the case really is over budget


def test_lk_level_step_nan_flow_keeps_unwarped_pixel(rng):
    prev, nxt = _pair(rng, 20, 24)
    flow = _smooth_flow(20, 24, 3.0)
    flow[5, 7] = np.nan
    jcfg = jof.LKConfig(levels=1, window=5)
    got = lk_step_fused.lk_level_step(_t(prev), _t(nxt), _t(flow), lk_config_from_jax(jcfg))
    want = np.asarray(_xla_step(prev, nxt, flow, jcfg), np.float32)
    g = got.numpy()
    np.testing.assert_array_equal(np.isnan(g), np.isnan(want))
    _close(g[~np.isnan(want)], want[~np.isnan(want)])


# --- kernel #2, flow_half: the in-kernel 2x flow upsample -------------------


def test_lk_level_step_flow_half_matches_pallas_interpret(rng, monkeypatch):
    """The plain flow_half step (upsample_flow, then the step) against the
    Pallas kernel's flow_half mode itself, interpret mode, at the smallest
    shape the TPU kernel admits (tests/test_pallas.py: a power-of-two padded
    width); a smooth half flow keeps its variation inside d_local."""
    from cuda_optical_flow_2_tpu.kernels import lk_step_fused as jlk_step_fused

    monkeypatch.setenv("OF2_PALLAS_INTERPRET", "1")
    h, w = 64, 448
    prev, nxt = _pair(rng, h, w)
    half = _smooth_flow(h // 2, w // 2, 2.0)
    jcfg = jof.LKConfig(levels=2, window=9, max_displacement=8, d_local=7)
    assert jlk_step_fused.supported_half(_j(prev), jcfg)
    want = jlk_step_fused.lk_level_step(_j(prev), _j(nxt), _j(half), jcfg, interpret=True,
                                        flow_half=True)
    got = lk_step_fused.lk_level_step_plain(_t(prev), _t(nxt), _t(half), lk_config_from_jax(jcfg),
                                            flow_half=True)
    _close(got, want)


def test_lk_level_step_flow_half_cpu_is_upsample_then_step(rng):
    """On CPU tensors the wrapper with flow_half is upsample_flow + the
    plain step bit for bit, centered or not, and launches nothing."""
    from cuda_optical_flow_2_torch.ops.resize import upsample_flow

    prev, nxt = _pair(rng, 2 * 18, 2 * 23)
    half = _t(_smooth_flow(18, 23, 3.0))
    cfg = lk_config_from_jax(jof.LKConfig(levels=1, window=9, max_displacement=4))
    before = lk_step_fused.lk_level_step.launches
    for centered in (False, True):
        got = lk_step_fused.lk_level_step(_t(prev), _t(nxt), half, cfg, centered, flow_half=True)
        want = lk_step_fused.lk_level_step_plain(_t(prev), _t(nxt), upsample_flow(half, (36, 46)),
                                                 cfg, centered)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert lk_step_fused.lk_level_step.launches == before


def test_lk_level_step_flow_half_launch_arguments(rng, monkeypatch):
    """What the wrapper hands the C entries (the launches themselves
    stubbed, the inputs meta tensors so the kernel path runs): with
    flow_half, the upsample kernel on the quarter-size flow, then the step
    on the full-size flow it made, each counted by its own wrapper; a flow
    of the wrong size for the mode raises before any launch."""
    from cuda_optical_flow_2_torch.kernels import upsample_flow

    calls = []
    monkeypatch.setattr(_build, "require_cuda", lambda *t: torch.device("cpu"))
    monkeypatch.setattr(_build, "launch", lambda dev, name, *args: calls.append((name, args)))
    prev, nxt = (torch.empty(32, 48, device="meta") for _ in range(2))
    half, full = torch.empty(16, 24, 2, device="meta"), torch.empty(32, 48, 2, device="meta")
    cfg = lk_config_from_jax(jof.LKConfig(levels=1, window=9))
    launches = (upsample_flow.upsample_flow.launches, lk_step_fused.lk_level_step.launches)
    lk_step_fused.lk_level_step(prev, nxt, half, cfg, True, flow_half=True)
    (up, (_, u_out, *u_dims)), (name, a) = calls
    assert up == "of2_upsample_flow" and u_dims == [1, 16, 24, 32, 48]
    assert name == "of2_lk_level_step" and a[2] == u_out and a[4:7] == (1, 32, 48)
    assert a[-1] == 1  # centered
    assert (upsample_flow.upsample_flow.launches, lk_step_fused.lk_level_step.launches) == (
        launches[0] + 1, launches[1] + 1)
    for flow, flow_half, p in ((full, True, prev), (half, False, prev), (half, True, prev[:31])):
        with pytest.raises(ValueError, match="want|octave"):
            lk_step_fused.lk_level_step(p, p, flow, cfg, flow_half=flow_half)
    assert len(calls) == 2


@pytest.mark.parametrize(
    "shape,flow_shape,kw",
    [
        ((64, 448), (32, 224), dict()),
        ((128, 448), (64, 224), dict(window=15, max_displacement=16)),
        ((64, 448), (64, 448), dict()),  # a warm start at level resolution
        ((63, 448), (31, 224), dict()),  # an odd level
        ((64, 448), (32, 224), dict(use_pallas=False)),
        ((64, 448), (32, 224), dict(warp_mode="nearest")),
        ((64, 448), (32, 224), dict(fused_half_upsample=False)),
    ],
    ids=["half", "window15", "warm_start", "odd", "plain", "nearest", "off"],
)
def test_fused_half_gate_matches_jax(rng, shape, flow_shape, kw):
    """The port's ``lk_level`` against JAX's on the same inputs, JAX on its
    XLA twin (the semantic arbiter): with ``flow_init_half`` the coarser
    flow is handed over to the level first, whatever the config's
    ``fused_half_upsample`` says and whichever path runs (the port has no
    gate: one route); a warm start is the same call at the level's
    resolution without it.  The flows stay inside ``max_displacement``, so
    the kernel path's clamp changes nothing."""
    from cuda_optical_flow_2_tpu.models import lucas_kanade as jlk

    from cuda_optical_flow_2_torch.models import lucas_kanade as tlk

    jcfg = jof.LKConfig(levels=2, **{"window": 9, "max_displacement": 8,
                                     "fused_half_upsample": True, **kw})
    prev, nxt = _pair(rng, *shape)
    flow = _smooth_flow(*flow_shape, 1.0)  # |u| <= 1, |v| <= 2.75: doubled, inside 8
    half = flow_shape != shape
    want = jlk.lk_level(_j(prev), _j(nxt), _j(flow), dataclasses.replace(jcfg, use_pallas=False),
                        flow_init_half=half)
    got = tlk.lk_level(_t(prev), _t(nxt), _t(flow), lk_config_from_jax(jcfg), flow_init_half=half)
    assert tuple(got.shape) == shape + (2,)
    _close(got, want)


# --- kernel #3: warp_bilinear_select ------------------------------------


@pytest.mark.parametrize("amp,max_disp", [(5.0, 32), (12.0, 6)])
def test_warp_select_matches_clipped_gather(rng, amp, max_disp):
    img = rng.integers(0, 256, (61, 45)).astype(np.float32)
    flow = _smooth_flow(61, 45, amp)
    want = jwarp_bilinear(_j(img), jnp.clip(_j(flow), -max_disp, max_disp))
    got = warp_select.warp_bilinear_select(_t(img), _t(flow), max_disp)
    _close(got, want, tol=1e-4)


# --- dispatch and launch counters ---------------------------------------


def test_cpu_tensors_take_the_plain_path_without_launches(rng):
    prev, nxt = _pair(rng, 32, 40)
    flow = _smooth_flow(32, 40, 3.0)
    wrappers = (lk_fused.lk_residual, lk_step_fused.lk_level_step, warp_select.warp_bilinear_select)
    before = [fn.launches for fn in wrappers]
    cfg = lk_config_from_jax(jof.LKConfig(levels=1, window=9))
    torch.testing.assert_close(
        lk_fused.lk_residual(_t(prev), _t(nxt), cfg),
        lk_fused.lk_residual_plain(_t(prev), _t(nxt), cfg), rtol=0, atol=0,
    )
    torch.testing.assert_close(
        lk_step_fused.lk_level_step(_t(prev), _t(nxt), _t(flow), cfg),
        lk_step_fused.lk_level_step_plain(_t(prev), _t(nxt), _t(flow), cfg), rtol=0, atol=0,
    )
    torch.testing.assert_close(
        warp_select.warp_bilinear_select(_t(prev), _t(flow), 8),
        warp_select.warp_bilinear_select_plain(_t(prev), _t(flow), 8), rtol=0, atol=0,
    )
    assert [fn.launches for fn in wrappers] == before


def test_non_cpu_non_cuda_tensors_raise():
    """Only a CPU tensor takes the plain version; anything else launches or raises."""
    meta = torch.empty(16, 16, device="meta")
    cfg = lk_config_from_jax(jof.LKConfig(levels=1, window=5))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        lk_fused.lk_residual(meta, meta, cfg)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        warp_select.warp_bilinear_select(meta, torch.empty(16, 16, 2, device="meta"))


def test_kernel_constants_bound_the_window():
    cfg = lk_config_from_jax(jof.LKConfig(window=15, normalize_gradients=True))
    r, taps, masks = lk_fused.kernel_constants(cfg)
    assert r == 7 and taps.shape == (15,) and masks.shape == (27,)
    assert masks.dtype == np.float32 and abs(masks[18:].sum() - 1.0) < 1e-6
    with pytest.raises(ValueError, match="window"):
        lk_fused.kernel_constants(dataclasses.replace(cfg, window=lk_fused.MAX_WINDOW + 2))


def test_build_module_names_sources_and_signatures():
    """Importing needs no nvcc; every C entry point has declared argtypes and
    exists in the sources."""
    names = {p.name for p in _build.SOURCES_DIR.iterdir()}
    assert {
        "lk_fused.cu", "lk_step_fused.cu", "warp_select.cu", "pyr_down.cu", "bilateral.cu",
        "hs_sweep.cu",
    } <= names
    src = "".join(p.read_text() for p in _build.SOURCES_DIR.glob("*.cu"))
    for fn in _build._SIGNATURES:
        assert f'extern "C" int {fn}(' in src
    assert {"of2_pyr_down", "of2_bilateral", "of2_hs_relax"} <= set(_build._SIGNATURES)


def test_build_compiles_each_source_then_links(tmp_path):
    """One nvcc compile per .cu file (run in parallel), one link of all objects."""
    compiles, link = _build.build_commands("nvcc", tmp_path, tmp_path / "lib.so")
    sources = sorted(_build.SOURCES_DIR.glob("*.cu"))
    assert [cmd[cmd.index("-c") + 1] for cmd in compiles] == [str(s) for s in sources]
    objects = [cmd[-1] for cmd in compiles]
    assert len(set(objects)) == len(sources)
    assert link[-len(objects):] == objects and "-shared" in link
    assert all("arch=compute_90a,code=sm_90a" in cmd for cmd in compiles + [link])


def test_import_leaves_jax_out():
    """Every module of the package imports without jax or the JAX package."""
    code = (
        "import sys, pkgutil, importlib, cuda_optical_flow_2_torch as pkg; "
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]; "
        "[importlib.import_module(n) for n in names]; "
        "assert len(names) >= 25, names; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', "
        "'cuda_optical_flow_2_tpu'))]; "
        "sys.exit(1 if bad else 0)"
    )
    root = Path(__file__).resolve().parent.parent
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=root)
    assert proc.returncode == 0, proc.stderr
