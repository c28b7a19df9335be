"""The port's captured entries (``capture.captured``) on the CPU.

The JAX package jits ``pyramidal_lk`` and the four family entries
(``pyramidal_<family>_jit``) and the serving pair ``init_state``/``step``;
the port's counterparts replay CUDA graphs on CUDA tensors and run the eager
entry on CPU tensors.  Here, on the CPU: each ``_jit`` name exists where
JAX defines it, is ``torch.equal`` to its eager entry and agrees with the
JAX ``_jit`` within the tolerance of the family's parity test
(tests/test_torch_pipeline.py, test_torch_horn_schunck.py,
test_torch_farneback.py, test_torch_tvl1.py, test_torch_dis.py); the key;
the launch counters' snapshot and delta; autograd; and the graph logic of
the captured entries and of the serving step with recovery (one graph per
key, the check's branches under ``capture.cond``), run through a stand-in
``capture.Graph`` that executes its body where the real one would capture
and replay (``tests/torch_capture_stand_in.py``; the donation and the cond
in detail in tests/test_torch_capture_donation.py; the CUDA capture itself
runs in chip_smoke.py phase 8n).
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
from cuda_optical_flow_2_tpu.models import lucas_kanade as jlk
from cuda_optical_flow_2_tpu.models import streaming as jstream
from cuda_optical_flow_2_tpu.models import tvl1 as jtvl1

import cuda_optical_flow_2_torch as tof
from cuda_optical_flow_2_torch import capture, interop
from cuda_optical_flow_2_torch.kernels import lk_fused, lk_step_fused, pyr_down, warp_select
from cuda_optical_flow_2_torch.kernels import upsample_flow as upsample_kernel
from cuda_optical_flow_2_torch.models import dis as tdis
from cuda_optical_flow_2_torch.models import farneback as tfb
from cuda_optical_flow_2_torch.models import horn_schunck as ths
from cuda_optical_flow_2_torch.models import lucas_kanade as tlk
from cuda_optical_flow_2_torch.models import streaming as tstream
from cuda_optical_flow_2_torch.models import tvl1 as ttvl1
from cuda_optical_flow_2_torch.ops.resize import upsample_flow
from cuda_optical_flow_2_torch.utils.io import synthetic_sequence

from torch_capture_stand_in import StandInGraph, stand_in  # noqa: F401  (a fixture)

# name -> (JAX module, port module, JAX config with use_pallas=False, config
# converter, (h, w), the family parity test's flow tolerance)
FAMILIES = {
    "lk": (jlk, tlk, jof.LKConfig(levels=3, window=11, temporal_kernel="gauss3", iterations=2,
                                  use_pallas=False),
           interop.lk_config_from_jax, (64, 96), 2e-3),
    "hs": (jhs, ths, jhs.HSConfig(levels=2, iterations=40, use_pallas=False),
           interop.hs_config_from_jax, (64, 96), 2e-4),
    "farneback": (jfb, tfb, jfb.FBConfig(levels=2, use_pallas=False),
                  interop.fb_config_from_jax, (96, 128), 1e-4),
    "tvl1": (jtvl1, ttvl1, jtvl1.TVL1Config(levels=2, warps=2, iterations=15, use_pallas=False),
             interop.tvl1_config_from_jax, (96, 128), 2e-4),
    # finest_level=2: the flow leaves the pyramid through upsample_flow's resize
    "dis": (jdis, tdis, jdis.DISConfig(levels=3, finest_level=2, iterations=3, window=7,
                                       window_weights="tri", use_pallas=False),
            interop.dis_config_from_jax, (96, 128), 2e-4),
}


def _pair(h, w):
    fr = synthetic_sequence(2, h, w, velocity=(2.0, 1.0), period=24)
    return fr[0].astype(np.float32), fr[1].astype(np.float32)


# --- names -------------------------------------------------------------------


@pytest.mark.parametrize("family", list(FAMILIES))
def test_jit_names_where_jax_defines_them(family):
    jmod, tmod, *_ = FAMILIES[family]
    name = {"lk": "pyramidal_lk_jit", "farneback": "pyramidal_farneback_jit"}.get(
        family, f"pyramidal_{family}_jit")
    assert hasattr(jmod, name)
    entry = getattr(tmod, name)
    assert name in tmod.__all__
    assert entry.eager is getattr(tmod, name[: -len("_jit")])
    assert isinstance(entry.cache, capture.GraphCache)


def test_package_exports_pyramidal_lk_jit():
    assert "pyramidal_lk_jit" in jof.__all__ and "pyramidal_lk_jit" in tof.__all__
    assert tof.pyramidal_lk_jit is tlk.pyramidal_lk_jit
    assert tstream.init_state is tof.init_state and tstream.step is tof.step


# --- the five families on the CPU --------------------------------------------


@pytest.mark.parametrize("family", list(FAMILIES))
def test_jit_equals_eager_and_matches_jax(family):
    jmod, tmod, jcfg, convert, (h, w), tol = FAMILIES[family]
    name = f"pyramidal_{family}" if family != "lk" else "pyramidal_lk"
    p, n = _pair(h, w)
    want = np.asarray(getattr(jmod, f"{name}_jit")(jnp.asarray(p), jnp.asarray(n), jcfg))
    captured_before = capture.graphs_captured()
    for use_pallas in (True, False):
        cfg = dataclasses.replace(convert(jcfg), use_pallas=use_pallas)
        tp, tn = torch.from_numpy(p), torch.from_numpy(n)
        got = getattr(tmod, f"{name}_jit")(tp, tn, cfg)
        assert torch.equal(got, getattr(tmod, name)(tp, tn, cfg))
        assert tuple(got.shape) == (h, w, 2) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want.astype(np.float32), rtol=tol, atol=tol)
    # CPU tensors run eagerly: nothing captured, nothing cached
    assert capture.graphs_captured() == captured_before
    assert not getattr(tmod, f"{name}_jit").cache.entries


@pytest.mark.parametrize("family", list(FAMILIES))
def test_jit_graph_logic_on_cpu(family, stand_in):
    """Through the stand-in graph: one capture per key, the result equal to
    the eager entry's on two different pairs (the copy-in), fresh clones."""
    _, tmod, jcfg, convert, _, _ = FAMILIES[family]
    h, w = 64, 96
    name = f"pyramidal_{family}" if family != "lk" else "pyramidal_lk"
    entry, eager = getattr(tmod, f"{name}_jit"), getattr(tmod, name)
    cfg = convert(jcfg)
    pairs = [_pair(h, w), tuple(f[::-1].copy() for f in _pair(h, w))]
    outs = []
    for p, n in pairs:
        tp, tn = torch.from_numpy(p), torch.from_numpy(n)
        got = entry(tp, tn, cfg)
        assert torch.equal(got, eager(tp, tn, cfg))
        outs.append(got)
    assert StandInGraph.built == 1 and len(entry.cache.entries) == 1
    assert not torch.equal(outs[0], outs[1])  # the second replay left the first result alone


def test_upsample_flow_resize_scale_bit_identical():
    """The resize branch (DIS at finest_level >= 2) scales u and v by Python
    floats now, no host-to-device tensor: torch.equal to the tensor scale."""
    rng = np.random.default_rng(0)
    for (h, w), (th, tw) in [((24, 32), (96, 128)), ((23, 31), (96, 130)), ((13, 17), (50, 67))]:
        flow = torch.from_numpy(rng.normal(size=(2, h, w, 2)).astype(np.float32) * 3)
        got = upsample_flow(flow, (th, tw))
        x = flow.reshape((-1, h, w, 2)).permute(0, 3, 1, 2)
        out = torch.nn.functional.interpolate(x, size=(th, tw), mode="bilinear",
                                              align_corners=False)
        scale = torch.tensor([tw / w, th / h], dtype=flow.dtype)
        assert torch.equal(got, out.permute(0, 2, 3, 1).reshape(2, th, tw, 2) * scale)


# --- the key -----------------------------------------------------------------


def test_key_separates_what_selects_a_program():
    key = tlk.pyramidal_lk_jit.key
    a = torch.zeros(48, 64)
    cfg = tof.LKConfig(levels=2, window=9)
    base = key(a, a, cfg)
    # two equal configs built separately share a key
    assert key(a, a, tof.LKConfig(levels=2, window=9)) == base
    assert hash(key(a, a, tof.LKConfig(levels=2, window=9))) == hash(base)
    # the data does not enter the key
    assert key(a + 1, a, cfg) == base
    for other in (
        key(a, a, tof.LKConfig(levels=2, window=11)),           # config value
        key(a, a, dataclasses.replace(cfg, use_pallas=False)),
        key(torch.zeros(48, 66), torch.zeros(48, 66), cfg),   # shape
        key(a.to(torch.uint8), a.to(torch.uint8), cfg),       # dtype
        key(a.to(torch.float64), a, cfg),
        key(torch.empty(48, 64, device="meta"), a, cfg),      # device
    ):
        assert other != base
    # keyword and default arguments bind as in the eager call
    assert key(a, a, config=cfg) == base


def test_step_key_separates_flow_none_and_flags():
    key = tstream._step_graphs.key
    cfg = tof.LKConfig(levels=1, window=9)
    pyr = (torch.zeros(32, 48),)
    frame = torch.zeros(32, 48)
    cold = key(tstream.FlowState(pyr), frame, cfg, True)
    warm = key(tstream.FlowState(pyr, torch.zeros(32, 48, 2)), frame, cfg, True)
    assert cold != warm
    assert key(tstream.FlowState(pyr), frame, cfg) == key(tstream.FlowState(pyr), frame, cfg, False,
                                                         None)
    assert key(tstream.FlowState(pyr), frame, cfg, False) != cold
    rec = tof.RecoveryConfig(levels=3)
    assert key(tstream.FlowState(pyr), frame, cfg, True, rec) != cold
    assert key(tstream.FlowState(pyr), frame, cfg, True, tof.RecoveryConfig(levels=3)) == key(
        tstream.FlowState(pyr), frame, cfg, True, rec)
    with pytest.raises(TypeError, match="hashable"):
        key(tstream.FlowState(pyr), frame, {"levels": 1})


# --- launch counters ---------------------------------------------------------


def test_counter_registry_holds_every_wrapper_counter():
    names = capture.counters()
    for name in ("lk_fused.lk_residual.launches", "lk_fused.lk_residual.launches_centered",
                 "lk_step_fused.lk_level_step.launches_centered", "pyr_down.pyr_down.launches",
                 "hs_sweep.hs_relax_band.launches", "tvl1_sweep.tvl1_relax.launches",
                 "median_select.median_filter_kernel.launches", "win_solve.window_solve.launches",
                 "fb_step_fused.fb_band_step.launches", "bilateral_tap.bilateral_kernel.launches",
                 "poly_exp_fused.poly_expansion_kernel.launches",
                 "warp_select.warp_bilinear_select_band.launches",
                 "occlusion_fill.fill_occluded_flow_kernel.launches",
                 "upsample_flow.upsample_flow.launches",
                 "tvl1_sweep.tvl1_relax.launches_clustered",
                 "tvl1_sweep.tvl1_relax_band.launches_clustered"):
        assert name in names
    assert len(names) == 24


@pytest.mark.parametrize("replays", [1, 3, 10])
def test_counter_delta_replays_give_the_eager_totals(replays):
    """A simulated capture: an eager call's launches (3 pyr_down, 1 residual,
    3 steps, 2 upsamples, 1 warp) recorded as the delta over the
    capture, the counters set back, then N replays: the totals are N eager
    calls'."""
    start = capture.snapshot()

    def eager_call():
        pyr_down.pyr_down.launches += 3
        lk_fused.lk_residual.launches += 1
        lk_step_fused.lk_level_step.launches += 3
        upsample_kernel.upsample_flow.launches += 2
        warp_select.warp_bilinear_select.launches += 1

    try:
        eager_call()  # the warm-up
        before = capture.snapshot()
        eager_call()  # the capture
        change = capture.delta(before, capture.snapshot())
        capture.restore(start)
        assert capture.snapshot() == start
        for _ in range(replays):
            capture.add_counts(change)
        got = capture.delta(start, capture.snapshot())
        for _ in range(replays):
            eager_call()
        want = capture.delta(start, capture.snapshot())
        assert {k: 2 * v for k, v in got.items()} == want
        assert got == {
            "pyr_down.pyr_down.launches": 3 * replays,
            "lk_fused.lk_residual.launches": replays,
            "lk_step_fused.lk_level_step.launches": 3 * replays,
            "upsample_flow.upsample_flow.launches": 2 * replays,
            "warp_select.warp_bilinear_select.launches": replays,
        }
    finally:
        capture.restore(start)


# --- autograd ----------------------------------------------------------------


def test_jit_under_autograd_gives_the_eager_gradient():
    p, n = _pair(48, 64)
    cfg = tof.LKConfig(levels=2, window=9, use_pallas=False)
    grads = []
    for entry in (tof.pyramidal_lk, tof.pyramidal_lk_jit):
        x = torch.from_numpy(n).requires_grad_(True)
        entry(torch.from_numpy(p), x, cfg)[..., 0].mean().backward()
        grads.append(x.grad)
    assert torch.equal(grads[0], grads[1]) and grads[0].abs().max() > 0


def test_runs_eagerly_rules():
    a = torch.zeros(4)
    assert capture.runs_eagerly([a, a])
    assert capture.runs_eagerly([])
    assert capture.runs_eagerly([a.requires_grad_(True)])


# --- the serving loop --------------------------------------------------------


def _cut_frames(h, w):
    a = synthetic_sequence(4, h, w, velocity=(2.0, 1.0)).astype(np.float32)
    b = synthetic_sequence(3, h, w, velocity=(-1.0, 1.5), period=23, seed=1).astype(np.float32)
    return [*a, *b]


def _serve(step_fn, init_fn, frames, cfg, rec):
    state = init_fn(torch.from_numpy(frames[0]), cfg, rec)
    flows = []
    for i, f in enumerate(frames[1:], start=1):
        if i == 5:  # a dropped frame: the carried flow goes
            state = tstream.FlowState(state.pyramid, None)
        state, flow = step_fn(state, torch.from_numpy(f), cfg, True, rec)
        flows.append(flow)
    return flows


@pytest.mark.parametrize("use_pallas", [True, False])
def test_recovery_step_graph_logic_on_cpu(stand_in, use_pallas):
    """The captured serving loop's graph logic through the stand-in graph:
    warm steps with recovery (one graph per key, the check's two solves
    under capture.cond) over a cut and a dropped frame, each flow
    torch.equal to the eager step's; both branches taken, on the host and
    by the graph's device counts; one key each for init_state, the cold
    step and the warm step (two graphs: the donated state's two sets)."""
    cfg = tof.LKConfig(levels=1, window=15, use_pallas=use_pallas)
    rec = tof.RecoveryConfig(levels=3)
    frames = _cut_frames(64, 96)
    branches = []
    seed_ok = tstream._seed_ok

    def spy(*args):
        ok = seed_ok(*args)
        branches.append(bool(ok))
        return ok

    eager = _serve(tstream._step, tstream._init_state, frames, cfg, rec)
    tstream._seed_ok = spy
    try:
        got = _serve(tof.step, tof.init_state, frames, cfg, rec)
    finally:
        tstream._seed_ok = seed_ok
    for g, e in zip(got, eager, strict=True):
        assert torch.equal(g, e)
    # built: init_state 1, cold steps (flow None) 1, warm steps 2 (G0, G1)
    assert StandInGraph.built == 4
    assert len(tstream._step_graphs.cache.entries) == 2
    # the check ran at capture (body) and on each warm replay; both outcomes seen
    assert True in branches and False in branches
    warm = [e for e in tstream._step_graphs.cache.entries.values() if len(e.graphs) == 2][0]
    capture.settle()
    taken = [sum(g.taken[0][b] for g in warm.graphs) for b in (0, 1)]
    assert min(taken) > 0 and sum(taken) == 4  # pairs 2, 3, 4 and 6


def test_recovery_step_matches_jax(stand_in):
    """One step across the cut through the captured logic, against JAX's
    jitted step from the same state (tests/test_torch_pipeline.py's 2e-3)."""
    jcfg = jof.LKConfig(levels=1, window=15, use_pallas=False)
    jrec = jstream.RecoveryConfig(levels=3)
    frames = _cut_frames(64, 96)
    jstate = jstream.init_state(jnp.asarray(frames[0]), jcfg, jrec)
    for f in frames[1:4]:
        jstate, _ = jstream.step(jstate, jnp.asarray(f), jcfg, True, jrec)
    # before the JAX step: it donates the state
    tstate = interop.flow_state_from_numpy(jstate.pyramid, jstate.flow, device="cpu")
    _, jflow = jstream.step(jstate, jnp.asarray(frames[4]), jcfg, True, jrec)
    tcfg = interop.lk_config_from_jax(jcfg)
    new, flow = tof.step(tstate, torch.from_numpy(frames[4]), tcfg, True,
                         tof.RecoveryConfig(levels=3))
    # the state's flow is the key's buffer, the returned flow a clone of it
    assert torch.equal(new.flow, flow) and new.flow.data_ptr() != flow.data_ptr()
    np.testing.assert_allclose(flow.numpy(), np.asarray(jflow, np.float32), rtol=2e-3, atol=2e-3)


def test_public_streaming_on_cpu_is_the_eager_body():
    cfg = tof.LKConfig(levels=2, window=9)
    frames = _cut_frames(48, 64)
    state = tof.init_state(torch.from_numpy(frames[0]), cfg)
    ref = tstream._init_state(torch.from_numpy(frames[0]), cfg)
    assert all(torch.equal(a, b) for a, b in zip(state.pyramid, ref.pyramid, strict=True))
    s1, f1 = tof.step(state, torch.from_numpy(frames[1]), cfg, True)
    s2, f2 = tstream._step(ref, torch.from_numpy(frames[1]), cfg, True)
    assert torch.equal(f1, f2) and torch.equal(s1.flow, s2.flow)
    assert not tstream._step_graphs.cache.entries and not tstream._init_state_graphs.cache.entries
