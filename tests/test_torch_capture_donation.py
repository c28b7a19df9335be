"""The captured serving step as one replay: ``capture.cond`` (the port's
``lax.cond``), ``settle`` and the donated state (JAX's ``donate_argnums``),
on the CPU.

The JAX package jits ``streaming.step`` as one program: the recovery
check's two solves under one ``lax.cond``, the old state donated.  The
port's ``step`` replays one CUDA graph per call with the branches as
conditional nodes and the state in two swapped buffer sets.  Here, through
the stand-in graph of ``tests/torch_capture_stand_in.py`` (the body runs
where a graph would be captured and replayed, each cond runs the branch its
predicate picks and counts it as the device does; buffers, copy-in, the
swap, conds' bookkeeping and counters are the real code): a cond takes the
branch its predicate picks on every replay and the counters after
``settle()`` are the eager calls'; the 8-frame serving loop with a cut and a
dropped frame is ``torch.equal`` to the eager ``_step`` loop and within
2e-3 of JAX's jitted ``step`` (tests/test_torch_pipeline.py's tolerance);
after the first warm step only the frame is copied in; a state is never
overwritten while it is held, and a handed-out flow never.  The CUDA
capture itself runs in chip_smoke.py phase 8n.
"""

import contextlib
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import cuda_optical_flow_2_tpu as jof
from cuda_optical_flow_2_tpu.models import streaming as jstream

import cuda_optical_flow_2_torch as tof
from cuda_optical_flow_2_torch import capture
from cuda_optical_flow_2_torch.kernels import _build, pyr_down, warp_select
from cuda_optical_flow_2_torch.models import streaming as tstream
from cuda_optical_flow_2_torch.utils.io import synthetic_sequence

from torch_capture_stand_in import StandInGraph, stand_in  # noqa: F401  (a fixture)

H, W = 64, 96
REC = tof.RecoveryConfig(levels=3)
# name -> (port config, JAX config): the serving configurations of chip_smoke.py
SERVE = {
    "lk": (tof.LKConfig(levels=1, window=15), jof.LKConfig(levels=1, window=15, use_pallas=False)),
    "fb": (tof.FBConfig(levels=1, iterations=1),
           jof.FBConfig(levels=1, iterations=1, use_pallas=False)),
}
JAX_TOL = 2e-3  # tests/test_torch_pipeline.py's serving tolerance


def _frames():
    """Eight frames: a (2, 1) px/frame translation, a cut at frame 5 to
    another texture and motion; the loops below drop the carried flow
    before the step to frame 7 (a dropped frame)."""
    a = synthetic_sequence(5, H, W, velocity=(2.0, 1.0)).astype(np.float32)
    b = synthetic_sequence(3, H, W, velocity=(-1.0, 1.5), period=23, seed=1).astype(np.float32)
    return [*a, *b]


DROP = 7


def _serve(step_fn, init_fn, frames, cfg):
    state = init_fn(torch.from_numpy(frames[0]), cfg, REC)
    flows = []
    for i, f in enumerate(frames[1:], start=1):
        if i == DROP:
            state = tstream.FlowState(state.pyramid, None)
        state, flow = step_fn(state, torch.from_numpy(f), cfg, True, REC)
        flows.append(flow)
    return flows


@pytest.fixture
def counting(monkeypatch):
    """Each kernel wrapper adds one to its ``launches`` per call, as it does
    per launch on the card (on the CPU it runs its plain version and counts
    nothing)."""
    for name in capture.counters():
        module, wrapper, attr = name.split(".")
        if attr != "launches":
            continue
        mod = importlib.import_module(f"cuda_optical_flow_2_torch.kernels.{module}")
        orig = getattr(mod, wrapper)

        def spy(*args, _orig=orig, **kwargs):
            _orig.launches += 1
            return _orig(*args, **kwargs)

        monkeypatch.setattr(mod, wrapper, spy)
    start = capture.snapshot()
    yield lambda: capture.delta(start, capture.snapshot())
    capture.restore(start)


def _warm_entry():
    """The donating entry of the loop's warm key (the one with two graphs)."""
    (entry,) = [e for e in tstream._step_graphs.cache.entries.values() if len(e.graphs) == 2]
    return entry


# --- cond ----------------------------------------------------------------------


def test_cond_eagerly_runs_the_branch_its_predicate_picks():
    x = torch.arange(4.0)
    assert torch.equal(capture.cond(torch.tensor(True), lambda a: a + 1, lambda a: a - 1, x), x + 1)
    assert torch.equal(capture.cond(torch.tensor(False), lambda a: a + 1, lambda a: a - 1, x), x - 1)


def test_cond_in_a_warm_up_runs_both_branches_and_returns_the_picked_one():
    ran = []
    with capture._as_mode(capture._WARM_UP):
        got = capture.cond(torch.tensor(False), lambda: ran.append("t") or 1,
                           lambda: ran.append("f") or 2)
    assert got == 2 and ran == ["t", "f"]


def _cond_entry():
    """A captured entry whose body branches on the sign of its input's sum:
    the true branch launches 3 pyr_down and 1 residual, the false one 1
    warp (counted as the wrappers count), around one shared launch."""
    def true_fn(x):
        pyr_down.pyr_down.launches += 3
        importlib.import_module("cuda_optical_flow_2_torch.kernels.lk_fused") \
            .lk_residual.launches += 1
        return x * 2

    def false_fn(x):
        warp_select.warp_bilinear_select.launches += 1
        return x - 1

    def body(x, scale):
        warp_select.warp_bilinear_select_band.launches += 1
        y = capture.cond((x.sum() > 0).reshape(()), true_fn, false_fn, x)
        return y * scale, x.sum()

    return capture.captured(body), body


@pytest.mark.parametrize("signs", [(1, -1, 1, -1), (1, 1, 1), (-1, -1), (-1, 1, 1, -1, -1)])
def test_cond_replays_take_the_picked_branch_and_settle_counts_them(stand_in, signs):
    entry, body = _cond_entry()
    start = capture.snapshot()
    try:
        got = [entry(torch.full((3,), float(s)), 2.0) for s in signs]
        captured_counts = capture.delta(start, capture.snapshot())
        mid = capture.snapshot()
        want = [body(torch.full((3,), float(s)), 2.0) for s in signs]
        eager_counts = capture.delta(mid, capture.snapshot())
    finally:
        capture.restore(start)
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g[0], w[0]) and torch.equal(g[1], w[1])
    assert captured_counts == eager_counts
    (graph,) = entry.cache.entries.values()
    assert StandInGraph.built == 1
    assert graph.taken == [[sum(s > 0 for s in signs), sum(s < 0 for s in signs)]]


def test_settle_reads_the_branches_once_per_settle(stand_in):
    """Counters read raw before settle() miss the branches; settle() adds
    them once, and a second settle() adds nothing."""
    entry, _ = _cond_entry()
    start = capture.snapshot()
    try:
        for s in (1, -1, -1):
            entry(torch.full((3,), float(s)), 1.0)
        raw = capture._counts()
        assert raw["pyr_down.pyr_down.launches"] == start["pyr_down.pyr_down.launches"]
        assert raw["warp_select.warp_bilinear_select_band.launches"] == \
            start["warp_select.warp_bilinear_select_band.launches"] + 3
        capture.settle()
        once = capture._counts()
        capture.settle()
        assert capture._counts() == once
        assert once["pyr_down.pyr_down.launches"] - start["pyr_down.pyr_down.launches"] == 3
        assert once["warp_select.warp_bilinear_select.launches"] - \
            start["warp_select.warp_bilinear_select.launches"] == 2
    finally:
        capture.restore(start)


def test_cond_counters_are_made_before_the_capture(stand_in):
    """The branch counts persist from replay to replay, so they live in a
    buffer made before the capture: a tensor allocated during it may sit in
    memory that earlier nodes of every replay write (on the card, a small
    warp temporary freed before the cond once overwrote the counts)."""
    made = {}

    class Recording(StandInGraph):
        def _capture(self, body):
            made["buffer"] = self._taken_device
            return super()._capture(body)

        def _cond(self, pred, true_fn, false_fn, operands):
            if not self.replaying:
                made.setdefault("pairs", []).append(self._taken_device[self._conds])
            return super()._cond(pred, true_fn, false_fn, operands)

    capture.Graph = Recording  # the stand_in fixture restores capture.Graph
    entry, _ = _cond_entry()
    entry(torch.ones(3), 1.0)
    (pair,) = made["pairs"]
    assert pair.untyped_storage().data_ptr() == made["buffer"].untyped_storage().data_ptr()
    assert made["buffer"].shape == (capture.CONDS, 2)


def test_cond_in_a_capture_rejects_nesting_and_unlike_branches(stand_in):
    def nested(x):
        return capture.cond(x.sum() > 0, lambda: capture.cond(x.sum() > 1, lambda: x, lambda: x),
                            lambda: x + 1)

    def unlike(x):
        return capture.cond(x.sum() > 0, lambda: x * 2, lambda: x[:1] * 2)

    for fn, what in ((nested, "inside a branch"), (unlike, "different outputs")):
        with pytest.raises(RuntimeError, match=what):
            capture.captured(fn)(torch.ones(3))


def test_cond_without_conditional_nodes_raises_with_the_versions(monkeypatch):
    """Where the CUDA installation has no conditional nodes, the
    capture raises and names torch and CUDA: nothing falls back to a host
    read or the eager body."""

    class NoConditionalNodes:
        @staticmethod
        def of2_cond_open(*args):
            return 801  # cudaErrorNotSupported

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(_build, "library", lambda: NoConditionalNodes)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: Stream)
    graph = object.__new__(capture.Graph)
    graph.device, graph._branch_pool = torch.device("cpu"), object()
    with pytest.raises(RuntimeError) as err:
        graph._open_cond(torch.tensor(True))
    assert f"torch {torch.__version__}" in str(err.value)
    assert f"CUDA {torch.version.cuda}" in str(err.value) and "801" in str(err.value)


# --- the serving step ------------------------------------------------------------


@pytest.mark.parametrize("family", list(SERVE))
def test_serving_loop_is_one_replay_per_step_and_matches_eager_and_jax(stand_in, counting,
                                                                        family):
    """Eight frames with a cut and a dropped frame: every flow torch.equal
    to the eager _step loop's, launches after settle() the eager loop's,
    both branches replayed as often as the eager loop took each (the device
    counts), one graph replayed per step, and JAX's jitted step within 2e-3."""
    cfg, jcfg = SERVE[family]
    frames = _frames()
    seed_ok, checks = tstream._seed_ok, []

    def spy(*args):
        ok = seed_ok(*args)
        checks.append(bool(ok))
        return ok

    before = counting()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tstream, "_seed_ok", spy)
        eager = _serve(tstream._step, tstream._init_state, frames, cfg)
    eager_counts = {k: v - before.get(k, 0) for k, v in counting().items()}
    mid = counting()
    got = _serve(tof.step, tof.init_state, frames, cfg)
    got_counts = {k: v - mid.get(k, 0) for k, v in counting().items()}
    for g, e in zip(got, eager, strict=True):
        assert torch.equal(g, e)
    assert got_counts == {k: v for k, v in eager_counts.items() if v}
    # init_state 1; the cold key (flow None) 1; the warm key G0 and G1
    assert StandInGraph.built == 4
    entry = _warm_entry()
    taken = [sum(g.taken[0][b] for g in entry.graphs) for b in (0, 1)]
    assert taken == [checks.count(True), checks.count(False)] and len(checks) == 5
    assert checks[3] is False and min(taken) > 0  # pair 5 is across the cut
    replays = sum(g.replays for e in tstream._step_graphs.cache.entries.values() for g in e.graphs)
    assert replays == len(frames) - 1 and entry.plain is None

    jstate = jstream.init_state(jnp.asarray(frames[0]), jcfg, REC)
    for i, f in enumerate(frames[1:], start=1):
        if i == DROP:
            jstate = jstream.FlowState(jstate.pyramid, None)
        jstate, jflow = jstream.step(jstate, jnp.asarray(f), jcfg, True, REC)
        np.testing.assert_allclose(got[i - 1].numpy(), np.asarray(jflow, np.float32),
                                   rtol=JAX_TOL, atol=JAX_TOL)


def _warm_state(cfg, frames):
    """A state that the warm key returned (its buffers), after two steps."""
    state = tof.init_state(torch.from_numpy(frames[0]), cfg, REC)
    state, _ = tof.step(state, torch.from_numpy(frames[1]), cfg, True, REC)
    state, _ = tof.step(state, torch.from_numpy(frames[2]), cfg, True, REC)
    return state


def _copied(entry) -> int:
    return sum(g.copied for g in entry.graphs)


def test_after_the_first_warm_step_only_the_frame_is_copied_in(stand_in):
    cfg = SERVE["lk"][0]
    frames = _frames()
    state = _warm_state(cfg, frames)
    entry = _warm_entry()
    assert _copied(entry) == 5  # the first warm step: 3 pyramid levels, the flow, the frame
    for k, f in enumerate(frames[3:6]):
        sets = entry.sets[(k + 1) % 2]  # the first warm step wrote set 1
        assert all(a.data_ptr() == b.data_ptr() for a, b in
                   zip((*state.pyramid, state.flow), sets, strict=True))
        before = _copied(entry)
        state, flow = tof.step(state, torch.from_numpy(f), cfg, True, REC)
        assert _copied(entry) == before + 1
        assert flow.data_ptr() != state.flow.data_ptr() and torch.equal(flow, state.flow)
    assert entry.plain is None


def test_passing_the_same_state_twice_gives_the_same_flow(stand_in):
    """The second call would write the set that the first call's returned
    state (still held) sits in: it replays the copy-in, clone-out graph,
    and the held state keeps its values."""
    cfg = SERVE["lk"][0]
    frames = _frames()
    state = _warm_state(cfg, frames)
    nxt = torch.from_numpy(frames[3])
    new_a, flow_a = tof.step(state, nxt, cfg, True, REC)
    kept = [t.clone() for t in (*new_a.pyramid, new_a.flow)]
    new_b, flow_b = tof.step(state, nxt, cfg, True, REC)
    assert torch.equal(flow_a, flow_b)
    assert all(torch.equal(a, b) for a, b in zip((*new_a.pyramid, new_a.flow), kept, strict=True))
    assert all(torch.equal(a, b) for a, b in zip(new_a.pyramid, new_b.pyramid, strict=True))
    assert _warm_entry().plain is not None
    # once the first result is let go, the swap resumes
    del new_a, kept
    entry = _warm_entry()
    plain_replays = entry.plain.replays
    _, flow_c = tof.step(state, nxt, cfg, True, REC)
    assert torch.equal(flow_c, flow_a) and entry.plain.replays == plain_replays


def test_a_state_from_another_key_or_the_caller_is_copied_in(stand_in):
    cfg = SERVE["lk"][0]
    frames = _frames()
    state = _warm_state(cfg, frames)
    entry = _warm_entry()
    eager_state = tstream.FlowState(tuple(t.clone() for t in state.pyramid), state.flow.clone())
    nxt = torch.from_numpy(frames[3])
    # a state the caller built from the key's own: copied in
    built = tstream.FlowState(tuple(t.clone() for t in state.pyramid), state.flow.clone())
    del state
    before = _copied(entry)
    _, flow = tof.step(built, nxt, cfg, True, REC)
    assert _copied(entry) == before + 5
    assert torch.equal(flow, tstream._step(eager_state, nxt, cfg, True, REC)[1])
    # a state of the cold key (a dropped frame before): copied in
    cold = tstream.FlowState(built.pyramid, None)
    state, _ = tof.step(cold, nxt, cfg, True, REC)
    before = _copied(entry)
    state, _ = tof.step(state, torch.from_numpy(frames[4]), cfg, True, REC)
    assert _copied(entry) == before + 5


def test_a_handed_flow_and_a_held_state_are_left_alone(stand_in):
    """A flow from step n is unchanged after steps n+1 and n+2; a state kept
    while the stream goes on keeps its values (the steps that would write
    its set replay the copy-in, clone-out graph), and the stream's flows
    stay the eager ones."""
    cfg = SERVE["lk"][0]
    frames = _frames()
    state = _warm_state(cfg, frames)
    eager = tstream.FlowState(tuple(t.clone() for t in state.pyramid), state.flow.clone())
    flows, kept = [], []
    for f in frames[3:7]:
        nxt = torch.from_numpy(f)
        state, flow = tof.step(state, nxt, cfg, True, REC)
        eager, want = tstream._step(eager, nxt, cfg, True, REC)
        assert torch.equal(flow, want)
        flows.append((flow, flow.clone()))
        kept.append((state, [t.clone() for t in (*state.pyramid, state.flow)]))
    for flow, copy in flows:
        assert torch.equal(flow, copy)
    for st, copy in kept:
        assert all(torch.equal(a, b) for a, b in zip((*st.pyramid, st.flow), copy, strict=True))


def test_two_streams_of_one_key_interleaved_match_their_eager_loops(stand_in):
    """Two streams with the same key, stepped in turn (JAX allows it): each
    stream's flows are its own eager loop's."""
    cfg = SERVE["lk"][0]
    frames = _frames()
    other = [f[::-1].copy() for f in frames]
    states = [tof.init_state(torch.from_numpy(s[0]), cfg, REC) for s in (frames, other)]
    eager = [tstream._init_state(torch.from_numpy(s[0]), cfg, REC) for s in (frames, other)]
    for i in range(1, 6):
        for k, seq in enumerate((frames, other)):
            nxt = torch.from_numpy(seq[i])
            states[k], flow = tof.step(states[k], nxt, cfg, True, REC)
            eager[k], want = tstream._step(eager[k], nxt, cfg, True, REC)
            assert torch.equal(flow, want), (i, k)
