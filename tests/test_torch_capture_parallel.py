"""The captured ``parallel/`` entries, ``track_sequence``, the advection and
the tools' device steps, on the CPU.

The JAX package jits its spatial-TP and grid entries (``shard_map`` under
``jax.jit``), ``sharded_flow`` and ``chunked_flow``, ``track_sequence``'s
scan and ``_advect_jit``; the port's counterparts replay CUDA graphs on
CUDA tensors (``capture.captured``) and keep their eager bodies as
``.eager``.  Here, through the stand-in graph of
``tests/torch_capture_stand_in.py`` (the body runs where a graph would be
captured and replayed; the counters, buffers and keys are the real code):
each captured entry is ``torch.equal`` to its eager body on two different
inputs, captures once per key, replays the eager call's launch counts, and
agrees with its JAX counterpart within the tolerance of the parity test of
its family (tests/test_torch_spatial.py, test_torch_tracking.py,
test_torch_capture.py).  Also: equal meshes share a key, and a space axis
over more than one device is captured with its frames placed as row
blocks (eagerly only over cards without peer access).  The CUDA capture
itself runs in chip_smoke.py phases 8o and 8p.

Sizes are tests/test_torch_spatial.py's: 256x48 (256x64 for DIS) on CPU
meshes of 8 (FB and DIS: 4) shards.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh

import cuda_optical_flow_2_tpu as jof
from cuda_optical_flow_2_tpu import parallel as jparallel
from cuda_optical_flow_2_tpu.models import dis as jdis
from cuda_optical_flow_2_tpu.models import farneback as jfb
from cuda_optical_flow_2_tpu.models import horn_schunck as jhs
from cuda_optical_flow_2_tpu.models import tracking as jtr
from cuda_optical_flow_2_tpu.models import tvl1 as jtvl1

import cuda_optical_flow_2_torch as tof
from cuda_optical_flow_2_torch import capture, interop, parallel
from cuda_optical_flow_2_torch.cli import demo, evaluate
from cuda_optical_flow_2_torch.kernels import (
    bilateral_tap,
    fb_step_fused,
    hs_sweep,
    lk_fused,
    lk_step_fused,
    median_select,
    poly_exp_fused,
    pyr_down,
    tvl1_sweep,
    warp_select,
)
from cuda_optical_flow_2_torch.models import tracking as ttr
from cuda_optical_flow_2_torch.parallel import multihost, spatial
from cuda_optical_flow_2_torch.utils import viz
from cuda_optical_flow_2_torch.utils.io import synthetic_sequence

from torch_capture_stand_in import StandInGraph, stand_in  # noqa: F401  (a fixture)

CPU8 = [torch.device("cpu")] * 8
# tests/test_torch_spatial.py's limits of TP against JAX's TP
LK_PYRAMID_TOL, HS_TOL, TVL1_TOL, FB_TOL, DIS_TOL = 5e-3, 5e-4, 5e-4, 2e-2, 1e-4
LK_TOL = 2e-3      # tests/test_torch_capture.py's LK family limit
TRACK_TOL, POINT_TOL = 1e-3, 1e-5  # tests/test_torch_tracking.py


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Torch on one thread (see tests/test_torch_spatial.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(h, w, seed=0, velocity=(2.0, 1.0)):
    fr = synthetic_sequence(2, h, w, velocity=velocity, period=24, seed=seed)
    return torch.from_numpy(fr[0].astype(np.float32)), torch.from_numpy(fr[1].astype(np.float32))


def _pairs(h, w):
    """The (2, 1) pair and a second pair of another scene and motion."""
    return _pair(h, w), _pair(h, w, seed=1, velocity=(-1.0, 1.5))


def _space(n):
    return parallel.make_mesh(axis_name="space", devices=CPU8[:n])


def _jspace(n):
    return jparallel.make_mesh(n, axis_name="space")


def _grid_meshes():
    return (parallel.Mesh(np.array(CPU8, dtype=object).reshape(2, 4), ("batch", "space")),
            JMesh(np.asarray(jax.devices()).reshape(2, 4), ("batch", "space")))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=0, atol=tol)


# (port entry, JAX entry, JAX config with use_pallas=False, converter, (h, w),
#  shards, tiles, tolerance)
TP = {
    "lk": (parallel.spatial_pyramidal_lk, jparallel.spatial_pyramidal_lk,
           jof.LKConfig(levels=2, window=9, iterations=2, temporal_kernel="gauss3",
                        max_displacement=4, use_pallas=False),
           interop.lk_config_from_jax, (256, 48), 8, {}, LK_PYRAMID_TOL),
    "lk_prefilter": (parallel.spatial_pyramidal_lk, jparallel.spatial_pyramidal_lk,
                     jof.LKConfig(levels=2, window=9, iterations=1, max_displacement=16,
                                  prefilter=jof.BilateralConfig(), use_pallas=False),
                     interop.lk_config_from_jax, (256, 48), 8, {}, LK_PYRAMID_TOL),
    "hs": (parallel.spatial_pyramidal_hs, jparallel.spatial_pyramidal_hs,
           jhs.HSConfig(alpha=8.0, levels=2, iterations=12, max_displacement=8,
                        use_pallas=False),
           interop.hs_config_from_jax, (256, 48), 8, {"sweep_tile": 6}, HS_TOL),
    "tvl1": (parallel.spatial_pyramidal_tvl1, jparallel.spatial_pyramidal_tvl1,
             jtvl1.TVL1Config(levels=2, warps=1, iterations=6, max_displacement=8,
                              use_pallas=False),
             interop.tvl1_config_from_jax, (256, 48), 8, {"iter_tile": 4}, TVL1_TOL),
    "fb": (parallel.spatial_pyramidal_fb, jparallel.spatial_pyramidal_fb,
           jfb.FBConfig(levels=2, iterations=2, winsize=11, max_displacement=4,
                        use_pallas=False),
           interop.fb_config_from_jax, (256, 48), 4, {}, FB_TOL),
    "dis": (parallel.spatial_pyramidal_dis, jparallel.spatial_pyramidal_dis,
            jdis.DISConfig(levels=2, window=9, max_displacement=4, use_pallas=False),
            interop.dis_config_from_jax, (256, 64), 4, {}, DIS_TOL),
}

# every band wrapper and the shard-local kernels a TP path launches: on CPU
# tensors the wrappers take their plain versions and count nothing, so a spy
# counts each call as the launch it would be on the card
SPIED = [(pyr_down, "pyr_down"), (lk_step_fused, "lk_band_step"), (lk_fused, "lk_residual"),
         (bilateral_tap, "bilateral_kernel_band"), (hs_sweep, "hs_relax_band"),
         (tvl1_sweep, "tvl1_relax_band"), (fb_step_fused, "fb_band_step"),
         (warp_select, "warp_bilinear_select_band"), (median_select, "median_filter_kernel"),
         (poly_exp_fused, "poly_expansion_kernel"), (lk_step_fused, "lk_level_step"),
         (warp_select, "warp_bilinear_select")]


@pytest.fixture
def counting(monkeypatch):
    """Each spied wrapper adds one to its ``launches`` per call, as it does
    per launch on the card; ``delta()`` gives the counters' change since the
    fixture began."""
    capture.counters()  # the registry holds the wrappers themselves, not the spies
    for module, name in SPIED:
        orig = getattr(module, name)

        def spy(*args, _orig=orig, **kwargs):
            _orig.launches += 1
            return _orig(*args, **kwargs)

        monkeypatch.setattr(module, name, spy)
    start = capture.snapshot()
    yield lambda: capture.delta(start, capture.snapshot())
    capture.restore(start)


def _counted(delta, fn):
    """(fn's result, the counters' change over the call)."""
    before = delta()
    out = fn()
    after = delta()
    return out, {k: after.get(k, 0) - before.get(k, 0) for k in after
                 if after.get(k, 0) != before.get(k, 0)}


def _held_to_eager(entry, calls, delta):
    """Each call (an argument tuple) through ``entry`` and ``entry.eager``:
    results torch.equal, launches equal per call; returns the results."""
    outs = []
    for args in calls:
        want, eager_counts = _counted(delta, lambda: entry.eager(*args))
        got, counts = _counted(delta, lambda: entry(*args))
        assert counts == eager_counts
        assert torch.equal(got, want)
        outs.append(got)
    return outs


# --- the TP and grid entries of the five families ------------------------------


@pytest.mark.parametrize("name", list(TP))
def test_tp_entry_captured_equals_eager_and_jax(name, stand_in, counting):
    """Two pairs through the captured entry: each torch.equal to the eager
    body with the eager call's launches, one capture for the key, the first
    result left alone by the second replay, and JAX's TP within the family's
    TP limit.  The port side runs the kernel path (band wrappers)."""
    entry, jentry, jcfg, convert, (h, w), shards, tiles, tol = TP[name]
    cfg = dataclasses.replace(convert(jcfg), use_pallas=True)
    (pa, na), (pb, nb) = _pairs(h, w)
    mesh = _space(shards)
    a, b = _held_to_eager(entry, [(pa, na, cfg, mesh, "space", *tiles.values()),
                                  (pb, nb, cfg, mesh, "space", *tiles.values())], counting)
    assert StandInGraph.built == 1 and len(entry.cache.entries) == 1
    assert not torch.equal(a, b)
    assert counting()  # the spies saw the band kernels
    want = jentry(jnp.asarray(pa.numpy()), jnp.asarray(na.numpy()), jcfg, _jspace(shards),
                  **tiles)
    _close(a, want, tol)
    # the model-generic dispatch replays the same graph
    got = parallel.spatial_pyramidal_flow(pb, nb, cfg, mesh, "space", **tiles)
    assert torch.equal(got, b) and StandInGraph.built == 1


def test_grid_pyramidal_lk_captures_per_group(stand_in, counting):
    """A (2 batch x 4 space) mesh: each batch group is one TP call on its
    space devices, both groups one key, so one capture; torch.equal to the
    eager grid with its launches, and JAX's grid within the LK limit."""
    entry, _, jcfg, convert, (h, w), *_ = TP["lk"]
    cfg = dataclasses.replace(convert(jcfg), use_pallas=True)
    (pa, na), (pb, nb) = _pairs(h, w)
    mesh, jmesh = _grid_meshes()
    batches = [(torch.stack([pa, pb, pa, pb]), torch.stack([na, nb, na, nb])),
               (torch.stack([pb, pa, nb, na]), torch.stack([nb, na, pb, pa]))]
    got = _held_to_eager(parallel.grid_pyramidal_lk,
                         [(p, n, cfg, mesh) for p, n in batches], counting)
    assert StandInGraph.built == 1 and len(entry.cache.entries) == 1
    want = jparallel.grid_pyramidal_lk(jnp.asarray(batches[0][0].numpy()),
                                       jnp.asarray(batches[0][1].numpy()), jcfg, jmesh)
    _close(got[0], want, LK_PYRAMID_TOL)


def test_grid_pyramidal_flow_captures_per_group(stand_in, counting):
    entry, _, jcfg, convert, (h, w), _, tiles, tol = TP["hs"]
    cfg = dataclasses.replace(convert(jcfg), use_pallas=True)
    (pa, na), (pb, nb) = _pairs(h, w)
    mesh, jmesh = _grid_meshes()
    batches = [(torch.stack([pa, pb]), torch.stack([na, nb])),
               (torch.stack([nb, na]), torch.stack([pb, pa]))]
    got = _held_to_eager(parallel.grid_pyramidal_flow,
                         [(p, n, cfg, mesh, "batch", "space", 6, 8) for p, n in batches],
                         counting)
    assert StandInGraph.built == 1 and len(entry.cache.entries) == 1
    want = jparallel.grid_pyramidal_flow(jnp.asarray(batches[0][0].numpy()),
                                         jnp.asarray(batches[0][1].numpy()), jcfg, jmesh,
                                         **tiles)
    _close(got[0], want, tol)


# --- the mesh as a key, and the one-device rule ---------------------------------


def test_equal_meshes_share_a_key(stand_in):
    p, n = _pair(64, 32)
    cfg = tof.LKConfig(levels=1, window=9, max_displacement=4)
    key = parallel.spatial_pyramidal_lk.key
    m1, m2 = _space(4), parallel.make_mesh(axis_name="space", devices=["cpu"] * 4)
    assert m1 == m2 and hash(m1) == hash(m2) and m1 is not m2
    assert key(p, n, cfg, m1) == key(p, n, cfg, m2)
    for other in (_space(2), parallel.make_mesh(axis_name="rows", devices=CPU8[:4]),
                  parallel.Mesh(np.array(CPU8[:4], dtype=object).reshape(2, 2), ("a", "space")),
                  parallel.make_mesh(axis_name="space", devices=["cpu:0"] * 4)):
        assert other != m1
    assert m1 != "not a mesh"
    parallel.spatial_pyramidal_lk(p, n, cfg, m1)
    parallel.spatial_pyramidal_lk(p, n, cfg, m2)
    assert StandInGraph.built == 1 and len(parallel.spatial_pyramidal_lk.cache.entries) == 1


def test_one_device_rule(monkeypatch):
    """``one_device`` decides whether the frames go whole to one device or
    as row blocks to theirs; ``peer_access`` whether a several-cards axis
    is captured: one card named twice needs nothing, two cards need peer
    access both ways (asked of ``torch.cuda.can_device_access_peer``)."""
    cuda0, cuda1 = torch.device("cuda", 0), torch.device("cuda", 1)
    assert spatial.one_device([cuda0] * 3) == cuda0
    assert spatial.one_device([cuda0]) == cuda0
    assert spatial.one_device([cuda0, cuda1, cuda0]) is None
    assert spatial.one_device([torch.device("cuda"), cuda0]) is None
    assert spatial.one_device(CPU8) == torch.device("cpu")
    assert spatial.one_device([torch.device("cpu"), torch.device("cpu:0")]) is None

    asked = []

    def can_access(a, b):
        asked.append((a, b))
        return {a, b} != {1, 2}  # cards 1 and 2 cannot reach each other

    monkeypatch.setattr(torch.cuda, "can_device_access_peer", can_access)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert spatial.peer_access(CPU8 + [torch.device("cpu:0")]) and not asked
    assert spatial.peer_access([torch.device("cuda"), cuda0] * 2) and not asked
    assert spatial.peer_access([torch.device("cuda"), cuda1, torch.device("cuda", 3)])
    assert sorted(asked) == [(0, 1), (0, 3), (1, 0), (1, 3), (3, 0), (3, 1)]
    assert not spatial.peer_access([cuda0, cuda1, torch.device("cuda", 2)])


def _mixed(n):
    """A space mesh of ``n`` entries that alternate ``cpu`` and ``cpu:0``:
    several devices to ``one_device``, as ``cuda`` and ``cuda:0`` are on a
    machine with one card."""
    return parallel.make_mesh(axis_name="space", devices=["cpu", "cpu:0"] * (n // 2))


def test_space_axis_over_several_devices_runs_eagerly(stand_in, monkeypatch, counting):
    """A space axis over several devices is captured: the frames go to the
    graph as their row blocks, one per device (JAX's ``in_shardings``), the
    call is torch.equal to the eager body with its launches and within the
    LK limit of JAX's TP; in a mixed grid both groups capture (one key
    each).  It runs eagerly, nothing captured, only over cards without peer
    access (``spatial.peer_access`` False)."""
    entry, jentry, jcfg, convert, (h, w), *_ = TP["lk"]
    cfg = dataclasses.replace(convert(jcfg), use_pallas=True)
    (pa, na), (pb, nb) = _pairs(h, w)
    mixed = _mixed(4)
    a, _ = _held_to_eager(entry, [(pa, na, cfg, mixed), (pb, nb, cfg, mixed)], counting)
    assert StandInGraph.built == 1
    (graph,) = entry.cache.entries.values()
    assert [tuple(t.shape) for t in graph.inputs] == [(h // 4, w)] * 8  # 2 frames x 4 blocks
    assert torch.equal(a, entry.eager(pa, na, cfg, _space(4)))
    want = jentry(jnp.asarray(pa.numpy()), jnp.asarray(na.numpy()), jcfg, _jspace(4))
    _close(a, want, LK_PYRAMID_TOL)

    grid = parallel.Mesh([["cpu"] * 4, ["cpu", "cpu:0"] * 2], ("batch", "space"))
    pg, ng = torch.stack([pa, pb]), torch.stack([na, nb])
    _held_to_eager(parallel.grid_pyramidal_lk, [(pg, ng, cfg, grid)], counting)
    assert StandInGraph.built == 3 and len(entry.cache.entries) == 3

    capture.clear()
    StandInGraph.built = 0
    monkeypatch.setattr(spatial, "peer_access", lambda devices: False)
    assert torch.equal(entry(pa, na, cfg, mixed), a)
    assert torch.equal(parallel.grid_pyramidal_lk(pg, ng, cfg, grid),
                       parallel.grid_pyramidal_lk.eager(pg, ng, cfg, grid))
    assert StandInGraph.built == 1  # the grid's one-device group alone


@pytest.mark.parametrize("name", list(TP))
def test_tp_entry_over_several_devices_captured(name, stand_in, counting):
    """Every family's TP entry on a space mesh of several devices (``cpu``
    and ``cpu:0`` in turn) captures once with its frames as placed row
    blocks, is torch.equal to its eager body over the same mesh and to the
    one-device mesh's result, and within the family's TP limit of JAX."""
    entry, jentry, jcfg, convert, (h, w), shards, tiles, tol = TP[name]
    cfg = dataclasses.replace(convert(jcfg), use_pallas=True)
    pa, na = _pair(h, w)
    mixed = _mixed(shards)
    (got,) = _held_to_eager(entry, [(pa, na, cfg, mixed, "space", *tiles.values())], counting)
    assert StandInGraph.built == 1
    (graph,) = entry.cache.entries.values()
    assert len(graph.inputs) == 2 * shards
    assert torch.equal(got, entry.eager(pa, na, cfg, _space(shards), "space", *tiles.values()))
    want = jentry(jnp.asarray(pa.numpy()), jnp.asarray(na.numpy()), jcfg, _jspace(shards),
                  **tiles)
    _close(got, want, tol)


class _FakeCuda:
    """Stand-ins for the ``torch.cuda`` calls of ``capture.Graph``'s CUDA
    methods, logging what each does to which card's stream: the order of a
    multi-device capture and replay, checked without a card."""

    class Stream:
        def __init__(self, device, log, name):
            self.device, self.log, self.name = torch.device(device), log, name

        def wait_stream(self, other):
            self.log.append(("wait", self.name, other.name))

        def __repr__(self):
            return self.name

    def __init__(self, monkeypatch):
        import contextlib

        self.log, self.current, self.card = [], {}, [0]
        fake = self

        def stream(device=None):
            d = torch.device(device)
            return fake.Stream(d, fake.log, f"capture{d.index}")

        def current_stream(device=None):
            i = torch.device(device).index
            return fake.current.setdefault(i, fake.Stream(torch.device("cuda", i), fake.log,
                                                          f"current{i}"))

        @contextlib.contextmanager
        def use_stream(s):
            before = current_stream(s.device)
            fake.current[s.device.index] = s
            try:
                yield
            finally:
                fake.current[s.device.index] = before

        @contextlib.contextmanager
        def device(d):
            before = fake.card[0]
            fake.card[0] = torch.device(d).index
            try:
                yield
            finally:
                fake.card[0] = before

        @contextlib.contextmanager
        def graph(g, pool=None, stream=None):
            fake.log.append(("begin", stream.name if stream is not None else None, fake.card[0]))
            with use_stream(stream if stream is not None else fake.Stream(
                    torch.device("cuda", 0), fake.log, "default")):
                yield
            fake.log.append(("end",))

        @contextlib.contextmanager
        def use_mem_pool(pool, d):
            fake.log.append(("pool", pool.card, torch.device(d).index))
            yield

        class MemPool:
            def __init__(self):
                self.card = fake.card[0]

        class CUDAGraph:
            def replay(self):
                fake.log.append(("replay", fake.current[fake.card[0]].name))

        for name, value in (("Stream", stream), ("current_stream", current_stream),
                            ("stream", use_stream), ("device", device), ("graph", graph),
                            ("use_mem_pool", use_mem_pool), ("MemPool", MemPool),
                            ("CUDAGraph", CUDAGraph), ("graph_pool_handle", object),
                            ("synchronize", lambda d=None: fake.log.append(("sync", d.index)))):
            monkeypatch.setattr(torch.cuda, name, value)
        monkeypatch.setattr(capture, "_capture_streams", {})


def test_capture_on_several_cards_is_one_graph(monkeypatch):
    """The order of a multi-device capture and replay (the design in
    ``capture.py``'s docstring), through stand-ins of the ``torch.cuda``
    calls: the capture begins on the first card's own capture stream (not
    ``torch.cuda.graph``'s one default stream of the process, which lies on
    whichever card captured first); each peer's capture stream waits on it
    (the fork) and is that card's current stream for the body, with a pool
    made on that card; the first card's stream waits on each peer's after
    the body (the join).  A replay waits on every peer's current stream
    (where the inputs were copied in) and each peer's current stream then
    waits on the replay's."""
    cards = [torch.device("cuda", i) for i in range(3)]
    fake = _FakeCuda(monkeypatch)
    graph = object.__new__(capture.Graph)
    graph.device, graph.peers, graph.inputs = cards[0], tuple(cards[1:]), []

    def body():
        fake.log.append(("body", fake.card[0], fake.current[1].name, fake.current[2].name))
        return "out"

    assert graph._capture(body) == "out"
    assert fake.log == [
        ("sync", 1), ("sync", 2), ("begin", "capture0", 0),
        ("wait", "capture1", "capture0"), ("pool", 1, 1),
        ("wait", "capture2", "capture0"), ("pool", 2, 2),
        ("body", 0, "capture1", "capture2"),
        ("wait", "capture0", "capture1"), ("wait", "capture0", "capture2"), ("end",)]

    fake.log.clear()
    graph._launch()
    assert fake.log == [("wait", "current0", "current1"), ("wait", "current0", "current2"),
                        ("replay", "current0"),
                        ("wait", "current1", "current0"), ("wait", "current2", "current0")]

    # one card: no peer, and the capture begins on that card's own stream
    fake.log.clear()
    single = object.__new__(capture.Graph)
    single.device, single.peers, single.inputs = cards[2], (), []
    assert single._capture(lambda: "one") == "one"
    assert fake.log == [("begin", "capture2", 2), ("end",)]


def test_captured_call_spans_the_cards_of_its_tensors(monkeypatch):
    """``captured`` gives a graph its first tensor's card as ``device`` and
    every other card its tensors lie on as ``peers``, once each, in order."""
    built = []

    class Recording:
        def __init__(self, body, tensors, device, name, key, peers=()):
            built.append((device, peers))
            self.outputs = body(*tensors)

        def replay(self, tensors):
            return self.outputs

    class OnCard(torch.Tensor):
        pass

    def on(t, index):
        t = t.as_subclass(OnCard)
        t.card = torch.device("cuda", index)
        return t

    monkeypatch.setattr(capture, "Graph", Recording)
    monkeypatch.setattr(capture, "runs_eagerly", lambda tensors: False)
    monkeypatch.setattr(OnCard, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(OnCard, "device", property(lambda self: self.card))
    entry = capture.captured(lambda blocks: sum(b.as_subclass(torch.Tensor) for b in blocks))
    x = torch.ones(2)
    entry([on(x, 2), on(x, 0), on(x, 2), on(x, 1)])
    assert built == [(torch.device("cuda", 2), (torch.device("cuda", 0), torch.device("cuda", 1)))]


def test_tp_entries_on_cpu_run_eagerly():
    """Without the stand-in, CPU tensors never reach a capture."""
    p, n = _pair(64, 32)
    cfg = tof.LKConfig(levels=1, window=9, max_displacement=4)
    before = capture.graphs_captured()
    got = parallel.spatial_pyramidal_lk(p, n, cfg, _space(4))
    assert torch.equal(got, parallel.spatial_pyramidal_lk.eager(p, n, cfg, _space(4)))
    assert capture.graphs_captured() == before
    assert not parallel.spatial_pyramidal_lk.cache.entries


# --- batch sharding ------------------------------------------------------------


@pytest.mark.parametrize("family", ["lk", "hs"])
def test_sharded_flow_replays_the_family_jit_per_shard(family, stand_in, counting):
    """Batch 4 over 2 devices: each shard replays ``pyramidal_<family>_jit``
    (both shards one key: one capture); torch.equal to the eager body,
    JAX's ``sharded_flow`` within the family limit; the LK alias and the
    multi-process entry (one process) take the same path."""
    jcfg, jit, tol = {
        "lk": (jof.LKConfig(levels=2, window=9, use_pallas=False), tof.pyramidal_lk_jit, LK_TOL),
        "hs": (jhs.HSConfig(levels=2, iterations=10, use_pallas=False),
               tof.models.horn_schunck.pyramidal_hs_jit, 2e-4),
    }[family]
    cfg = dataclasses.replace(
        interop.lk_config_from_jax(jcfg) if family == "lk" else interop.hs_config_from_jax(jcfg),
        use_pallas=True)
    (pa, na), (pb, nb) = _pairs(64, 48)
    mesh = parallel.make_mesh(devices=CPU8[:2])
    batches = [(torch.stack([pa, pb, na, nb]), torch.stack([na, nb, pa, pb])),
               (torch.stack([nb, na, pb, pa]), torch.stack([pb, pa, nb, na]))]
    got = _held_to_eager(parallel.sharded_flow, [(p, n, cfg, mesh) for p, n in batches],
                         counting)
    assert StandInGraph.built == 1 and len(jit.cache.entries) == 1
    want = jparallel.sharded_flow(jnp.asarray(batches[0][0].numpy()),
                                  jnp.asarray(batches[0][1].numpy()), jcfg,
                                  jparallel.make_mesh(2))
    _close(got[0], want, tol)
    if family == "lk":
        assert torch.equal(parallel.sharded_pyramidal_lk(*batches[1], cfg, mesh), got[1])
    assert torch.equal(multihost.sharded_flow_from_local(*batches[1], cfg, mesh), got[1])
    assert StandInGraph.built == 1


def test_chunked_flow_one_graph_over_the_loop(stand_in, counting):
    jcfg = jof.LKConfig(levels=2, window=9, use_pallas=False)
    cfg = dataclasses.replace(interop.lk_config_from_jax(jcfg), use_pallas=True)
    (pa, na), (pb, nb) = _pairs(64, 48)
    batches = [(torch.stack([pa, pb, na, nb]), torch.stack([na, nb, pa, pb])),
               (torch.stack([nb, na, pb, pa]), torch.stack([pb, pa, nb, na]))]
    got = _held_to_eager(parallel.chunked_flow, [(p, n, cfg, 2) for p, n in batches], counting)
    assert StandInGraph.built == 1 and len(parallel.chunked_flow.cache.entries) == 1
    want = jparallel.chunked_flow(jnp.asarray(batches[0][0].numpy()),
                                  jnp.asarray(batches[0][1].numpy()), jcfg, chunk=2)
    _close(got[0], want, LK_TOL)
    parallel.chunked_flow(*batches[0], cfg, 4)  # another chunk: another key
    assert StandInGraph.built == 2


# --- tracking ------------------------------------------------------------------


def _clip(seed, velocity, t=5, h=64, w=80):
    return synthetic_sequence(t, h, w, velocity=velocity, period=24, seed=seed).astype(np.float32)


@pytest.mark.parametrize("warm_start", [True, False])
def test_track_sequence_one_graph_per_clip_shape(warm_start, stand_in, counting):
    """Two clips of one shape: one capture; positions and liveness
    torch.equal to the eager scan, launches per clip the eager clip's,
    JAX's jitted scan within the tracking limit.  A one-frame clip returns
    the empty result without a capture."""
    jcfg = jof.LKConfig(levels=3, window=11, temporal_kernel="gauss3", iterations=2,
                        use_pallas=False)
    cfg = dataclasses.replace(interop.lk_config_from_jax(jcfg), use_pallas=True)
    clips = [_clip(0, (2.0, 1.0)), _clip(1, (-1.0, 1.5))]
    rng = np.random.default_rng(0)
    pts = np.stack([rng.uniform(4, 76, 30), rng.uniform(4, 60, 30)], -1).astype(np.float32)
    outs = []
    for clip in clips:
        args = (torch.from_numpy(clip), torch.from_numpy(pts), cfg, warm_start)
        want, eager_counts = _counted(counting, lambda: ttr.track_sequence.eager(*args))
        got, counts = _counted(counting, lambda: ttr.track_sequence(*args))
        assert counts == eager_counts and counts
        assert all(torch.equal(g, w) for g, w in zip(got, want, strict=True))
        outs.append(got)
    assert StandInGraph.built == 1 and len(ttr.track_sequence.cache.entries) == 1
    jp, ja = jtr.track_sequence(jnp.asarray(clips[0]), pts, jcfg, warm_start=warm_start)
    _close(outs[0][0], jp, TRACK_TOL)
    np.testing.assert_array_equal(outs[0][1].numpy(), np.asarray(ja))
    # numpy frames and list points take the same graph (made tensors first)
    again = ttr.track_sequence(clips[1], pts.tolist(), cfg, warm_start, device="cpu")
    assert torch.equal(again[0], outs[1][0]) and StandInGraph.built == 1
    pos, alive = ttr.track_sequence(clips[0][:1], pts, cfg, warm_start, device="cpu")
    assert tuple(pos.shape) == (0, 30, 2) and tuple(alive.shape) == (0, 30)
    assert StandInGraph.built == 1


def test_advect_jit_equals_eager_and_jax(stand_in):
    rng = np.random.default_rng(3)
    flows = [rng.normal(0, 3, (16, 24, 2)).astype(np.float32) for _ in range(2)]
    pts = np.stack([rng.uniform(-3, 26, 40), rng.uniform(-3, 18, 40)], -1).astype(np.float32)
    alive = torch.from_numpy(rng.uniform(size=40) > 0.2)
    for flow in flows:
        args = (torch.from_numpy(flow), torch.from_numpy(pts), alive)
        got = ttr._advect_jit(*args)
        want = ttr.advect_points(*args)
        assert all(torch.equal(g, w) for g, w in zip(got, want, strict=True))
        jp, ja = jtr._advect_jit(jnp.asarray(flow), jnp.asarray(pts), jnp.asarray(alive.numpy()))
        _close(got[0], jp, POINT_TOL)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ja))
    assert StandInGraph.built == 1
    ttr._advect_jit(torch.from_numpy(flows[0]), torch.from_numpy(pts))  # alive None: a key
    assert StandInGraph.built == 2
    assert ttr._advect_jit.eager is ttr.advect_points


def test_track_points_advects_through_the_captured_step(stand_in):
    clip = _clip(0, (2.0, 1.0), t=4)
    pts = np.array([[20.0, 20.0], [40.5, 30.25]], np.float32)
    cfg = tof.LKConfig(levels=2, window=9)
    got = [p for _, p, _ in ttr.track_points(list(clip), pts, cfg, device="cpu")]
    want = ttr.track_sequence.eager(clip, pts, cfg, device="cpu")[0]
    for t, g in enumerate(got):
        assert torch.equal(g, want[t])
    assert len(ttr._advect_jit.cache.entries) == 1


# --- the tools' device steps ------------------------------------------------------


@pytest.mark.parametrize("fill", [False, True])
def test_evaluate_step_captured(fill, stand_in):
    cfg = tof.LKConfig(levels=2, window=9)
    step = evaluate._step_jit()
    (pa, na), (pb, nb) = _pairs(48, 64)
    for p, n in ((pa, na), (pb, nb)):
        assert torch.equal(step(p, n, cfg, fill), evaluate._step(p, n, cfg, fill))
    assert StandInGraph.built == 1 and step is evaluate._step_jit()


def test_demo_render_captured(stand_in):
    rng = np.random.default_rng(5)
    for _ in range(2):
        flow = torch.from_numpy(rng.normal(0, 4, (24, 32, 2)).astype(np.float32))
        for max_flow in (None, 5.0):
            assert torch.equal(demo._render(flow, max_flow),
                               viz.flow_to_color_device(flow, max_flow))
    assert StandInGraph.built == 2  # one key per max_flow
