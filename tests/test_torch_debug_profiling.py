"""The port's device utils against the JAX package's, on the CPU:
``utils/debug.py`` (per-stage A/B), ``utils/profiling.py`` (device time,
traces) and ``utils/native.py`` (the native frame ingestion, built by the
port itself).

The stage reports of both run on the same numpy inputs; the port's
``"plain"``/``"banded"`` backends stand where the JAX package's
``"xla"``/``"banded"`` stand.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import cuda_optical_flow_2_tpu as jof
from cuda_optical_flow_2_tpu.models.dis import DISConfig as JDIS
from cuda_optical_flow_2_tpu.models.farneback import FBConfig as JFB
from cuda_optical_flow_2_tpu.models.horn_schunck import HSConfig as JHS
from cuda_optical_flow_2_tpu.models.tvl1 import TVL1Config as JTVL1
from cuda_optical_flow_2_tpu.utils import io as jio
from cuda_optical_flow_2_tpu.utils import native as jnative
from cuda_optical_flow_2_tpu.utils.debug import stage_report as j_stage_report
from cuda_optical_flow_2_torch import interop
from cuda_optical_flow_2_torch.utils import debug, native, profiling


def _pair(h, w, v=(2.0, 1.0)):
    seq = jio.synthetic_sequence(2, h, w, velocity=v, noise=0.0)
    return seq[0].astype(np.float32), seq[1].astype(np.float32)


FAMILIES = {
    "lk": (jof.LKConfig(levels=2, window=9, iterations=1, max_displacement=8.0,
                        window_weights="box"), interop.lk_config_from_jax),
    "hs": (JHS(levels=2, iterations=12), interop.hs_config_from_jax),
    "tvl1": (JTVL1(levels=2, iterations=8), interop.tvl1_config_from_jax),
    "fb": (JFB(levels=2, iterations=2, winsize=9), interop.fb_config_from_jax),
    "dis": (JDIS(levels=2, window=9, iterations=2), interop.dis_config_from_jax),
}


def _keys(report):
    def name(b):
        return "plain" if b == "xla" else b

    return [(r.level, r.stage, name(r.backend), name(r.baseline), r.shape) for r in report]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_stage_names_levels_and_shapes_match_jax(family):
    """Every stage of every level and the end-to-end flow: the same names,
    levels and shapes as the JAX report (each backend against itself, so
    every stage the baseline runs is listed)."""
    prev, nxt = _pair(64, 64)
    jcfg, conv = FAMILIES[family]
    want = j_stage_report(prev, nxt, jcfg, backends=("xla",))
    got = debug.stage_report(prev, nxt, conv(jcfg), backends=("plain",), device="cpu")
    assert _keys(got) == _keys(want)
    assert all(r.max_abs == 0.0 for r in got)


@pytest.mark.parametrize("family", ["lk", "fb"])
def test_banded_and_oracle_within_jax_report(family):
    """``banded`` vs ``plain`` (and LK's ``oracle`` rows) within what the
    JAX package's ``banded``/``oracle`` vs ``xla`` report on the same
    inputs: the band emulation is exact on every stencil stage."""
    prev, nxt = _pair(64, 48)
    jcfg, conv = FAMILIES[family]
    backends = ("banded", "oracle")
    jrep = j_stage_report(prev, nxt, jcfg, backends=backends, n_bands=4)
    want = {k[:3]: r for k, r in zip(_keys(jrep), jrep)}
    got = debug.stage_report(prev, nxt, conv(jcfg), backends=backends, n_bands=4, device="cpu")
    assert [k[:3] for k in _keys(got)] == list(want)
    for r in got:
        w = want[(r.level, r.stage, r.backend)]
        if r.backend == "banded":
            assert r.max_abs == 0.0 == w.max_abs, (r, w)
        else:
            # the oracle's float32 accumulation order (window sums: documented
            # in the JAX test as the order-sensitive stage)
            assert r.max_abs <= max(w.max_abs, 1e-5), (r, w)


def test_sharded_flow_over_cpu_shards():
    """The ``sharded`` end-to-end row: spatial TP over n_bands shards of the
    inputs' device, against the unsharded plain flow (LK TP is bit-equal on
    CPU shards)."""
    prev, nxt = _pair(128, 48)
    cfg = interop.lk_config_from_jax(FAMILIES["lk"][0])
    rep = debug.stage_report(prev, nxt, cfg, backends=("sharded",), stages=("flow",),
                             n_bands=4, device="cpu")
    assert len(rep) == 1 and rep[0].stage == "flow" and rep[0].level == -1
    assert rep[0].max_abs == 0.0 and "E2E" in str(rep[0])
    one = debug.stage_report(prev, nxt, cfg, backends=("sharded",), stages=("flow",),
                             n_bands=1, device="cpu")
    assert one == []  # one shard is no sharding: the row is skipped


def test_kernel_backend_refused_on_cpu_tensors():
    prev, nxt = _pair(32, 32)
    cfg = interop.lk_config_from_jax(FAMILIES["lk"][0])
    for kw in ({"backends": ("kernel",)}, {"backends": ("banded",), "baseline": "kernel"}):
        with pytest.raises(ValueError, match="'kernel' backend .* needs CUDA tensors"):
            debug.stage_report(prev, nxt, cfg, device="cpu", **kw)
    with pytest.raises(ValueError, match="'kernel' backend"):
        debug.stage_report(torch.as_tensor(prev), torch.as_tensor(nxt), cfg)


def test_unknown_backend_and_empty_report():
    prev = np.zeros((32, 32), np.float32)
    cfg = interop.lk_config_from_jax(jof.LKConfig(levels=1, window=5))
    with pytest.raises(ValueError, match="unknown backend"):
        debug.stage_report(prev, prev, cfg, backends=("plain,kernel",), device="cpu")
    rep = debug.stage_report(prev, prev, cfg, backends=("banded",), baseline="oracle",
                             stages=("flow",), device="cpu")
    assert rep == [] and "no stages matched" in debug.format_report(rep)


def test_arrays_default_to_the_cuda_device():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    prev = np.zeros((32, 32), np.float32)
    cfg = interop.lk_config_from_jax(jof.LKConfig(levels=1, window=5))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        debug.stage_report(prev, prev, cfg, backends=("banded",))


@pytest.mark.parametrize("row_axis,halo", [(-2, 3), (-3, 2), (0, 0)])
def test_banded_lift_is_exact_for_a_stencil(row_axis, halo):
    """``banded`` of a row stencil of radius <= halo equals the stencil on
    the whole tensor (zero rows beyond the image, as the halo exchange)."""
    x = (torch.arange(2 * 24 * 5 * 2, dtype=torch.float32).reshape(2, 24, 5, 2) % 7)
    x = x.movedim(1, row_axis)
    ax = row_axis % x.ndim

    def shift(t, s):
        """t moved s rows along the row axis (s < 0: up), zero filled."""
        n = t.shape[ax]
        pad = torch.zeros_like(t.narrow(ax, 0, abs(s)))
        if s > 0:
            return torch.cat([pad, t.narrow(ax, 0, n - s)], dim=ax)
        return torch.cat([t.narrow(ax, -s, n + s), pad], dim=ax)

    def stencil(t):
        out = t.clone()
        for s in range(1, halo + 1):
            out = out + s * shift(t, s) - shift(t, -s)
        return out

    got = debug.banded(stencil, halo, 4, row_axis=row_axis)(x)
    assert torch.equal(got, stencil(x))


# --- profiling -------------------------------------------------------------


def test_device_time_is_seconds_per_call():
    calls = []
    x = torch.ones(64, 64)

    def fn(t):
        calls.append(1)
        return t * 2

    secs = profiling.device_time(fn, x, iters=5)
    assert isinstance(secs, float) and secs > 0
    assert len(calls) == profiling.WARMUP + 5  # warm-up, then the timed calls
    with pytest.raises(ValueError):
        profiling.device_time(fn, x, iters=0)


def test_device_time_takes_jax_perturb_arg():
    """JAX's ``device_time(fn, *args, iters, perturb_arg)``: the keyword is
    accepted (there is no chain to perturb, so it changes nothing)."""
    import inspect

    from cuda_optical_flow_2_tpu.utils import profiling as jprofiling

    jparams = inspect.signature(jprofiling.device_time).parameters
    params = inspect.signature(profiling.device_time).parameters
    assert params["perturb_arg"].default == jparams["perturb_arg"].default == 0
    assert params["perturb_arg"].kind == jparams["perturb_arg"].kind
    calls = []
    x, y = torch.ones(8, 8), torch.zeros(8, 8)
    secs = profiling.device_time(lambda a, b: calls.append(1) or a + b, x, y, iters=3,
                                 perturb_arg=1)
    assert isinstance(secs, float) and secs > 0 and len(calls) == profiling.WARMUP + 3


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "t")):
        torch.ones(32, 32).cumsum(0)
    with open(tmp_path / "t" / "trace.json") as f:
        assert "traceEvents" in json.load(f)


# --- native ----------------------------------------------------------------


def test_native_builds_into_the_package_build_dir_or_reports_numpy():
    """The library is built from native/framesrc.cpp into the package's
    _build/ (nothing is written into native/), or, without a compiler,
    ``available()`` reports the numpy path."""
    before = sorted(os.listdir(native.SOURCE.parent))
    built = native.build()
    assert sorted(os.listdir(native.SOURCE.parent)) == before
    path = native.library_path()
    assert path.parent.parent == native._BUILD_DIR and path.parent.name.startswith("native-")
    assert built == native.available()
    if built:
        assert path.exists() and (path.parent / "build.log").exists()
        assert os.path.realpath(native._lib._name) == os.path.realpath(path)


def test_native_outputs_equal_to_jax(rng):
    rgb = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    assert np.array_equal(native.gray_f32(rgb), jnative.gray_f32(rgb))
    assert np.array_equal(native.gray_u8(rgb), jnative.gray_u8(rgb))
    for t in (0, 5):
        assert np.array_equal(native.synthetic_frame(t, 40, 60, 2.0, 1.0),
                              jnative.synthetic_frame(t, 40, 60, 2.0, 1.0))
    with native.FrameStream.synthetic(4, 32, 48, vx=2, vy=1) as s:
        got = [f for _, f in s]
    assert len(got) == 4
    for t, f in enumerate(got):
        assert np.array_equal(f, jnative.synthetic_frame(t, 32, 48, 2, 1).astype(np.float32))


def test_native_numpy_path_gives_the_same_frames(rng, monkeypatch):
    rgb = rng.integers(0, 256, (21, 30, 3), dtype=np.uint8)
    want = (native.gray_f32(rgb), native.gray_u8(rgb), native.synthetic_frame(3, 20, 24, 1.5, 0.5))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_attempted", True)
    assert not native.available()
    got = (native.gray_f32(rgb), native.gray_u8(rgb), native.synthetic_frame(3, 20, 24, 1.5, 0.5))
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    with native.FrameStream.synthetic(3, 20, 24, vx=1.5, vy=0.5) as s:
        assert [t for t, _ in s] == [0, 1, 2]


def test_native_frame_stream_ppm_and_y4m(tmp_path, rng):
    frames = [rng.integers(0, 256, (12, 16, 3), dtype=np.uint8) for _ in range(3)]
    paths = []
    for i, f in enumerate(frames):
        paths.append(str(tmp_path / f"f{i}.ppm"))
        jio.write_ppm(paths[-1], f)
    with native.FrameStream.from_ppm(paths) as s:
        got = [f for _, f in s]
    assert all(np.array_equal(g, jnative.gray_f32(f)) for g, f in zip(got, frames))
    lumas = [rng.integers(0, 256, (12, 16), dtype=np.uint8) for _ in range(2)]
    jio.write_y4m(str(tmp_path / "v.y4m"), lumas)
    with native.FrameStream.from_y4m(str(tmp_path / "v.y4m")) as s:
        got = [f for _, f in s]
    assert len(got) == 2 and all(np.array_equal(g, l.astype(np.float32))
                                 for g, l in zip(got, lumas))


def test_stage_report_config_is_unchanged():
    """stage_report never mutates the config it is given (frozen
    dataclasses; every backend runs a replaced copy)."""
    cfg = interop.fb_config_from_jax(FAMILIES["fb"][0])
    before = dataclasses.asdict(cfg)
    debug.stage_report(*_pair(32, 32), cfg, backends=("banded",), device="cpu")
    assert dataclasses.asdict(cfg) == before
