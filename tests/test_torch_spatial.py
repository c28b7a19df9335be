"""The port's spatial and batch sharding against the JAX package (CPU).

Spatial TP of ``cuda_optical_flow_2_torch.parallel`` on a mesh of eight CPU
devices against the JAX package's same entry on its eight virtual CPU
devices (``tests/conftest.py``), both on the plain path
(``use_pallas=False``), and against the port's unsharded pipelines.  With
``use_pallas`` the CPU shards take the band kernels' plain versions, so the
kernel-path TP is held to the unsharded kernel path.  Inputs: period-24
synthetic textures moving (2, 1) px, from seeds.

Tolerances, JAX's own for TP against unsharded (tests/test_parallel.py):
1e-4 px at a single level, 5e-3 px for an LK pyramid (the warp amplifies
float-order noise level by level), 5e-4 px for HS and TV-L1, 2e-2 px for
Farnebäck (1/det of the windowed normal equations amplifies float order),
1e-4 px for DIS (JAX's limit for its kernel-path DIS TP; the refinement's
cumsum window means round differently on a band, 3.4e-6 px here), with a
(2, 1) median check.  The two packages' TP paths are held to the same
limits.

The window-limit dispatch: past a CUDA kernel's window limit the models and
the TP levels take the plain composition, decided from the config; spies
on the kernel wrappers show which ran (on the CPU every wrapper would take
its plain version itself, so only the call tells).
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
from cuda_optical_flow_2_tpu.models import tvl1 as jtvl1
from cuda_optical_flow_2_tpu.parallel import spatial as jspatial
from cuda_optical_flow_2_tpu.parallel import spatial_models as jspatial_models

import cuda_optical_flow_2_torch as tof
from cuda_optical_flow_2_torch import parallel
from cuda_optical_flow_2_torch.interop import (
    dis_config_from_jax,
    fb_config_from_jax,
    hs_config_from_jax,
    lk_config_from_jax,
    tvl1_config_from_jax,
)
from cuda_optical_flow_2_torch.kernels import (
    bilateral_tap,
    fb_step_fused,
    hs_sweep,
    lk_fused,
    lk_step_fused,
    poly_exp_fused,
    tvl1_sweep,
    warp_select,
)
from cuda_optical_flow_2_torch.parallel import spatial, spatial_models
from cuda_optical_flow_2_torch.utils.io import synthetic_sequence

SINGLE_LEVEL_TOL = 1e-4
LK_PYRAMID_TOL = 5e-3
HS_TOL = 5e-4
TVL1_TOL = 5e-4
FB_TOL = 2e-2
DIS_TOL = 1e-4
CPU8 = [torch.device("cpu")] * 8


def _pair(h, w, seed=0, velocity=(2.0, 1.0)):
    fr = synthetic_sequence(2, h, w, velocity=velocity, period=24, seed=seed)
    return fr[0].astype(np.float32), fr[1].astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _j(a):
    return jnp.asarray(np.asarray(a, np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(
        np.asarray(got, np.float32), np.asarray(want, np.float32), rtol=0, atol=tol
    )


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Run torch on one thread here.  The shard loops issue thousands of
    small ops, and torch spreads an expensive elementwise op such as
    ``exp`` over every core even at a few thousand elements: a 2x128x32
    ``exp`` took 84 us on 8 threads and 9 us on one on this test's CPU, and
    the 33x33 plain bilateral runs 3267 of them.  Under several pytest
    workers the threads contend and such a case stalled for a minute.
    Elementwise results do not depend on the thread count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mesh():
    return parallel.make_mesh(axis_name="space", devices=CPU8)


def _jmesh():
    return jparallel.make_mesh(axis_name="space")


# --- spatial_pyramidal_lk -----------------------------------------------


@pytest.mark.parametrize(
    "kw,tol",
    [
        (dict(levels=1, window=11, iterations=1, max_displacement=16), SINGLE_LEVEL_TOL),
        (dict(levels=2, window=9, iterations=2, temporal_kernel="gauss3", max_displacement=4),
         LK_PYRAMID_TOL),
        (dict(levels=2, window=9, iterations=1, prefilter=jof.BilateralConfig(),
              max_displacement=16), LK_PYRAMID_TOL),
    ],
    ids=["single_level", "pyramid", "prefilter"],
)
def test_spatial_pyramidal_lk_matches_jax_and_unsharded(kw, tol):
    """Both port TP paths against the unsharded kernel path: TP always
    enforces the warp budget, as the kernel path does (the unclamped plain
    path runs up to 10 px at the left border here)."""
    p, n = _pair(256, 48)
    jcfg = jof.LKConfig(use_pallas=False, **kw)
    want = np.asarray(jparallel.spatial_pyramidal_lk(_j(p), _j(n), jcfg, _jmesh()))
    cfg = lk_config_from_jax(jcfg)
    got = parallel.spatial_pyramidal_lk(_t(p), _t(n), cfg, _mesh())
    assert tuple(got.shape) == (256, 48, 2)
    _close(got, want, tol)
    # the kernel path: the band kernels' plain versions on CPU shards
    kcfg = dataclasses.replace(cfg, use_pallas=True)
    unsharded = tof.pyramidal_lk(_t(p), _t(n), kcfg)
    _close(got, unsharded, tol)
    _close(parallel.spatial_pyramidal_lk(_t(p), _t(n), kcfg, _mesh()), unsharded, tol)


def test_spatial_lk_kernel_path_runs_band_steps():
    """With use_pallas every level, the coarsest included, runs lk_band_step
    (zero flow at the coarsest): its plain version once per shard and
    iteration, and never the whole-image entries."""
    p, n = _pair(128, 32)
    cfg = tof.LKConfig(levels=2, window=9, iterations=2, max_displacement=4)
    calls = []
    orig = lk_step_fused.lk_band_step_plain

    def spy(*args, **kw):
        calls.append(args[3])
        return orig(*args, **kw)

    lk_step_fused.lk_band_step_plain = spy
    try:
        parallel.spatial_pyramidal_lk(_t(p), _t(n), cfg, parallel.make_mesh(devices=CPU8[:4],
                                                                             axis_name="space"))
    finally:
        lk_step_fused.lk_band_step_plain = orig
    # 2 levels x 2 iterations x 4 shards; level 1's first call per shard has
    # the gradient halo (r_grad = 6), the rest the warp halo (6 + 4 + 2)
    assert len(calls) == 16
    assert calls[:4] == [-6, 10, 26, 42]
    assert calls[-4:] == [-12, 20, 52, 84]


def test_grid_pyramidal_lk_matches_jax_and_unsharded():
    p0, n0 = _pair(256, 48, seed=0)
    p1, n1 = _pair(256, 48, seed=1, velocity=(-1.0, 1.5))
    pb, nb = np.stack([p0, p1, p0, p1]), np.stack([n0, n1, n0, n1])
    jcfg = jof.LKConfig(levels=2, window=9, iterations=1, temporal_kernel="gauss3",
                        max_displacement=4.0, use_pallas=False)
    jmesh = JMesh(np.asarray(jax.devices()).reshape(2, 4), ("batch", "space"))
    want = np.asarray(jparallel.grid_pyramidal_lk(_j(pb), _j(nb), jcfg, jmesh))
    mesh = parallel.Mesh(np.array(CPU8, dtype=object).reshape(2, 4), ("batch", "space"))
    assert mesh.shape == {"batch": 2, "space": 4}
    cfg = lk_config_from_jax(jcfg)
    got = parallel.grid_pyramidal_lk(_t(pb), _t(nb), cfg, mesh)
    assert tuple(got.shape) == (4, 256, 48, 2)
    _close(got, want, LK_PYRAMID_TOL)
    for i, (p, n) in enumerate([(p0, n0), (p1, n1)] * 2):
        _close(got[i], tof.pyramidal_lk(_t(p), _t(n), cfg), LK_PYRAMID_TOL)
    with pytest.raises(ValueError, match="not divisible by batch size 2"):
        parallel.grid_pyramidal_lk(_t(pb[:3]), _t(nb[:3]), cfg, mesh)


# --- spatial_pyramidal_hs -----------------------------------------------


@pytest.mark.parametrize(
    "kw,sweep_tile",
    [(dict(iterations=12), 6), (dict(iterations=8, alpha=20.0, penalty="charbonnier"), 8)],
    ids=["quadratic", "charbonnier"],
)
def test_spatial_pyramidal_hs_matches_jax_and_unsharded(kw, sweep_tile):
    """Charbonnier with iterations <= sweep_tile, where the TP chunk (the
    IRLS cadence) equals the unsharded one."""
    p, n = _pair(256, 48)
    base = dict(alpha=8.0, levels=2, max_displacement=8)
    jcfg = jhs.HSConfig(**{**base, **kw}, use_pallas=False)
    want = np.asarray(jparallel.spatial_pyramidal_hs(_j(p), _j(n), jcfg, _jmesh(), sweep_tile=sweep_tile))
    for use_pallas in (False, True):
        cfg = dataclasses.replace(hs_config_from_jax(jcfg), use_pallas=use_pallas)
        got = parallel.spatial_pyramidal_hs(_t(p), _t(n), cfg, _mesh(), sweep_tile=sweep_tile)
        assert tuple(got.shape) == (256, 48, 2)
        _close(got, want, HS_TOL)
        _close(got, tof.pyramidal_hs(_t(p), _t(n), cfg), HS_TOL)


def test_spatial_hs_kernel_path_chunks_sweeps():
    """ceil(iterations / sweep_tile) hs_relax_band chunks per level and
    shard, each of at most sweep_tile sweeps, with a sweeps + 2 halo."""
    p, n = _pair(128, 32)
    cfg = tof.HSConfig(alpha=8.0, iterations=10, levels=2, max_displacement=4)
    calls = []
    orig = hs_sweep.hs_relax_band_plain

    def spy(prev, nxt, flow, row0, h_global, **kw):
        calls.append((row0, h_global, kw["sweeps"]))
        return orig(prev, nxt, flow, row0, h_global, **kw)

    hs_sweep.hs_relax_band_plain = spy
    try:
        parallel.spatial_pyramidal_hs(_t(p), _t(n), cfg,
                                      parallel.make_mesh(devices=CPU8[:2], axis_name="space"),
                                      sweep_tile=4)
    finally:
        hs_sweep.hs_relax_band_plain = orig
    assert len(calls) == 2 * 3 * 2
    assert [c[2] for c in calls[:6]] == [4, 4, 4, 4, 2, 2]
    assert calls[:2] == [(-6, 64, 4), (26, 64, 4)]
    assert calls[-2:] == [(-6, 128, 2), (58, 128, 2)]


# --- spatial_pyramidal_tvl1 and spatial_pyramidal_fb ----------------------


def _spy(monkeypatch, module, name, record):
    """Replace ``module.name`` by a wrapper that appends ``record(args, kw)``
    to the returned list before calling it."""
    calls, orig = [], getattr(module, name)

    def spy(*args, **kw):
        calls.append(record(args, kw))
        return orig(*args, **kw)

    monkeypatch.setattr(module, name, spy)
    return calls


def test_spatial_pyramidal_tvl1_matches_jax_and_unsharded():
    """Both port TP paths against JAX's plain TP and the port's unsharded
    path on eight shards (the warp halo 6 + 8 + 2 fills level 1's 16 rows);
    the budget (8 px) never binds here, so the unsharded plain path is the
    same function."""
    p, n = _pair(256, 48)
    jcfg = jtvl1.TVL1Config(levels=2, warps=2, iterations=6, use_pallas=False,
                            max_displacement=8)
    want = np.asarray(jparallel.spatial_pyramidal_tvl1(_j(p), _j(n), jcfg, _jmesh(), iter_tile=4))
    for use_pallas in (False, True):
        cfg = dataclasses.replace(tvl1_config_from_jax(jcfg), use_pallas=use_pallas)
        got = parallel.spatial_pyramidal_tvl1(_t(p), _t(n), cfg, _mesh(), iter_tile=4)
        assert tuple(got.shape) == (256, 48, 2)
        _close(got, want, TVL1_TOL)
        _close(got, tof.pyramidal_tvl1(_t(p), _t(n), cfg), TVL1_TOL)


@pytest.mark.parametrize("gaussian_window", [False, True], ids=["box", "gaussian"])
def test_spatial_pyramidal_fb_matches_jax_and_unsharded(gaussian_window):
    """The plain path on eight shards as JAX's; the kernel path on four (the
    fused band step's halo, 12 + 4 + 2 rows plus the expansion's 3, needs
    21 rows at level 1); the Gaussian window takes the non-fused level with
    the band warp."""
    p, n = _pair(256, 48)
    jcfg = jfb.FBConfig(levels=2, iterations=2, winsize=11, use_pallas=False,
                        max_displacement=4, gaussian_window=gaussian_window)
    want = np.asarray(jparallel.spatial_pyramidal_fb(_j(p), _j(n), jcfg, _jmesh()))
    for use_pallas, shards in ((False, 8), (True, 4)):
        cfg = dataclasses.replace(fb_config_from_jax(jcfg), use_pallas=use_pallas)
        mesh = parallel.make_mesh(axis_name="space", devices=CPU8[:shards])
        got = parallel.spatial_pyramidal_fb(_t(p), _t(n), cfg, mesh)
        assert tuple(got.shape) == (256, 48, 2)
        _close(got, want, FB_TOL)
        _close(got, tof.pyramidal_farneback(_t(p), _t(n), cfg), FB_TOL)
        med = np.median(got.numpy()[32:-32, 16:-16], axis=(0, 1))
        assert abs(med[0] - 2) < 0.1 and abs(med[1] - 1) < 0.1, med


def test_spatial_tvl1_kernel_path_chunks_iterations(monkeypatch):
    """ceil(iterations / iter_tile) tvl1_relax_band chunks per warp, level
    and shard with an iterations + 2 halo, and one band warp per warp."""
    p, n = _pair(128, 32)
    cfg = tof.TVL1Config(levels=2, warps=2, iterations=10, max_displacement=4)
    chunks = _spy(monkeypatch, tvl1_sweep, "tvl1_relax_band_plain",
                  lambda a, kw: (a[4], a[5], kw["iterations"]))
    warps = _spy(monkeypatch, warp_select, "warp_bilinear_select_band_plain", lambda a, kw: a[2])
    parallel.spatial_pyramidal_tvl1(_t(p), _t(n), cfg,
                                    parallel.make_mesh(devices=CPU8[:2], axis_name="space"),
                                    iter_tile=4)
    # 2 levels x 2 warps x 3 chunks (4, 4, 2) x 2 shards; halo 4 + 2
    assert len(chunks) == 24 and len(warps) == 8
    assert [c[2] for c in chunks[:6]] == [4, 4, 4, 4, 2, 2]
    assert chunks[:2] == [(-6, 64, 4), (26, 64, 4)]
    assert chunks[-2:] == [(-6, 128, 2), (58, 128, 2)]
    # the warp band's halo: 6 + 4 + 2
    assert warps[:2] == [-12, 20]


def test_spatial_fb_kernel_path_runs_band_steps(monkeypatch):
    """One fb_band_step per iteration, level and shard with the fused halo;
    the prev expansion once per level and shard through kernel #9."""
    p, n = _pair(128, 32)
    cfg = tof.FBConfig(levels=2, iterations=3, max_displacement=4)
    steps = _spy(monkeypatch, fb_step_fused, "fb_band_step_plain", lambda a, kw: (a[3], a[5]))
    firsts = _spy(monkeypatch, fb_step_fused, "fb_band_step", lambda a, kw: a[6])
    expansions = _spy(monkeypatch, poly_exp_fused, "poly_expansion_kernel",
                      lambda a, kw: tuple(a[0].shape))
    parallel.spatial_pyramidal_fb(_t(p), _t(n), cfg,
                                  parallel.make_mesh(devices=CPU8[:2], axis_name="space"))
    assert len(steps) == 2 * 3 * 2
    assert steps[:2] == [(-18, 64), (14, 64)] and steps[-2:] == [(-18, 128), (46, 128)]
    assert firsts == [True, True] + [False] * 10
    # level 1 (32 x 16 per shard) and level 0 (64 x 32), each with 18 + 3
    # halo rows
    assert expansions == [(74, 16)] * 2 + [(106, 32)] * 2


# --- model-generic entry points -----------------------------------------


def test_spatial_pyramidal_flow_dispatch():
    p, n = _pair(256, 48)
    hs_j = jhs.HSConfig(alpha=8.0, iterations=8, levels=2, max_displacement=8, use_pallas=False)
    hs_cfg = hs_config_from_jax(hs_j)
    lk_cfg = tof.LKConfig(levels=2, window=9, max_displacement=4, use_pallas=False)
    a = parallel.spatial_pyramidal_flow(_t(p), _t(n), hs_cfg, _mesh(), sweep_tile=4)
    torch.testing.assert_close(
        a, parallel.spatial_pyramidal_hs(_t(p), _t(n), hs_cfg, _mesh(), sweep_tile=4),
        rtol=0, atol=0)
    want = jparallel.spatial_pyramidal_flow(_j(p), _j(n), hs_j, _jmesh(), sweep_tile=4)
    _close(a, want, HS_TOL)
    torch.testing.assert_close(
        parallel.spatial_pyramidal_flow(_t(p), _t(n), lk_cfg, _mesh()),
        parallel.spatial_pyramidal_lk(_t(p), _t(n), lk_cfg, _mesh()), rtol=0, atol=0)


def test_spatial_and_grid_flow_take_iter_tile():
    """The generic entries reach TV-L1 and FB with iter_tile, as the
    direct ones do, and grid_pyramidal_flow matches JAX's for TV-L1."""
    p, n = _pair(256, 48)
    tv_j = jtvl1.TVL1Config(levels=2, warps=1, iterations=6, use_pallas=False,
                            max_displacement=8)
    tv = tvl1_config_from_jax(tv_j)
    fbc = tof.FBConfig(levels=2, iterations=1, max_displacement=4, use_pallas=False)
    mesh = _mesh()
    torch.testing.assert_close(
        parallel.spatial_pyramidal_flow(_t(p), _t(n), tv, mesh, iter_tile=3),
        parallel.spatial_pyramidal_tvl1(_t(p), _t(n), tv, mesh, iter_tile=3), rtol=0, atol=0)
    torch.testing.assert_close(
        parallel.spatial_pyramidal_flow(_t(p), _t(n), fbc, mesh),
        parallel.spatial_pyramidal_fb(_t(p), _t(n), fbc, mesh), rtol=0, atol=0)
    pb, nb = np.stack([p, n]), np.stack([n, p])
    jmesh = JMesh(np.asarray(jax.devices()).reshape(2, 4), ("batch", "space"))
    want = np.asarray(jparallel.grid_pyramidal_flow(_j(pb), _j(nb), tv_j, jmesh, iter_tile=3))
    gmesh = parallel.Mesh([CPU8[:4], CPU8[4:]], ("batch", "space"))
    got = parallel.grid_pyramidal_flow(_t(pb), _t(nb), tv, gmesh, iter_tile=3)
    assert tuple(got.shape) == (2, 256, 48, 2)
    _close(got, want, TVL1_TOL)


def test_grid_pyramidal_flow_matches_jax():
    p, n = _pair(256, 48)
    pb, nb = np.stack([p, p * 0.5]), np.stack([n, n * 0.5])
    jcfg = jhs.HSConfig(alpha=8.0, iterations=8, levels=2, use_pallas=False, max_displacement=8)
    jmesh = JMesh(np.asarray(jax.devices()).reshape(2, 4), ("batch", "space"))
    want = np.asarray(jparallel.grid_pyramidal_flow(_j(pb), _j(nb), jcfg, jmesh, sweep_tile=4))
    mesh = parallel.Mesh([CPU8[:4], CPU8[4:]], ("batch", "space"))
    got = parallel.grid_pyramidal_flow(_t(pb), _t(nb), hs_config_from_jax(jcfg), mesh,
                                       sweep_tile=4)
    assert tuple(got.shape) == (2, 256, 48, 2)
    _close(got, want, HS_TOL)


def test_spatial_and_grid_flow_dispatch_dis():
    """The generic entries take a DISConfig to spatial_pyramidal_dis, with
    sweep_tile, and grid_pyramidal_flow shards a batch of DIS pairs, each
    as its own spatial run; they validate with the DIS validator."""
    p, n = _pair(256, 64)
    cfg = tof.DISConfig(levels=2, window=9, max_displacement=4, refine_iterations=6)
    mesh = _mesh4()
    got = parallel.spatial_pyramidal_flow(_t(p), _t(n), cfg, mesh, sweep_tile=4)
    torch.testing.assert_close(
        got, parallel.spatial_pyramidal_dis(_t(p), _t(n), cfg, mesh, sweep_tile=4), rtol=0, atol=0)
    gmesh = parallel.Mesh([CPU8[:4], CPU8[4:]], ("batch", "space"))
    flows = parallel.grid_pyramidal_flow(_t(np.stack([p, n])), _t(np.stack([n, p])), cfg, gmesh)
    assert tuple(flows.shape) == (2, 256, 64, 2)
    torch.testing.assert_close(
        flows[1], parallel.spatial_pyramidal_dis(_t(n), _t(p), cfg, mesh), rtol=0, atol=0)
    with pytest.raises(ValueError, match="spatial DIS needs H divisible"):
        parallel.spatial_pyramidal_flow(_t(p[:100]), _t(n[:100]), cfg, mesh)


def test_jax_config_raises_type_error():
    x = torch.zeros(64, 32)
    for cfg in (jof.LKConfig(), jhs.HSConfig(), object()):
        with pytest.raises(TypeError, match="config must be the port's"):
            parallel.spatial_pyramidal_flow(x, x, cfg, _mesh())


# --- spatial_pyramidal_dis ----------------------------------------------


def _mesh4():
    return parallel.make_mesh(axis_name="space", devices=CPU8[:4])


def _jmesh4():
    return jparallel.make_mesh(4, axis_name="space")


@pytest.mark.parametrize(
    "kw",
    [dict(), dict(mean_normalize=False), dict(refine_penalty="charbonnier"),
     dict(finest_level=1)],
    ids=["quadratic", "raw", "charbonnier", "finest1"],
)
def test_spatial_pyramidal_dis_matches_jax_and_unsharded(kw):
    """Both port TP paths (the plain one and the band kernels' plain
    versions) against JAX's plain TP on four shards and the port's
    unsharded path: 256x64 at levels=2, window 9 and a 4 px budget is what
    JAX's validator admits on four shards.  The Charbonnier case keeps
    refine_iterations (5) <= sweep_tile (8), where the TP IRLS cadence is
    the unsharded one; finest_level=1's last step is the exact 2x
    upsample on both sides."""
    p, n = _pair(256, 64)
    jcfg = jdis.DISConfig(levels=2, window=9, max_displacement=4, use_pallas=False, **kw)
    want = np.asarray(jparallel.spatial_pyramidal_dis(_j(p), _j(n), jcfg, _jmesh4()))
    for use_pallas in (False, True):
        cfg = dataclasses.replace(dis_config_from_jax(jcfg), use_pallas=use_pallas)
        got = parallel.spatial_pyramidal_dis(_t(p), _t(n), cfg, _mesh4())
        assert tuple(got.shape) == (256, 64, 2)
        _close(got, want, DIS_TOL)
        _close(got, tof.pyramidal_dis(_t(p), _t(n), cfg), DIS_TOL)
        med = np.median(got.numpy()[32:-32, 16:-16].reshape(-1, 2), axis=0)
        assert abs(med[0] - 2) < 0.1 and abs(med[1] - 1) < 0.1, med


def test_spatial_dis_finest_level_2_matches_jax_tp():
    """At finest_level >= 2 TP upsamples in 2x steps where the unsharded
    path resizes once (0.2 px apart here), so TP is held to JAX's TP:
    levels=3 and 2 refinement sweeps fit level 2's 16 rows per shard."""
    p, n = _pair(256, 64)
    jcfg = jdis.DISConfig(levels=3, finest_level=2, refine_iterations=2, window=9,
                          max_displacement=4, use_pallas=False)
    want = np.asarray(jparallel.spatial_pyramidal_dis(_j(p), _j(n), jcfg, _jmesh4()))
    for use_pallas in (False, True):
        cfg = dataclasses.replace(dis_config_from_jax(jcfg), use_pallas=use_pallas)
        _close(parallel.spatial_pyramidal_dis(_t(p), _t(n), cfg, _mesh4()), want, DIS_TOL)


def test_spatial_dis_kernel_path_runs_band_kernels(monkeypatch):
    """With use_pallas each level and shard runs the centered band step per
    search iteration, one band warp and one hs_relax_band chunk with the
    it_offset plane (k = min(8, 5, 16) = 5 sweeps), and never a
    whole-image kernel."""
    p, n = _pair(128, 32)
    cfg = tof.DISConfig(levels=2, window=9, max_displacement=4)
    steps = _spy(monkeypatch, lk_step_fused, "lk_band_step_plain", lambda a, kw: (a[3], a[6]))
    relax = _spy(monkeypatch, hs_sweep, "hs_relax_band_plain",
                 lambda a, kw: (a[3], kw["sweeps"], kw["it_offset"] is not None))
    warps = _spy(monkeypatch, warp_select, "warp_bilinear_select_band_plain", lambda a, kw: a[2])
    whole = []
    for module, name in ((lk_fused, "lk_residual"), (lk_step_fused, "lk_level_step"),
                         (hs_sweep, "hs_relax"), (warp_select, "warp_bilinear_select")):
        _spy(monkeypatch, module, name, lambda a, kw, name=name: whole.append(name))
    parallel.spatial_pyramidal_dis(_t(p), _t(n), cfg,
                                   parallel.make_mesh(devices=CPU8[:2], axis_name="space"))
    assert not whole
    # level 1 (32 rows per shard): the zero-flow step with the gradient halo
    # (6), then the warp halo (6 + 4 + 2); level 0 (64 rows) twice the latter
    assert steps == [(-6, True), (26, True), (-12, True), (20, True),
                     (-12, True), (52, True), (-12, True), (52, True)]
    # rg = 5 + 2; the refine warp band rp + d + 2 = (7 + 5) + 4 + 2
    assert relax == [(-7, 5, True), (25, 5, True), (-7, 5, True), (57, 5, True)]
    assert warps == [-18, 14, -18, 46]


# --- validators: the JAX package's messages -------------------------------


def _messages(fn_t, fn_j, *args):
    with pytest.raises((ValueError, NotImplementedError)) as got:
        fn_t(*args[0])
    with pytest.raises(type(got.value)) as want:
        fn_j(*args[1])
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize(
    "h,w,kw",
    [
        (100, 64, dict(levels=3, window=9)),  # H not divisible by 8 * 4
        (256, 60, dict(levels=4, window=9)),  # W not divisible by 8
        (128, 64, dict(levels=3, window=31)),  # coarsest level too short for its halos
        (1024, 64, dict(levels=3, window=9, iterations=2)),  # a warping coarsest level
        (64, 64, dict(levels=1, window=9, prefilter=jof.BilateralConfig(window=19))),
        (256, 64, dict(levels=2, warp_mode="nearest")),
    ],
    ids=["rows", "cols", "halo", "coarsest_warps", "prefilter", "nearest"],
)
def test_validate_spatial_messages_match_jax(h, w, kw):
    jcfg = jof.LKConfig(use_pallas=False, **kw)
    _messages(spatial.validate_spatial, jspatial.validate_spatial,
              (h, w, lk_config_from_jax(jcfg), 8), (h, w, jcfg, 8))


@pytest.mark.parametrize(
    "h,w,kw,tile",
    [
        (500, 64, dict(levels=3), 8),
        (256, 64, dict(levels=3), 8),  # warp halo 36 > 8 rows per shard at level 2
        (256, 64, dict(levels=1, iterations=40), 40),  # sweep halo
    ],
    ids=["rows", "warp_halo", "sweep_halo"],
)
def test_validate_spatial_hs_messages_match_jax(h, w, kw, tile):
    jcfg = jhs.HSConfig(use_pallas=False, **kw)
    _messages(spatial_models.validate_spatial_hs, jspatial_models.validate_spatial_hs,
              (h, w, hs_config_from_jax(jcfg), 8, tile), (h, w, jcfg, 8, tile))


@pytest.mark.parametrize(
    "h,w,kw,tile",
    [
        (100, 64, dict(levels=2), 8),  # H not divisible by 8 * 2
        (256, 64, dict(levels=2), 8),  # 16 rows per shard at level 1, need 44
        (512, 64, dict(levels=1, max_displacement=2, median_filtering=135), 8),  # median halo
    ],
    ids=["rows", "halo", "median_halo"],
)
def test_validate_spatial_tvl1_messages_match_jax(h, w, kw, tile):
    jcfg = jtvl1.TVL1Config(use_pallas=False, **kw)
    _messages(spatial_models.validate_spatial_tvl1, jspatial_models.validate_spatial_tvl1,
              (h, w, tvl1_config_from_jax(jcfg), 8, tile), (h, w, jcfg, 8, tile))


@pytest.mark.parametrize(
    "h,w,kw",
    [
        (100, 64, dict(levels=2)),  # H not divisible by 8 * 2
        (256, 64, dict(levels=2)),  # the warp halo at level 1
        (128, 64, dict(levels=1, iterations=1, winsize=33)),  # a coarsest level that never warps
        (256, 64, dict(levels=2, warp_planes="coeff")),
    ],
    ids=["rows", "halo", "coarsest", "coeff"],
)
def test_validate_spatial_fb_messages_match_jax(h, w, kw):
    jcfg = jfb.FBConfig(use_pallas=False, **kw)
    _messages(spatial_models.validate_spatial_fb, jspatial_models.validate_spatial_fb,
              (h, w, fb_config_from_jax(jcfg), 8), (h, w, jcfg, 8))


@pytest.mark.parametrize(
    "h,w,n,kw",
    [
        (100, 64, 8, dict(levels=2)),  # H not divisible by 8 * 2
        (256, 64, 8, dict(levels=2)),  # the search warp halo at level 1
        (2160, 3840, 3, dict()),  # 4K DISConfig(): level 4 holds 45 rows, needs 46
        (256, 64, 8, dict(levels=1, max_displacement=2, refine_iterations=40)),  # refine halo
        (256, 64, 4, dict(levels=3, finest_level=2, max_displacement=4)),  # level 2's sweeps
        (64, 64, 1, dict(levels=1, prefilter=jof.BilateralConfig(window=131))),
    ],
    ids=["rows", "halo", "uhd_3_shards", "refine_halo", "finest2", "prefilter"],
)
def test_validate_spatial_dis_messages_match_jax(h, w, n, kw):
    jcfg = jdis.DISConfig(use_pallas=False, **kw)
    _messages(spatial_models.validate_spatial_dis, jspatial_models.validate_spatial_dis,
              (h, w, dis_config_from_jax(jcfg), n, 40), (h, w, jcfg, n, 40))


# --- the window-limit dispatch --------------------------------------------


def _kernel_calls(monkeypatch):
    """Spies on the wrappers of the LK and bilateral kernels: the names of
    those the code under test called."""
    called = []
    for module, name in ((lk_fused, "lk_residual"), (lk_step_fused, "lk_level_step"),
                         (lk_step_fused, "lk_band_step"), (bilateral_tap, "bilateral_kernel"),
                         (bilateral_tap, "bilateral_kernel_band")):
        _spy(monkeypatch, module, name, lambda a, kw, name=name: called.append(name))
    return called


@pytest.mark.parametrize(
    "kw,called",
    [
        (dict(), {"lk_residual", "lk_level_step"}),
        (dict(window=67), set()),
        (dict(prefilter=tof.BilateralConfig()), {"bilateral_kernel", "lk_residual",
                                                 "lk_level_step"}),
        (dict(prefilter=tof.BilateralConfig(window=33)), {"lk_residual", "lk_level_step"}),
    ],
    ids=["default", "lk_window_67", "bilateral", "bilateral_window_33"],
)
def test_window_limit_dispatch_lk(monkeypatch, kw, called):
    """Past the CUDA kernels' window limits (65 for LK, 31 for the
    bilateral) pyramidal_lk and the LK TP level take the plain composition,
    as the JAX package takes its XLA twin; within them the kernels."""
    p, n = _pair(128, 32)
    cfg = tof.LKConfig(levels=2, max_displacement=4, **{"window": 9, **kw})
    calls = _kernel_calls(monkeypatch)
    flow = tof.pyramidal_lk(_t(p), _t(n), cfg)
    assert set(calls) == called
    plain = tof.pyramidal_lk(_t(p), _t(n), dataclasses.replace(cfg, use_pallas=False))
    _close(flow, plain, LK_PYRAMID_TOL)
    calls.clear()
    parallel.spatial_pyramidal_lk(_t(p), _t(n), cfg,
                                  parallel.make_mesh(devices=CPU8[:1], axis_name="space"))
    band = {"lk_band_step"} if "lk_level_step" in called else set()
    band |= {"bilateral_kernel_band"} if "bilateral_kernel" in called else set()
    assert set(calls) == band


@pytest.mark.parametrize("window,called", [(9, True), (67, False)], ids=["default", "window_67"])
def test_window_limit_dispatch_dis(monkeypatch, window, called):
    p, n = _pair(64, 32)
    cfg = tof.DISConfig(levels=2, window=window, refine_iterations=2)
    calls = _kernel_calls(monkeypatch)
    tof.pyramidal_dis(_t(p), _t(n), cfg)
    assert set(calls) == ({"lk_residual", "lk_level_step"} if called else set())


# --- the mesh and batch sharding ------------------------------------------


def test_make_mesh_needs_cuda_unless_devices_are_given(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.make_mesh()
    mesh = parallel.make_mesh(devices=CPU8)
    assert mesh.shape == {"batch": 8}
    assert all(d == torch.device("cpu") for d in mesh.devices)
    with pytest.raises(ValueError, match="devices"):
        parallel.make_mesh(n_devices=9, devices=CPU8)
    assert parallel.make_mesh(3, "space", devices=CPU8).shape == {"space": 3}


def test_sharded_and_chunked_flow_match_unsharded():
    p, n = _pair(64, 48)
    pb = _t(np.stack([p + i for i in range(4)]))
    nb = _t(np.stack([n + i for i in range(4)]))
    mesh = parallel.make_mesh(devices=CPU8[:2])
    for cfg in (tof.LKConfig(levels=2, window=9), tof.HSConfig(levels=2, iterations=10)):
        want = tof.pyramidal_flow(pb, nb, cfg)
        torch.testing.assert_close(parallel.sharded_flow(pb, nb, cfg, mesh), want,
                                   rtol=0, atol=1e-5)
        torch.testing.assert_close(parallel.chunked_flow(pb, nb, cfg, chunk=2), want,
                                   rtol=0, atol=1e-5)
    torch.testing.assert_close(
        parallel.sharded_pyramidal_lk(pb, nb, tof.LKConfig(levels=1), mesh),
        tof.pyramidal_lk(pb, nb, tof.LKConfig(levels=1)), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="not divisible by mesh axis size 2"):
        parallel.sharded_flow(pb[:3], nb[:3], tof.LKConfig(levels=1), mesh)
    with pytest.raises(ValueError, match="chunk 3"):
        parallel.chunked_flow(pb, nb, tof.LKConfig(levels=1), chunk=3)
    shards = parallel.shard_batch(pb, mesh)
    assert [tuple(s.shape) for s in shards] == [(2, 64, 48)] * 2
