"""The port's forward-backward consistency against the JAX package (CPU).

The same numpy flows and frames, made from a seed or by
``utils.layered.layered_scene``, go through ``models.consistency`` of both
packages (JAX jitted, ``use_pallas=False``).

Tolerances:
- the cycle warp's identity: ``warp_bilinear_select_plain(img, flow,
  max(H, W))`` is ``torch.equal`` to ``warp_bilinear(img, flow)``, flows far
  outside the image included (what lets the card run kernel #3 there);
- ``fb_consistency`` and ``occlusion_score``: atol 1e-5 against JAX;
  ``occlusion_mask``: equal outside pixels whose score is within 1e-4 of
  beta;
- ``fill_occluded_flow``: matched pixels ``torch.equal`` to the input,
  filled pixels within 1e-4 px of JAX after 96 sweeps;
- ``consistent_flow``: flow within 2e-4 px (as
  tests/test_torch_streaming_generic.py), the mask as above.  JAX's
  ``consistent_flow`` is ``pyramidal_flow`` both ways and ``occlusion_mask``;
  the test runs those steps, so one jitted compile serves both directions
  and the score is at hand.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cuda_optical_flow_2_tpu as jof
from cuda_optical_flow_2_tpu.models import consistency as jc
from cuda_optical_flow_2_tpu.models import tvl1 as jtvl1
from cuda_optical_flow_2_tpu.utils.layered import Layer, layered_scene

import cuda_optical_flow_2_torch as tof
from cuda_optical_flow_2_torch.interop import lk_config_from_jax, tvl1_config_from_jax
from cuda_optical_flow_2_torch.kernels import warp_select
from cuda_optical_flow_2_torch.models import consistency as tc
from cuda_optical_flow_2_torch.ops.warp import warp_bilinear
from cuda_optical_flow_2_torch.utils.io import synthetic_sequence

SCORE_TOL = 1e-5
BETA_BAND = 1e-4
FILL_TOL = 1e-4
FLOW_TOL = 2e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Torch on one thread: small plain ops spread over every core contend
    under several pytest workers (see tests/test_torch_spatial.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def disk_scene():
    return layered_scene(
        192, 256, bg_flow=(-2.0, 1.0),
        layers=[Layer("disk", (96.0, 128.0), 45.0, (3.0, 1.0))], seed=3,
    )


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _assert_mask(got, want, score, beta=0.5):
    """Equal outside the pixels whose score is within BETA_BAND of beta."""
    sure = np.abs(np.asarray(score) - beta) > BETA_BAND
    np.testing.assert_array_equal(np.asarray(got)[sure], np.asarray(want)[sure])


@pytest.mark.parametrize("shape", [(24, 40), (3, 17, 29)])
def test_warp_select_plain_is_warp_bilinear_at_max_hw(shape):
    """Clipping to +-max(H, W) changes no output: a component beyond it
    leaves the image before and after the clip."""
    rng = np.random.default_rng(len(shape))
    h, w = shape[-2:]
    d = 2 * max(h, w)
    img = torch.from_numpy(rng.normal(0, 50, shape).astype(np.float32))
    flow = torch.from_numpy(rng.uniform(-d, d, shape + (2,)).astype(np.float32))
    flow[..., 0, 0, :] = torch.tensor([max(h, w) + 0.5, 0.25])
    assert (flow.abs() > max(h, w)).float().mean() > 0.4
    assert torch.equal(warp_select.warp_bilinear_select_plain(img, flow, max(h, w)),
                       warp_bilinear(img, flow))


@pytest.mark.parametrize("shape", [(32, 48), (2, 20, 36)])
def test_fb_consistency_and_score_match_jax(shape):
    rng = np.random.default_rng(7)
    fw = rng.normal(0, 2, shape + (2,)).astype(np.float32)
    bw = (-fw + rng.normal(0, 0.6, shape + (2,))).astype(np.float32)
    bw[..., 5:9, 5:9, :] = 5.0  # an inconsistent block
    jfw, jbw = jnp.asarray(fw), jnp.asarray(bw)
    np.testing.assert_allclose(tc.fb_consistency(_t(fw), _t(bw)).numpy(),
                               np.asarray(jc.fb_consistency(jfw, jbw)), rtol=0, atol=SCORE_TOL)
    for alpha in (0.01, 0.1):
        score = np.asarray(jc.occlusion_score(jfw, jbw, alpha))
        got = tc.occlusion_score(_t(fw), _t(bw), alpha)
        np.testing.assert_allclose(got.numpy(), score, rtol=0, atol=SCORE_TOL)
        mask = tc.occlusion_mask(_t(fw), _t(bw), alpha, 0.5)
        assert mask.dtype == torch.bool
        _assert_mask(mask.numpy(), np.asarray(jc.occlusion_mask(jfw, jbw, alpha, 0.5)), score)
        assert torch.equal(mask, got > 0.5)
    assert torch.equal(tc.fb_consistency(_t(fw), _t(bw), use_pallas=False),
                       tc.fb_consistency(_t(fw), _t(bw)))


def test_cycle_warp_is_one_kernel_call_on_both_planes(monkeypatch):
    """Off the CPU the cycle warp is ONE call of the warp_select kernel's
    wrapper: both planes of the reverse flow as a batch of 2, the forward flow
    broadcast to it, budget max(H, W); ``use_pallas=False`` calls the plain
    warp instead.  (Meta tensors stand in for the card.)"""
    calls = []

    def spy(img, flow, max_displacement=32):
        calls.append((tuple(img.shape), tuple(flow.shape), max_displacement))
        return torch.empty_like(img)

    monkeypatch.setattr(warp_select, "warp_bilinear_select", spy)
    fw = torch.empty((24, 40, 2), device="meta")
    tc.occlusion_mask(fw, torch.empty_like(fw))
    assert calls == [((2, 24, 40), (2, 24, 40, 2), 40)]
    tc.fb_consistency(fw, torch.empty_like(fw), use_pallas=False)
    tc.fb_consistency(torch.zeros(24, 40, 2), torch.zeros(24, 40, 2))
    assert len(calls) == 1


def test_fill_matches_jax_on_disk_scene(disk_scene):
    """The fill of a TV-L1 flow of the disk scene with the true mask."""
    sc = disk_scene
    flow = tof.pyramidal_tvl1(_t(sc.prev), _t(sc.nxt), tof.TVL1Config(levels=3))
    want = np.asarray(jax.jit(jc.fill_occluded_flow)(jnp.asarray(flow.numpy()),
                                                     jnp.asarray(sc.occ)))
    got = tc.fill_occluded_flow(flow, _t(sc.occ))
    assert torch.equal(got[_t(~sc.occ)], flow[_t(~sc.occ)])
    np.testing.assert_allclose(got.numpy()[sc.occ], want[sc.occ], rtol=0, atol=FILL_TOL)
    assert np.abs(got.numpy()[sc.occ] - flow.numpy()[sc.occ]).max() > 0.5  # it filled


@pytest.mark.parametrize("beta", [0.0, 3.0])
def test_fill_options_match_jax(beta):
    rng = np.random.default_rng(3)
    flow = rng.normal(0, 2, (40, 56, 2)).astype(np.float32)
    occ = np.zeros((40, 56), bool)
    occ[10:25, 18:30] = True
    want = np.asarray(jc.fill_occluded_flow(jnp.asarray(flow), jnp.asarray(occ),
                                            iterations=12, beta=beta))
    got = tc.fill_occluded_flow(_t(flow), _t(occ), iterations=12, beta=beta).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=FILL_TOL)
    np.testing.assert_array_equal(got[~occ], flow[~occ])


def test_fill_noop_without_occlusion():
    flow = np.random.default_rng(0).normal(0, 2, (40, 56, 2)).astype(np.float32)
    out = tc.fill_occluded_flow(_t(flow), torch.zeros(40, 56, dtype=torch.bool), iterations=8)
    assert torch.equal(out, _t(flow))


def _jax_pair(cfg, prev, nxt):
    """JAX's consistent_flow as its steps: flows both ways, score, mask."""
    if isinstance(cfg, jtvl1.TVL1Config):
        run = jax.jit(lambda p, n: jtvl1.pyramidal_tvl1(p, n, cfg))
    else:
        run = jax.jit(lambda p, n: jof.pyramidal_lk(p, n, cfg))
    fw = run(jnp.asarray(prev), jnp.asarray(nxt))
    bw = run(jnp.asarray(nxt), jnp.asarray(prev))
    return (np.asarray(fw), np.asarray(jc.occlusion_mask(fw, bw)),
            np.asarray(jc.occlusion_score(fw, bw)))


@pytest.mark.parametrize("family", ["lk", "tvl1"])
def test_consistent_flow_matches_jax(disk_scene, family):
    """LK at tests/test_layered_motion.py's config on the 192x256 disk
    scene; a small TV-L1 (levels=2) on its 96x128 centre."""
    sc = disk_scene
    if family == "lk":
        jcfg = jof.LKConfig(levels=3, window=19, iterations=2, temporal_kernel="gauss3",
                            use_pallas=False, max_displacement=8, window_weights="tri")
        tcfg, prev, nxt = lk_config_from_jax(jcfg), sc.prev, sc.nxt
    else:
        jcfg = jtvl1.TVL1Config(levels=2, warps=2, iterations=10, use_pallas=False)
        tcfg = tvl1_config_from_jax(jcfg)
        prev, nxt = sc.prev[48:144, 64:192].copy(), sc.nxt[48:144, 64:192].copy()
    want_flow, want_occ, score = _jax_pair(jcfg, prev, nxt)
    flow, occ = tc.consistent_flow(_t(prev), _t(nxt), tcfg)
    np.testing.assert_allclose(flow.numpy(), want_flow, rtol=0, atol=FLOW_TOL)
    assert occ.dtype == torch.bool and 0.005 < float(occ.float().mean()) < 0.2
    _assert_mask(occ.numpy(), want_occ, score)


def test_consistent_flow_fill_option():
    """fill=True keeps the mask and every unmasked pixel of fill=False, and
    returns finite values at the masked ones."""
    frames = synthetic_sequence(2, 96, 128, velocity=(2.0, 1.0))
    p, n = (torch.from_numpy(f).float() for f in frames)
    cfg = tof.LKConfig(levels=2, window=9)
    flow, occ = tc.consistent_flow(p, n, cfg)
    filled, occ2 = tc.consistent_flow(p, n, cfg, fill=True)
    assert torch.equal(occ, occ2)
    assert torch.equal(filled[~occ], flow[~occ])
    assert bool(torch.isfinite(filled).all())
    assert torch.equal(tof.consistent_flow(p, n, cfg)[0], flow)
