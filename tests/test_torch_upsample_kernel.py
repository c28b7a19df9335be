"""The coarse-to-fine handoff (``kernels/upsample_flow``): the wrapper's CPU
path and the route helper against ``ops.resize.upsample_flow`` and the JAX
package's upsample, and each family's handoffs through the helper.

The CUDA kernel itself runs only on the card: ``chip_smoke.py`` holds it
``torch.equal`` to ``upsample_flow_plain`` at every handoff shape.  Here the
helper's decision is seen through spies on the two routes: the kernel
wrapper (which takes the plain version on CPU tensors) and
``upsample_flow_plain`` (``ops.resize.upsample_flow``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cuda_optical_flow_2_tpu.ops import resize as jresize

import cuda_optical_flow_2_torch as tof
from cuda_optical_flow_2_torch.kernels import upsample_flow as ukernel
from cuda_optical_flow_2_torch.ops import resize as tresize
from cuda_optical_flow_2_torch.utils.io import synthetic_sequence

_jax_upsample = jax.jit(jresize.upsample_flow, static_argnums=1)


def _flow(rng, shape):
    f = rng.normal(0, 3, shape).astype(np.float32)
    f.flat[:3] = [np.nan, np.inf, -0.0]  # the stencil carries them as the plain ops do
    return torch.from_numpy(f)


@pytest.mark.parametrize("lead", [(), (3,), (2, 2)], ids=["plane", "batch", "batch2d"])
@pytest.mark.parametrize("hw", [(5, 7), (1, 4), (4, 1), (1, 1)], ids=["5x7", "1x4", "4x1", "1x1"])
@pytest.mark.parametrize("odd", [(0, 0), (1, 0), (0, 1), (1, 1)],
                         ids=["2hx2w", "2h+1x2w", "2hx2w+1", "2h+1x2w+1"])
def test_octave_wrapper_and_helper_are_the_plain_upsample(lead, hw, odd):
    """Every octave target, 1-pixel sides and leading batch dims: the
    wrapper's CPU path and the helper are ``torch.equal`` to the plain
    version (NaN, inf and -0.0 included)."""
    h, w = hw
    target = (2 * h + odd[0], 2 * w + odd[1])
    flow = _flow(np.random.default_rng(h * 10 + w), lead + (h, w, 2))
    want = tresize.upsample_flow(flow, target)
    assert want.shape == lead + target + (2,)
    assert tresize.is_octave(flow.shape, target)
    for got in (ukernel.upsample_flow(flow, target), ukernel.handoff(flow, target, True),
                ukernel.handoff(flow, target, False)):
        assert torch.equal(got.nan_to_num(7.0), want.nan_to_num(7.0))
        assert torch.equal(got.isnan(), want.isnan())
        assert torch.equal(torch.signbit(got), torch.signbit(want))


def _spies(monkeypatch):
    """Spies on the helper's two routes: the kernel wrapper and
    ``upsample_flow_plain``; each records (input shape, target).  The
    kernel spy returns what the wrapper returns on CPU tensors, the plain
    version, without passing through the plain spy."""
    calls = {"kernel": [], "plain": []}
    plain = tresize.upsample_flow

    def kernel_spy(flow, shape):
        calls["kernel"].append((tuple(flow.shape), tuple(shape)))
        return plain(flow, shape)

    def plain_spy(flow, shape):
        calls["plain"].append((tuple(flow.shape), tuple(shape)))
        return plain(flow, shape)

    monkeypatch.setattr(ukernel, "upsample_flow", kernel_spy)
    monkeypatch.setattr(ukernel, "upsample_flow_plain", plain_spy)
    return calls


@pytest.mark.parametrize("target", [(10, 14), (24, 34), (7, 9)], ids=["x2.5", "x4", "x1.4"])
def test_non_octave_resize_takes_the_plain_route(monkeypatch, target):
    """A resize that is no octave (DIS's ``finest_level`` > 1) is the plain
    bilinear resize, with ``use_pallas`` too."""
    flow = _flow(np.random.default_rng(1), (2, 4, 6, 2))
    want = tresize.upsample_flow(flow, target)
    calls = _spies(monkeypatch)
    assert not tresize.is_octave(flow.shape, target)
    got = ukernel.handoff(flow, target, True)
    assert calls == {"kernel": [], "plain": [((2, 4, 6, 2), target)]}
    assert torch.equal(got.nan_to_num(7.0), want.nan_to_num(7.0))


def test_same_size_handoff_is_the_flow_itself():
    flow = torch.ones(3, 5, 2)
    assert ukernel.handoff(flow, (3, 5), True) is flow


_FAMILIES = {
    # config, entry, the helper's kernel-route handoffs at 72x96
    "lk": (tof.PAPER_1080P, tof.pyramidal_lk, 4),
    "hs": (tof.HSConfig(levels=3, iterations=4), tof.pyramidal_hs, 2),
    "fb": (tof.FBConfig(levels=3, iterations=1), tof.pyramidal_farneback, 2),
    "tvl1": (tof.TVL1Config(levels=3, warps=1, iterations=3), tof.pyramidal_tvl1, 2),
    "dis": (tof.DISConfig(levels=4, iterations=1, refine_iterations=1), tof.pyramidal_dis, 3),
}


@pytest.mark.parametrize("family", sorted(_FAMILIES))
def test_family_handoffs_route_through_the_helper(monkeypatch, family):
    """With ``use_pallas`` each handoff between pyramid levels takes the
    kernel route (on CPU tensors the wrapper runs the plain version); with
    ``use_pallas=False`` every handoff is the plain upsample, the JAX
    package's XLA composition."""
    cfg, entry, n = _FAMILIES[family]
    fr = synthetic_sequence(2, 72, 96, velocity=(2.0, 1.0), period=24)
    p, q = torch.from_numpy(fr[0]), torch.from_numpy(fr[1])
    calls = _spies(monkeypatch)
    on = entry(p, q, cfg)
    assert len(calls["kernel"]) == n and calls["plain"] == []
    kernel_calls = calls["kernel"][:]
    calls["kernel"].clear()
    off = entry(p, q, dataclasses.replace(cfg, use_pallas=False))
    assert calls["kernel"] == [] and calls["plain"] == kernel_calls
    assert on.shape == off.shape == (72, 96, 2)


def test_dis_finest_level_resize_stays_plain(monkeypatch):
    """DIS with ``finest_level=2``: the solved levels hand off by octaves
    through the kernel route, the last resize (4x) through the plain one."""
    cfg = tof.DISConfig(levels=4, finest_level=2, iterations=1, refine_iterations=1)
    fr = synthetic_sequence(2, 72, 96, velocity=(2.0, 1.0), period=24)
    calls = _spies(monkeypatch)
    tof.pyramidal_dis(torch.from_numpy(fr[0]), torch.from_numpy(fr[1]), cfg)
    assert calls == {"kernel": [((9, 12, 2), (18, 24))], "plain": [((18, 24, 2), (72, 96))]}


def test_paper_1080p_handoffs_bitwise_the_parents_route(monkeypatch):
    """``PAPER_1080P`` at 72x96 (1080x1920's level parities: 72, 36, 18, 9,
    4 rows, so one handoff with an odd target): each handoff the helper
    makes is ``torch.equal`` to ``ops.resize.upsample_flow`` and within the
    JAX package's upsample's tolerance, and the flow is ``torch.equal`` to
    the one that hands off through ``ops.resize.upsample_flow`` directly."""
    fr = synthetic_sequence(2, 72, 96, velocity=(2.0, 1.0), period=48)
    p, q = torch.from_numpy(fr[0]), torch.from_numpy(fr[1])
    seen, kernel = [], ukernel.upsample_flow

    def spy(flow, shape):
        out = kernel(flow, shape)
        seen.append((flow, shape, out))
        return out

    monkeypatch.setattr(ukernel, "upsample_flow", spy)
    got = tof.pyramidal_lk(p, q, tof.PAPER_1080P)
    assert [(tuple(f.shape[:2]), s) for f, s, _ in seen] == [
        ((4, 6), (9, 12)), ((9, 12), (18, 24)), ((18, 24), (36, 48)), ((36, 48), (72, 96))]
    for flow, shape, out in seen:
        assert torch.equal(out, tresize.upsample_flow(flow, shape))
        np.testing.assert_allclose(out.numpy(), np.asarray(_jax_upsample(jnp.asarray(
            flow.numpy()), shape)), rtol=1e-6, atol=1e-6)
    monkeypatch.setattr(ukernel, "handoff", lambda flow, shape, _use: tresize.upsample_flow(
        flow, shape))
    assert torch.equal(tof.pyramidal_lk(p, q, tof.PAPER_1080P), got)
