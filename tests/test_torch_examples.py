"""The port's ten examples on the CPU, and their functions against the JAX
examples' own.

Each port example runs through ``main(device="cpu", out_dir=tmp_path)`` at
its JAX twin's sizes, seeds and step counts, with its own asserts
(``gradient_alignment``: translation error under 0.1 px;
``learned_refinement``: refined EPE under 0.85 of the coarse EPE;
``frame_interpolation``: the midpoint beats frame hold by 4x).
``sharded_batch`` runs on a mesh of two CPU shards.

The JAX examples' functions come from ``runpy.run_path`` of
``examples/<name>.py``.  Tolerances, stated per test: the frames and flows
of the same float32 operations in another order 1e-4 (a 0-255 image, px);
the interpolation pipeline the spread of the JAX function's own jitted and
eager runs (``INTERP_*``); the RefineNet
(convolutions summed in another order) 1e-5 on its output and 1e-4 of the
largest gradient on its gradients and on its parameters after five adam
steps.
"""

import os
import runpy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from cuda_optical_flow_2_tpu.models import FBConfig as JFBConfig
from cuda_optical_flow_2_tpu.ops import warp as jwarp

from cuda_optical_flow_2_torch.examples import EXAMPLES
from cuda_optical_flow_2_torch.examples import frame_interpolation as t_interp
from cuda_optical_flow_2_torch.examples import gradient_alignment as t_align
from cuda_optical_flow_2_torch.examples import learned_refinement as t_refine
from cuda_optical_flow_2_torch.models import FBConfig
from cuda_optical_flow_2_torch.utils import io

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGE_TOL = 1e-4
# Farnebäck at 240x320 amplifies float order past the 2e-4 px other
# pipelines hold: the JAX function jitted and eager differ by 8.5e-4 px in
# the flow and 0.011 gray levels in the midpoint; the port differs from the
# jitted one by 9.0e-4 and 0.0078
INTERP_FLOW_TOL, INTERP_MID_TOL = 2e-3, 0.05
NET_TOL = 1e-5
NET_GRAD_RTOL = 1e-4

EXTRA = {"sharded_batch": {"shards": 2}}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The examples run thousands of small ops (120 warm LK frames, 400 adam
    steps).  Beside the suite's other workers, eight intra-op threads per
    process spend them at barriers: 30 ``live_stream`` frames took 53 s
    with 8 threads and 3.3 s with 1 on an 8-core CPU with five cores
    busy."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_example(name):
    return runpy.run_path(os.path.join(ROOT, "examples", f"{name}.py"), run_name="jax_example")


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs(name, tmp_path):
    """main() on the CPU, its asserts included, returns its numbers."""
    mod = __import__(f"cuda_optical_flow_2_torch.examples.{name}", fromlist=["main"])
    out = mod.main(device="cpu", out_dir=tmp_path, **EXTRA.get(name, {}))
    assert isinstance(out, dict) and out
    if name == "basic":
        assert (tmp_path / "flow_basic.png").exists() and (tmp_path / "flow_basic.flo").exists()
        np.testing.assert_allclose(out["median_flow"], (3.0, 1.0), atol=0.2)
    if name == "sharded_batch":
        assert out["shape"] == (4, 128, 160, 2)
        np.testing.assert_allclose(out["median_flow"], (2.0, 1.0), atol=0.1)
    if name == "spatial_tp":
        np.testing.assert_allclose(out["median_flow"], (2.0, 1.0), atol=0.1)
        np.testing.assert_allclose(out["fb_median_flow"], (2.0, 1.0), atol=0.1)
    if name == "scene_cut_recovery":
        post_cut = [out["epe"]["with recovery"][i] for i in range(6, 10)]
        assert max(post_cut) < 1.0 < max(out["epe"]["plain warm"][i] for i in range(6, 10))
    if name == "live_stream":
        assert out["frames"] == 120 and out["failed"] == 0


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_refuses_the_cpu_unasked(name, tmp_path, monkeypatch):
    """Without a card, main() with its default device ends with a message
    naming --device cpu, before any work: no example falls back."""
    mod = __import__(f"cuda_optical_flow_2_torch.examples.{name}", fromlist=["main"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        mod.main(out_dir=tmp_path)


def test_interpolate_midpoint_matches_jax():
    """The midpoint frame and the forward flow of the JAX example's
    function on the same three frames (plain paths on both sides)."""
    jex = _jax_example("frame_interpolation")
    frames = io.synthetic_sequence(3, 240, 320, velocity=(2.0, 1.0))
    f0, f2 = frames[0].astype(np.float32), frames[2].astype(np.float32)
    jmid, jflow = jax.jit(lambda a, b: jex["interpolate_midpoint"](
        a, b, JFBConfig(levels=3, iterations=2, use_pallas=False)))(jnp.asarray(f0), jnp.asarray(f2))
    mid, flow = t_interp.interpolate_midpoint(
        torch.from_numpy(f0), torch.from_numpy(f2), FBConfig(levels=3, iterations=2))
    np.testing.assert_allclose(flow.numpy(), np.asarray(jflow), rtol=0, atol=INTERP_FLOW_TOL)
    np.testing.assert_allclose(mid.numpy(), np.asarray(jmid), rtol=0, atol=INTERP_MID_TOL)


def test_gradient_alignment_matches_jax():
    """affine_flow, and the photometric loss and its gradient at the dense
    seed's neighbourhood, against the JAX example's affine_flow under
    jax.grad (the JAX loss is main's closure, rebuilt from its parts)."""
    jex = _jax_example("gradient_alignment")
    h, w = 160, 192
    rng = np.random.default_rng(0)
    params = np.array([*rng.normal(0, 1, 4), -3.5, 2.1], np.float32)
    np.testing.assert_allclose(
        t_align.affine_flow(torch.from_numpy(params), h, w).numpy(),
        np.asarray(jex["affine_flow"](jnp.asarray(params), h, w)), rtol=0, atol=IMAGE_TOL)

    prev, nxt = t_align.shifted_pair(h, w, (3.6, -2.2))

    def jloss(p):
        warped = jwarp.warp_bilinear(jnp.asarray(nxt), jex["affine_flow"](p, h, w))
        return jnp.mean((warped[8:-8, 8:-8] - jnp.asarray(prev)[8:-8, 8:-8]) ** 2)

    jval, jgrad = jax.value_and_grad(jloss)(jnp.asarray(params))
    p = torch.tensor(params, requires_grad=True)
    val = t_align.photometric_loss(p, torch.from_numpy(prev), torch.from_numpy(nxt))
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-5)
    g, jg = p.grad.numpy(), np.asarray(jgrad)
    assert np.abs(g - jg).max() <= NET_GRAD_RTOL * np.abs(jg).max(), (g, jg)


def test_learned_refinement_data_matches_jax():
    """make_pair from the same generator state, and the feature stack (the
    port's channels first) on the same frames and flow."""
    jex = _jax_example("learned_refinement")
    got = t_refine.make_pair(np.random.default_rng(3))
    want = jex["make_pair"](np.random.default_rng(3))
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g, w_, rtol=0, atol=1e-3)  # |prev| ~ 1000
    prev, nxt, flow = (torch.from_numpy(a) for a in got)
    feats = t_refine.features(prev, nxt, flow).numpy()
    jfeats = np.asarray(jex["features"](*(jnp.asarray(a) for a in got)))
    np.testing.assert_allclose(feats, jfeats.transpose(2, 0, 1), rtol=0, atol=IMAGE_TOL)


def test_refine_net_matches_flax():
    """RefineNet with the flax RefineNet's parameters (the output conv made
    nonzero, so every layer carries gradient): the forward, the parameter
    gradients of the EPE loss, and the parameters after five adam steps
    against optax's."""
    jex = _jax_example("learned_refinement")
    rng = np.random.default_rng(5)
    b, h, w = 2, 16, 20
    x = rng.normal(0, 1, (b, h, w, 4)).astype(np.float32)
    truth = rng.normal(0, 1, (b, h, w, 2)).astype(np.float32)
    coarse = rng.normal(0, 1, (b, h, w, 2)).astype(np.float32)
    jnet = jex["RefineNet"]()
    params = jnet.init(jax.random.key(0), jnp.asarray(x[0]))
    params = jax.tree_util.tree_map(np.asarray, params)
    params["params"]["Conv_2"]["kernel"] = rng.normal(0, 0.1, (3, 3, 16, 2)).astype(np.float32)
    params["params"]["Conv_2"]["bias"] = rng.normal(0, 0.1, 2).astype(np.float32)

    net = t_refine.RefineNet()
    net.load_state_dict(t_refine.refine_net_state_from_flax(params))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    jout = np.asarray(jax.vmap(lambda f: jnet.apply(params, f))(jnp.asarray(x)))
    np.testing.assert_allclose(net(xt).detach().permute(0, 2, 3, 1).numpy(), jout,
                               rtol=0, atol=NET_TOL)

    def jloss(p):
        delta = jax.vmap(lambda f: jnet.apply(p, f))(jnp.asarray(x))
        return jnp.mean(jnp.sqrt(jnp.sum(
            (jnp.asarray(coarse) + delta - jnp.asarray(truth)) ** 2, -1) + 1e-12))

    def tloss():
        return t_refine.epe(t_refine.refine(net, xt, torch.from_numpy(coarse)),
                            torch.from_numpy(truth))

    def compare(tree, named, what, scale=None):
        for name, want in t_refine.refine_net_state_from_flax(tree).items():
            got = named[name].detach().numpy()
            s = np.abs(want.numpy()).max() if scale is None else scale
            assert np.abs(got - want.numpy()).max() <= NET_GRAD_RTOL * s, (what, name)

    jgrad = jax.jit(jax.grad(jloss))
    jgrads = jgrad(params)
    tloss().backward()
    compare(jgrads, {n: p.grad for n, p in net.named_parameters()}, "gradient")

    opt = optax.adam(t_refine.LR)
    state = opt.init(params)
    topt = torch.optim.Adam(net.parameters(), lr=t_refine.LR, betas=(0.9, 0.999), eps=1e-8)
    jp = params
    for _ in range(5):
        updates, state = opt.update(jgrad(jp), state)
        jp = optax.apply_updates(jp, updates)
        topt.zero_grad()
        tloss().backward()
        topt.step()
    # five steps move a parameter by at most 5 * lr; held at 1e-4 of that
    compare(jp, dict(net.named_parameters()), "adam", scale=5 * t_refine.LR)
