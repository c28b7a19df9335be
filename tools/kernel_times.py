"""Time whole-image CUDA kernels of one checkout; print one JSON line.

    python3 tools/kernel_times.py ROOT
    python3 tools/kernel_times.py ROOT --win-tiles
    python3 tools/kernel_times.py ROOT --lk-strips
    python3 tools/kernel_times.py ROOT --tvl1-clusters

ROOT is the root of a checkout of this repo (its ``chip_smoke.py`` and
``cuda_optical_flow_2_torch`` are imported from there).  It builds that
checkout's kernels and times, at 1080x1920 with CUDA events and the shapes
of ``chip_smoke.py``'s phase 9: the kernels of the shared LK tile body,
``lk_residual`` (``PAPER_1080P`` and the DIS 9x9 box centered mode),
``lk_level_step`` (both, and ``flow_half`` of both where the checkout has
it: a fused instance, or the handoff kernel then the step) and
``lk_band_step`` (``PAPER_1080P``, the frames as the band of rows
497-1577 of a 2160-row image); ``warp_bilinear_select``,
``bilateral_kernel`` (9x9, the stacked pair), ``hs_relax`` (100 sweeps,
quadratic and Charbonnier), ``tvl1_relax`` (14 iterations, warm) and
``fb_level_step`` (``FBConfig()``, warm), ``poly_expansion_kernel``
(``poly_n = 7``), ``window_solve`` (15x15) and TV-L1's per-warp 5x5
median of the (2, H, W) flow view (``median_filter_kernel``; a checkout
without it times the plain ``ops.median.median_filter`` that its TV-L1
path runs); and the band entries at
phase 9's interior 4K band (rows 720-1440 of 2160x3840 and the TP path's
halo): ``lk_band_step`` (halo 43, ``PAPER_1080P`` and the DIS 9x9 box
centered mode), ``bilateral_kernel_band`` (halo 4, 9x9, the stacked
pair), ``fb_band_step`` (halo 46, ``FBConfig()``, warm),
``hs_relax_band`` (halo 10, 8 quadratic sweeps; 8 Charbonnier sweeps with
``it_offset``) and ``tvl1_relax_band`` (halo 10, 8 iterations, carried
duals).

Each time is the device's: median over runs of the ms per call of
``inner`` back-to-back calls between two CUDA events, recorded while the
card waits in a sleep kernel until the host has enqueued them all, so the
host's launch time (a wrapper call costs tens of microseconds, more than
some of these kernels) is not in it.  To compare two checkouts, run it
on both on one card, one after the other in one command, in the order
parent, change, change, parent.

``--win-tiles`` instead sweeps the window solve's output tile
(``tile_geometry.win_tile_candidate``: heights 8-64, widths 16, 32, 64,
those that fit a block's shared memory) at 1080x1920 and window radii 0, 4,
7 and 16, each launch checked bit-equal to ``window_solve_plain``, and
prints one JSON line per radius: the tile ``win_tile`` picks and every
tile's device ms.

``--lk-strips`` instead sweeps the LK kernel's blocks for
``lk_level_step``, each launch checked bit-equal to the wrapper's: the
walker's strip (columns x rows per step, ``tile_geometry.lk_walk``, those
that fit) and segment (output rows a block walks: the one ``lk_segment``
picks and a range of others) with ``PAPER_1080P`` at 8 x 1080 x 1920 (video
batch) and 54 x 1080 x 1920 (camera streams); the centered tile (rows x
columns, ``tile_geometry.lk_tile_candidate``, those that fit) in the DIS
9x9 box centered mode at 8 x 540 x 960 and DIS's next three levels.  One
JSON line per shape: the block ``lk_launch`` picks and every block's
device ms.

``--tvl1-clusters`` instead times ``tvl1_relax`` (``TVL1Config()``'s 30
iterations, warm) at each of its pyramid's five level shapes at 1080x1920,
with 8 pairs and with one, and ``tvl1_relax_band`` (8 iterations, carried
duals) at the interior 4K band, in each cluster shape the C entry has
compiled in (``tile_geometry.TVL1_CLUSTERS``) and, for the clusters, at
``ITERS_PER_LAUNCH`` 8 and 10; each launch is checked ``torch.equal`` to
the plain launch (1 x 1 at 8), which is checked against the plain version.
It prints the card's SMs and ``cudaOccupancyMaxActiveClusters`` per shape,
then one JSON line per shape: the cluster ``tvl1_cluster`` picks and every
launch's device ms.
"""

import inspect
import json
import sys
from pathlib import Path

import numpy as np


SLEEP_CYCLES = 5_000_000  # about 3 ms of SM clock: longer than 10 calls take to enqueue


def device_ms(fn, reps: int, inner: int = 1, warmup: int = 3) -> float:
    """Median over ``reps`` of the device ms per call of ``inner`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def sweep_win_tiles(p0, n0, f0) -> int:
    """Device ms of the window solve at each tile that fits, per radius."""
    import torch

    from cuda_optical_flow_2_torch.kernels import _build, poly_exp_fused, tile_geometry, win_solve
    from cuda_optical_flow_2_torch.models.farneback import fb_normal_eq_products

    dev = p0.device
    xs = [t.contiguous() for t in fb_normal_eq_products(
        poly_exp_fused.poly_expansion_plain(p0, 7, 1.5),
        poly_exp_fused.poly_expansion_plain(n0, 7, 1.5), f0[..., 0], f0[..., 1])]
    (h, w), out = xs[0].shape, torch.empty(xs[0].shape + (2,), device=dev)
    for rw in (0, 4, 7, 16):
        want = win_solve.window_solve_plain(*xs, window=2 * rw + 1)
        times = {}
        for th in (8, 16, 24, 32, 40, 48, 64):
            for tw in (16, 32, 64):
                if tile_geometry.win_tile_candidate(rw, th, tw).smem_bytes > tile_geometry.SMEM_MAX:
                    continue

                def launch(th=th, tw=tw):
                    _build.launch(dev, "of2_window_solve", *(x.data_ptr() for x in xs),
                                  out.data_ptr(), 1, h, w, rw, th, tw, 1e-6)

                times[f"{th}x{tw}"] = device_ms(launch, 20, inner=10)
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    raise SystemExit(f"window solve rw={rw} tile {th}x{tw}: not bit-equal")
        pick = tile_geometry.win_tile(rw)
        print(json.dumps({"rw": rw, "win_tile": f"{pick.tile_h}x{pick.tile_w}",
                          "ms": dict(sorted(times.items(), key=lambda kv: kv[1]))}))
    return 0


LK_SWEEP_STRIPS = ((64, 16), (32, 32), (64, 8), (32, 16), (128, 8), (96, 8), (48, 16))


def sweep_lk_strips(textured_pair) -> int:
    """Device ms of lk_level_step at each block, per shape."""
    import torch

    import cuda_optical_flow_2_torch as of
    from cuda_optical_flow_2_torch.kernels import _build, lk_step_fused, tile_geometry as tg
    from cuda_optical_flow_2_torch.kernels.lk_fused import kernel_constants
    from cuda_optical_flow_2_torch.models.dis import _lk_like

    dev = torch.device("cuda", 0)
    dis_lk = _lk_like(of.DISConfig())
    for label, b, h, w, cfg, centered in (
            ("lk video_batch", 8, 1080, 1920, of.PAPER_1080P, False),
            ("lk camera_streams", 54, 1080, 1920, of.PAPER_1080P, False),
            ("dis video_batch", 8, 540, 960, dis_lk, True),
            ("dis level 2", 8, 270, 480, dis_lk, True),
            ("dis level 3", 8, 135, 240, dis_lk, True),
            ("dis level 4", 8, 68, 120, dis_lk, True)):
        p0, n0, f0 = (torch.as_tensor(a, device=dev) for a in textured_pair(h, w, seed=h))
        p, n, f = (x.expand(b, *x.shape).contiguous() for x in (p0, n0, f0))
        want = lk_step_fused.lk_level_step(p, n, f, cfg, centered)
        out = torch.empty_like(want)
        r, taps, masks = kernel_constants(cfg)
        picked = tg.lk_launch(b, h, w, r, centered)
        geos = set()
        if centered:
            for th in tg.TILE_HEIGHTS:
                for tw in tg.TILE_WIDTHS:
                    if tg.lk_tile_candidate(r, th, tw).smem_bytes <= tg.SMEM_MAX:
                        geos.add((th, tw, th))
        else:
            for tw, rs in LK_SWEEP_STRIPS:
                strip = tg.lk_walk(r, rs, tw)
                if strip.smem_bytes > tg.SMEM_MAX or strip.threads > tg.LK_MAX_THREADS:
                    continue
                geos |= {(rs, tw, strip.segment(-(-h // k), r)) for k in (1, 2, 3, 4, 5, 7, 9, 14)}
        times = {}
        for geo in sorted(geos | {picked}):
            def launch(geo=geo):
                _build.launch(dev, "of2_lk_level_step", p.data_ptr(), n.data_ptr(),
                              f.data_ptr(), out.data_ptr(), b, h, w, 0, h, r, *geo,
                              taps.ctypes.data, masks.ctypes.data, float(cfg.det_eps),
                              float(cfg.max_displacement), int(centered))

            name = f"{geo[0]}x{geo[1]}" if centered else f"{geo[1]}x{geo[0]}/{geo[2]}"
            times[name] = device_ms(launch, 20, inner=10)
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise SystemExit(f"lk_level_step {label} block {geo}: not bit-equal")
        print(json.dumps({"shape": label, "lk_launch": picked,
                          "ms": dict(sorted(times.items(), key=lambda kv: kv[1]))}))
    return 0


TVL1_SWEEP_K = (8, 10)


def sweep_tvl1_clusters(textured_pair) -> int:
    """Device ms of the TV-L1 relaxation per cluster shape, per level shape."""
    import torch

    import cuda_optical_flow_2_torch as of
    from cuda_optical_flow_2_torch.kernels import tile_geometry as tg
    from cuda_optical_flow_2_torch.kernels import tvl1_sweep, warp_select

    dev = torch.device("cuda", 0)
    print(json.dumps({"sms": tvl1_sweep.sm_count(dev),
                      "max_active_clusters": {f"{cx}x{cy}": tvl1_sweep.max_clusters(dev, (cx, cy))
                                              for cx, cy in tg.TVL1_CLUSTERS}}))
    tv = of.TVL1Config()
    kw = dict(lambda_=tv.lambda_, theta=tv.theta, tau=tv.tau, eps=tv.epsilon)
    base_k = tvl1_sweep.ITERS_PER_LAUNCH
    rng = np.random.default_rng(5)
    shapes = [(b, h, w) for b in (8, 1)
              for h, w in ((1080, 1920), (540, 960), (270, 480), (135, 240), (67, 120))]
    for b, h, w in shapes + [(1, 740, 3840)]:
        p0, n0, f0 = (torch.as_tensor(a, device=dev) for a in textured_pair(h, w, seed=h + b))
        w0 = warp_select.warp_bilinear_select_plain(n0, f0)
        p, wp, f = (x.expand(b, *x.shape).contiguous() for x in (p0, w0, f0))
        if h == 740:  # the interior band of a 3-shard 4K split, with its halo
            state = tuple(torch.as_tensor(rng.normal(0, 0.05, (1, h, w)).astype(np.float32),
                                          device=dev) for _ in range(4))
            state = (f[..., 0] * 0.5, f[..., 1] * 0.5, *state)
            duals = torch.stack(state[2:], dim=-1)
            flow, row0, hg, iters = torch.stack(state[:2], dim=-1), 710, 2160, 8
            want = tvl1_sweep.tvl1_relax_band_plain(p, wp, f, state, row0, hg, iterations=iters,
                                                    **kw)
            want = (torch.stack(want[:2], dim=-1), torch.stack(want[2:], dim=-1))
        else:
            duals, flow, row0, hg, iters = None, f * 0.9, 0, h, tv.iterations
            want = (tvl1_sweep.tvl1_relax_plain(p, wp, f, flow, iterations=iters, **kw), None)
        picked = tg.tvl1_cluster(b, h, w, tvl1_sweep.launch_iterations(iters)[0],
                                 tvl1_sweep.sm_count(dev))
        times, ref = {}, None
        for k in TVL1_SWEEP_K:
            for cluster in tg.TVL1_CLUSTERS:
                if cluster == (1, 1) and k != base_k:
                    continue

                def launch(cluster=cluster):
                    return tvl1_sweep._launch(p, wp, f, flow, duals, row0, hg, iters,
                                              cluster=cluster, **kw)[:2]

                tvl1_sweep.ITERS_PER_LAUNCH = k
                try:
                    got = launch()
                    times[f"{cluster[0]}x{cluster[1]} K={k}"] = device_ms(launch, 10, inner=3)
                finally:
                    tvl1_sweep.ITERS_PER_LAUNCH = base_k
                if ref is None:
                    ref = got
                    if not all(a is None or torch.equal(a, c) for a, c in zip(got, want)):
                        raise SystemExit(f"tvl1 {b}x{h}x{w} plain launch: not bit-equal to "
                                         "the plain version")
                if not all(a is None or torch.equal(a, c) for a, c in zip(got, ref)):
                    raise SystemExit(f"tvl1 {b}x{h}x{w} cluster {cluster} K={k}: not bit-equal")
        print(json.dumps({"shape": f"{b}x{h}x{w}", "iterations": iters,
                          "tvl1_cluster": f"{picked[0]}x{picked[1]}",
                          "ms": dict(sorted(times.items(), key=lambda kv: kv[1]))}), flush=True)
    return 0


def main() -> int:
    root = Path(sys.argv[1]).resolve()
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as cs
    import cuda_optical_flow_2_torch as of
    from cuda_optical_flow_2_torch.kernels import (
        _build,
        bilateral_tap,
        fb_step_fused,
        hs_sweep,
        lk_fused,
        lk_step_fused,
        poly_exp_fused,
        tvl1_sweep,
        warp_select,
        win_solve,
    )
    from cuda_optical_flow_2_torch.models.dis import _lk_like
    from cuda_optical_flow_2_torch.ops.median import median_filter

    try:
        from cuda_optical_flow_2_torch.kernels.median_select import median_filter_kernel
    except ImportError:  # before the kernel: TV-L1 ran the plain median
        median_filter_kernel = median_filter
    from cuda_optical_flow_2_torch.models.farneback import fb_normal_eq_products

    dev = torch.device("cuda", 0)
    _build.library()
    p0, n0, f0 = (torch.as_tensor(a, device=dev) for a in cs.textured_pair(1080, 1920, seed=7))
    if "--win-tiles" in sys.argv[2:]:
        return sweep_win_tiles(p0, n0, f0)
    if "--lk-strips" in sys.argv[2:]:
        return sweep_lk_strips(cs.textured_pair)
    if "--tvl1-clusters" in sys.argv[2:]:
        return sweep_tvl1_clusters(cs.textured_pair)
    pair = torch.stack([p0, n0])
    w0 = warp_select.warp_bilinear_select_plain(n0, f0)
    exp0 = poly_exp_fused.poly_expansion_plain(p0, 7, 1.5)
    tv = of.TVL1Config()
    tvl1_kw = dict(iterations=14, lambda_=tv.lambda_, theta=tv.theta, tau=tv.tau, eps=tv.epsilon)
    dis_lk = _lk_like(of.DISConfig())
    prods0 = fb_normal_eq_products(exp0, poly_exp_fused.poly_expansion_plain(n0, 7, 1.5),
                                   f0[..., 0], f0[..., 1])
    cfg = of.PAPER_1080P
    cases = [
        ("lk_residual", lambda: lk_fused.lk_residual(p0, n0, cfg), 30, 10),
        ("lk_residual centered", lambda: lk_fused.lk_residual(p0, n0, dis_lk, centered=True),
         30, 10),
        ("lk_level_step", lambda: lk_step_fused.lk_level_step(p0, n0, f0, cfg), 30, 10),
        ("lk_level_step centered", lambda: lk_step_fused.lk_level_step(
            p0, n0, f0, dis_lk, centered=True), 30, 10),
        ("lk_band_step", lambda: lk_step_fused.lk_band_step(p0, n0, f0, 497, cfg, 2160), 30, 10),
        ("warp_bilinear_select", lambda: warp_select.warp_bilinear_select(p0, f0, 32), 30, 10),
        ("bilateral_kernel", lambda: bilateral_tap.bilateral_kernel(pair, 9), 30, 10),
        ("hs_relax", lambda: hs_sweep.hs_relax(p0, n0, None, iterations=100, alpha=10.0,
                                               temporal_kernel="gauss3"), 10, 1),
        ("hs_relax charbonnier", lambda: hs_sweep.hs_relax(
            p0, n0, None, iterations=100, alpha=10.0, temporal_kernel="gauss3",
            robust=(3.0, 0.1)), 10, 1),
        ("tvl1_relax", lambda: tvl1_sweep.tvl1_relax(p0, w0, f0, f0, **tvl1_kw), 10, 1),
        ("fb_level_step", lambda: fb_step_fused.fb_level_step(n0, exp0, f0, of.FBConfig()), 30, 10),
        ("poly_expansion_kernel", lambda: poly_exp_fused.poly_expansion_kernel(p0, 7, 1.5), 30,
         10),
        ("window_solve", lambda: win_solve.window_solve(*prods0, 15, 1e-6), 30, 10),
        ("median_filter_kernel", lambda: median_filter_kernel(f0.movedim(-1, 0), 5), 30, 10),
    ]
    # the band entries at the interior 4K band, with its TP halo of 10 rows
    rng = np.random.default_rng(3)
    p8, n8, f8 = (torch.as_tensor(a, device=dev) for a in cs.textured_pair(2160, 3840, seed=8))
    w8 = warp_select.warp_bilinear_select_plain(n8, f8)
    off8, *duals8 = (torch.as_tensor(rng.normal(0, s, (2160, 3840)).astype(np.float32), device=dev)
                     for s in (5.0, 0.05, 0.05, 0.05, 0.05))

    def band(x, halo=10):
        return x[720 - halo:1440 + halo].contiguous()

    state8 = tuple(band(x) for x in (f8[..., 0] * 0.5, f8[..., 1] * 0.5, *duals8))
    hs_band = (band(p8), band(n8), band(f8) * 0.1, 710, 2160)
    hs_band_kw = dict(sweeps=8, alpha=10.0, temporal_kernel="gauss3")
    hs_charb_kw = dict(hs_band_kw, robust=(3.0, 0.1), it_offset=band(off8))
    tvl1_band = (band(p8), band(w8), band(f8), state8, 710, 2160)
    tvl1_band_kw = dict(tvl1_kw, iterations=8)
    lk_band = (band(p8, 43), band(n8, 43), band(f8, 43), 720 - 43)
    exp8 = poly_exp_fused.poly_expansion_plain(p8, 7, 1.5)
    fb_band = (band(n8, 46), tuple(band(e, 46) for e in exp8), band(f8, 46), 720 - 46,
               of.FBConfig(), 2160)
    bil_band = (torch.stack([band(p8, 4), band(n8, 4)]), 720 - 4, 2160, 9)
    cases += [
        ("bilateral_kernel_band", lambda: bilateral_tap.bilateral_kernel_band(*bil_band), 30, 10),
        ("lk_band_step 4K", lambda: lk_step_fused.lk_band_step(*lk_band, cfg, 2160), 30, 10),
        ("lk_band_step 4K centered", lambda: lk_step_fused.lk_band_step(
            *lk_band, dis_lk, 2160, centered=True), 30, 10),
        ("fb_band_step", lambda: fb_step_fused.fb_band_step(*fb_band), 30, 10),
        ("hs_relax_band", lambda: hs_sweep.hs_relax_band(*hs_band, **hs_band_kw), 30, 10),
        ("hs_relax_band charbonnier", lambda: hs_sweep.hs_relax_band(*hs_band, **hs_charb_kw),
         30, 10),
        ("tvl1_relax_band", lambda: tvl1_sweep.tvl1_relax_band(*tvl1_band, **tvl1_band_kw), 30,
         10),
    ]
    if "flow_half" in inspect.signature(lk_step_fused.lk_level_step).parameters:
        half = f0[::2, ::2].contiguous()
        cases.append(("lk_level_step flow_half", lambda: lk_step_fused.lk_level_step(
            p0, n0, half, cfg, flow_half=True), 30, 10))
        cases.append(("lk_level_step flow_half centered", lambda: lk_step_fused.lk_level_step(
            p0, n0, half, dis_lk, centered=True, flow_half=True), 30, 10))
    out = {name: device_ms(fn, reps, inner=inner) for name, fn, reps, inner in cases}
    print(json.dumps({"tree": root.name, **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
