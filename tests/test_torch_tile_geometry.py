"""The output tiles of the window kernels (the Farnebäck step, the window
solve and the centered LK kernel) and the LK walker's strips and segments,
as the wrappers pick them: over the whole range each kernel accepts, the
block fits its shared memory, the grid covers the image, every thread's run
lies inside its pass, a band and the whole image launch the same block, and
the walker stages fewer source cells per output than the tile did.  TV-L1's
clustered tile launches: each pixel written once, the ring only at a
cluster's outer sides, the cluster rule and its counters."""

import numpy as np
import pytest
import torch

from cuda_optical_flow_2_torch import FBConfig, LKConfig, capture
from cuda_optical_flow_2_torch.kernels import (
    _build, fb_step_fused, lk_fused, lk_step_fused, tvl1_sweep,
)
from cuda_optical_flow_2_torch.kernels import tile_geometry as tg
from cuda_optical_flow_2_torch.kernels.poly_exp_fused import MAX_POLY_N
from cuda_optical_flow_2_torch.kernels.win_solve import MAX_WINDOW as FB_MAX_WINDOW

LK_RADII = range(lk_fused.MAX_WINDOW // 2 + 1)  # windows 1 .. 65
WIN_RADII = range(FB_MAX_WINDOW // 2 + 1)  # windows 1 .. 33
FB_RADII = [
    (rw, rp) for rw in range(FB_MAX_WINDOW // 2 + 1) for rp in range(1, MAX_POLY_N // 2 + 1)
]
SHAPES = [(1, 1), (7, 5), (479, 641), (1080, 1920), (806, 3840), (2160, 3840)]


def all_tiles():
    for r in LK_RADII:
        yield f"lk r={r} centered=False", tg.lk_strip(r)
        yield f"lk r={r} centered=True", tg.lk_tile(r)
    for rw, rp in FB_RADII:
        yield f"fb rw={rw} rp={rp}", tg.fb_tile(rw, rp)
    for rw in WIN_RADII:
        yield f"win rw={rw}", tg.win_tile(rw)


def test_the_ranges_are_the_kernels_limits():
    assert lk_fused.supported(LKConfig(window=65))
    assert not lk_fused.supported(LKConfig(window=67))
    assert fb_step_fused.supported(FBConfig(winsize=33, poly_n=31))
    assert not fb_step_fused.supported(FBConfig(winsize=35))
    assert not fb_step_fused.supported(FBConfig(poly_n=33))


@pytest.mark.parametrize("kernel", ["lk", "fb", "win"])
def test_shared_memory_fits_a_block(kernel):
    for label, tile in all_tiles():
        if label.startswith(kernel):
            assert 0 < tile.smem_bytes <= 232_448, label
            assert tg.blocks_per_sm(tile.smem_bytes) >= 1, label


def _tile_sides(label, tile, b, h, w):
    """(rows, columns) of a block's output: an LK block's segment (or tile
    rows) and strip (or tile columns)."""
    if label.startswith("lk"):
        r, centered = int(label.split()[1][2:]), label.endswith("True")
        _, tw, seg = tg.lk_launch(b, h, w, r, centered)
        return seg, tw
    return tile.tile_h, tile.tile_w


@pytest.mark.parametrize("shape", SHAPES)
def test_the_grid_covers_the_image(shape):
    h, w = shape
    for label, tile in all_tiles():
        # the C entries' grid: ceil(H / rows) x ceil(W / columns) blocks
        th, tw = _tile_sides(label, tile, 1, h, w)
        gy, gx = -(-h // th), -(-w // tw)
        assert gy * th >= h and gx * tw >= w, (label, shape)
        assert (gy - 1) * th < h and (gx - 1) * tw < w, (label, shape)


@pytest.mark.parametrize("kernel", ["lk", "fb", "win"])
def test_every_run_lies_inside_its_pass(kernel):
    for label, tile in all_tiles():
        if not label.startswith(kernel):
            continue
        if isinstance(tile, tg.Strip):
            assert tile.rows_per_step % tg.RUN == 0 and tile.strip_w % tg.RUN == 0, label
        else:
            assert tile.tile_h % tg.RUN == 0 and tile.tile_w % tg.RUN == 0, label
        for name, extent in tile.passes:
            starts = tg.run_starts(extent)
            assert extent >= tg.RUN, (label, name)
            assert all(0 <= s and s + tg.RUN <= extent for s in starts), (label, name)
            covered = np.zeros(extent, bool)
            for s in starts:
                covered[s:s + tg.RUN] = True
            assert covered.all(), (label, name)


def test_runs_of_a_pass_meet_without_gaps():
    assert tg.run_starts(tg.RUN) == [0]
    assert tg.run_starts(3 * tg.RUN) == [0, tg.RUN, 2 * tg.RUN]
    assert tg.run_starts(3 * tg.RUN + 1) == [0, tg.RUN, 2 * tg.RUN, 2 * tg.RUN + 1]


def test_the_tile_depends_on_the_radii_alone():
    first = [tile for _, tile in all_tiles()]
    tg.lk_strip.cache_clear()
    tg.lk_tile.cache_clear()
    tg.fb_tile.cache_clear()
    tg.win_tile.cache_clear()
    assert [tile for _, tile in all_tiles()] == first


@pytest.mark.parametrize(
    "r, centered, expect",
    [(7, False, (64, 16, 3)), (4, True, (32, 32, 3)), (4, False, (64, 16, 3)),
     (9, False, (64, 16, 3))],
)
def test_main_path_lk_tiles(r, centered, expect):
    """The main paths' blocks: the walker's strip (columns, rows a step) and
    the centered tile (rows, columns), three blocks of 256 threads an SM."""
    if centered:
        tile = tg.lk_tile(r)
        assert (tile.tile_h, tile.tile_w, min(tg.blocks_per_sm(tile.smem_bytes),
                                              tg.LK_BLOCKS_PER_SM)) == expect
        assert tile.tile_h * tile.tile_w == tg.RUN * tg.LK_MAX_THREADS  # one run a thread
    else:
        strip = tg.lk_strip(r)
        assert (strip.strip_w, strip.rows_per_step, tg.resident_blocks(strip)) == expect
        assert strip.threads == tg.LK_MAX_THREADS == 256
    assert tg.LK_MIN_BLOCKS == 3


def test_main_path_fb_tile():
    tile = tg.fb_tile(7, 3)
    assert (tile.tile_h, tile.tile_w) == (16, 32)
    assert tg.blocks_per_sm(tile.smem_bytes) >= tg.FB_BLOCKS_PER_SM


@pytest.mark.parametrize("rw", WIN_RADII)
def test_win_tile_is_the_widest_that_leaves_two_blocks(rw):
    """16 x 64 where two blocks fit an SM (up to rw = 14), else 8 x 64."""
    tile = tg.win_tile(rw)
    assert tile.tile_w == tg.WIN_TILE_W == 64
    assert tile.tile_h == (16 if rw <= 14 else 8)
    assert tg.blocks_per_sm(tile.smem_bytes) >= 2
    taller = tg.win_tile_candidate(rw, 16, 64)
    assert tile.tile_h == 16 or tg.blocks_per_sm(taller.smem_bytes) < 2


def test_main_path_win_tile():
    """FBConfig()'s winsize 15: the fastest tile of the sweep on the card."""
    tile = tg.win_tile(7)
    assert (tile.tile_h, tile.tile_w) == (16, 64)
    assert tg.blocks_per_sm(tile.smem_bytes) == 3


def _spy_launches(monkeypatch):
    """Run the CUDA launch paths on CPU tensors, recording the C calls."""
    calls = []
    monkeypatch.setattr(_build, "require_cuda", lambda *ts: torch.device("cpu"))
    monkeypatch.setattr(_build, "launch", lambda dev, name, *args: calls.append((name, args)))
    return calls


@pytest.mark.parametrize("centered", [False, True])
def test_lk_band_and_whole_image_launch_the_same_tile(monkeypatch, centered):
    """A band and the whole image launch the same strip (rows per step and
    columns) or centered the same tile; each launch's (rs, tw, seg) is
    lk_launch's for its own shape."""
    calls = _spy_launches(monkeypatch)
    rng = np.random.default_rng(0)
    frames = [torch.as_tensor(rng.random((64, 96), dtype=np.float32)) for _ in range(2)]
    flow = torch.zeros(64, 96, 2)
    cfg = LKConfig(window=15)
    lk_step_fused._launch(*frames, flow, cfg, centered, 0, 64)
    lk_step_fused._launch(frames[0][10:50], frames[1][10:50], flow[10:50], cfg, centered, 10, 64)
    assert [name for name, _ in calls] == ["of2_lk_level_step"] * 2
    # after r: rows per step, strip columns, segment rows (centered: tile
    # rows, columns, rows)
    assert [args[10:13] for _, args in calls] == [tg.lk_launch(1, h, 96, 7, centered)
                                                  for h in (64, 40)]
    assert len({args[10:12] for _, args in calls}) == 1
    if centered:
        assert calls[0][1][10] == calls[0][1][12] == 24  # 6 blocks: a wave's shorter tile
    else:
        assert calls[0][1][10:12] == (16, 64)


LK_GRID_SHAPES = [(1080, 1920), (540, 960), (68, 120), (17, 30), (479, 641), (7, 5), (1, 1)]


@pytest.mark.parametrize("r, centered", [(r, c) for r in LK_RADII for c in (False, True)])
def test_lk_strip_fits_a_block(r, centered):
    """Every radius the kernel takes, both modes: a walker strip with C's
    walk (of2_lk_walk), or a centered tile of one column-pass run a thread,
    whose block fits the shared memory and the thread limit."""
    if centered:
        tile = tg.lk_tile(r)
        assert 0 < tile.smem_bytes <= tg.SMEM_MAX and tg.blocks_per_sm(tile.smem_bytes) >= 1
        assert tile.tile_h % tg.RUN == 0 and tile.tile_w % tg.RUN == 0
        assert tile.tile_h * tile.tile_w <= tg.RUN * tg.LK_MAX_THREADS
        return
    strip = tg.lk_strip(r)
    assert 0 < strip.smem_bytes <= tg.SMEM_MAX and tg.resident_blocks(strip) >= 1
    assert 32 <= strip.threads <= tg.LK_MAX_THREADS
    assert strip.threads == strip.rows_per_step * strip.strip_w // tg.RUN
    rs = strip.rows_per_step
    assert strip.ring_rows == 2 * r + rs  # a step's output rows see 2r + rs row-pass rows
    assert strip.src_rows == rs + 2 and strip.src_w == strip.strip_w + 2 * r + 2
    assert strip.steps(1, r) * rs >= 2 * r + 1 > (strip.steps(1, r) - 1) * rs


LK_GRID_SHAPES = [(1080, 1920), (540, 960), (68, 120), (17, 30), (479, 641), (7, 5), (1, 1)]


@pytest.mark.parametrize("b", [1, 8, 54])
@pytest.mark.parametrize("shape", LK_GRID_SHAPES)
def test_lk_grid_covers_the_image(shape, b):
    """Walker segments whose rows and the window's 2r fill whole steps,
    centered tiles of lk_tile's size or one height shorter; either covers
    the rows and columns once (the last block may be shorter), and the
    staged cells count each block's source rows and columns."""
    h, w = shape
    for r, centered in ((4, True), (4, False), (7, False), (9, False), (32, True)):
        rs, tw, seg = tg.lk_launch(b, h, w, r, centered)
        n, cols = -(-h // seg), -(-w // tw)
        assert (n - 1) * seg < h <= n * seg and (cols - 1) * tw < w <= cols * tw
        staged, out = tg.lk_cells(b, h, w, r, centered)
        assert out == b * h * w
        if centered:
            tile = tg.lk_tile(r)
            assert rs == seg and tw == tile.tile_w and seg in (tile.tile_h, tile.tile_h - 8)
            assert staged == b * cols * n * (seg + 2 * r + 2) * (tw + 2 * r + 2)
            continue
        strip = tg.lk_strip(r)
        assert (rs, tw) == (strip.rows_per_step, strip.strip_w)
        assert seg >= 1 and (seg + 2 * r) % rs == 0
        assert seg < max(h, rs) + rs
        assert staged >= b * cols * strip.src_w * (h + 2 * r + 2)
        steps = [-(-(min(seg, h - y0) + 2 * r) // rs) for y0 in range(0, h, seg)]
        assert staged == b * cols * strip.src_w * sum(k * rs + 2 for k in steps)


@pytest.mark.parametrize(
    "b, h, w, r, centered, expect",
    [(8, 1080, 1920, 7, False, 1.3866), (54, 1080, 1920, 7, False, 1.3241),
     (8, 540, 960, 4, True, 1.7354)],
    ids=["lk_batch", "lk_streams", "dis_batch"],
)
def test_lk_halo_factor_below_the_tiles(b, h, w, r, centered, expect):
    """At the benchmark's level-0 shapes the walker stages fewer source
    cells per output than the 48 x 32 tile at r = 7 did, (64 x 48) / (48 x
    32) = 2.00; the centered kernel keeps its 32 x 32 tile, (42 x 42) / (32 x
    32) = 1.72, and the tiles past the image's last row."""
    staged, out = tg.lk_cells(b, h, w, r, centered)
    assert staged / out == pytest.approx(expect, abs=1e-4)
    assert staged / out < (1.75 if centered else 1.4)


def test_lk_segment_follows_the_launch():
    """A batch of 8 at 1080 x 1920 (r = 7): seven 162-row segments, 1680
    blocks over the card's 396 resident ones; 54 frames: four; one frame
    and the coarse levels: short segments, so the few columns still spread
    over the SMs; a segment and its 2r rows fill whole steps.  The centered
    tile: 32 x 32 where its grid fills a wave, 24 x 32 at DIS's coarse
    levels."""
    strip = tg.lk_strip(7)
    assert tg.resident_blocks(strip) * tg.SMS == 396
    assert tg.lk_segment(8, 1080, 1920, 7) == 162
    assert tg.lk_segment(54, 1080, 1920, 7) == 274
    for b, h, w in ((8, 68, 120), (1, 1080, 1920), (8, 270, 480), (1, 1, 1)):
        seg = tg.lk_segment(b, h, w, 7)
        assert (seg + 14) % strip.rows_per_step == 0
        assert seg <= max(-(-h // 2), 2)
    assert tg.lk_launch(8, 540, 960, 4, True) == (32, 32, 32)
    assert tg.lk_launch(1, 1080, 1920, 4, True) == (32, 32, 32)
    assert tg.lk_launch(8, 270, 480, 4, True) == (32, 32, 32)  # 1080 blocks
    assert tg.lk_launch(8, 135, 240, 4, True) == (24, 32, 24)  # 320 blocks at 32 rows


def test_fb_band_and_whole_image_launch_the_same_tile(monkeypatch):
    calls = _spy_launches(monkeypatch)
    rng = np.random.default_rng(1)
    nxt = torch.as_tensor(rng.random((64, 96), dtype=np.float32))
    exp1 = tuple(torch.as_tensor(rng.random((64, 96), dtype=np.float32)) for _ in range(5))
    flow = torch.zeros(64, 96, 2)
    cfg = FBConfig()
    fb_step_fused._launch(nxt, exp1, flow, cfg, False, 0, 64)
    fb_step_fused._launch(nxt[5:40], tuple(e[5:40] for e in exp1), flow[5:40], cfg, False, 5, 64)
    tile = tg.fb_tile(cfg.winsize // 2, cfg.poly_n // 2)
    assert [name for name, _ in calls] == ["of2_fb_step"] * 2
    assert {args[15:17] for _, args in calls} == {(tile.tile_h, tile.tile_w)}  # after rw, rp


@pytest.mark.parametrize(
    "b, h, w, window, centered, bound",
    [(8, 1080, 1920, 15, False, 1.4), (8, 540, 960, 9, True, 1.75)],
    ids=["lk_1080p", "dis_540p"],
)
def test_lk_wrappers_count_cells(monkeypatch, b, h, w, window, centered, bound):
    """Each of the three LK wrappers counts one launch per call (meta
    tensors: no data, the launch spied), the counters that
    kernel_calls_per_replay.batch sums, and nothing else; the halo factor
    of those launches, the source cells they stage over the output cells
    they write (:func:`tile_geometry.lk_cells`), stays under the bound."""
    calls = _spy_launches(monkeypatch)
    p, n = (torch.empty(b, h, w, device="meta") for _ in range(2))
    f = torch.empty(b, h, w, 2, device="meta")
    cfg = LKConfig(window=window, window_weights="box" if centered else "tri")
    before = capture.snapshot()
    lk_fused.lk_residual(p, n, cfg, centered)
    lk_step_fused.lk_level_step(p, n, f, cfg, centered)
    lk_step_fused.lk_band_step(p, n, f, 100, cfg, h + 200, centered)
    change = capture.delta(before, capture.snapshot())
    assert [name for name, _ in calls] == ["of2_lk_residual"] + ["of2_lk_level_step"] * 2
    mode = ["lk_fused.lk_residual", "lk_step_fused.lk_level_step", "lk_step_fused.lk_band_step"]
    want = {f"{fn}.launches": 1 for fn in mode}
    want |= {f"{fn}.launches_centered": 1 for fn in mode} if centered else {}
    assert change == want
    staged, out = tg.lk_cells(b, h, w, window // 2, centered)
    assert out == b * h * w and staged / out < bound


# --- TV-L1's relaxation in thread-block clusters ----------------------------

TVL1_LEVELS_1080P = [(1080, 1920), (540, 960), (270, 480), (135, 240), (67, 120)]  # TVL1Config()
TVL1_SHAPES = TVL1_LEVELS_1080P + [(479, 641), (740, 3840)]  # ragged; a TP band (4K, 3 shards)


@pytest.mark.parametrize("cluster", tg.TVL1_CLUSTERS)
@pytest.mark.parametrize("k", [7, 8])
@pytest.mark.parametrize("shape", TVL1_SHAPES)
def test_tvl1_cluster_writes_each_pixel_once(shape, k, cluster):
    """Every pixel of the band is written back by exactly one block of a
    tile launch, and each block's ring is k cells on the sides that are its
    cluster's outer sides and none on the sides it shares with a peer."""
    h, w = shape
    cx, cy = cluster
    written = np.zeros((h, w), np.int32)
    blocks = 0
    for by, bx, (y0, y1), (x0, x1), ring in tg.tvl1_block_writes(h, w, k, cluster):
        rx, ry = bx % cx, by % cy
        assert ring == (k if ry == 0 else 0, k if ry == cy - 1 else 0,
                        k if rx == 0 else 0, k if rx == cx - 1 else 0), (by, bx)
        if y0 < y1 and x0 < x1:
            written[y0:y1, x0:x1] += 1
        blocks += 1
    gy, gx = tg.tvl1_grid(h, w, k, cluster)
    assert blocks == gy * gx * cx * cy
    assert (written == 1).all()


@pytest.mark.parametrize("b, clustered", [(8, [0, 1]), (1, [0])])
def test_tvl1_cluster_rule_follows_the_grid(b, clustered):
    """TVL1Config() at 1080x1920: 1 x 2 clusters where the plain grid (b x
    tiles at the call's first k, 8) is more than four waves of an H100's
    132 SMs (8 x 1080 x 1920: 7360 tiles, 8 x 540 x 960: 1920, 1 x 1080 x
    1920: 920), the plain launch at the thinner levels (8 x 270 x 480: 480
    tiles)."""
    assert tg.TVL1_CLUSTER == (1, 2) and tg.TVL1_CLUSTER_WAVES == 4
    for level, (h, w) in enumerate(TVL1_LEVELS_1080P):
        ty, tx = tg.tvl1_grid(h, w, 8)
        want = tg.TVL1_CLUSTER if level in clustered else (1, 1)
        assert (b * ty * tx > 4 * tg.SMS) == (level in clustered)
        assert tg.tvl1_cluster(b, h, w, 8, tg.SMS) == want
    assert tg.tvl1_cluster(1, 740, 3840, 8, tg.SMS) == tg.TVL1_CLUSTER  # the 4K TP band
    assert tg.tvl1_cluster(8, 270, 480, 8, 100) == tg.TVL1_CLUSTER  # a card of fewer SMs


@pytest.mark.parametrize(
    "cluster, k, slots",
    [((1, 1), 8, 1.8173), ((1, 1), 7, 1.6948), (tg.TVL1_CLUSTER, 8, 1.5802),
     (tg.TVL1_CLUSTER, 7, 1.5407)],
)
def test_tvl1_slot_factor_at_1080p(cluster, k, slots):
    """Cells iterated per pixel at 1080x1920: 920 plain 64 x 64 tiles at k = 8
    (858 at k = 7) against 400 (390) clusters of 1 x 2 tiles."""
    assert tg.tvl1_slots(1, 1080, 1920, k, cluster) == pytest.approx(slots, abs=1e-4)
    assert tg.tvl1_slots(8, 1080, 1920, k, cluster) == tg.tvl1_slots(1, 1080, 1920, k, cluster)


def _spy_tvl1(monkeypatch):
    """Run the TV-L1 wrappers' launch path on meta tensors, recording the C
    calls' (B, H, W, row0, Hg, iterations, cx, cy)."""
    calls = []
    monkeypatch.setattr(_build, "require_cuda", lambda *ts: ts[0].device)
    monkeypatch.setattr(_build, "launch",
                        lambda dev, name, *args: calls.append(args[8:15] + args[20:22]))
    return calls


def _tvl1_call(band: bool, b: int, h: int, w: int, iterations: int = 30):
    kw = dict(iterations=iterations, lambda_=0.15, theta=0.3, tau=0.25, eps=0.01)
    p, n = (torch.empty(b, h, w, device="meta") for _ in range(2))
    f = torch.empty(b, h, w, 2, device="meta")
    if band:
        state = tuple(torch.empty(b, h, w, device="meta") for _ in range(6))
        tvl1_sweep.tvl1_relax_band(p, n, f, state, 100, h + 200, **dict(kw, iterations=8))
    else:
        tvl1_sweep.tvl1_relax(p, n, f, f, **kw)


def test_tvl1_band_and_whole_image_launch_the_same_cluster(monkeypatch):
    """The whole image and a band of the same shape launch the cluster the
    rule gives for their shape, whatever the band's rows."""
    calls = _spy_tvl1(monkeypatch)
    for band in (False, True):
        for h, w in ((540, 960), (135, 240)):
            _tvl1_call(band, 8, h, w)
    want = [tg.tvl1_cluster(8, h, w, 8, tg.SMS) for h, w in ((540, 960), (135, 240))] * 2
    assert [c[-2:] for c in calls] == want
    assert [c[3:5] for c in calls] == [(0, 540), (0, 135), (100, 740), (100, 335)]


@pytest.mark.parametrize("b, clustered", [(8, 10), (1, 5)], ids=["video_batch", "single_pair"])
def test_tvl1_wrappers_count_clustered_calls(monkeypatch, b, clustered):
    """The counters: a TVL1Config() call at 1080x1920 runs 25 relaxations (5
    levels x 5 warps), of which 10 clustered with 8 pairs and 5 with one;
    ``launches_clustered`` is a ``launches*`` counter that
    kernel_calls_per_replay.batch does not sum (it counts ``.launches``)."""
    import importlib.util
    from pathlib import Path

    names = capture.counters()
    for fn in ("tvl1_relax", "tvl1_relax_band"):
        assert f"tvl1_sweep.{fn}.launches_clustered" in names
    path = Path(__file__).parent.parent / "flowbench" / "metrics" / "kernel_calls_per_replay.batch.py"
    spec = importlib.util.spec_from_file_location("kernel_calls_per_replay_batch", path)
    metric = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(metric)

    _spy_tvl1(monkeypatch)
    before = capture.snapshot()
    for h, w in TVL1_LEVELS_1080P:
        for _ in range(5):
            _tvl1_call(False, b, h, w)
    change = capture.delta(before, capture.snapshot())
    assert change == {"tvl1_sweep.tvl1_relax.launches": 25,
                      "tvl1_sweep.tvl1_relax.launches_clustered": clustered}
    assert metric._total(change) == 25
    before = capture.snapshot()
    _tvl1_call(True, 1, 740, 3840)
    assert capture.delta(before, capture.snapshot()) == {
        "tvl1_sweep.tvl1_relax_band.launches": 1, "tvl1_sweep.tvl1_relax_band.launches_clustered": 1}
