"""The output tiles of the window kernels (the LK tile, the Farnebäck step
and the window solve), as the wrappers pick them from the radii: over the
whole range each kernel accepts, the tile fits a block's shared memory,
covers the image, keeps every thread's run inside its pass, and is the same
for a band and the whole image."""

import numpy as np
import pytest
import torch

from cuda_optical_flow_2_torch import FBConfig, LKConfig
from cuda_optical_flow_2_torch.kernels import _build, fb_step_fused, lk_fused, lk_step_fused
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
        for centered in (False, True):
            yield f"lk r={r} centered={centered}", tg.lk_tile(r, centered)
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


@pytest.mark.parametrize("shape", SHAPES)
def test_the_grid_covers_the_image(shape):
    h, w = shape
    for label, tile in all_tiles():
        # the C entries' grid: ceil(H / tile_h) x ceil(W / tile_w) blocks
        gy, gx = -(-h // tile.tile_h), -(-w // tile.tile_w)
        assert gy * tile.tile_h >= h and gx * tile.tile_w >= w, (label, shape)
        assert (gy - 1) * tile.tile_h < h and (gx - 1) * tile.tile_w < w, (label, shape)


@pytest.mark.parametrize("kernel", ["lk", "fb", "win"])
def test_every_run_lies_inside_its_pass(kernel):
    for label, tile in all_tiles():
        if not label.startswith(kernel):
            continue
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
    tg.lk_tile.cache_clear()
    tg.fb_tile.cache_clear()
    tg.win_tile.cache_clear()
    assert [tile for _, tile in all_tiles()] == first


@pytest.mark.parametrize(
    "r, centered, expect",
    [(7, False, (48, 32)), (4, True, (32, 32)), (4, False, (56, 32)), (9, False, (40, 32))],
)
def test_main_path_lk_tiles(r, centered, expect):
    tile = tg.lk_tile(r, centered)
    assert (tile.tile_h, tile.tile_w) == expect
    assert tg.blocks_per_sm(tile.smem_bytes) >= tg.LK_BLOCKS_PER_SM


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
    calls = _spy_launches(monkeypatch)
    rng = np.random.default_rng(0)
    frames = [torch.as_tensor(rng.random((64, 96), dtype=np.float32)) for _ in range(2)]
    flow = torch.zeros(64, 96, 2)
    cfg = LKConfig(window=15)
    lk_step_fused._launch(*frames, flow, cfg, centered, 0, 64)
    lk_step_fused._launch(frames[0][10:50], frames[1][10:50], flow[10:50], cfg, centered, 10, 64)
    tile = tg.lk_tile(7, centered)
    assert [name for name, _ in calls] == ["of2_lk_level_step"] * 2
    assert {args[10:12] for _, args in calls} == {(tile.tile_h, tile.tile_w)}  # after r


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
