"""Output-tile geometry of the window kernels.

The LK tile (``csrc/of2_lk_tile.cuh``: ``lk_residual``, ``lk_level_step``,
``lk_band_step``), the Farnebäck step (``csrc/fb_step.cu``:
``fb_level_step``, ``fb_band_step``) and the window solve
(``csrc/win_solve.cu``: ``window_solve``) stage an output tile plus its
window halo in shared memory.  The halo grows with the window radius, so
the tile that fits the shared memory shrinks: the wrapper picks the tile
here, from the radii alone, and passes it to the C entry, which checks it
and refuses a tile it cannot launch.  The choice depends on nothing but the
radii, so a spatial-TP band and the whole image tile alike.

Each thread of a block owns ``RUN`` consecutive cells of a pass (a run)
and sums them from registers.  A pass over an extent that ``RUN`` does not
divide moves its last run back to end at the extent: the cells it shares
with the run before it are computed twice, with the same arithmetic, and
written with the same value.  The formulas below are the C sources'
(``of2_lk_smem_floats``, ``of2_fb_smem_floats``, ``of2_ws_smem_floats``,
``of2_run_start``).
"""

from __future__ import annotations

import dataclasses
import functools

__all__ = [
    "RUN", "SMEM_MAX", "Tile", "blocks_per_sm", "fb_tile", "lk_tile", "run_starts", "win_tile",
    "win_tile_candidate",
]

RUN = 4  # OF2_RUN: cells per thread in each register-blocked pass
SMEM_MAX = 232_448  # bytes of shared memory one block may opt in to (H100)
SMEM_PER_SM = 228 * 1024  # of which each resident block reserves 1 KB
TILE_HEIGHTS = (8, 16, 24, 32, 40, 48, 56, 64)
TILE_WIDTHS = (16, 32, 64)
# Blocks per SM worth making room for: the kernels' warp stages wait on
# dependent gathers, so resident blocks count as much as a small halo, up to
# here.  A sweep of 21 tiles (heights 8-64 but 56, widths 16, 32, 64) on an
# H100 at tools/kernel_times.py's shapes found LK 48 x 32 at r = 7, 32 x 32
# centered at r = 4 and FB 16 x 32 at FBConfig() fastest, which is what the
# rule below picks.
LK_BLOCKS_PER_SM = 3
FB_BLOCKS_PER_SM = 4
# The window solve's tile: 64 columns, 16 rows where two blocks fit an SM,
# else 8.  ``python3 tools/kernel_times.py ROOT --win-tiles`` sweeps heights
# 8-64 and widths 16-64 at rw = 0, 4, 7 and 16 on the card (PERF.md).
WIN_TILE_W = 64
WIN_TILE_HEIGHTS = (16, 8)


def blocks_per_sm(smem_bytes: int) -> int:
    """Blocks of ``smem_bytes`` that fit the shared memory of one SM."""
    return SMEM_PER_SM // (smem_bytes + 1024)


def run_starts(extent: int) -> list[int]:
    """First cell of each run of a pass over ``extent`` cells (``extent >=
    RUN``); the last run ends at the extent."""
    return [min(k * RUN, extent - RUN) for k in range(-(-extent // RUN))]


@dataclasses.dataclass(frozen=True)
class Tile:
    tile_h: int
    tile_w: int
    smem_bytes: int
    # (pass, extent of the cells it runs over along its runs)
    passes: tuple[tuple[str, int], ...]
    # cells of the warp and product (LK: gradient) halo regions per output
    halo_cells: float


def _lk(r: int, th: int, tw: int, centered: bool) -> Tile:
    sh, sw = th + 2 * r + 2, tw + 2 * r + 2
    gh, gw = th + 2 * r, tw + 2 * r
    ldg, ldr, planes = gw | 1, tw + 1, 9 if centered else 5
    floats = 3 * gh * ldg + max(2 * sh * sw, planes * gh * ldr)
    passes = (("gradient rows", gh), ("row-pass columns", tw), ("column-pass rows", th))
    return Tile(th, tw, 4 * floats, passes, (sh * sw + gh * gw) / (th * tw))


def _fb(rw: int, rp: int, th: int, tw: int) -> Tile:
    ph, pw = th + 2 * rw, tw + 2 * rw
    sh, sw = ph + 2 * rp, pw + 2 * rp
    ldp, ldt = pw | 1, sw | 1
    floats = 5 * ph * ldp + max(sh * sw + 3 * ph * ldt, 5 * th * ldp)
    passes = (("vertical-expansion rows", ph), ("moment columns", pw),
              ("window column-pass rows", th), ("window row-pass columns", tw))
    return Tile(th, tw, 4 * floats, passes, (sh * sw + ph * pw) / (th * tw))


def win_tile_candidate(rw: int, th: int, tw: int) -> Tile:
    """A th x tw tile of the window solve (its shared memory and passes)."""
    ph, pw = th + 2 * rw, tw + 2 * rw
    lead = -rw % 4  # the staged rows start on a multiple of 4 image columns
    ldp, ldv = (lead + pw + 3) // 4 * 4, ((pw + 3) // 4 | 1) * 4
    floats = 5 * ph * ldp + 5 * th * ldv
    passes = (("column-pass rows", th), ("row-pass columns", tw))
    return Tile(th, tw, 4 * floats, passes, (ph * pw + th * pw) / (th * tw))


def _pick(tiles: list[Tile], blocks: int) -> Tile:
    """The tile with the least halo work per resident block (halo cells per
    output over the blocks per SM it leaves room for, at most ``blocks``);
    ties go to the wider, then the taller tile."""
    fits = [t for t in tiles if t.smem_bytes <= SMEM_MAX]
    if not fits:
        raise ValueError("no tile fits the shared memory")
    return min(fits, key=lambda t: (t.halo_cells / min(blocks_per_sm(t.smem_bytes), blocks),
                                    -t.tile_w, -t.tile_h))


@functools.cache
def lk_tile(r: int, centered: bool) -> Tile:
    """The LK tile for window radius ``r`` (``centered``: the nine-sum DIS
    mode)."""
    return _pick([_lk(r, th, tw, centered) for th in TILE_HEIGHTS for tw in TILE_WIDTHS],
                 LK_BLOCKS_PER_SM)


@functools.cache
def fb_tile(rw: int, rp: int) -> Tile:
    """The Farnebäck step's tile for window radius ``rw`` and expansion
    radius ``rp``."""
    return _pick([_fb(rw, rp, th, tw) for th in TILE_HEIGHTS for tw in TILE_WIDTHS],
                 FB_BLOCKS_PER_SM)


@functools.cache
def win_tile(rw: int) -> Tile:
    """The window solve's tile for window radius ``rw``: the first of
    ``WIN_TILE_HEIGHTS`` x ``WIN_TILE_W`` that leaves room for two blocks per
    SM, else the last."""
    tiles = [win_tile_candidate(rw, th, WIN_TILE_W) for th in WIN_TILE_HEIGHTS]
    return next((t for t in tiles if blocks_per_sm(t.smem_bytes) >= 2), tiles[-1])
