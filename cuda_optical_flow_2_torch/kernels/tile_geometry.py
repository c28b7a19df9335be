"""Output-tile geometry of the window kernels.

The Farnebäck step (``csrc/fb_step.cu``: ``fb_level_step``,
``fb_band_step``) and the window solve (``csrc/win_solve.cu``:
``window_solve``) stage an output tile plus its window halo in shared
memory.  The halo grows with the window radius, so the tile that fits the
shared memory shrinks: the wrapper picks the tile here, from the radii
alone, and passes it to the C entry, which checks it and refuses a tile it
cannot launch.  The choice depends on nothing but the radii, so a
spatial-TP band and the whole image tile alike.

The LK kernel (``csrc/of2_lk_tile.cuh``: ``lk_residual``, ``lk_level_step``,
``lk_band_step``) lays its blocks out by mode.  With the five plain sums it
is a walker: a block owns a strip of output columns and walks down a
segment of rows a few rows at a time, keeping a ring of the last rows'
row-pass sums, so the window's vertical halo is staged once per segment.
Its strip (columns, rows per step, threads) depends on the radius alone
(:func:`lk_strip`); its segment length on the launch's shape too
(:func:`lk_segment`, trading the card's resident blocks filled against the
2r rows each segment stages again).  With the nine centered (DIS) sums it
keeps one output tile per block (:func:`lk_tile`, picked from the radius
like the Farnebäck tile, one height shorter where its grid would not fill
the card once).  :func:`lk_launch` gives the C entry's three numbers for
either.  None of this changes a pixel's arithmetic.

TV-L1's time-tiled relaxation (``csrc/tvl1_sweep.cu``: ``tvl1_relax``,
``tvl1_relax_band``) gives each block of 1024 threads a 64 x 64 tile and
launches its blocks in thread-block clusters: the CTAs of a cluster hand
each other the rows along their shared edge, so a launch of k iterations
recomputes a ring of k cells only at the cluster's outer sides
(:func:`tvl1_cluster` picks the cluster, :func:`tvl1_grid` and
:func:`tvl1_block_writes` give the launch's blocks and the pixels each
writes back).

Each thread of a block owns ``RUN`` consecutive cells of a pass (a run)
and sums them from registers.  A pass over an extent that ``RUN`` does not
divide moves its last run back to end at the extent: the cells it shares
with the run before it are computed twice, with the same arithmetic, and
written with the same value.  The formulas below are the C sources'
(``of2_lk_walk``, ``of2_lk_smem_floats``, ``of2_fb_smem_floats``,
``of2_ws_smem_floats``, ``of2_run_start``).
"""

from __future__ import annotations

import dataclasses
import functools

__all__ = [
    "RUN", "SMEM_MAX", "Strip", "TVL1_CLUSTER", "Tile", "blocks_per_sm", "fb_tile", "lk_cells",
    "lk_launch", "lk_segment", "lk_strip", "lk_tile", "lk_tile_candidate", "lk_walk",
    "resident_blocks", "run_starts", "tvl1_block_writes", "tvl1_cluster", "tvl1_grid",
    "tvl1_slots", "win_tile", "win_tile_candidate",
]

RUN = 4  # OF2_RUN: cells per thread in each register-blocked pass
SMEM_MAX = 232_448  # bytes of shared memory one block may opt in to (H100)
SMEM_PER_SM = 228 * 1024  # of which each resident block reserves 1 KB
SMS = 132  # streaming multiprocessors of an H100 SXM
TILE_HEIGHTS = (8, 16, 24, 32, 40, 48, 56, 64)
TILE_WIDTHS = (16, 32, 64)
# Blocks per SM worth making room for: the kernels' warp stages wait on
# dependent gathers, so resident blocks count as much as a small halo, up to
# here.  Sweeps of the tiles (heights 8-64, widths 16, 32, 64) on an H100
# at tools/kernel_times.py's shapes found the centered LK tile 32 x 32 at
# r = 4 (8 x 540 x 960) and FB 16 x 32 at FBConfig() fastest, which is what
# the rules below pick.
LK_BLOCKS_PER_SM = 3
FB_BLOCKS_PER_SM = 4
# The LK walker's strips, (columns, rows per step): 128 or 256 threads.
# ``python3 tools/kernel_times.py ROOT --lk-strips`` sweeps strips and
# segments on the card (PERF.md).
LK_STRIPS = ((64, 16), (32, 32), (64, 8), (32, 16))
LK_MAX_THREADS = 256  # OF2_LK_MAX_THREADS
LK_MIN_BLOCKS = 3  # OF2_LK_MIN_BLOCKS: blocks of LK_MAX_THREADS an SM holds by registers
LK_PLANES_C = 8  # OF2_LK_PLANES_C: the centered tile's row-pass planes
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


@dataclasses.dataclass(frozen=True)
class Strip:
    """The LK walker's block: ``strip_w`` output columns, ``rows_per_step``
    rows a step, ``threads`` threads; it holds a ring of ``ring_rows`` rows
    of row-pass sums and one of ``src_rows`` rows of ``src_w`` source
    columns."""

    rows_per_step: int
    strip_w: int
    threads: int
    smem_bytes: int
    ring_rows: int
    src_rows: int
    src_w: int
    # (pass, extent of the cells it runs over along its runs)
    passes: tuple[tuple[str, int], ...]

    def steps(self, rows: int, r: int) -> int:
        """Steps that walk ``rows`` output rows: the window's 2r rows more."""
        return -(-(rows + 2 * r) // self.rows_per_step)

    def segment(self, rows: int, r: int) -> int:
        """The shortest segment of whole steps with at least ``rows`` rows."""
        return self.steps(rows, r) * self.rows_per_step - 2 * r


def lk_walk(r: int, rows_per_step: int, strip_w: int) -> Strip:
    """The walker's block for window radius ``r`` with this strip."""
    rs, tw = rows_per_step, strip_w
    ring, src, sw, gw = 2 * r + rs, rs + 2, tw + 2 * r + 2, tw + 2 * r
    ldg, ldr = gw | 1, tw + 1
    floats = 3 * rs * ldg + 5 * ring * ldr + 2 * src * sw
    passes = (("gradient rows", rs), ("row-pass columns", tw), ("column-pass rows", rs))
    return Strip(rs, tw, rs * tw // RUN, 4 * floats, ring, src, sw, passes)


def resident_blocks(strip: Strip) -> int:
    """Blocks of this strip that one SM holds (shared memory, threads and
    registers)."""
    return min(blocks_per_sm(strip.smem_bytes), LK_MIN_BLOCKS * LK_MAX_THREADS // strip.threads)


@functools.cache
def lk_strip(r: int) -> Strip:
    """The LK walker's strip for window radius ``r``: of ``LK_STRIPS`` that
    fit, the least staging per output (source and gradient columns over
    output columns) per resident thread; ties go to the earlier strip."""
    fits = [lk_walk(r, rs, tw) for tw, rs in LK_STRIPS]
    fits = [s for s in fits if s.smem_bytes <= SMEM_MAX]
    if not fits:
        raise ValueError(f"no LK strip fits the shared memory at r = {r}")

    def staging(s: Strip) -> float:
        return (2 * s.src_w - 2) / s.strip_w / (resident_blocks(s) * s.threads)

    return min(fits, key=staging)


# A launch's blocks take about the same time and the card runs them as
# slots free: a launch lasts about its block-steps over its resident slots
# (whole waves of them under two waves, where a partial wave leaves SMs
# idle for a whole block), plus the tail of its last blocks, LK_TAIL of one
# block's steps.  Where the launch has more blocks than the card holds at
# once, a block walks at least LK_MIN_STEPS steps, so its start (the first
# rows' staging and gradients) stays a small part of it (fitted to
# tools/kernel_times.py --lk-strips on an H100: PERF.md).
LK_TAIL = 0.6
LK_MIN_STEPS = 4


@functools.cache
def lk_segment(b: int, h: int, w: int, r: int) -> int:
    """Output rows each walker block walks in a (b, h, w) launch.

    Each segment count n is taken at its shortest segment of whole steps
    (its rows and the window's 2r fill them); more segments fill more of
    the card's resident blocks but stage the 2r rows once more each.  Of
    the counts whose blocks walk at least ``LK_MIN_STEPS`` steps or fit the
    resident slots at once, the one whose waves (whole under two) times a
    block's steps, plus ``LK_TAIL`` of a block's steps, are least; the
    fewest segments on a tie."""
    strip = lk_strip(r)
    per_row = b * -(-w // strip.strip_w)
    slots = SMS * resident_blocks(strip)
    best = None
    for n in range(1, h + 1):
        seg = strip.segment(-(-h // n), r)
        if -(-h // seg) != n:  # whole steps made the segments fewer
            continue
        steps = strip.steps(seg, r)
        if n > 1 and steps < LK_MIN_STEPS and per_row * n > slots:
            continue
        waves = per_row * n / slots
        cost = (waves if waves >= 2 else -(-per_row * n // slots)) * steps + LK_TAIL * steps
        if best is None or cost < best[0] - 1e-9:
            best = (cost, seg)
    return best[1]


def lk_tile_candidate(r: int, th: int, tw: int) -> Tile:
    """A th x tw tile of the centered LK kernel (its shared memory and
    passes)."""
    sh, sw = th + 2 * r + 2, tw + 2 * r + 2
    gh, gw = th + 2 * r, tw + 2 * r
    ldg, ldr = gw | 1, tw + 1
    floats = 3 * gh * ldg + max(2 * sh * sw, LK_PLANES_C * gh * ldr)
    passes = (("gradient rows", gh), ("row-pass columns", tw), ("column-pass rows", th))
    return Tile(th, tw, 4 * floats, passes, (sh * sw + gh * gw) / (th * tw))


@functools.cache
def lk_tile(r: int) -> Tile:
    """The centered LK tile for window radius ``r``, of those whose column
    pass gives each of the block's threads one run at most (PERF.md: 40 x 32
    at r = 4, whose 320 runs leave most threads a second round, ran 1.5 %
    slower than 32 x 32 at 8 x 540 x 960)."""
    return _pick([lk_tile_candidate(r, th, tw) for th in TILE_HEIGHTS for tw in TILE_WIDTHS
                  if th * tw <= RUN * LK_MAX_THREADS], LK_BLOCKS_PER_SM)


def _lk_tile_for(b: int, h: int, w: int, r: int) -> Tile:
    """:func:`lk_tile`, or where its grid is less than one wave of the card's
    resident blocks (DIS's coarse levels), the next shorter height: the few
    blocks finish sooner, and their larger halo costs SMs that sat idle."""
    tile = lk_tile(r)
    blocks = b * -(-h // tile.tile_h) * -(-w // tile.tile_w)
    shorter = [t for t in TILE_HEIGHTS if t < tile.tile_h]
    if blocks >= SMS * min(blocks_per_sm(tile.smem_bytes), LK_BLOCKS_PER_SM) or not shorter:
        return tile
    return lk_tile_candidate(r, shorter[-1], tile.tile_w)


def lk_launch(b: int, h: int, w: int, r: int, centered: bool) -> tuple[int, int, int]:
    """The LK C entries' (rs, tw, seg) for a (b, h, w) launch at radius
    ``r``: the walker's rows per step, strip columns and segment, or
    centered the tile's (rows, columns, rows)."""
    if centered:
        tile = _lk_tile_for(b, h, w, r)
        return tile.tile_h, tile.tile_w, tile.tile_h
    strip = lk_strip(r)
    return strip.rows_per_step, strip.strip_w, lk_segment(b, h, w, r)


def lk_cells(b: int, h: int, w: int, r: int, centered: bool) -> tuple[int, int]:
    """(source cells the launch stages, output cells it writes): their
    ratio is the kernel's halo factor."""
    rs, tw, seg = lk_launch(b, h, w, r, centered)
    cols = b * -(-w // tw)
    if centered:
        return cols * -(-h // seg) * (seg + 2 * r + 2) * (tw + 2 * r + 2), b * h * w
    strip = lk_strip(r)
    rows = sum(strip.steps(min(seg, h - y0), r) * rs + 2 for y0 in range(0, h, seg))
    return cols * strip.src_w * rows, b * h * w


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


TVL1_EXT = 64  # OF2_EXT: a TV-L1 tile block's side in cells, one block per SM
# The cluster (cx, cy) of TV-L1 tile blocks where clusters pay (swept on an
# H100 with tools/kernel_times.py --tvl1-clusters: PERF.md §6), and every
# shape the C entry has compiled in.
TVL1_CLUSTER = (1, 2)
TVL1_CLUSTERS = ((1, 1), (1, 2))
# Clusters pay where the plain grid runs more than this many waves of the
# card's SMs (one tile block per SM); on thinner grids the cluster's wider
# rows and its peer waits cost what the smaller ring saves.
TVL1_CLUSTER_WAVES = 4


def tvl1_grid(h: int, w: int, k: int, cluster: tuple[int, int] = (1, 1)) -> tuple[int, int]:
    """Clusters (rows, columns) of a TV-L1 tile launch of ``k`` iterations on
    an ``h`` x ``w`` band: each covers (64 cy) x (64 cx) cells and writes
    back its inner (64 cy - 2k) x (64 cx - 2k)."""
    cx, cy = cluster
    return -(-h // (TVL1_EXT * cy - 2 * k)), -(-w // (TVL1_EXT * cx - 2 * k))


def tvl1_cluster(b: int, h: int, w: int, k: int, sms: int) -> tuple[int, int]:
    """The cluster (cx, cy) of a TV-L1 tile launch of ``k`` iterations on a
    (b, h, w) batch: :data:`TVL1_CLUSTER` where the plain grid (b x its 1 x 1
    tiles) is more than :data:`TVL1_CLUSTER_WAVES` waves of the card's
    ``sms`` SMs, else (1, 1)."""
    ty, tx = tvl1_grid(h, w, k)
    return TVL1_CLUSTER if b * ty * tx > TVL1_CLUSTER_WAVES * sms else (1, 1)


def tvl1_slots(b: int, h: int, w: int, k: int, cluster: tuple[int, int]) -> float:
    """Cells a TV-L1 tile launch iterates per pixel (the ring's overhead)."""
    ty, tx = tvl1_grid(h, w, k, cluster)
    return ty * tx * cluster[0] * cluster[1] * TVL1_EXT * TVL1_EXT / (h * w)


def tvl1_block_writes(h: int, w: int, k: int, cluster: tuple[int, int]):
    """Each block of a TV-L1 tile launch (one batch entry), as the C entry
    lays them out: ``(by, bx, (y0, y1), (x0, x1), ring)`` with the band
    rows and columns it writes back (inside the band; y0 >= y1 or x0 >= x1:
    none) and its ring, the cells (top, bottom, left, right) of its tile
    that it iterates but does not write for staleness.  Block (bx, by) is
    tile (bx % cx, by % cy) of cluster (bx // cx, by // cy), whose region
    starts k cells before its output."""
    cx, cy = cluster
    gy, gx = tvl1_grid(h, w, k, cluster)
    ty, tx = TVL1_EXT * cy - 2 * k, TVL1_EXT * cx - 2 * k
    e = TVL1_EXT
    for by in range(gy * cy):
        ry = by % cy
        top = by // cy * ty - k + ry * e  # the tile's first band row
        r0, r1 = max(k - ry * e, 0), min(k + ty - ry * e, e)  # written tile rows
        for bx in range(gx * cx):
            rx = bx % cx
            left = bx // cx * tx - k + rx * e
            c0, c1 = max(k - rx * e, 0), min(k + tx - rx * e, e)
            yield (by, bx, (max(top + r0, 0), min(top + r1, h)),
                   (max(left + c0, 0), min(left + c1, w)), (r0, e - r1, c0, e - c1))
