"""Roofline share of DIS's inverse search: the LK tile in its centered mode
(#1c and #2c, ``csrc/of2_lk_tile.cuh`` with CENTERED true, both the
residual and the step instances) over a cold pair's solved levels: at the
coarsest one centered residual and ``iterations - 1`` centered steps, at
every finer solved level ``iterations`` centered steps."""

from flowbench.layers import config_view, least_ms, level_shapes, meta, roofline_pct

PATTERN = r"of2_lk_tile_kernel<\s*(true|false),\s*true"  # CENTERED = true, STEP either way


def least_ms_per_pair(config):
    cfg = config_view(config)
    solved = level_shapes(config)[cfg.finest_level:]
    residual = [((meta(solved[-1]), None, cfg), {"centered": True})]
    steps = []
    for k, (h, w) in enumerate(solved):
        n = cfg.iterations - 1 if k == len(solved) - 1 else cfg.iterations
        steps += [((meta((h, w)), None, None, cfg), {"centered": True})] * n
    return least_ms("lk_residual", residual) + least_ms("lk_level_step", steps)


def read(r):
    return roofline_pct(r, PATTERN, least_ms_per_pair(r.config))
