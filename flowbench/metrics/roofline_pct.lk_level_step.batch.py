"""Roofline share of the LK level step (#2, ``csrc/lk_step_fused.cu``) in a
cold pair: one step per iteration at each level but the coarsest, which
runs the residual first and ``iterations - 1`` steps."""

from flowbench.layers import config_view, least_ms, level_shapes, meta, roofline_pct

PATTERN = r"of2_lk_tile_kernel<true"  # STEP = true: the level step, not the residual


def least_ms_per_pair(config):
    cfg = config_view(config)
    shapes = level_shapes(config)
    calls = []
    for k, (h, w) in enumerate(shapes):
        n = cfg.iterations - 1 if k == len(shapes) - 1 else cfg.iterations
        calls += [((meta((h, w)), None, None, cfg), {})] * n
    return least_ms("lk_level_step", calls)


def read(r):
    return roofline_pct(r, PATTERN, least_ms_per_pair(r.config))
