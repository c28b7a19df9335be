"""Roofline share of the LK level step (#2, ``csrc/lk_step_fused.cu``) in a
warm serving step: the seed from the previous flow makes every level,
the coarsest too, run ``iterations`` steps."""

from flowbench.layers import config_view, least_ms, level_shapes, meta, roofline_pct

PATTERN = r"of2_lk_tile_kernel<true"  # STEP = true: the level step, not the residual


def least_ms_per_pair(config):
    cfg = config_view(config)
    calls = [((meta(s), None, None, cfg), {}) for s in level_shapes(config)] * cfg.iterations
    return least_ms("lk_level_step", calls)


def read(r):
    return roofline_pct(r, PATTERN, least_ms_per_pair(r.config))
