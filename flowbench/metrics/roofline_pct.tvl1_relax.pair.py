"""Roofline share of the TV-L1 relaxation (#7, ``csrc/tvl1_sweep.cu``: its
constants launch and its time-tiled launches): ``warps`` calls of
``iterations`` primal-dual iterations at every level."""

from flowbench.layers import config_view, least_ms, level_shapes, meta, roofline_pct

PATTERN = r"of2_tvl1_(const|tile)"


def least_ms_per_pair(config):
    cfg = config_view(config)
    calls = [((meta(s),), {"iterations": cfg.iterations}) for s in level_shapes(config)]
    return least_ms("tvl1_relax", calls * cfg.warps)


def read(r):
    return roofline_pct(r, PATTERN, least_ms_per_pair(r.config))
