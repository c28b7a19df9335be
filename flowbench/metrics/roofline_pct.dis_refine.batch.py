"""Roofline share of DIS's variational refinement: the Horn-Schunck
relaxation (#6, ``csrc/hs_sweep.cu``: its gradient launch, and per
Charbonnier chunk its weight, coefficient and time-tiled launches) with
the ``it_offset`` plane, one call of ``refine_iterations`` sweeps at every
solved level.  The plain glue that makes the offset (Sobel, the warped
difference, the integral-image windows) is not in it: it is in
``ops_device_ms_per_pair.batch``."""

from flowbench.layers import config_view, least_ms, level_shapes, meta, roofline_pct

PATTERN = r"of2_hs_"


def least_ms_per_pair(config):
    cfg = config_view(config)
    robust = (cfg.refine_eps_data, cfg.refine_eps_smooth) \
        if cfg.refine_penalty == "charbonnier" else None
    calls = [((meta(s), meta(s), meta(s + (2,))),
              {"iterations": cfg.refine_iterations, "temporal_kernel": cfg.temporal_kernel,
               "robust": robust, "it_offset": meta(s)})
             for s in level_shapes(config)[cfg.finest_level:]]
    return least_ms("hs_relax", calls)


def read(r):
    return roofline_pct(r, PATTERN, least_ms_per_pair(r.config))
