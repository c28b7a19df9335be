"""The least time for a kernel's work on one H100: a frozen copy.

``work`` and ``bound`` are copied from the repository's ``chip_smoke.py``
(``work``, ``bound`` and the peaks above them), with the two numbers that
function read from the port inlined (the nonzero taps of each temporal mask,
and ``hs_sweep.MAX_SWEEPS``), so that a change to the program cannot move
the yardstick.  ``flowbench/tests`` holds the copy equal to the original at
sample shapes.  Bytes count each input read once and each output written
once; operations are the function's arithmetic on these inputs.

Peaks: NVIDIA's data sheet for the H100 SXM at 700 W: 3.35 TB/s of HBM and
67 TFLOP/s FP32 outside the tensor cores; special functions (divisions,
square roots, exp) at 16 per clock per SM, at the clock the FP32 peak
implies over 132 SMs x 128 lanes x 2 operations per FMA.  A shape argument
may be any object with ``numel()`` (a tensor on the ``meta`` device).
"""

from __future__ import annotations

import math

__all__ = ["FP32_OPS_PER_S", "HBM_BYTES_PER_S", "SFU_OPS_PER_S", "bound", "work"]

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
SFU_OPS_PER_S = 132 * 16 * FP32_OPS_PER_S / (132 * 128 * 2)

# nonzero taps of the port's temporal masks (constants.MASKS)
_TEMPORAL_TAPS = {"dt3": 9, "gauss3": 9, "delta": 1}
_HS_MAX_SWEEPS = 16  # kernels/hs_sweep.MAX_SWEEPS


def _taps_in_image(n: int, r: int, row0: int = 0, h_global: int | None = None) -> int:
    hg = n if h_global is None else h_global
    return sum(min(y + r, hg - 1) - max(y - r, 0) + 1
               for y in range(row0, row0 + n) if 0 <= y < hg)


def _gradient_ops(temporal_kernel: str) -> int:
    t = _TEMPORAL_TAPS[temporal_kernel]
    return 2 * 11 + 1 + (2 * t - 1)


def work(name: str, args, kw) -> tuple[float, float, float]:
    """(bytes, FP32 operations, special-function operations) that the call
    ``name(*args, **kw)`` must do."""
    if name in ("lk_residual", "lk_level_step", "lk_band_step"):
        prev, cfg = args[0], args[4 if name == "lk_band_step" else -1]
        px = prev.numel()
        centered = kw.get("centered", False)
        planes = 9 if centered else 5
        window = planes * 2 * (2 * cfg.window - 1)
        ops = _gradient_ops(cfg.temporal_kernel) + 5 + window + 12
        if centered:
            ops += 16
        sfu = float(px) if centered else 0.0
        if name == "lk_residual":
            return 16.0 * px, float(ops * px), sfu
        if kw.get("flow_half"):
            return 18.0 * px, float((ops + 23 + 20) * px), sfu
        return 24.0 * px, float((ops + 23) * px), sfu
    if name in ("tvl1_relax", "tvl1_relax_band"):
        px = args[0].numel()
        it = kw["iterations"]
        nbytes = (32.0 if name == "tvl1_relax" else 64.0) * px
        return nbytes, float((28 + 46 * it) * px), float(8 * it * px)
    if name in ("warp_bilinear_select", "warp_bilinear_select_band"):
        img = args[0]
        return 16.0 * img.numel(), 21.0 * img.numel(), 0.0
    if name == "pyr_down":
        x = args[0]
        out_px = x.numel() // x.shape[-1] // x.shape[-2] * (x.shape[-2] // 2) * (x.shape[-1] // 2)
        return 4.0 * x.numel() + 4.0 * out_px, 17.0 * out_px, 0.0
    if name in ("bilateral_kernel", "bilateral_kernel_band"):
        img = args[0]
        if name == "bilateral_kernel":
            window, guide, row0, hg = args[1], (args[4] if len(args) > 4 else None), 0, None
        else:
            window, guide, (row0, hg) = args[3], None, args[1:3]
        h, w = img.shape[-2:]
        r = window // 2
        planes = img.numel() // (h * w)
        cols = _taps_in_image(w, r)
        rows = max(0, min(row0 + h, h if hg is None else hg) - max(row0, 0))
        px = planes * rows * w
        taps = planes * _taps_in_image(h, r, row0, hg) * cols
        inner = planes * _taps_in_image(rows, r) * cols
        pairs = (inner - px) // 2 + (taps - inner)
        read = img.element_size() * img.numel() + (0 if guide is None else 4 * guide.numel())
        ops = 2 * pairs + 4 * (taps - px) + 3 * px + px
        return float(read + 4 * img.numel()), float(ops), float(pairs + px)
    if name == "poly_expansion_kernel":
        f, n = args[0], args[1]
        return 24.0 * f.numel(), float((18 * n + 60) * f.numel()), 0.0
    if name == "window_solve":
        px, window = args[0].numel(), args[5]
        return 28.0 * px, float((10 * (window - 1) + 12) * px), 0.0
    if name == "median_filter_kernel":
        return 8.0 * args[0].numel(), 0.0, 0.0
    if name in ("fb_level_step", "fb_band_step"):
        nxt = args[0]
        cfg, i_first = (args[3], 4) if name == "fb_level_step" else (args[4], 6)
        first = args[i_first] if len(args) > i_first else kw.get("first", False)
        px = nxt.numel()
        ops = (18 * cfg.poly_n + 60) + 32 + 10 * (cfg.winsize - 1) + 12 + (0 if first else 21)
        return (32.0 if first else 40.0) * px, float(ops * px), 0.0
    if name == "fill_occluded_flow_kernel":
        occ = args[1]
        it = args[2] if len(args) > 2 else kw.get("iterations", 96)
        px, n_occ = occ.numel(), int(occ.sum())
        return 17.0 * px, float(70 * px + 29 * it * n_occ), float(3 * px + 2 * it * n_occ)
    if name in ("hs_relax", "hs_relax_band"):
        prev, _nxt, flow_init = args[:3]
        px = prev.numel()
        ops = _gradient_ops(kw["temporal_kernel"])
        it = kw["iterations"] if name == "hs_relax" else kw["sweeps"]
        sfu = 0
        if kw.get("robust") is None:
            ops += 4 + 27 * it
        else:
            chunks = math.ceil(it / _HS_MAX_SWEEPS)
            ops += 49 * chunks + 56 * it
            sfu = 2 * chunks * px
        read = 8 * px + (0 if flow_init is None else 8 * px)
        if kw.get("it_offset") is not None:
            read += 4 * px
            ops += 1
        return float(read + 8 * px), float(ops * px), float(sfu)
    raise KeyError(name)


def bound(name: str, args, kw) -> tuple[float, str]:
    """(least ms for the work of ``name(*args, **kw)``, "bytes" or "operations")."""
    nbytes, ops, sfu = work(name, args, kw)
    t = {"bytes": nbytes / HBM_BYTES_PER_S,
         "operations": max(ops / FP32_OPS_PER_S, sfu / SFU_OPS_PER_S)}
    by = max(t, key=t.get)
    return t[by] * 1e3, by
