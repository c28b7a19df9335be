"""Per-stage A/B debugging: run any pipeline stage through several backends
and diff the results.

Counterpart of ``cuda_optical_flow_2_tpu.utils.debug``: the productized form
of the reference's comment-swap workflow (main.cu keeps a commented-out CPU
twin next to every GPU call site, main.cu:199, 239, 248, 261).
:func:`stage_report` runs each stage of the selected model family through
the requested backends from IDENTICAL canonical inputs and reports
per-stage absolute differences (max and mean, as the JAX module, and the
median, p99 and p99.9).

Backends (the JAX module's names in brackets):

* ``"plain"``   (``"xla"``) — the plain PyTorch ops (``use_pallas=False``);
  the default comparison baseline.
* ``"kernel"``  (``"pallas"``) — the hand-written CUDA kernels.  It needs
  CUDA tensors and is refused on CPU tensors, where the kernels' wrappers
  would run the plain versions and the row would compare the plain ops
  with themselves.
* ``"banded"``  — the spatial-TP shard-local math, emulated in-process:
  rows are split into ``n_bands`` bands, each stage runs on a halo-extended
  band (halo rows sliced from the full array, zero filled at the global
  border, matching ``parallel.spatial.halo_exchange``), then cropped and
  concatenated.  Decomposes a sharded-vs-unsharded mismatch into the stage
  that introduces it without a mesh.
* ``"oracle"``  — the NumPy float twins (``oracle/gpu_reference``), where a
  twin of the stage exists (the Lucas-Kanade residual stages).
* ``"sharded"`` — the end-to-end flow only: spatial TP over a mesh that
  lists the inputs' device ``n_bands`` times, with the config as given (on a
  CUDA device its ``use_pallas`` runs the band kernels; compare it against
  the ``"kernel"`` baseline for the sharding's own error).

Stages that a backend cannot isolate (e.g. the gradients inside the fused
LK kernel) are skipped for that backend, not faked.

CLI: ``of2-torch-diff --model fb --size 256x64`` (``cli/diff.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

__all__ = ["StageDiff", "stage_report", "format_report", "stages_for", "banded"]

BACKENDS = ("plain", "kernel", "banded", "oracle", "sharded")


@dataclasses.dataclass(frozen=True)
class StageDiff:
    """One (stage, backend-vs-baseline) comparison at one pyramid level.

    Beside the JAX module's max and mean of |backend - baseline|, the
    median, p99 and p99.9 (linear interpolation, as ``np.percentile``): the
    statistics the kernels' limits against their plain versions are stated
    in."""

    level: int
    stage: str
    backend: str
    baseline: str
    max_abs: float
    mean_abs: float
    shape: tuple[int, ...]
    median_abs: float = 0.0
    p99_abs: float = 0.0
    p999_abs: float = 0.0

    def __str__(self) -> str:
        lvl = "E2E" if self.level < 0 else f"L{self.level}"
        return (
            f"{lvl:<3} {self.stage:<12} {self.backend:>7} vs "
            f"{self.baseline}: max {self.max_abs:.3e}  mean "
            f"{self.mean_abs:.3e}  {self.shape}"
        )


# ---------------------------------------------------------------------------
# Band emulation (the "banded" backend)
# ---------------------------------------------------------------------------


def _extend_band(x: torch.Tensor, lo: int, hi: int, halo: int, row_axis: int = -2):
    """Rows [lo-halo, hi+halo) of ``x``, zero-filling beyond the image like
    parallel.spatial.halo_exchange does at the mesh boundary (the banded
    warp's clamped-sampling semantics come from warp_bilinear_band's
    global-valid logic, not from the fill)."""
    ax = row_axis % x.ndim
    h = x.shape[ax]
    a, b = max(lo - halo, 0), min(hi + halo, h)
    pad_top, pad_bot = a - (lo - halo), (hi + halo) - b

    def zeros(n: int) -> torch.Tensor:
        shape = list(x.shape)
        shape[ax] = n
        return x.new_zeros(shape)

    parts = [x.narrow(ax, a, b - a)]
    if pad_top:
        parts.insert(0, zeros(pad_top))
    if pad_bot:
        parts.append(zeros(pad_bot))
    return torch.cat(parts, dim=ax) if len(parts) > 1 else parts[0]


def _band_bounds(h: int, n_bands: int) -> list[tuple[int, int]]:
    if h % n_bands:
        raise ValueError(f"{h} rows not divisible into {n_bands} bands")
    k = h // n_bands
    return [(i * k, (i + 1) * k) for i in range(n_bands)]


def banded(fn: Callable, halo: int, n_bands: int, row_axis: int = -2,
           out_row_axis: int | None = None):
    """Lift ``fn(*tensors) -> tensor|tuple`` to run band-by-band with halos.

    ``fn`` must be a stencil of radius <= ``halo`` rows: each output row
    depends only on input rows within ``halo``.  Then the banded result is
    exactly the sharded result (interior shards see neighbor rows; border
    shards see the boundary fill).  ``out_row_axis`` locates the row axis of
    the outputs when it differs from the inputs' (e.g. image -> flow adds a
    trailing component axis: row_axis=-2, out_row_axis=-3)."""
    oax = row_axis if out_row_axis is None else out_row_axis

    def run(*tensors):
        h = tensors[0].shape[row_axis]
        outs = None
        for lo, hi in _band_bounds(h, n_bands):
            res = fn(*(_extend_band(t, lo, hi, halo, row_axis) for t in tensors))
            tup = res if isinstance(res, tuple) else (res,)
            cropped = [r.narrow(oax, halo, r.shape[oax] - 2 * halo) for r in tup]
            if outs is None:
                outs = [[c] for c in cropped]
            else:
                for o, c in zip(outs, cropped):
                    o.append(c)
        cat = [torch.cat(o, dim=oax) for o in outs]
        return tuple(cat) if len(cat) > 1 else cat[0]

    return run


# ---------------------------------------------------------------------------
# Stage definitions
# ---------------------------------------------------------------------------


def _use_kernels(config, backend: str):
    return dataclasses.replace(config, use_pallas=backend == "kernel")


def _clamp(flow: torch.Tensor, config) -> torch.Tensor:
    d = float(config.max_displacement)
    return flow.clamp(-d, d)


def _make_warp_stage(nxt_l, clamped, config, n_bands):
    """Shared 'warp' stage runner (LK and FB use the identical stage): the
    bilinear warp of the next frame by the clamped flow."""

    def warp(backend):
        if backend == "plain":
            from cuda_optical_flow_2_torch.ops.warp import warp_bilinear

            return warp_bilinear(nxt_l, clamped)
        if backend == "kernel":
            from cuda_optical_flow_2_torch.kernels import warp_select

            return warp_select.warp_bilinear_select(
                nxt_l, clamped, max_displacement=config.max_displacement
            )
        if backend == "banded":
            from cuda_optical_flow_2_torch.ops.warp import warp_bilinear_band

            halo = int(np.ceil(config.max_displacement)) + 2
            h = nxt_l.shape[-2]
            outs = []
            for lo, hi in _band_bounds(h, n_bands):
                nb = _extend_band(nxt_l, lo, hi, halo)
                fb = _extend_band(clamped, lo, hi, 0, row_axis=-3)
                outs.append(warp_bilinear_band(nb, fb, lo - halo, lo, h))
            return torch.cat(outs, dim=-2)
        return None

    return warp


def _guarded_solve_np(sums, det_eps: float) -> np.ndarray:
    """NumPy float twin of ops/solve.solve_2x2 (guarded Cramer)."""
    g11, g22, g12, h1, h2 = (_np(s).astype(np.float32) for s in sums)
    det = g11 * g22 - g12 * g12
    if det_eps == 0.0:
        from cuda_optical_flow_2_torch.oracle.gpu_reference import inverse_matrix_float

        return inverse_matrix_float(g11, g22, g12, h1, h2)
    safe = np.abs(det) >= det_eps
    inv = np.where(safe, 1.0 / np.where(safe, det, 1.0), 0.0)
    u = (-g22 * h1 + g12 * h2) * inv
    v = (g12 * h1 - g11 * h2) * inv
    return np.stack([u, v], axis=-1).astype(np.float32)


def _lk_stages(prev_l, nxt_l, flow_in, config, n_bands):
    """Stage runners for Lucas-Kanade at one level.

    Canonical inputs: ``prev_l``/``nxt_l`` the level's pyramid images,
    ``flow_in`` the incoming (upsampled) flow.  ``nxt_w`` — the plain-warped
    next frame — feeds the residual stages so every backend sees identical
    inputs and differences localize to the stage under test."""
    from cuda_optical_flow_2_torch.constants import MASKS
    from cuda_optical_flow_2_torch.kernels import lk_fused
    from cuda_optical_flow_2_torch.models.lucas_kanade import lk_level, solve_flow
    from cuda_optical_flow_2_torch.ops.gradients import spatial_gradients, temporal_gradient
    from cuda_optical_flow_2_torch.ops.warp import warp_bilinear
    from cuda_optical_flow_2_torch.ops.window import structure_tensor_sums
    from cuda_optical_flow_2_torch.oracle import gpu_reference as gref

    r_grad = config.window // 2 + 2
    clamped = _clamp(flow_in, config)
    nxt_w = warp_bilinear(nxt_l, clamped)

    def _grads_of(p, nw):
        return spatial_gradients(p, config.normalize_gradients) + (
            temporal_gradient(p, nw, config.temporal_kernel, config.normalize_gradients),
        )

    ix, iy, it = _grads_of(prev_l, nxt_w)

    def grads(backend):
        if backend == "plain":
            return _grads_of(prev_l, nxt_w)
        if backend == "banded":
            return banded(_grads_of, 2, n_bands)(prev_l, nxt_w)
        if backend == "oracle":
            p = _np(prev_l).astype(np.float32)[..., None]
            d = (_np(nxt_w).astype(np.float32) - p[..., 0])[..., None]
            s = 1.0 / 8.0 if config.normalize_gradients else 1.0
            gx = gref.conv_3ch_1ch_float(p, MASKS["sobel_x"] * s)
            gy = gref.conv_3ch_1ch_float(p, MASKS["sobel_y"] * s)
            tm = MASKS[config.temporal_kernel]
            if config.normalize_gradients:
                tm = tm / tm.sum()
            gt = gref.conv_3ch_1ch_float(d, tm)
            return gx, gy, gt
        return None

    weights = config.window_weights

    def _sums_of(a, b, c):
        return structure_tensor_sums(a, b, c, config.window, config.window_method, weights)

    def window_sums(backend):
        if backend == "plain":
            return _sums_of(ix, iy, it)
        if backend == "banded":
            return banded(_sums_of, config.window // 2, n_bands)(ix, iy, it)
        if backend == "oracle":
            if weights != "box":
                # The reference's srm sums are inherently flat — there is no
                # oracle twin for a weighted window; skip the row rather
                # than compare mismatched computations.
                return None
            w = config.window
            gx, gy, gt = (_np(a).astype(np.float32) for a in (ix, iy, it))
            return tuple(
                gref.srm_1ch_float(a, b, w, w)
                for a, b in ((gx, gx), (gy, gy), (gx, gy), (gx, gt), (gy, gt))
            )
        return None

    sums = _sums_of(ix, iy, it)

    def solve(backend):
        if backend == "plain":
            return solve_flow(sums, config)
        if backend == "oracle":
            return _guarded_solve_np(sums, config.det_eps)
        return None

    warp = _make_warp_stage(nxt_l, clamped, config, n_bands)

    def residual(backend):
        if backend == "plain":
            return lk_fused.lk_residual_plain(prev_l, nxt_w, config)
        if backend == "kernel":
            # the same skip-not-crash contract as the other kernel rows
            if not lk_fused.supported(config):
                return None
            return lk_fused.lk_residual(prev_l, nxt_w, config)
        if backend == "banded":
            h = prev_l.shape[-2]
            outs = []
            for lo, hi in _band_bounds(h, n_bands):
                pb = _extend_band(prev_l, lo, hi, r_grad)
                nb = _extend_band(nxt_w, lo, hi, r_grad)
                res = lk_fused.lk_residual_plain(pb, nb, config, row0=lo - r_grad, h_global=h)
                outs.append(res[..., r_grad:-r_grad, :, :])
            return torch.cat(outs, dim=-3)
        return None

    def level(backend):
        if backend in ("plain", "kernel"):
            return lk_level(prev_l, nxt_l, flow_in, _use_kernels(config, backend))
        return None

    return {
        "gradients": grads,
        "window_sums": window_sums,
        "solve": solve,
        "warp": warp,
        "residual": residual,
        "level": level,
    }


def _fb_stages(prev_l, nxt_l, flow_in, config, n_bands):
    """Stage runners for Farnebäck (image-warp formulation) at one level."""
    from cuda_optical_flow_2_torch.kernels import poly_exp_fused, win_solve
    from cuda_optical_flow_2_torch.models.farneback import (
        _window_solve,
        fb_level_image,
        fb_normal_eq_products,
    )
    from cuda_optical_flow_2_torch.ops.poly_exp import poly_expansion
    from cuda_optical_flow_2_torch.ops.warp import warp_bilinear

    r_poly = config.poly_n // 2
    plain_cfg = dataclasses.replace(config, use_pallas=False)
    clamped = _clamp(flow_in, config)

    def _expand(f):
        return poly_expansion(f, config.poly_n, config.poly_sigma)

    exp1 = _expand(prev_l)
    w_exp = _expand(warp_bilinear(nxt_l, clamped))
    prods = fb_normal_eq_products(exp1, w_exp, clamped[..., 0], clamped[..., 1])

    def expand(backend):
        if backend == "plain":
            return _expand(prev_l)
        if backend == "kernel":
            if config.poly_n > poly_exp_fused.MAX_POLY_N:
                return None
            return poly_exp_fused.poly_expansion_kernel(prev_l, config.poly_n, config.poly_sigma)
        if backend == "banded":
            return banded(_expand, r_poly, n_bands)(prev_l)
        return None

    warp = _make_warp_stage(nxt_l, clamped, config, n_bands)

    def window_solve(backend):
        if backend == "plain":
            return _window_solve(prods, plain_cfg)
        if backend == "kernel":
            if config.gaussian_window or config.winsize > win_solve.MAX_WINDOW:
                return None
            return win_solve.window_solve(*prods, window=config.winsize, det_eps=config.det_eps)
        if backend == "banded":
            return banded(
                lambda *p: _window_solve(p, plain_cfg),
                config.winsize // 2,
                n_bands,
                out_row_axis=-3,
            )(*prods)
        return None

    def level(backend):
        if backend in ("plain", "kernel"):
            return fb_level_image(nxt_l, exp1, flow_in, _use_kernels(config, backend))
        return None

    return {
        "expand": expand,
        "warp": warp,
        "window_solve": window_solve,
        "level": level,
    }


def _hs_stages(prev_l, nxt_l, flow_in, config, n_bands):
    """Stage runners for Horn-Schunck at one level: the relaxation is
    isolated on the canonical warped pair (sweeps from zero flow)."""
    from cuda_optical_flow_2_torch.models.horn_schunck import hs_level
    from cuda_optical_flow_2_torch.ops.warp import warp_bilinear

    clamped = _clamp(flow_in, config)
    nxt_w = warp_bilinear(nxt_l, clamped)

    def sweeps(backend):
        if backend in ("plain", "kernel"):
            return hs_level(prev_l, nxt_w, None, _use_kernels(config, backend))
        return None

    def level(backend):
        if backend in ("plain", "kernel"):
            return clamped + hs_level(prev_l, nxt_w, None, _use_kernels(config, backend))
        return None

    return {"sweeps": sweeps, "level": level}


def _tvl1_stages(prev_l, nxt_l, flow_in, config, n_bands):
    """Stage runners for TV-L1 at one level (one linearization/warp)."""
    from cuda_optical_flow_2_torch.models.tvl1 import tvl1_level
    from cuda_optical_flow_2_torch.ops.warp import warp_bilinear

    clamped = _clamp(flow_in, config)
    warped = warp_bilinear(nxt_l, clamped)

    def sweeps(backend):
        if backend in ("plain", "kernel"):
            return tvl1_level(prev_l, warped, clamped, clamped, _use_kernels(config, backend))
        return None

    return {"sweeps": sweeps}


def _dis_stages(prev_l, nxt_l, flow_in, config, n_bands):
    """Stage runners for DIS at one level: the mean-normalized inverse
    search and the variational refinement are isolated on the canonical
    clamped/warped inputs."""
    from cuda_optical_flow_2_torch.models.dis import _refine, dis_level
    from cuda_optical_flow_2_torch.ops.warp import warp_bilinear

    clamped = _clamp(flow_in, config)
    warped = warp_bilinear(nxt_l, clamped)

    def search(backend):
        if backend in ("plain", "kernel"):
            cfg = dataclasses.replace(_use_kernels(config, backend), refine_iterations=0)
            return dis_level(prev_l, warped, None, cfg)
        return None

    def refine(backend):
        if backend in ("plain", "kernel"):
            return _refine(prev_l, nxt_l, clamped, _use_kernels(config, backend))
        return None

    def level(backend):
        if backend in ("plain", "kernel"):
            return dis_level(prev_l, nxt_l, flow_in, _use_kernels(config, backend))
        return None

    return {"search": search, "refine": refine, "level": level}


def _flow_runner(prev, nxt, config, n_shards):
    """Whole-pipeline stage ("flow"): unsharded plain/kernel + the
    ``sharded`` backend (spatial TP over ``n_shards`` shards of the inputs'
    device)."""
    from cuda_optical_flow_2_torch import parallel
    from cuda_optical_flow_2_torch.models import pyramidal_flow

    def run(backend):
        if backend in ("plain", "kernel"):
            return pyramidal_flow(prev, nxt, _use_kernels(config, backend))
        if backend == "sharded":
            if n_shards < 2:
                return None
            mesh = parallel.make_mesh(axis_name="space", devices=[prev.device] * n_shards)
            try:
                return parallel.spatial_pyramidal_flow(prev, nxt, config, mesh)
            except (ValueError, NotImplementedError):
                return None  # shape/config not shardable this way
        return None

    return run


def stages_for(config) -> Callable:
    """The stage-runner factory for a config's model family."""
    from cuda_optical_flow_2_torch.models.dis import DISConfig
    from cuda_optical_flow_2_torch.models.farneback import FBConfig
    from cuda_optical_flow_2_torch.models.horn_schunck import HSConfig
    from cuda_optical_flow_2_torch.models.tvl1 import TVL1Config

    if isinstance(config, FBConfig):
        return _fb_stages
    if isinstance(config, HSConfig):
        return _hs_stages
    if isinstance(config, TVL1Config):
        return _tvl1_stages
    if isinstance(config, DISConfig):
        return _dis_stages
    return _lk_stages


# ---------------------------------------------------------------------------
# Report
# ---------------------------------------------------------------------------


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _canonical_levels(prev, nxt, config):
    """Per-level canonical inputs from one unsharded plain run.

    Returns (prev_pyr, next_pyr, flow_in) with flow_in[k] the flow entering
    level k: zeros at the coarsest, else the upsampled result of running the
    family's own coarse-to-fine over the coarser levels."""
    from cuda_optical_flow_2_torch.models.streaming import _flow, _preprocess
    from cuda_optical_flow_2_torch.ops.resize import upsample_flow

    plain_cfg = dataclasses.replace(config, use_pallas=False)
    prev_pyr = _preprocess(prev, plain_cfg)
    next_pyr = _preprocess(nxt, plain_cfg)
    flow_in: dict[int, torch.Tensor] = {}
    top = config.levels - 1
    flow_in[top] = prev_pyr[top].new_zeros(tuple(prev_pyr[top].shape) + (2,))
    for k in range(top - 1, -1, -1):
        sub_cfg = dataclasses.replace(plain_cfg, levels=top - k)
        f = _flow(prev_pyr[k + 1 :], next_pyr[k + 1 :], sub_cfg)
        flow_in[k] = upsample_flow(f, tuple(prev_pyr[k].shape[-2:]))
    return prev_pyr, next_pyr, flow_in


def _diff(a, b) -> dict[str, float]:
    """Statistics of |a - b| over every element of every output, in float64
    on the device of the first tensor (a NaN on either side makes the max
    and the mean NaN)."""
    at = a if isinstance(a, tuple) else (a,)
    bt = b if isinstance(b, tuple) else (b,)
    if len(at) != len(bt):
        raise ValueError(
            f"backend returned {len(bt)} outputs, baseline {len(at)} — "
            f"refusing to silently compare a subset"
        )
    dev = next((t.device for t in (*at, *bt) if isinstance(t, torch.Tensor)), None)

    def f64(x) -> torch.Tensor:
        return torch.as_tensor(x, device=dev).to(torch.float64)

    d = torch.cat([(f64(x) - f64(y)).abs().flatten() for x, y in zip(at, bt)])
    srt = d.sort().values
    n = srt.numel()

    def q(p: float) -> float:
        pos = p * (n - 1)
        lo = int(pos)
        hi = min(lo + 1, n - 1)
        return float(srt[lo] + (srt[hi] - srt[lo]) * (pos - lo))

    return {
        "max_abs": float(d.max()), "mean_abs": float(d.mean()),
        "median_abs": q(0.5), "p99_abs": q(0.99), "p999_abs": q(0.999),
    }


def _as_frame(x, device) -> torch.Tensor:
    from cuda_optical_flow_2_torch.models.streaming import resolve_device

    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=resolve_device(device))


def stage_report(
    prev,
    nxt,
    config,
    *,
    backends: tuple[str, ...] = ("kernel", "banded"),
    baseline: str = "plain",
    levels: tuple[int, ...] | None = None,
    n_bands: int = 4,
    stages: tuple[str, ...] | None = None,
    device: torch.device | str | None = None,
) -> list[StageDiff]:
    """Run each stage through ``backends`` and diff against ``baseline``.

    ``prev``/``nxt``: a planar float frame pair; tensors keep their device,
    arrays go to ``device`` (default the CUDA device; pass ``"cpu"`` to run
    on the CPU).  Canonical per-level inputs (pyramid images and the
    incoming upsampled flow) come from one unsharded plain run, so every
    backend computes the SAME stage from the SAME data — differences
    localize to the stage, not to error accumulated upstream.  The level's
    rows must divide by ``n_bands`` for the banded backend; ``sharded``
    splits the rows into ``n_bands`` shards.
    """
    bad = [b for b in (*backends, baseline) if b not in BACKENDS]
    if bad:
        # A runner silently returns None for names it doesn't know, which
        # would yield an EMPTY report — e.g. `--backends plain,kernel` (one
        # comma-joined token) printing nothing and exiting 0.
        raise ValueError(f"unknown backend(s) {bad}; choose from {sorted(BACKENDS)}")

    prev = _as_frame(prev, device)
    nxt = _as_frame(nxt, prev.device)
    if "kernel" in (*backends, baseline) and prev.device.type != "cuda":
        raise ValueError(
            "the 'kernel' backend launches the CUDA kernels and needs CUDA tensors; on "
            f"{prev.device} their wrappers run the plain versions, which is the 'plain' "
            "backend"
        )
    prev_pyr, next_pyr, flow_in = _canonical_levels(prev, nxt, config)

    factory = stages_for(config)
    out: list[StageDiff] = []
    lvls = levels if levels is not None else tuple(range(config.levels))
    for k in lvls:
        runners = factory(prev_pyr[k], next_pyr[k], flow_in[k], config, n_bands)
        for name, run in runners.items():
            if stages is not None and name not in stages:
                continue
            base = run(baseline)
            if base is None:
                continue
            for backend in backends:
                got = run(backend)
                if got is None:
                    continue
                stats = _diff(base, got)
                first = base[0] if isinstance(base, tuple) else base
                out.append(StageDiff(k, name, backend, baseline, shape=tuple(first.shape),
                                     **stats))
    if stages is None or "flow" in stages:
        run = _flow_runner(prev, nxt, config, n_bands)
        base = run(baseline)
        if base is None:
            # Same skip contract as the per-stage loop: e.g. the "oracle"
            # baseline has no end-to-end flow runner.
            return out
        for backend in backends:
            got = run(backend)
            if got is None:
                continue
            out.append(StageDiff(-1, "flow", backend, baseline, shape=tuple(base.shape),
                                 **_diff(base, got)))
    return out


def format_report(report: list[StageDiff]) -> str:
    if not report:
        # Distinguish "nothing diffed" from a clean run: every row skipped
        # means the stage filter (or a baseline with no runner for any
        # stage) matched nothing.
        return "(no stages matched — check --stages / --baseline)"
    return "\n".join(str(r) for r in report)
