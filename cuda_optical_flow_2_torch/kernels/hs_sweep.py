"""Horn-Schunck relaxation kernel: every Jacobi sweep of one level on the card.

Replaces ``cuda_optical_flow_2_tpu/kernels/hs_sweep.py``: the whole-image
``hs_relax`` (quadratic and Charbonnier, with ``it_offset``) and the
spatial-TP band entry ``hs_relax_band``.  CUDA source: ``csrc/hs_sweep.cu``.
It computes, from ``Ix, Iy`` = Sobel / 8 of ``prev`` and
``It = tmask (x) (nxt - prev)`` (+ ``it_offset``), zero padding throughout:

* quadratic: ``iterations`` sweeps of
  ``u <- u_bar - Ix (Ix u_bar + Iy v_bar + It) / (alpha^2 + Ix^2 + Iy^2)``
  (and v alike), with ``u_bar`` the HS neighbour average;
* Charbonnier (``robust = (eps_data, eps_smooth)``): the sweeps in chunks of
  ``MAX_SWEEPS``; each chunk recomputes the lagged data and smoothness
  weights from its incoming flow and freezes them for its sweeps, so the
  chunk length is part of the result, as in the JAX kernel.

What bounds it on an H100: with the whole relaxation counted once, FP32
operations (about 27 per pixel per quadratic sweep, 56 per Charbonnier
sweep, against 16-28 bytes of frames and flow per pixel for the whole
call).  The design is time tiling, the TPU kernel's K sweeps per resident
band carried over to 64 x 64 tiles in shared memory: one launch runs up
to ``SWEEPS_PER_LAUNCH`` (K) sweeps on each tile with the flow
double-buffered there (and, Charbonnier, the chunk's smoothness weights)
and each pixel's constants in the registers of the thread that owns it,
and writes back only the tile's inner (64 - 2R)^2 pixels.  A sweep reads
the eight neighbours, so a ring of ``ring(k)`` = k cells keeps them exact.
One launch computes the gradients (and the quadratic denominators); then
quadratic, a call of n sweeps runs in ceil(n / K) tile launches;
Charbonnier, each ``MAX_SWEEPS`` chunk runs two launches of weights and
normalizers, then its ceil(16 / K) tile launches.  So the flow makes one
pass over device memory per tile launch, not per sweep.
The C entry point issues every launch of the call, so the wrapper makes
one ctypes call per level.

The band entry runs one chunk of at most ``MAX_SWEEPS`` sweeps on a band
holding global rows [row0, row0 + HB) of an ``h_global``-row image: the
gradients and the flow are zero outside the global image on every sweep
(the whole image's zero padding), so with a caller halo of sweeps + 2 rows
the kept rows match the whole-image relaxation.  The whole-image entry is
the band ``(0, H)``.

:func:`hs_relax` and :func:`hs_relax_band` launch the kernels for CUDA
tensors and take their plain versions for CPU tensors; ``.launches`` on each
counts calls that launched (one per call, whatever its sweep count).
"""

from __future__ import annotations

import numpy as np
import torch

from cuda_optical_flow_2_torch.constants import MASKS
from cuda_optical_flow_2_torch.kernels import _build
from cuda_optical_flow_2_torch.kernels.lk_fused import planes
from cuda_optical_flow_2_torch.ops.band import rows_in_image
from cuda_optical_flow_2_torch.ops.gradients import (
    sobel_scale,
    spatial_gradients,
    temporal_gradient,
    temporal_mask,
)

__all__ = [
    "hs_relax",
    "hs_relax_band",
    "hs_relax_band_plain",
    "hs_relax_plain",
    "MAX_SWEEPS",
    "SWEEPS_PER_LAUNCH",
    "ring",
]

# Sweeps per Charbonnier chunk: the lagged weights are refreshed this often
# (the JAX kernel's time-tiling depth, which fixes the IRLS cadence).
MAX_SWEEPS = 16

# K: sweeps per launch (each on 64 x 64 tiles with a ring of K cells); the
# result does not depend on it.
SWEEPS_PER_LAUNCH = 8


def ring(k: int) -> int:
    """The tile ring, in cells, of a launch of ``k`` sweeps: the kernel
    writes back the pixels at least this far from its tile's edge (the
    gradients and the Charbonnier weights come whole from their own
    launches)."""
    return k


def _identity(prev: torch.Tensor, flow_init: torch.Tensor | None) -> torch.Tensor:
    """Zero sweeps: the initial flow (zeros without one), float32."""
    if flow_init is not None:
        return flow_init.to(torch.float32)
    return torch.zeros(prev.shape + (2,), dtype=torch.float32, device=prev.device)


def hs_relax_plain(
    prev: torch.Tensor,
    nxt: torch.Tensor,
    flow_init: torch.Tensor | None,
    *,
    iterations: int,
    alpha: float,
    temporal_kernel: str,
    it_offset: torch.Tensor | None = None,
    robust: tuple[float, float] | None = None,
) -> torch.Tensor:
    """The plain PyTorch version: the ops gradients and the relaxation loops
    of ``models.horn_schunck`` (the JAX package's XLA twin)."""
    from cuda_optical_flow_2_torch.models import horn_schunck as hs

    if iterations <= 0:
        return _identity(prev, flow_init)
    ix, iy, it = _gradients(prev, nxt, temporal_kernel, it_offset)
    uv = _identity(prev, flow_init)
    if robust is not None:
        return hs._robust_relax_xla(uv, ix, iy, it, iterations, alpha, robust)
    return hs._quadratic_relax(uv, ix, iy, it, iterations, alpha)


def hs_relax_band_plain(
    prev: torch.Tensor,
    nxt: torch.Tensor,
    flow_init: torch.Tensor | None,
    row0: int,
    h_global: int,
    *,
    sweeps: int,
    alpha: float,
    temporal_kernel: str,
    it_offset: torch.Tensor | None = None,
    robust: tuple[float, float] | None = None,
) -> torch.Tensor:
    """The plain PyTorch version of the band entry: one chunk of the plain
    relaxation with the gradients, the initial flow and every sweep's flow
    (and the Charbonnier smoothness weight) zero outside the global image."""
    from cuda_optical_flow_2_torch.models import horn_schunck as hs

    _check_chunk(sweeps)
    if sweeps <= 0:
        return _identity(prev, flow_init)
    keep = rows_in_image(prev.shape[-2], row0, h_global, prev.device)
    ix, iy, it = (
        torch.where(keep, g, 0.0) for g in _gradients(prev, nxt, temporal_kernel, it_offset)
    )
    uv = torch.where(keep[..., None], _identity(prev, flow_init), 0.0)
    if robust is not None:
        return hs._robust_chunk(uv, ix, iy, it, sweeps, alpha, robust, keep)
    return hs._quadratic_relax(uv, ix, iy, it, sweeps, alpha, keep)


def _gradients(prev, nxt, temporal_kernel, it_offset):
    """Ix, Iy (Sobel / 8) and It (+ ``it_offset``), zero-padded."""
    ix, iy = spatial_gradients(prev, normalize=True)
    it = temporal_gradient(prev, nxt, temporal_kernel, normalize=True)
    if it_offset is not None:
        it = it + it_offset.to(torch.float32)
    return ix, iy, it


def _check_chunk(sweeps: int) -> None:
    if sweeps > MAX_SWEEPS:
        raise ValueError(f"hs_relax_band runs one chunk: sweeps={sweeps} > {MAX_SWEEPS}")


def _masks(temporal_kernel: str) -> np.ndarray:
    """The 27 floats of the C entry point: Sobel-x/8, Sobel-y/8, temporal."""
    scale = sobel_scale(True)
    return np.concatenate(
        [
            (MASKS["sobel_x"] * scale).ravel(),
            (MASKS["sobel_y"] * scale).ravel(),
            temporal_mask(temporal_kernel, True).ravel(),
        ]
    ).astype(np.float32)


def hs_relax(
    prev: torch.Tensor,
    nxt: torch.Tensor,
    flow_init: torch.Tensor | None,
    *,
    iterations: int,
    alpha: float,
    temporal_kernel: str,
    it_offset: torch.Tensor | None = None,
    robust: tuple[float, float] | None = None,
) -> torch.Tensor:
    """``iterations`` Jacobi sweeps of Horn-Schunck on (..., H, W) frames,
    from ``flow_init`` (..., H, W, 2) or zeros; returns (..., H, W, 2) float32.

    ``it_offset`` (..., H, W) is added to the temporal gradient (the
    linearization term when relaxing a total flow around a warp point);
    ``robust = (eps_data, eps_smooth)`` selects the Charbonnier penalty.
    """
    tensors = [t for t in (prev, nxt, flow_init, it_offset) if t is not None]
    if all(t.device.type == "cpu" for t in tensors):
        return hs_relax_plain(
            prev, nxt, flow_init, iterations=iterations, alpha=alpha,
            temporal_kernel=temporal_kernel, it_offset=it_offset, robust=robust,
        )
    out = _launch(prev, nxt, flow_init, it_offset, iterations, alpha, temporal_kernel, robust,
                  0, prev.shape[-2])
    hs_relax.launches += int(iterations > 0)  # zero sweeps launch nothing
    return out


def hs_relax_band(
    prev: torch.Tensor,
    nxt: torch.Tensor,
    flow_init: torch.Tensor | None,
    row0: int,
    h_global: int,
    *,
    sweeps: int,
    alpha: float,
    temporal_kernel: str,
    it_offset: torch.Tensor | None = None,
    robust: tuple[float, float] | None = None,
) -> torch.Tensor:
    """ONE chunk of ``sweeps`` (<= ``MAX_SWEEPS``) Jacobi sweeps on a row
    band holding global rows [row0, row0 + HB) of an ``h_global``-row image
    (the spatial-TP entry, ``parallel/spatial_models.py``).

    With a caller halo of ``sweeps + 2`` real rows (the gradient ring and
    one row of band-edge staleness per sweep) the kept rows match
    :func:`hs_relax` on the whole image; band-edge rows are for the caller
    to crop.  Chunking across exchanges is the caller's: each chunk needs
    fresh neighbour rows.  Under ``robust`` the chunk is the IRLS cadence.
    """
    _check_chunk(sweeps)
    tensors = [t for t in (prev, nxt, flow_init, it_offset) if t is not None]
    if all(t.device.type == "cpu" for t in tensors):
        return hs_relax_band_plain(
            prev, nxt, flow_init, row0, h_global, sweeps=sweeps, alpha=alpha,
            temporal_kernel=temporal_kernel, it_offset=it_offset, robust=robust,
        )
    out = _launch(prev, nxt, flow_init, it_offset, sweeps, alpha, temporal_kernel, robust,
                  row0, h_global)
    hs_relax_band.launches += int(sweeps > 0)  # zero sweeps launch nothing
    return out


def _launch(prev, nxt, flow_init, it_offset, iterations, alpha, temporal_kernel, robust, row0,
            h_global) -> torch.Tensor:
    tensors = [t for t in (prev, nxt, flow_init, it_offset) if t is not None]
    dev = _build.require_cuda(*tensors)
    lead, (h, w) = prev.shape[:-2], prev.shape[-2:]
    if (
        nxt.shape != prev.shape
        or (flow_init is not None and flow_init.shape != prev.shape + (2,))
        or (it_offset is not None and it_offset.shape != prev.shape)
    ):
        raise ValueError(
            f"shapes prev {tuple(prev.shape)}, next {tuple(nxt.shape)}, flow_init "
            f"{None if flow_init is None else tuple(flow_init.shape)}, it_offset "
            f"{None if it_offset is None else tuple(it_offset.shape)}: want (..., H, W), "
            "(..., H, W, 2)"
        )
    if iterations <= 0:
        return _identity(prev, flow_init)
    p, n = planes(prev.reshape(-1, h, w), nxt.reshape(-1, h, w))
    b = p.shape[0]
    off = None if it_offset is None else planes(it_offset.reshape(-1, h, w))[0]
    f0 = None if flow_init is None else planes(flow_init.reshape(-1, h, w, 2))[0]
    out = torch.empty((b, h, w, 2), dtype=torch.float32, device=dev)
    n_px = b * h * w
    n2 = n_px + (n_px & 1)  # keeps the float4 scratch planes 16-byte aligned
    scratch = torch.empty((14 if robust else 8) * n2, dtype=torch.float32, device=dev)
    ed, es = robust if robust is not None else (1.0, 1.0)
    masks = _masks(temporal_kernel)
    _build.launch(
        dev, "of2_hs_relax", p.data_ptr(), n.data_ptr(),
        None if off is None else off.data_ptr(), None if f0 is None else f0.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), b, h, w, int(row0), int(h_global), int(iterations),
        MAX_SWEEPS, SWEEPS_PER_LAUNCH, float(alpha * alpha), masks.ctypes.data,
        int(robust is not None), float(ed), float(ed * ed), float(es), float(es * es),
    )
    return out.reshape(lead + (h, w, 2))


hs_relax.launches = 0
hs_relax_band.launches = 0
