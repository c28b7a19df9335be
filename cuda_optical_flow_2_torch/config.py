"""Framework configuration (numpy/stdlib only).

A copy of ``cuda_optical_flow_2_tpu.config``: the same dataclasses, fields,
defaults, validation and operating points.  It is copied rather than imported
because importing anything under ``cuda_optical_flow_2_tpu`` loads jax, which
the PyTorch port must not need.  ``tests/test_torch_ops.py`` holds the two
equal.

Fields whose meaning is specific to the TPU kernels keep their names so a
config crosses between the packages unchanged (``interop.lk_config_from_jax``):

* ``use_pallas`` selects the hand-written kernel path (``True``: the kernels'
  semantics, budget clamp to ``max_displacement`` and accumulation on the
  clamped flow) or the plain ops composition (``False``: no clamp), as it
  selects the Pallas kernels or the XLA twin in the JAX package.
* ``d_local`` and ``c_max`` bound the TPU select-loop warp.  The port's warp
  is a direct gather and has no such bound; they are validated and ignored.
* ``fused_half_upsample`` moves the JAX package's 2x flow upsample into its
  level kernel.  The port accepts and ignores it: every coarse-to-fine
  handoff is a pass of its own (``kernels.upsample_flow.handoff``, on the
  kernel path the standalone upsample kernel, which on an H100 is faster
  than a step that upsamples at each flow read), so the flow and the route
  are the same either way.
* ``window_method`` changes only the float summation order; the kernels
  ignore it as the Pallas kernels do.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["BilateralConfig", "LKConfig", "REFERENCE_GPU", "REFERENCE_CPU", "PAPER_1080P"]


@dataclasses.dataclass(frozen=True)
class BilateralConfig:
    """Joint-bilateral pre-filter parameters."""

    window: int = 9
    sigma_spatial: float = 2.0
    sigma_range: float = 10.0


@dataclasses.dataclass(frozen=True)
class LKConfig:
    """Pyramidal Lucas-Kanade configuration.

    Attributes:
      levels: pyramid depth (level k is the base image floor-halved k times).
      window: odd integration-window side for the structure-tensor sums.
      iterations: refinement iterations per level.
      temporal_kernel: "dt3" (unnormalized Dt_3x3), "gauss3" (binomial
        smoothing of both frames) or "delta" (direct frame difference).
      warp_mode: "bilinear" | "nearest" | "none" — coarse-to-fine backward warp.
      det_eps: |det| threshold below which the 2x2 solve returns (0, 0);
        0.0 divides by the raw determinant (inf/nan pass through).
      window_method: "sep_conv" | "cumsum" | "reduce_window": the plain ops'
        box-sum backend (float summation order only).
      window_weights: "box" (flat sum), "tri" (trapezoid: two iterated box
        sums) or "gauss" (truncated Gaussian, sigma = window/6).
      max_displacement: per-level warp displacement budget in pixels; the
        kernel path clamps flow to it before sampling.
      normalize_gradients: scale the derivative stencils to unit gain.
      prefilter: optional joint-bilateral pre-smoothing of the input frames
        (``REFERENCE_GPU`` sets the reference's 9x9 filter).
      use_pallas: take the hand-written kernel path (see module docstring).
      d_local, c_max: TPU select-warp bounds; validated, unused by the port.
      fused_half_upsample: the JAX package's in-kernel upsample; accepted
        and ignored by the port (see the module docstring).
    """

    levels: int = 4
    window: int = 19
    iterations: int = 1
    temporal_kernel: str = "dt3"
    warp_mode: str = "bilinear"
    det_eps: float = 1e-8
    window_method: str = "sep_conv"
    window_weights: str = "tri"
    normalize_gradients: bool = True
    max_displacement: int = 32
    prefilter: Optional[BilateralConfig] = None
    use_pallas: bool = True
    d_local: int = 7
    c_max: int = 1
    fused_half_upsample: bool = False

    def __post_init__(self) -> None:
        if self.c_max < 0:
            raise ValueError(f"c_max must be >= 0, got {self.c_max}")
        if self.window % 2 != 1:
            raise ValueError(f"window must be odd, got {self.window}")
        if self.levels < 1:
            raise ValueError(f"levels must be >= 1, got {self.levels}")
        if self.warp_mode not in ("bilinear", "nearest", "none"):
            raise ValueError(f"unknown warp_mode {self.warp_mode!r}")
        if self.d_local < 1:
            raise ValueError(f"d_local must be >= 1, got {self.d_local}")
        if self.iterations < 1:
            raise ValueError(f"iterations must be >= 1, got {self.iterations}")
        if self.temporal_kernel not in ("dt3", "gauss3", "delta"):
            raise ValueError(f"unknown temporal_kernel {self.temporal_kernel!r}")
        if self.window_method not in ("sep_conv", "cumsum", "reduce_window"):
            raise ValueError(f"unknown window_method {self.window_method!r}")
        if self.window_weights not in ("box", "tri", "gauss"):
            raise ValueError(f"unknown window_weights {self.window_weights!r}")


# The reference GPU operating point: bilateral pre-filter, 4 levels, 19x19
# window, raw (unnormalized) gradient gains, flat box window.
REFERENCE_GPU = LKConfig(
    levels=4,
    window=19,
    temporal_kernel="dt3",
    normalize_gradients=False,
    window_weights="box",
    prefilter=BilateralConfig(),
)

# The reference CPU twin operating point.
REFERENCE_CPU = LKConfig(
    levels=4, window=9, temporal_kernel="gauss3", normalize_gradients=False,
    window_weights="box",
)

# 5-level pyramidal LK, 15x15 window, 1080p.
PAPER_1080P = LKConfig(levels=5, window=15, temporal_kernel="dt3")
