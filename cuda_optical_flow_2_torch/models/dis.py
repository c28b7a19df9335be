"""DIS-style dense inverse-search optical flow (Kroeger et al., ECCV 2016;
the algorithm behind OpenCV's ``DISOpticalFlow``).

Counterpart of ``cuda_optical_flow_2_tpu.models.dis``.  Per pyramid level:

* **Inverse search**: ``config.iterations`` Gauss-Newton steps whose normal
  equations are the LK ones with every window sum centered (the
  mean-normalized SSD that cancels additive illumination changes), at
  stride 1, so every pixel is its own patch and densification is the
  identity.  At the coarsest level without a seed the first step is a plain
  centered residual with no warp.
* **Variational refinement**: Jacobi relaxation of the total flow around the
  warp point (Horn-Schunck form, quadratic or Charbonnier), with the data
  term linearized at the applied flow and, under ``mean_normalize``,
  centered by its window mean (the ``it_offset`` plane).

``config.use_pallas`` (default True) routes the search steps through the
hand-written kernels ``kernels.lk_fused.lk_residual`` and
``kernels.lk_step_fused.lk_level_step`` in their ``centered`` mode, the
refinement warp through ``kernels.warp_select`` and its relaxation through
``kernels.hs_sweep.hs_relax`` with ``it_offset``; for CPU tensors those
wrappers take their plain versions.  ``use_pallas=False`` is the plain
composition, the JAX package's XLA twin; a window past the LK kernels'
limit (``lk_fused.supported``) takes it for the search steps, decided from
the config.  ``fused_half_upsample`` lets each level's first search step
take the coarser flow and upsample it in the kernel (``flow_half``, the same
flow bit for bit).  Images (..., H, W), flows (..., H, W, 2).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from cuda_optical_flow_2_torch.config import BilateralConfig, LKConfig
from cuda_optical_flow_2_torch.constants import MASKS
from cuda_optical_flow_2_torch.kernels import hs_sweep, lk_fused, lk_step_fused, warp_select
from cuda_optical_flow_2_torch.models.lucas_kanade import (
    _fused_half_upsample,
    _validate,
    preprocess,
)
from cuda_optical_flow_2_torch.ops.clip import clip
from cuda_optical_flow_2_torch.ops.conv import stencil2d
from cuda_optical_flow_2_torch.ops.gradients import SOBEL_GAIN
from cuda_optical_flow_2_torch.ops.resize import upsample_flow
from cuda_optical_flow_2_torch.ops.warp import warp_bilinear
from cuda_optical_flow_2_torch.ops.window import window_sum

__all__ = [
    "DISConfig",
    "DIS_REALTIME",
    "dis_level",
    "dis_preprocess",
    "dis_coarse_to_fine",
    "pyramidal_dis",
]


@dataclasses.dataclass(frozen=True)
class DISConfig:
    """DIS-style flow configuration: the JAX package's fields and defaults.

    Attributes:
      levels: pyramid depth.
      finest_level: stop the solve at this pyramid level and bilinearly
        upsample the rest of the way (0 = solve at full resolution).
      iterations: inverse-search (Gauss-Newton) steps per level.
      window: odd patch side for the mean-normalized window sums.
      mean_normalize: subtract per-window means from the data term (False:
        plain iterated LK with a direct frame difference).
      refine_iterations: refinement Jacobi sweeps per level (0 disables).
      refine_alpha: refinement smoothness weight (as HSConfig.alpha).
      refine_penalty: "quadratic" or "charbonnier" (lagged diffusivity,
        weights refreshed every ``hs_sweep.MAX_SWEEPS`` sweeps).
      refine_eps_data, refine_eps_smooth: Charbonnier scales.
      temporal_kernel: "dt3" (default), "delta" or "gauss3".
      det_eps: |det| guard of the 2x2 solve (see LKConfig.det_eps).
      window_method: plain-path window-sum backend (see LKConfig).
      window_weights: "box", "tri" or "gauss" (see LKConfig).
      prefilter: optional joint-bilateral pre-smoothing, as in LKConfig.
      use_pallas: the hand-written kernel path (see the module docstring).
      max_displacement: warp budget in pixels.
      d_local, c_max: TPU select-warp bounds; validated, unused by the port.
      fused_half_upsample: upsample the coarser flow inside the first search
        step's kernel (see ``LKConfig.fused_half_upsample``).
    """

    levels: int = 5
    finest_level: int = 0
    iterations: int = 2
    window: int = 9
    mean_normalize: bool = True
    refine_iterations: int = 5
    refine_alpha: float = 20.0
    refine_penalty: str = "quadratic"
    refine_eps_data: float = 3.0
    refine_eps_smooth: float = 0.1
    temporal_kernel: str = "dt3"
    det_eps: float = 1e-8
    window_method: str = "sep_conv"
    window_weights: str = "box"
    prefilter: Optional[BilateralConfig] = None
    use_pallas: bool = True
    max_displacement: int = 32
    d_local: int = 7
    c_max: int = 1
    fused_half_upsample: bool = False

    def __post_init__(self) -> None:
        if self.levels < 1:
            raise ValueError(f"levels must be >= 1, got {self.levels}")
        if not 0 <= self.finest_level < self.levels:
            raise ValueError(
                f"finest_level must be in [0, levels); got "
                f"{self.finest_level} with levels={self.levels}"
            )
        if self.iterations < 1:
            raise ValueError(f"iterations must be >= 1, got {self.iterations}")
        if self.window % 2 != 1 or self.window < 3:
            raise ValueError(f"window must be odd >= 3, got {self.window}")
        if self.refine_iterations < 0:
            raise ValueError(f"refine_iterations must be >= 0, got {self.refine_iterations}")
        if self.refine_alpha <= 0:
            raise ValueError(f"refine_alpha must be > 0, got {self.refine_alpha}")
        if self.refine_penalty not in ("quadratic", "charbonnier"):
            raise ValueError(f"unknown refine_penalty {self.refine_penalty!r}")
        if self.refine_eps_data <= 0:
            raise ValueError(f"refine_eps_data must be > 0, got {self.refine_eps_data}")
        if self.refine_eps_smooth <= 0:
            raise ValueError(f"refine_eps_smooth must be > 0, got {self.refine_eps_smooth}")
        if self.temporal_kernel not in ("delta", "dt3", "gauss3"):
            raise ValueError(f"unknown temporal_kernel {self.temporal_kernel!r}")
        if self.window_weights not in ("box", "tri", "gauss"):
            raise ValueError(f"unknown window_weights {self.window_weights!r}")
        if self.c_max < 0:
            raise ValueError(f"c_max must be >= 0, got {self.c_max}")
        if self.d_local < 1:
            raise ValueError(f"d_local must be >= 1, got {self.d_local}")


def _lk_like(config: DISConfig) -> LKConfig:
    """LKConfig view of a DISConfig: the inverse-search step runs the LK
    kernels themselves, so the solve knobs (window, temporal kernel, det
    guard, window method and weights) carry over with the preprocess and
    warp knobs."""
    return LKConfig(
        levels=config.levels,
        window=config.window,
        iterations=1,
        temporal_kernel=config.temporal_kernel,
        warp_mode="bilinear",
        det_eps=config.det_eps,
        window_method=config.window_method,
        window_weights=config.window_weights,
        normalize_gradients=True,
        max_displacement=config.max_displacement,
        prefilter=config.prefilter,
        use_pallas=config.use_pallas,
        d_local=config.d_local,
        c_max=config.c_max,
        fused_half_upsample=config.fused_half_upsample,
    )


def _dis_residual_xla(prev: torch.Tensor, warped: torch.Tensor, config: DISConfig) -> torch.Tensor:
    """Mean-normalized GN step between prev and the (already warped) next:
    the plain composition."""
    return lk_fused.lk_residual_plain(prev, warped, _lk_like(config), config.mean_normalize)


def _kernels(config: DISConfig) -> bool:
    """The centered LK kernels' dispatch, from the config alone:
    ``use_pallas`` and a window they take (``lk_fused.supported``)."""
    return config.use_pallas and lk_fused.supported(_lk_like(config))


def _dis_residual(prev: torch.Tensor, warped: torch.Tensor, config: DISConfig) -> torch.Tensor:
    if _kernels(config):
        return lk_fused.lk_residual(prev, warped, _lk_like(config), config.mean_normalize)
    return _dis_residual_xla(prev, warped, config)


def _robust_eps(config: DISConfig) -> tuple[float, float] | None:
    """(eps_data, eps_smooth) for the Charbonnier penalty, else None."""
    if config.refine_penalty != "charbonnier":
        return None
    return (config.refine_eps_data, config.refine_eps_smooth)


def _refine(
    prev: torch.Tensor, nxt: torch.Tensor, flow: torch.Tensor, config: DISConfig
) -> torch.Tensor:
    """Variational refinement: relax the TOTAL flow around the warp point w0.

    The data term is ``ix u + iy v + it_off`` with ``it_off = -(ix u0 + iy
    v0)`` and, under ``mean_normalize``, minus the window mean of the warped
    temporal difference (cumsum window, as the JAX package).  The flow is
    clamped first on every backend, so u0 is the flow the warp applied.
    """
    d = float(config.max_displacement)
    flow = clip(flow, -d, d)
    if config.use_pallas:
        warped = warp_select.warp_bilinear_select(nxt, flow, config.max_displacement)
    else:
        warped = warp_bilinear(nxt, flow)
    sscale = 1.0 / SOBEL_GAIN
    ix = stencil2d(prev, MASKS["sobel_x"] * sscale)
    iy = stencil2d(prev, MASKS["sobel_y"] * sscale)
    off = -(ix * flow[..., 0] + iy * flow[..., 1])
    if config.mean_normalize:
        tmask = MASKS[config.temporal_kernel]
        it_w = stencil2d(warped - prev, tmask / tmask.sum())
        counts = window_sum(torch.ones_like(it_w), config.window, "cumsum")
        off = off - window_sum(it_w, config.window, "cumsum") / clip(counts, 1.0)
    relax = hs_sweep.hs_relax if config.use_pallas else hs_sweep.hs_relax_plain
    return relax(
        prev, warped, flow, iterations=config.refine_iterations, alpha=config.refine_alpha,
        temporal_kernel=config.temporal_kernel, it_offset=off, robust=_robust_eps(config),
    )


def dis_level(
    prev: torch.Tensor,
    nxt: torch.Tensor,
    flow_init: torch.Tensor | None,
    config: DISConfig,
    flow_init_half: bool = False,
) -> torch.Tensor:
    """One pyramid level: inverse-search GN steps + variational refinement.
    ``flow_init`` is the level-resolution seed (None at a cold coarsest
    level), or with ``flow_init_half`` the coarser level's flow, which the
    first kernel step upsamples itself (as ``lucas_kanade.lk_level``)."""
    lk_like = _lk_like(config)
    flow = flow_init
    if flow_init_half and not _kernels(config):
        flow = upsample_flow(flow, tuple(prev.shape[-2:]))
    for it in range(config.iterations):
        if flow is None:
            # Coarsest start: zero displacement, so the "warped" frame is
            # the frame itself: one plain centered residual step.
            flow = _dis_residual(prev, nxt, config)
        elif _kernels(config):
            flow = lk_step_fused.lk_level_step(
                prev, nxt, flow, lk_like, config.mean_normalize,
                flow_half=flow_init_half and it == 0,
            )
        else:
            flow = flow + _dis_residual_xla(prev, warp_bilinear(nxt, flow), config)
    if config.refine_iterations > 0:
        flow = _refine(prev, nxt, flow, config)
    return flow


def dis_preprocess(frame: torch.Tensor, config: DISConfig) -> list[torch.Tensor]:
    """Frame -> (optionally bilateral-filtered) Gaussian pyramid (shared with LK)."""
    return preprocess(frame, _lk_like(config))


def dis_coarse_to_fine(
    prev_pyr: list[torch.Tensor],
    next_pyr: list[torch.Tensor],
    config: DISConfig,
    init_flow: torch.Tensor | None = None,
) -> torch.Tensor:
    """Coarse-to-fine DIS over prebuilt pyramids; returns the finest flow.

    Levels below ``config.finest_level`` are never solved: the flow is
    bilinearly upsampled the rest of the way.  ``init_flow`` (coarsest-level
    resolution and units) warm-starts the coarsest level.
    """
    flow = init_flow
    lk_like = _lk_like(config)
    for k in range(config.levels - 1, config.finest_level - 1, -1):
        half = False
        if flow is not None:
            half = _fused_half_upsample(prev_pyr[k], flow, lk_like)
            if not half:
                flow = upsample_flow(flow, tuple(prev_pyr[k].shape[-2:]))
        flow = dis_level(prev_pyr[k], next_pyr[k], flow, config, flow_init_half=half)
    if config.finest_level > 0:
        flow = upsample_flow(flow, tuple(prev_pyr[0].shape[-2:]))
    return flow


def pyramidal_dis(prev: torch.Tensor, nxt: torch.Tensor, config: DISConfig) -> torch.Tensor:
    """Dense DIS-style flow (..., H, W, 2) from a frame pair.

    Both frames' pyramids are built in one stacked pass; the flow comes back
    on the frames' device.
    """
    _validate(prev, nxt, config)
    both = dis_preprocess(torch.stack([prev, nxt]).to(torch.float32), config)
    return dis_coarse_to_fine([lvl[0] for lvl in both], [lvl[1] for lvl in both], config)


# Realtime serving preset: skip the full-resolution solve (finest_level=1)
# like OpenCV's fast presets.
DIS_REALTIME = DISConfig(levels=5, finest_level=1)
