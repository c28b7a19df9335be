"""Horn-Schunck dense optical flow: the global variational family.

Counterpart of ``cuda_optical_flow_2_tpu.models.horn_schunck``.  The Jacobi
relaxation

    u <- u_bar - Ix (Ix u_bar + Iy v_bar + It) / (alpha^2 + Ix^2 + Iy^2)
    v <- v_bar - Iy (Ix u_bar + Iy v_bar + It) / (alpha^2 + Ix^2 + Iy^2)

runs ``config.iterations`` sweeps per pyramid level.  ``config.use_pallas``
(default True) routes each level through the hand-written kernel
``kernels.hs_sweep.hs_relax`` and each coarse-to-fine warp through
``kernels.warp_select`` (budget clamp to ``max_displacement``, accumulation
on the clamped flow); for CPU tensors those wrappers take their plain
versions.  ``use_pallas=False`` is the plain composition (this module's
loops and ``ops.warp.warp_bilinear``), the JAX package's XLA twin.  The
pyramid and the optional bilateral prefilter are the LK pipeline's
(``models.lucas_kanade.preprocess``).  Images (..., H, W), flows
(..., H, W, 2).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from cuda_optical_flow_2_torch.capture import captured
from cuda_optical_flow_2_torch.config import BilateralConfig, LKConfig
from cuda_optical_flow_2_torch.kernels import hs_sweep, upsample_flow, warp_select
from cuda_optical_flow_2_torch.models.lucas_kanade import preprocess
from cuda_optical_flow_2_torch.ops.clip import clip
from cuda_optical_flow_2_torch.ops.conv import stencil2d
from cuda_optical_flow_2_torch.ops.warp import warp_bilinear

__all__ = [
    "HSConfig",
    "HS_AVG_3X3",
    "hs_level",
    "horn_schunck",
    "lk_preproc_config",
    "hs_preprocess",
    "hs_coarse_to_fine",
    "pyramidal_hs",
    "pyramidal_hs_jit",
]

# Horn & Schunck 1981 neighbour-average weights (4-neighbours 1/6, diagonals
# 1/12; centre 0: the centre enters through the data term).
HS_AVG_3X3 = np.array(
    [[1 / 12, 1 / 6, 1 / 12], [1 / 6, 0.0, 1 / 6], [1 / 12, 1 / 6, 1 / 12]], dtype=np.float32
)


@dataclasses.dataclass(frozen=True)
class HSConfig:
    """Horn-Schunck configuration: the JAX package's fields and defaults.

    Attributes:
      alpha: smoothness weight; larger = smoother flow.
      iterations: Jacobi sweeps per pyramid level.
      levels: pyramid depth (1 = single-scale Horn-Schunck).
      temporal_kernel: as in LKConfig ("gauss3" recommended).
      prefilter: optional joint-bilateral pre-smoothing, as in LKConfig.
      use_pallas: the hand-written kernel path (see the module docstring).
      max_displacement: per-level warp budget of the kernel path, in pixels.
      d_local, c_max: TPU select-warp bounds; validated, unused by the port.
      penalty: "quadratic" or "charbonnier" (lagged diffusivity, weights
        refreshed every ``hs_sweep.MAX_SWEEPS`` sweeps).
      eps_data, eps_smooth: Charbonnier scales; eps -> inf is quadratic.
    """

    alpha: float = 10.0
    iterations: int = 100
    levels: int = 3
    temporal_kernel: str = "gauss3"
    prefilter: Optional[BilateralConfig] = None
    use_pallas: bool = True
    max_displacement: int = 32
    d_local: int = 7
    c_max: int = 1
    penalty: str = "quadratic"
    eps_data: float = 3.0
    eps_smooth: float = 0.1

    def __post_init__(self) -> None:
        if self.alpha <= 0:
            raise ValueError(f"alpha must be > 0, got {self.alpha}")
        if self.iterations < 1 or self.levels < 1:
            raise ValueError("iterations and levels must be >= 1")
        if self.c_max < 0:
            raise ValueError(f"c_max must be >= 0, got {self.c_max}")
        if self.penalty not in ("quadratic", "charbonnier"):
            raise ValueError(f"unknown penalty {self.penalty!r}")
        if self.eps_data <= 0 or self.eps_smooth <= 0:
            raise ValueError("eps_data and eps_smooth must be > 0")


def _robust_eps(config: HSConfig) -> tuple[float, float] | None:
    """(eps_data, eps_smooth) for the Charbonnier penalty, else None."""
    if config.penalty != "charbonnier":
        return None
    return (config.eps_data, config.eps_smooth)


def hs_level(
    prev: torch.Tensor, nxt: torch.Tensor, flow_init: torch.Tensor | None, config: HSConfig
) -> torch.Tensor:
    """Jacobi-relaxed HS flow for one level, warm-started at ``flow_init``
    (``nxt`` already warped by it when coming from a coarser level)."""
    relax = hs_sweep.hs_relax if config.use_pallas else hs_sweep.hs_relax_plain
    return relax(
        prev, nxt, flow_init, iterations=config.iterations, alpha=config.alpha,
        temporal_kernel=config.temporal_kernel, robust=_robust_eps(config),
    )


def _avg3x3(x: torch.Tensor) -> torch.Tensor:
    """HS neighbour average (zero-padded, == conv2d(HS_AVG_3X3)) as
    shifted slices: cross * 1/6 + diagonals * 1/12."""
    xp = torch.nn.functional.pad(x, (1, 1, 1, 1))
    h, w = x.shape[-2:]

    def sh(dy: int, dx: int) -> torch.Tensor:
        return xp[..., 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]

    cross = sh(-1, 0) + sh(1, 0) + sh(0, -1) + sh(0, 1)
    diag = sh(-1, -1) + sh(-1, 1) + sh(1, -1) + sh(1, 1)
    return cross * (1 / 6) + diag * (1 / 12)


def _quadratic_relax(
    uv: torch.Tensor, ix: torch.Tensor, iy: torch.Tensor, it: torch.Tensor,
    iterations: int, alpha: float, keep: torch.Tensor | None = None,
) -> torch.Tensor:
    """The quadratic sweeps of the JAX package's ``hs_level`` XLA path.

    ``keep`` (a mask broadcasting to the image; spatial-TP bands) zeroes the
    flow outside the global image after every sweep: the whole image's zero
    padding stays zero, and the band rows beyond the image must too, or
    their nonzero average would leak back inward."""
    denom = alpha**2 + ix * ix + iy * iy
    u, v = uv[..., 0], uv[..., 1]
    for _ in range(iterations):
        u_bar = _avg3x3(u)
        v_bar = _avg3x3(v)
        rate = (ix * u_bar + iy * v_bar + it) / denom
        u, v = u_bar - ix * rate, v_bar - iy * rate
        if keep is not None:
            u, v = torch.where(keep, u, 0.0), torch.where(keep, v, 0.0)
    return torch.stack([u, v], dim=-1)


# Central-difference masks for the lagged-diffusivity flow gradient (only
# the squared magnitude is used, so the sign convention does not matter).
_DXC = np.array([[0.5, 0.0, -0.5]], np.float32)
_DYC = _DXC.T


def _robust_relax_xla(
    flow: torch.Tensor, ix: torch.Tensor, iy: torch.Tensor, it: torch.Tensor,
    iterations: int, alpha: float, robust: tuple[float, float],
) -> torch.Tensor:
    """The plain Charbonnier relaxation (the JAX package's XLA twin of the
    kernel's robust mode): weights recomputed from the current flow every
    ``hs_sweep.MAX_SWEEPS`` sweeps and frozen within the chunk; zero-shift
    boundary throughout (the normalization by S with ws = 0 outside the
    image drops missing neighbours: a Neumann-style border)."""
    k = min(hs_sweep.MAX_SWEEPS, iterations)
    n_full, rem = divmod(iterations, k)
    uv = flow
    for _ in range(n_full):
        uv = _robust_chunk(uv, ix, iy, it, k, alpha, robust)
    if rem:
        uv = _robust_chunk(uv, ix, iy, it, rem, alpha, robust)
    return uv


def _robust_chunk(
    uv: torch.Tensor, ix: torch.Tensor, iy: torch.Tensor, it: torch.Tensor,
    sweeps: int, alpha: float, robust: tuple[float, float],
    keep: torch.Tensor | None = None,
) -> torch.Tensor:
    """One Charbonnier chunk: the weights from the incoming flow, frozen for
    ``sweeps`` sweeps.  ``keep`` as in :func:`_quadratic_relax`."""
    weights = _robust_weights(uv, ix, iy, it, alpha, robust, keep)
    return _robust_sweeps(uv, ix, iy, it, weights, sweeps, keep)


def _robust_weights(
    uv: torch.Tensor, ix: torch.Tensor, iy: torch.Tensor, it: torch.Tensor,
    alpha: float, robust: tuple[float, float], keep: torch.Tensor | None = None,
) -> tuple[torch.Tensor, ...]:
    """A chunk's frozen weights from its incoming flow: (wd, ws, 1/S,
    1/(alpha^2 S + wd |grad I|^2)).  ``keep`` zeroes the smoothness weight
    outside the global image, which the normalizer S reads at the
    neighbours."""
    ed, es = robust
    u, v = uv[..., 0], uv[..., 1]
    r = ix * u + iy * v + it
    wd = ed * torch.rsqrt(r * r + ed * ed)
    g2 = (
        stencil2d(u, _DXC) ** 2
        + stencil2d(v, _DXC) ** 2
        + stencil2d(u, _DYC) ** 2
        + stencil2d(v, _DYC) ** 2
    )
    ws = es * torch.rsqrt(g2 + es * es)
    if keep is not None:
        ws = torch.where(keep, ws, 0.0)
    s_plane = clip((ws + _avg3x3(ws)) * 0.5, 1e-12)
    inv_s = 1.0 / s_plane
    inv_denom = 1.0 / (alpha * alpha * s_plane + wd * (ix * ix + iy * iy))
    return wd, ws, inv_s, inv_denom


def _robust_sweeps(
    uv: torch.Tensor, ix: torch.Tensor, iy: torch.Tensor, it: torch.Tensor,
    weights: tuple[torch.Tensor, ...], sweeps: int, keep: torch.Tensor | None = None,
) -> torch.Tensor:
    """``sweeps`` Charbonnier sweeps with the frozen ``weights`` of
    :func:`_robust_weights`; ``keep`` as in :func:`_quadratic_relax`."""
    wd, ws, inv_s, inv_denom = weights
    u, v = uv[..., 0], uv[..., 1]
    for _ in range(sweeps):
        u_bar = (ws * _avg3x3(u) + _avg3x3(ws * u)) * 0.5 * inv_s
        v_bar = (ws * _avg3x3(v) + _avg3x3(ws * v)) * 0.5 * inv_s
        rate = wd * (ix * u_bar + iy * v_bar + it) * inv_denom
        u = u_bar - ix * rate
        v = v_bar - iy * rate
        if keep is not None:
            u, v = torch.where(keep, u, 0.0), torch.where(keep, v, 0.0)
    return torch.stack([u, v], dim=-1)


def horn_schunck(prev: torch.Tensor, nxt: torch.Tensor, config: HSConfig) -> torch.Tensor:
    """Single-scale Horn-Schunck (the 1981 algorithm), (..., H, W) -> flow."""
    return hs_level(prev, nxt, None, config)


# The LKConfig that drives the shared preprocess (pyramid + optional
# bilateral); its LK-specific fields are irrelevant there.
_LK_PREPROC = LKConfig(levels=3, window=9)


def lk_preproc_config(config: HSConfig) -> LKConfig:
    """LKConfig view of a model config for the shared preprocess and warp
    plumbing: its levels, prefilter, use_pallas, max_displacement, d_local
    and c_max."""
    return dataclasses.replace(
        _LK_PREPROC,
        levels=config.levels,
        prefilter=config.prefilter,
        use_pallas=config.use_pallas,
        max_displacement=config.max_displacement,
        d_local=config.d_local,
        c_max=config.c_max,
    )


def hs_preprocess(frame: torch.Tensor, config: HSConfig) -> list[torch.Tensor]:
    """Frame -> (optionally bilateral-filtered) Gaussian pyramid (shared with LK)."""
    return preprocess(frame, lk_preproc_config(config))


def hs_coarse_to_fine(
    prev_pyr: list[torch.Tensor],
    next_pyr: list[torch.Tensor],
    config: HSConfig,
    init_flow: torch.Tensor | None = None,
) -> torch.Tensor:
    """Coarse-to-fine HS over prebuilt pyramids; returns the finest flow.

    At each finer level the flow is upsampled, the next frame warped by it,
    the residual relaxed from zero and added.  On the kernel path the warp
    clamps the flow to ``max_displacement`` and the residual is added to
    the clamped flow, the flow the warp applied.
    """
    flow = init_flow
    d = config.max_displacement
    for k in range(config.levels - 1, -1, -1):
        p, n = prev_pyr[k], next_pyr[k]
        if flow is None:
            flow = hs_level(p, n, None, config)
            continue
        flow = upsample_flow.handoff(flow, tuple(p.shape[-2:]), config.use_pallas)
        if config.use_pallas:
            flow = clip(flow, -float(d), float(d))
            warped = warp_select.warp_bilinear_select(n, flow, d)
        else:
            warped = warp_bilinear(n, flow)
        flow = flow + hs_level(p, warped, None, config)
    return flow


def pyramidal_hs(prev: torch.Tensor, nxt: torch.Tensor, config: HSConfig) -> torch.Tensor:
    """Coarse-to-fine Horn-Schunck: motion beyond one pixel per iteration.

    Both frames' pyramids are built in one stacked pass; the flow comes
    back on the frames' device.
    """
    if prev.shape != nxt.shape:
        raise ValueError(f"frame shapes differ: {tuple(prev.shape)} vs {tuple(nxt.shape)}")
    both = hs_preprocess(torch.stack([prev, nxt]).to(torch.float32), config)
    return hs_coarse_to_fine([lvl[0] for lvl in both], [lvl[1] for lvl in both], config)


# The JAX package's jitted entry: on CUDA tensors a replay of a graph captured
# once per config and input shape, dtype and device (``capture.captured``);
# on CPU tensors, or under autograd, ``pyramidal_hs`` itself.
pyramidal_hs_jit = captured(pyramidal_hs)
