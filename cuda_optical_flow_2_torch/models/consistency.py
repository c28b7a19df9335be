"""Forward-backward consistency: occlusion masks and the occlusion fill.

Counterpart of ``cuda_optical_flow_2_tpu.models.consistency``.  The cycle
test backward-warps the reverse flow by the forward flow and measures
|F_fw(x) + F_bw(x + F_fw(x))|: ~0 where the two fields agree, large at
occlusions and mistracks.  :func:`consistent_flow` runs the configured
family in both directions and thresholds that residual;
:func:`fill_occluded_flow` replaces the flagged pixels with a side-aware
diffusion fill.

On CUDA tensors the cycle warp is one launch of the ``warp_select`` kernel
(#3) on both planes of the reverse flow, with a displacement budget of
max(H, W): a component beyond it leaves the image both before and after the
clip, and an out-of-image sample keeps the source pixel either way, so the
budget changes no output and the kernel computes the plain ``warp_bilinear``
(``tests/test_torch_consistency.py`` pins the identity).  On CPU tensors, or
with ``use_pallas=False``, the plain warp runs.  The fill is the
``occlusion_fill`` kernel on CUDA tensors (one weights launch, then
``iterations`` diffusion sweeps time-tiled in shared memory), and its plain
version, 4 blur steps and the sweeps in plain torch, on CPU tensors or with
``use_pallas=False``.
"""

from __future__ import annotations

import torch

from cuda_optical_flow_2_torch.kernels import occlusion_fill, warp_select
from cuda_optical_flow_2_torch.ops.warp import warp_bilinear

__all__ = [
    "fb_consistency",
    "occlusion_mask",
    "occlusion_score",
    "consistent_flow",
    "fill_occluded_flow",
]


def fb_consistency(
    flow_fw: torch.Tensor, flow_bw: torch.Tensor, *, use_pallas: bool = True
) -> torch.Tensor:
    """Cycle residual |F_fw(x) + F_bw(x + F_fw(x))| per pixel.

    Args:
      flow_fw: (..., H, W, 2) forward flow (prev -> next, prev(x) = next(x + d)).
      flow_bw: (..., H, W, 2) backward flow (next -> prev).
      use_pallas: the cycle warp launches the ``warp_select`` kernel on CUDA
        tensors; False takes the plain warp on any device.
    Returns: (..., H, W) residual magnitude.
    """
    cyc2, _ = _cycle_terms(flow_fw, flow_bw, use_pallas)
    return torch.sqrt(cyc2)


def occlusion_mask(
    flow_fw: torch.Tensor,
    flow_bw: torch.Tensor,
    alpha: float = 0.01,
    beta: float = 0.5,
    *,
    use_pallas: bool = True,
) -> torch.Tensor:
    """Boolean occlusion/mistrack mask, True where the flow should NOT be
    trusted: |cycle|^2 > alpha * (|F_fw|^2 + |F_bw(x+F_fw)|^2) + beta
    (Sundaram et al. 2010), i.e. ``occlusion_score(...) > beta``."""
    return occlusion_score(flow_fw, flow_bw, alpha=alpha, use_pallas=use_pallas) > beta


def occlusion_score(
    flow_fw: torch.Tensor, flow_bw: torch.Tensor, alpha: float = 0.01, *, use_pallas: bool = True
) -> torch.Tensor:
    """Continuous occlusion evidence ``|cycle|^2 - alpha * mag^2``: the form
    to sweep ``beta`` over for precision/recall curves."""
    cyc2, mag2 = _cycle_terms(flow_fw, flow_bw, use_pallas)
    return cyc2 - alpha * mag2


def _warp_by(planes: torch.Tensor, flow: torch.Tensor, use_pallas: bool) -> torch.Tensor:
    """(..., 2, H, W) planes backward-warped by one (..., H, W, 2) flow."""
    flow = flow.unsqueeze(-4).expand(planes.shape + (2,))
    if use_pallas and planes.device.type != "cpu":
        return warp_select.warp_bilinear_select(planes, flow, max(planes.shape[-2:]))
    return warp_bilinear(planes, flow)


def _cycle_terms(
    flow_fw: torch.Tensor, flow_bw: torch.Tensor, use_pallas: bool = True
) -> tuple[torch.Tensor, torch.Tensor]:
    """Shared core of the cycle test: backward-warp the reverse flow once,
    return (|cycle|^2, |F_fw|^2 + |F_bw(x+F_fw)|^2)."""
    bw_u, bw_v = _warp_by(flow_bw.movedim(-1, -3), flow_fw, use_pallas).unbind(-3)
    u, v = flow_fw[..., 0], flow_fw[..., 1]
    ru = u + bw_u
    rv = v + bw_v
    cyc2 = ru * ru + rv * rv
    mag2 = u * u + v * v + bw_u * bw_u + bw_v * bw_v
    return cyc2, mag2


def consistent_flow(
    prev: torch.Tensor,
    nxt: torch.Tensor,
    config,
    alpha: float = 0.01,
    beta: float = 0.5,
    fill: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward flow plus its occlusion mask.

    Runs the configured family (any of the five, by config type) in both
    directions and applies :func:`occlusion_mask`; the cycle warp follows
    ``config.use_pallas``, and so does the fill.  With ``fill=True`` the
    masked pixels are replaced by :func:`fill_occluded_flow` (single frame
    pair only).

    Returns (flow, occluded): (..., H, W, 2) and boolean (..., H, W).
    """
    from cuda_optical_flow_2_torch.models import pyramidal_flow

    flow_fw = pyramidal_flow(prev, nxt, config)
    flow_bw = pyramidal_flow(nxt, prev, config)
    occ = occlusion_mask(flow_fw, flow_bw, alpha=alpha, beta=beta, use_pallas=config.use_pallas)
    if fill:
        flow_fw = fill_occluded_flow(flow_fw, occ, use_pallas=config.use_pallas)
    return flow_fw, occ


def fill_occluded_flow(
    flow: torch.Tensor,
    occ: torch.Tensor,
    iterations: int = 96,
    beta: float = 1.0,
    *,
    use_pallas: bool = True,
) -> torch.Tensor:
    """Replace occluded flow with a side-aware diffusion fill.

    Occluded pixels belong to the surface being covered, so the fill comes
    from the occludee's side: each trusted pixel gets the weight
    ``exp(-beta * max(0, f . n))``, ``n`` the inward normal of the occluded
    region (the gradient of the blurred mask), and the normalized diffusion
    turns it into a local softmin over the inward projection.  The JAX
    module's docstring gives the measurements behind the defaults.  Matched
    pixels are returned bit-identical.

    On CUDA tensors the ``occlusion_fill`` kernel computes it (a bool mask;
    it raises on what it does not take); on CPU tensors, or with
    ``use_pallas=False``, its plain version
    (``occlusion_fill.fill_occluded_flow_plain``), whose sweep averages the
    two weighted flow planes and the weight as one stacked (3, H, W)
    ``_avg3x3``.

    Args:
      flow: (H, W, 2) dense flow.
      occ: (H, W) bool, True where the flow should be replaced.
      iterations: diffusion sweeps; the fill front advances one pixel per
        sweep.
      beta: inward-projection penalty (1/px); 0 = plain two-sided diffusion.
      use_pallas: False takes the plain fill on any device.
    Returns: (H, W, 2) flow with occluded pixels filled.
    """
    if use_pallas:
        return occlusion_fill.fill_occluded_flow_kernel(flow, occ, iterations, beta)
    return occlusion_fill.fill_occluded_flow_plain(flow, occ, iterations, beta)
