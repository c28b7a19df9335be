"""Plain reference of pyramidal TV-L1 as the port's kernel path runs it.

The semantics of ``TVL1Config(use_pallas=True)`` on the card, written out in
plain PyTorch (a frozen copy of the arithmetic of the port's
``models.tvl1.primal_dual`` and its coarse-to-fine loop): at each level,
from zero flow at the coarsest or the coarser flow upsampled one octave,
``warps`` times: clip the flow to +-``max_displacement``, warp the next
frame by it, run ``iterations`` primal-dual steps on the linearized L1
residual with the duals from zero, then a ``median_filtering`` x
``median_filtering`` median of each flow plane with edge-replicated
borders.  A median is a selection, so it is taken here with
``torch.median``, which returns the same value as the port's networks.

Supported fields: those of ``TVL1Config`` with no prefilter and
``use_pallas=True``; :func:`check_fields` refuses others.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from flowbench.reference.ops import SOBEL_X, SOBEL_Y, clip, correlate, pyramid, upsample_flow
from flowbench.reference.ops import warp_bilinear

__all__ = ["check_fields", "flow", "median", "primal_dual"]

_DEFAULTS = {
    "lambda_": 0.15, "theta": 0.3, "tau": 0.25, "warps": 5, "iterations": 30, "levels": 5,
    "epsilon": 1e-6, "median_filtering": 5, "use_pallas": True, "max_displacement": 32,
    "d_local": 7, "c_max": 1, "prefilter": None,
}


def check_fields(fields: dict) -> dict:
    f = {**_DEFAULTS, **fields}
    unknown = set(f) - set(_DEFAULTS)
    if unknown:
        raise ValueError(f"fields the TV-L1 reference does not know: {sorted(unknown)}")
    if f["prefilter"] is not None or not f["use_pallas"]:
        raise ValueError("the TV-L1 reference covers the kernel path with no prefilter")
    return f


def _fwd_diff(x: torch.Tensor, dim: int) -> torch.Tensor:
    n = x.shape[dim]
    d = x.narrow(dim, 1, n - 1) - x.narrow(dim, 0, n - 1)
    return torch.cat([d, torch.zeros_like(x.narrow(dim, 0, 1))], dim=dim)


def _div(px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    def bwd(x: torch.Tensor, dim: int) -> torch.Tensor:
        n = x.shape[dim]
        d = x.narrow(dim, 1, n - 2) - x.narrow(dim, 0, n - 2)
        return torch.cat([x.narrow(dim, 0, 1), d, -x.narrow(dim, n - 2, 1)], dim=dim)

    return bwd(px, -1) + bwd(py, -2)


def _magnitude(gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(gx * gx + gy * gy)


def primal_dual(prev, warped, u0, flow, f: dict) -> torch.Tensor:
    """``iterations`` primal-dual steps of one linearization; returns the
    total flow."""
    gx = correlate(warped, SOBEL_X / 8.0)
    gy = correlate(warped, SOBEL_Y / 8.0)
    g2 = gx * gx + gy * gy
    g2s = clip(g2, f["epsilon"])
    it = warped - prev
    theta = f["theta"]
    lt = f["lambda_"] * theta
    tt = f["tau"] / theta
    th = lt * g2
    u, v = flow[..., 0], flow[..., 1]
    u0u, u0v = u0[..., 0], u0[..., 1]
    p1x = p1y = p2x = p2y = torch.zeros_like(u)
    for _ in range(f["iterations"]):
        rho = it + (u - u0u) * gx + (v - u0v) * gy
        lo, hi = rho < -th, rho > th
        du = torch.where(lo, lt * gx, torch.where(hi, -lt * gx, -rho * gx / g2s))
        dv = torch.where(lo, lt * gy, torch.where(hi, -lt * gy, -rho * gy / g2s))
        u = u + du + theta * _div(p1x, p1y)
        v = v + dv + theta * _div(p2x, p2y)
        ux, uy = _fwd_diff(u, -1), _fwd_diff(u, -2)
        vx, vy = _fwd_diff(v, -1), _fwd_diff(v, -2)
        nu = 1.0 + tt * _magnitude(ux, uy)
        nv = 1.0 + tt * _magnitude(vx, vy)
        p1x, p1y = (p1x + tt * ux) / nu, (p1y + tt * uy) / nu
        p2x, p2y = (p2x + tt * vx) / nv, (p2y + tt * vy) / nv
    return torch.stack([u, v], dim=-1)


def median(planes: torch.Tensor, size: int) -> torch.Tensor:
    """size x size median of (..., H, W) planes, edge-replicated borders."""
    r = size // 2
    lead, (h, w) = planes.shape[:-2], planes.shape[-2:]
    xp = F.pad(planes.reshape(1, -1, h, w), (r, r, r, r), mode="replicate")
    xp = xp.reshape(lead + (h + 2 * r, w + 2 * r))
    out = torch.empty_like(planes)
    for i in range(planes.shape[0]):  # one leading slice at a time, to bound memory
        stacked = torch.stack([xp[i, ..., dy:dy + h, dx:dx + w]
                               for dy in range(size) for dx in range(size)])
        out[i] = stacked.median(dim=0).values
    return out


def flow(prev: torch.Tensor, nxt: torch.Tensor, fields: dict,
         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Flow (..., H, W, 2) float32 of frame pairs (..., H, W), computed in
    ``dtype``."""
    f = check_fields(fields)
    pp = pyramid(prev.to(dtype), f["levels"])
    npyr = pyramid(nxt.to(dtype), f["levels"])
    d = float(f["max_displacement"])
    out = None
    for k in range(f["levels"] - 1, -1, -1):
        p, n = pp[k], npyr[k]
        if out is None:
            out = torch.zeros(p.shape + (2,), dtype=dtype, device=p.device)
        else:
            out = upsample_flow(out, tuple(p.shape[-2:]))
        for _ in range(f["warps"]):
            out = clip(out, -d, d)
            out = primal_dual(p, warp_bilinear(n, out), out, out, f)
            if f["median_filtering"] > 1:
                out = median(out.movedim(-1, 0), f["median_filtering"]).movedim(0, -1)
    return out.float()
