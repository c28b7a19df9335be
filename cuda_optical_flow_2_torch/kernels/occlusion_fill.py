"""The occlusion fill: the side-aware diffusion fill of ``consistent_flow``.

Replaces ``cuda_optical_flow_2_tpu/models/consistency.py:124-205``
``fill_occluded_flow``, which has no ``pallas_call``: its 96 diffusion
sweeps are one ``lax.fori_loop`` that XLA fuses.  CUDA source:
``csrc/occlusion_fill.cu``.  It computes :func:`fill_occluded_flow_plain`,
the port's plain fill, which stays the plain version:

* weights: the mask blurred four times (``m = 0.5 avg(m) + 0.5 occ``), its
  gradient ``(gx, gy)`` the inward normal, each trusted pixel weighted
  ``exp(-beta * clip(f . n / |n|, 0, 30))``, the state ``(u w, v w, w)``;
* ``iterations`` sweeps: an occluded pixel whose neighbours' weight average
  ``den`` exceeds 1e-9 takes their weighted flow average over ``den`` and a
  weight of at least 1; every other pixel keeps its state;
* the flow where kept, the state's flow where occluded.

What bounds it on an H100: bytes, the flow (8), the mask (1) and the output
(8) per pixel, against about 30 FP32 operations and two divisions per
occluded pixel per sweep (``chip_smoke.work``).  The plain version moves
the three state planes through device memory in about 19 ops per sweep.
The kernel keeps the sweeps in shared memory: one launch computes the
weights on 64 x 64 tiles with a ring of :data:`WEIGHTS_RING` cells, writes
the state into both buffers of a ping-pong pair, the output of zero sweeps,
and per block whether its output tile holds an occluded pixel; then
ceil(iterations / K) launches of near equal k <= K
(:data:`SWEEPS_PER_LAUNCH`) run k sweeps each on 64 x 64 tiles with a ring
of ``ring(k)`` = k cells (``csrc/of2_tile.cuh``) and write back only the
occluded pixels, the last launch into the output.  A kept pixel never
changes and both buffers start equal, so a tile with no occluded pixel in
its output area returns at once, decided on the device from those flags:
the grid is fixed, nothing is read on the host, and the call can be
captured.  Every product and sum is rounded as the plain op rounds it.

:func:`fill_occluded_flow_kernel` launches the kernels for CUDA tensors and
takes :func:`fill_occluded_flow_plain` for CPU tensors;
``fill_occluded_flow_kernel.launches`` counts calls that launched (one per
call: the weights launch and the sweep launches of one C call).
"""

from __future__ import annotations

import torch

from cuda_optical_flow_2_torch.kernels import _build
from cuda_optical_flow_2_torch.ops.clip import clip
from cuda_optical_flow_2_torch.ops.conv import stencil2d

__all__ = [
    "fill_occluded_flow_kernel",
    "fill_occluded_flow_plain",
    "fill_weights_plain",
    "fill_sweeps_plain",
    "ring",
    "SWEEPS_PER_LAUNCH",
    "WEIGHTS_RING",
]

# K: sweeps per launch (each on 64 x 64 tiles with a ring of K cells); the
# result does not depend on it.
SWEEPS_PER_LAUNCH = 8

# The weights launch's ring: four blur rounds and the gradient stencil each
# read one cell further.
WEIGHTS_RING = 5

_WEIGHTS_TILE = 64 - 2 * WEIGHTS_RING  # the output tile of the weights launch


def ring(k: int) -> int:
    """The tile ring, in cells, of a launch of ``k`` sweeps: the kernel
    writes back the pixels at least this far from its tile's edge."""
    return k


def fill_weights_plain(
    flow: torch.Tensor, occ: torch.Tensor, beta: float = 1.0
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fill's start: (u, keep, state), the flow as float32, the mask of
    kept pixels and the (3, ..., H, W) state (u w, v w, w)."""
    from cuda_optical_flow_2_torch.models.horn_schunck import _DXC, _DYC, _avg3x3

    u = flow.to(torch.float32)
    occf = occ.to(torch.float32)
    m = occf
    for _ in range(4):
        m = 0.5 * _avg3x3(m) + 0.5 * occf
    gx = -stencil2d(m, _DXC)
    gy = -stencil2d(m, _DYC)
    norm = torch.sqrt(gx * gx + gy * gy) + 1e-6
    proj = (u[..., 0] * gx + u[..., 1] * gy) / norm
    src_w = torch.exp(-beta * clip(proj, 0.0, 30.0))
    trusted = (1.0 - occf) * src_w
    keep = (1.0 - occf) > 0
    # planes: the weighted flow (u, v) and its weight
    state = torch.stack([u[..., 0] * trusted, u[..., 1] * trusted, trusted])
    return u, keep, state


def fill_sweeps_plain(state: torch.Tensor, grow: torch.Tensor, sweeps: int) -> torch.Tensor:
    """``sweeps`` diffusion sweeps of the (3, ..., H, W) state, changing only
    the pixels of ``grow`` (the occluded ones)."""
    from cuda_optical_flow_2_torch.models.horn_schunck import _avg3x3

    for _ in range(sweeps):
        avg = _avg3x3(state)
        den = avg[2]
        filled = den > 1e-9
        # a newly reached pixel takes the normalized average and a weight of
        # at least 1; the rest keep theirs
        reached = torch.cat([avg[:2] / clip(den, 1e-9), clip(state[2:], 1.0)])
        state = torch.where(grow & filled, reached, state)
    return state


def fill_occluded_flow_plain(
    flow: torch.Tensor, occ: torch.Tensor, iterations: int = 96, beta: float = 1.0
) -> torch.Tensor:
    """The plain PyTorch fill of ``models.consistency.fill_occluded_flow``:
    (..., H, W, 2) flow, (..., H, W) mask -> (..., H, W, 2) float32."""
    u, keep, state = fill_weights_plain(flow, occ, beta)
    state = fill_sweeps_plain(state, ~keep, iterations)
    return torch.where(keep[..., None], u, state[:2].movedim(0, -1))


def fill_occluded_flow_kernel(
    flow: torch.Tensor, occ: torch.Tensor, iterations: int = 96, beta: float = 1.0
) -> torch.Tensor:
    """Fill the pixels of ``occ`` (..., H, W) bool in ``flow`` (..., H, W, 2);
    returns (..., H, W, 2) float32 with the kept pixels bit-identical."""
    if flow.device.type == "cpu" and occ.device.type == "cpu":
        return fill_occluded_flow_plain(flow, occ, iterations, beta)
    dev = _build.require_cuda(flow, occ)
    if occ.dtype != torch.bool:
        raise ValueError(f"the occlusion fill kernel takes a bool mask, got {occ.dtype}")
    if flow.dim() < 3 or flow.shape[-1] != 2 or occ.shape != flow.shape[:-1] or not occ.numel():
        raise ValueError(
            f"shapes flow {tuple(flow.shape)}, occ {tuple(occ.shape)}: want (..., H, W, 2) and "
            "(..., H, W), not empty"
        )
    lead, (h, w) = occ.shape[:-2], occ.shape[-2:]
    u = flow.to(torch.float32).contiguous().reshape(-1, h, w, 2)
    if u.data_ptr() % 8:  # read as one float2 per pixel
        u = u.clone()
    mask = occ.contiguous().reshape(-1, h, w)
    b = u.shape[0]
    out = torch.empty_like(u)
    scratch = torch.empty(6 * b * h * w, dtype=torch.float32, device=dev)
    tiles = -(-h // _WEIGHTS_TILE) * -(-w // _WEIGHTS_TILE)
    flags = torch.empty(b * tiles, dtype=torch.uint8, device=dev)
    _build.launch(
        dev, "of2_occlusion_fill", u.data_ptr(), mask.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), flags.data_ptr(), b, h, w, max(int(iterations), 0),
        SWEEPS_PER_LAUNCH, -float(beta),
    )
    fill_occluded_flow_kernel.launches += 1
    return out.reshape(lead + (h, w, 2))


fill_occluded_flow_kernel.launches = 0
