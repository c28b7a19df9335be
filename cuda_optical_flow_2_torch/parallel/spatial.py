"""Spatial (tensor-parallel) sharding: one frame pair's rows split over a mesh.

Counterpart of ``cuda_optical_flow_2_tpu.parallel.spatial``.  The image's row
axis is cut into one block per device of the mesh's space axis; every
stencil stage (prefilter, pyramid step, gradients, window sums, warp, 2x flow
upsample) pads its block with exactly the halo rows it needs from the
neighbouring blocks (:func:`halo_exchange`) and works on that band, and the
band kernels (``kernels/*_band``) test positions against the GLOBAL image.
JAX runs the blocks under one ``shard_map`` with ``lax.ppermute``; here one
process runs every stage on all blocks in turn, in lockstep, and a halo row
moves with ``.to(device)`` (nothing moves between blocks on one device).
Use it for frames too large for one card or to cut one pair's latency; for
throughput over many pairs prefer batch sharding (``parallel/batching.py``).

Captured entries: the JAX package jits each TP entry, so here each public
entry replays a CUDA graph (``capture.captured``) keyed on the config, the
mesh (by value), the axis names, the tiles and the frames' shapes and
devices, with its eager body as ``.eager``.  The frames are placed before
the graph, as JAX's ``in_shardings`` place them (a capture cannot copy from
pageable host memory): on a space axis that lists ONE device (a mesh over
one card, several times or once) each whole frame goes to it; on a space
axis over several devices (:func:`one_device` is None: ``cuda:0`` and
``cuda:1``, or ``cuda`` and ``cuda:0``, which name one card twice) each
row block goes to its device, and the body takes the blocks as they lie.
A call over several cards is then one multi-device graph (``capture.py``):
its halo exchanges and the gather are copies between cards inside the
graph.  The one exception: a space axis over cards of which two cannot
reach each other's memory (:func:`peer_access` is False) runs the eager
body, since a graph cannot hold a copy between them.  The grid entries
capture per batch group: each group is one TP call on its own space
devices.  On CPU tensors every entry runs its eager body.

Exactness: away from the global top and bottom edges the sharded result is
the unsharded computation (same zero-padded stencils, same warp fallback),
float for float up to summation order.  The one semantic difference, as in
the JAX package: the sharded path always enforces the
``config.max_displacement`` warp budget (the halo is sized from it), as the
kernel path does, where the unsharded plain path warps without one.

The JAX package's dispatch predicates (``_fused_enabled``,
``_prefilter_pallas``) reduce here to ``config.use_pallas`` and the
kernels' window limits (``lk_fused.supported``, ``bilateral_tap.supported``),
as the port's single-card dispatch does: the CUDA band kernels take any
width and any displacement budget.  With ``use_pallas`` the band kernels
run on CUDA shards and their plain versions on CPU shards; without it, or
past a window limit, the plain ops composition (the JAX package's XLA
twin) runs.
"""

from __future__ import annotations

import inspect
import math
from collections.abc import Callable, Sequence

import torch

from cuda_optical_flow_2_torch.capture import captured
from cuda_optical_flow_2_torch.config import LKConfig
from cuda_optical_flow_2_torch.kernels import bilateral_tap, lk_fused, lk_step_fused
from cuda_optical_flow_2_torch.ops.bilateral import bilateral_filter_band
from cuda_optical_flow_2_torch.ops.clip import clip
from cuda_optical_flow_2_torch.ops.pyramid import pyr_down
from cuda_optical_flow_2_torch.ops.resize import _up2x_axis
from cuda_optical_flow_2_torch.ops.warp import warp_bilinear_band
from cuda_optical_flow_2_torch.parallel.batching import Mesh

__all__ = [
    "halo_exchange",
    "one_device",
    "peer_access",
    "spatial_pyramidal_lk",
    "grid_pyramidal_lk",
    "validate_spatial",
]

Blocks = list[torch.Tensor]


def halo_exchange(
    blocks: Blocks,
    top: int,
    bottom: int,
    *,
    row_axis: int = -2,
    boundary: str = "zero",
) -> Blocks:
    """Pad each row block with ``top``/``bottom`` rows of its neighbours.

    ``blocks`` are the consecutive row blocks of one array, one per mesh
    position; each comes back padded, on its own device.  The first and last
    blocks, which have no neighbour there, get zeros (``boundary="zero"``,
    matching the zero-padded stencils) or their own edge row replicated
    (``boundary="edge"``, matching clamped sampling).  Halo widths must not
    exceed the block height (one neighbour hop).
    """
    h = blocks[0].shape[row_axis]
    if top > h or bottom > h:
        raise ValueError(f"halo ({top}, {bottom}) exceeds block height {h}")
    if boundary not in ("zero", "edge"):
        raise ValueError(f"unknown boundary {boundary!r}")
    n = len(blocks)
    out = []
    for i, x in enumerate(blocks):
        parts = []
        if top > 0:
            if i > 0:
                parts.append(blocks[i - 1].narrow(row_axis, h - top, top).to(x.device))
            elif boundary == "edge":
                parts.append(_replicate_row(x, 0, top, row_axis))
            else:
                parts.append(torch.zeros_like(x.narrow(row_axis, 0, top)))
        parts.append(x)
        if bottom > 0:
            if i < n - 1:
                parts.append(blocks[i + 1].narrow(row_axis, 0, bottom).to(x.device))
            elif boundary == "edge":
                parts.append(_replicate_row(x, h - 1, bottom, row_axis))
            else:
                parts.append(torch.zeros_like(x.narrow(row_axis, 0, bottom)))
        out.append(torch.cat(parts, dim=row_axis))
    return out


def _replicate_row(x: torch.Tensor, row: int, count: int, row_axis: int) -> torch.Tensor:
    r = x.narrow(row_axis, row, 1)
    shape = list(r.shape)
    shape[row_axis] = count
    return r.expand(shape)


def _crop_rows(x: torch.Tensor, r: int, row_axis: int = -2) -> torch.Tensor:
    return x.narrow(row_axis, r, x.shape[row_axis] - 2 * r)


def _row0s(blocks: Blocks) -> list[int]:
    """The global row of each block's first row."""
    return [i * b.shape[-2] for i, b in enumerate(blocks)]


def _local_prefilter(frames: Blocks, config, h_global: int) -> Blocks:
    """Shard-local bilateral prefilter: exchange ``window // 2`` rows,
    filter each band with GLOBAL-row tap masking, crop.

    Kept rows see exactly the taps the unsharded filter would (the halo
    supplies real neighbour rows; beyond the global border the mask skips
    taps as the whole-image filter does).
    """
    pf = config.prefilter
    r = pf.window // 2
    kernel = config.use_pallas and bilateral_tap.supported(pf.window)
    band = bilateral_tap.bilateral_kernel_band if kernel else bilateral_filter_band
    return [
        _crop_rows(band(fp, row0 - r, h_global, pf.window, pf.sigma_spatial, pf.sigma_range), r)
        for fp, row0 in zip(halo_exchange(frames, r, r), _row0s(frames))
    ]


def _local_pyr_down(blocks: Blocks, use_pallas: bool) -> Blocks:
    """Shard-local blur + 2x subsample, halo-exact.

    pyr_down's output row i reads source rows 2i-1..2i+1 (zero outside the
    image).  Padding each block with TWO rows from above keeps the even
    start-row alignment: the padded block starts at global row s-2, its
    first output row is global output row s/2 - 1, and dropping it leaves
    this block's output rows.  The first block's zero halo is the global
    zero padding.  It is the same function as the whole-image step, so CUDA
    blocks take the ``pyr_down`` kernel with ``use_pallas``.
    """
    return [
        pyr_down(xp, use_pallas=use_pallas)[..., 1:, :] for xp in halo_exchange(blocks, 2, 0)
    ]


def _local_upsample2x_flow(flow: Blocks) -> Blocks:
    """Shard-local exact-2x flow upsample (rows sharded, columns whole).

    The row stencil (out[2k] = .75 in[k] + .25 in[k-1], edges clamped,
    ``ops/resize``) needs one neighbour row on each side; the ``edge``
    boundary is the global clamp on the first and last blocks.  The padded
    rows' outputs are cropped.
    """
    return [
        _up2x_axis(_crop_rows(_up2x_axis(fp, -3), 2, -3), -2) * 2.0
        for fp in halo_exchange(flow, 1, 1, row_axis=-3, boundary="edge")
    ]


def _halo_radius(config: LKConfig) -> tuple[int, int]:
    """(gradient + window halo, that plus the warp budget and the bilinear
    neighbour)."""
    r_grad = config.window // 2 + 2
    d = int(math.ceil(config.max_displacement))
    return r_grad, r_grad + d + 2


def _local_lk_level(
    prev: Blocks,
    nxt: Blocks,
    flow: Blocks | None,
    config: LKConfig,
    h_global: int,
    centered: bool = False,
) -> Blocks:
    """One pyramid level on row blocks, with per-iteration halo exchange.

    Mirrors ``models.lucas_kanade.lk_level``: gradients and window sums need
    ``r_grad = window // 2 + 2`` halo rows (zero at the global border,
    matching the zero padding); the warp also needs the clamped displacement
    budget.  The residual is computed on the padded band
    (``kernels.lk_fused.lk_residual_plain`` in its band form: gradients zero
    outside the global image) and cropped, so every kept row sees exactly
    the taps of the unsharded computation.

    With ``config.use_pallas`` (bilinear warp) the whole shard-local step
    runs as the band kernel ``kernels.lk_step_fused.lk_band_step``; the form
    below is its ``use_pallas=False`` twin.
    """
    r_grad, r_img = _halo_radius(config)
    row0s = _row0s(prev)
    if config.use_pallas and lk_fused.supported(config) and config.warp_mode == "bilinear":
        return _local_lk_level_fused(prev, nxt, flow, config, h_global, r_grad, r_img, centered)

    prev_p = halo_exchange(prev, r_grad, r_grad)

    def residual(nxt_p: Blocks, out_row0s: list[int]) -> Blocks:
        return [
            _crop_rows(
                lk_fused.lk_residual_plain(pp, np_, config, centered, r0, h_global), r_grad, -3
            )
            for pp, np_, r0 in zip(prev_p, nxt_p, out_row0s)
        ]

    def residual_nowarp() -> Blocks:
        return residual(halo_exchange(nxt, r_grad, r_grad), [r0 - r_grad for r0 in row0s])

    iterations = config.iterations
    if flow is None:
        # Coarsest level: residual between the raw frames, no warp.
        flow = residual_nowarp()
        iterations -= 1
        if config.warp_mode == "none" or iterations <= 0:
            return flow
    if config.warp_mode == "none":
        return [f + r for f, r in zip(flow, residual_nowarp())]
    nxt_p = halo_exchange(nxt, r_img, r_img)
    d = float(config.max_displacement)
    for _ in range(iterations):
        flow = [clip(f, -d, d) for f in flow]
        flow_p = halo_exchange(flow, r_grad, r_grad, row_axis=-3)
        warped = [
            warp_bilinear_band(np_, fp, r0 - r_img, r0 - r_grad, h_global)
            for np_, fp, r0 in zip(nxt_p, flow_p, row0s)
        ]
        flow = [f + r for f, r in zip(flow, residual(warped, [r0 - r_grad for r0 in row0s]))]
    return flow


def _local_lk_level_fused(
    prev: Blocks,
    nxt: Blocks,
    flow: Blocks | None,
    config: LKConfig,
    h_global: int,
    r_grad: int,
    r_img: int,
    centered: bool = False,
) -> Blocks:
    """Kernel-path shard-local LK level: exchange, then ONE band step per
    block and iteration (``kernels.lk_step_fused.lk_band_step``).

    The coarsest no-warp pass runs the same step with zero flow (the warp is
    then an exact identity load, so it equals the residual) and needs only
    the gradient halo ``r_grad``; warping iterations take the full ``r_img``
    halo.  Band-edge rows are garbage by construction and cropped.
    """
    iterations = config.iterations
    warps_here = iterations > 1 or flow is not None
    # The frames are constant across iterations: ONE exchange at the widest
    # halo this level needs; narrower-halo steps crop the same band.
    big = r_img if warps_here else r_grad
    prev_b = halo_exchange(prev, big, big)
    nxt_b = halo_exchange(nxt, big, big)
    row0s = _row0s(prev)

    def band_step(flow_blocks: Blocks, halo: int) -> Blocks:
        flow_p = halo_exchange(flow_blocks, halo, halo, row_axis=-3)
        return [
            _crop_rows(
                lk_step_fused.lk_band_step(
                    _crop_rows(pb, big - halo), _crop_rows(nb, big - halo), fp, r0 - halo,
                    config, h_global, centered,
                ),
                halo, -3,
            )
            for pb, nb, fp, r0 in zip(prev_b, nxt_b, flow_p, row0s)
        ]

    if flow is None:
        flow = band_step([p.new_zeros(p.shape + (2,)) for p in prev], r_grad)
        iterations -= 1
    for _ in range(iterations):
        flow = band_step(flow, r_img)
    return flow


def validate_prefilter_shards(h: int, n: int, config) -> None:
    """Shared check: every family's spatial validator rejects shards too
    short to supply the bilateral prefilter's halo rows (only
    ``config.prefilter`` is consulted)."""
    if config.prefilter is not None and h // n < config.prefilter.window // 2:
        raise ValueError(
            f"prefilter window {config.prefilter.window} needs "
            f"{config.prefilter.window // 2} halo rows but each of {n} "
            f"shards holds only {h // n}"
        )


def validate_spatial(h: int, w: int, config: LKConfig, n: int) -> None:
    """Raise with a precise message if (h, w) can't be row-sharded n ways."""
    validate_prefilter_shards(h, n, config)
    if config.warp_mode == "nearest":
        raise NotImplementedError("spatial sharding supports bilinear/none warps")
    r_grad, r_img = _halo_radius(config)
    top = config.levels - 1
    if h % (n << top) or (top and w % (1 << top)):
        raise ValueError(
            f"spatial sharding needs H divisible by n_shards * 2^(levels-1) "
            f"= {n << top} and W by {1 << top}; got {h}x{w}"
        )
    for k in range(config.levels):
        # Level k warps (and so needs the image halo r_img) unless it is the
        # coarsest level running a single iteration, which never warps.
        warps = config.warp_mode != "none" and (k < top or config.iterations > 1)
        hk = (h >> k) // n
        need = max(r_img if warps else r_grad, 2)
        if hk < need:
            raise ValueError(
                f"level {k} holds {hk} rows/shard but its halos need {need}; "
                f"reduce levels, window, max_displacement or shards"
            )


LevelFn = Callable[[Blocks, Blocks, "Blocks | None", int], Blocks]


def _local_family_pipeline(
    prev: Blocks, nxt: Blocks, config, h: int, level_fn: LevelFn, finest_level: int = 0
) -> Blocks:
    """The per-shard pipeline every family instantiates: optional banded
    prefilter -> shard-local pyramids -> coarse-to-fine with
    ``level_fn(prev, nxt, flow, h_level)`` per solved level -> the
    remaining 2x upsamples (DIS's ``finest_level``; 0 for the other
    families).

    The two frames of each block go through the prefilter and the pyramid
    stacked, one kernel launch per block and stage, as the unsharded
    pipelines stack the pair.
    """
    pairs = [torch.stack([p, q]).to(torch.float32) for p, q in zip(prev, nxt)]
    if config.prefilter is not None:
        pairs = _local_prefilter(pairs, config, h)
    pyramid = [pairs]
    for _ in range(1, config.levels):
        pyramid.append(_local_pyr_down(pyramid[-1], config.use_pallas))
    flow = None
    for k in range(config.levels - 1, finest_level - 1, -1):
        if flow is not None:
            flow = _local_upsample2x_flow(flow)
        flow = level_fn([b[0] for b in pyramid[k]], [b[1] for b in pyramid[k]], flow, h >> k)
    for _ in range(finest_level):
        flow = _local_upsample2x_flow(flow)
    return flow


def _local_pipeline(prev: Blocks, nxt: Blocks, config: LKConfig, h: int) -> Blocks:
    """The full per-shard LK pipeline on row blocks (one frame pair)."""

    def level_fn(p: Blocks, q: Blocks, flow: Blocks | None, h_level: int) -> Blocks:
        return _local_lk_level(p, q, flow, config, h_level)

    return _local_family_pipeline(prev, nxt, config, h, level_fn)


Frame = torch.Tensor | Blocks


def _place(x: Frame, devices: list) -> Blocks:
    """The row blocks of a (..., H, W) frame, each on its device of
    ``devices``: a frame is split, a frame given as its blocks (what a
    captured entry's placement made) is taken as it lies."""
    blocks = list(x) if isinstance(x, (list, tuple)) else x.chunk(len(devices), dim=-2)
    return [b.to(d) for b, d in zip(blocks, devices)]


def _frame_hw(x: Frame) -> tuple[int, int]:
    """(H, W) of a frame, whole or as its row blocks."""
    if isinstance(x, (list, tuple)):
        return sum(b.shape[-2] for b in x), x[0].shape[-1]
    return tuple(x.shape[-2:])


def _run_sharded(prev: Frame, nxt: Frame, devices: list, local: Callable) -> torch.Tensor:
    """Split the rows of (..., H, W) frames over ``devices`` (or take them
    as placed), run ``local`` on the blocks, and gather the (..., H, W, 2)
    flow on the first device."""
    blocks = [_place(x, devices) for x in (prev, nxt)]
    if [b.shape for b in blocks[0]] != [b.shape for b in blocks[1]]:
        shapes = [(*x[0].shape[:-2], *_frame_hw(x)) for x in blocks]
        raise ValueError(f"frame shapes differ: {shapes[0]} vs {shapes[1]}")
    flow = local(*blocks)
    return torch.cat([f.to(devices[0]) for f in flow], dim=-3)


def one_device(devices: Sequence[torch.device]) -> torch.device | None:
    """The device that every entry of ``devices`` names, or None when they
    name more than one: whether a TP entry's frames go whole to one device
    or as row blocks to theirs (module docstring).  Devices compare as
    ``torch.device`` does, so ``cuda`` and ``cuda:0`` count as two."""
    first = devices[0]
    return first if all(d == first for d in devices) else None


def _card(device: torch.device) -> int:
    return torch.cuda.current_device() if device.index is None else device.index


def peer_access(devices: Sequence[torch.device]) -> bool:
    """Whether every two distinct cards among ``devices`` can reach each
    other's memory (``torch.cuda.can_device_access_peer``): the rule for a
    TP entry over several cards, which runs its eager body when they cannot
    (module docstring).  One card named twice, and other devices, need
    nothing."""
    cards = sorted({_card(d) for d in devices if d.type == "cuda"})
    return all(torch.cuda.can_device_access_peer(a, b) for a in cards for b in cards if a != b)


def _captured_tp(fn: Callable) -> Callable:
    """A TP entry ``fn`` (frames, ``config``, ``mesh``, ``axis_name``, ...) as
    a captured entry whose frames are placed first: whole on the space
    axis's one device, or as row blocks on its devices; it runs eagerly
    over cards without peer access (module docstring)."""
    signature = inspect.signature(fn)

    def prepare(*args, **kwargs):
        bound = signature.bind(*args, **kwargs)
        bound.apply_defaults()
        mesh, axis = bound.arguments["mesh"], bound.arguments["axis_name"]
        if axis not in mesh.axis_names:
            return None  # the eager body raises as it always has
        devices = mesh.axis_devices(axis)
        device = one_device(devices)
        if device is None and not peer_access(devices):
            return None
        for name, value in bound.arguments.items():
            if isinstance(value, torch.Tensor):
                bound.arguments[name] = (value.to(device) if device is not None
                                         else _place(value, devices))
        return bound.args, bound.kwargs

    return captured(fn, prepare)


@_captured_tp
def spatial_pyramidal_lk(
    prev: torch.Tensor,
    nxt: torch.Tensor,
    config: LKConfig,
    mesh: Mesh,
    axis_name: str = "space",
) -> torch.Tensor:
    """Dense flow for ONE frame pair row-sharded over ``mesh``.

    A captured entry (module docstring): one graph per key, across cards
    where the space axis lists several.

    Args:
      prev / nxt: (H, W) planar grayscale, H divisible by
        n_shards * 2^(levels-1).
    Returns: (H, W, 2) flow on the mesh's first device.
    """
    h, w = _frame_hw(prev)
    n = mesh.shape[axis_name]
    validate_spatial(h, w, config, n)
    return _run_sharded(
        prev, nxt, mesh.axis_devices(axis_name),
        lambda p, q: _local_pipeline(p, q, config, h),
    )


def _grid(
    prev_batch: torch.Tensor, nxt_batch: torch.Tensor, mesh: Mesh, batch_axis: str,
    space_axis: str, tp: Callable,
) -> torch.Tensor:
    """Batch groups over ``batch_axis``, each group's rows over the
    ``space_axis`` devices at that batch index through ``tp(prev, nxt,
    space_mesh)`` (a TP entry on a 1-D ``"space"`` mesh of those devices);
    (B, H, W, 2) flow on the mesh's first device."""
    b = prev_batch.shape[-3]
    nb = mesh.shape[batch_axis]
    if b % nb != 0:
        raise ValueError(f"batch {b} not divisible by {batch_axis} size {nb}")
    grid = mesh.devices.transpose(
        mesh.axis_names.index(batch_axis), mesh.axis_names.index(space_axis)
    )
    groups = zip(prev_batch.chunk(nb, dim=-3), nxt_batch.chunk(nb, dim=-3), grid)
    first = grid[0][0]
    return torch.cat(
        [tp(p, q, Mesh(list(devs), ("space",))).to(first) for p, q, devs in groups], dim=-4
    )


def grid_pyramidal_lk(
    prev_batch: torch.Tensor,
    nxt_batch: torch.Tensor,
    config: LKConfig,
    mesh: Mesh,
    batch_axis: str = "batch",
    space_axis: str = "space",
) -> torch.Tensor:
    """Combined DP x TP: a frame-pair batch over a 2-D mesh.

    The batch axis is data-parallel (no communication) and each pair's rows
    are sharded over the space axis with halo exchange: each batch group is
    one :func:`spatial_pyramidal_lk` call, a replay on the group's space
    devices (``.eager`` runs every group eagerly).

    Args:
      prev_batch / nxt_batch: (B, H, W), B divisible by the batch axis size,
        H by space-size * 2^(levels-1).
    Returns: (B, H, W, 2) flow on the mesh's first device.
    """
    return _grid_lk(False, prev_batch, nxt_batch, config, mesh, batch_axis, space_axis)


def _grid_lk(eager: bool, prev_batch, nxt_batch, config, mesh, batch_axis, space_axis):
    h, w = prev_batch.shape[-2:]
    validate_spatial(h, w, config, mesh.shape[space_axis])
    tp = spatial_pyramidal_lk.eager if eager else spatial_pyramidal_lk
    return _grid(prev_batch, nxt_batch, mesh, batch_axis, space_axis,
                 lambda p, q, space: tp(p, q, config, space))


def _grid_pyramidal_lk_eager(
    prev_batch: torch.Tensor,
    nxt_batch: torch.Tensor,
    config: LKConfig,
    mesh: Mesh,
    batch_axis: str = "batch",
    space_axis: str = "space",
) -> torch.Tensor:
    """:func:`grid_pyramidal_lk` with every group's TP call eager."""
    return _grid_lk(True, prev_batch, nxt_batch, config, mesh, batch_axis, space_axis)


grid_pyramidal_lk.eager = _grid_pyramidal_lk_eager
