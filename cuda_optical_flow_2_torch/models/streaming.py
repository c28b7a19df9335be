"""Streaming video flow: carried pyramid state across frames.

Counterpart of ``cuda_optical_flow_2_tpu.models.streaming``, model-generic
over the five families: ``config`` is the port's :class:`LKConfig`,
``HSConfig``, ``FBConfig``, ``TVL1Config`` or ``DISConfig`` and selects the
preprocess and the coarse-to-fine solve.  Any other config (a JAX config
included) raises ``TypeError``.

    state = init_state(first_frame, config)
    for frame in frames:
        state, flow = step(state, frame, config)

The state lives on the device of the frames.  With a prefilter in the config
the carried pyramid is the prefiltered one.  The serving configuration is a
shallow pyramid with ``warm_start=True``: each pair is seeded with the
previous pair's flow.  With a :class:`RecoveryConfig` every warm step first
checks the seed at the deepest carried pyramid level (one warp through the
``warp_select`` kernel on the kernel path) and re-acquires over a deeper
pyramid after a scene cut.

On CUDA tensors ``init_state`` and ``step`` replay CUDA graphs captured once
per key (``capture``), the counterpart of the JAX package's jitted pair: one
replay per call, the recovery check's two solves under one ``capture.cond``
(JAX's ``lax.cond``), and the state donated (JAX's ``donate_argnums=(0,)``).
The eager bodies ``_init_state`` and ``_step`` run on CPU tensors and under
autograd.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from cuda_optical_flow_2_torch import capture
from cuda_optical_flow_2_torch.config import LKConfig
from cuda_optical_flow_2_torch.kernels import warp_select
from cuda_optical_flow_2_torch.models.dis import DISConfig, dis_coarse_to_fine, dis_preprocess
from cuda_optical_flow_2_torch.models.farneback import FBConfig, fb_coarse_to_fine, fb_preprocess
from cuda_optical_flow_2_torch.models.horn_schunck import (
    HSConfig,
    hs_coarse_to_fine,
    hs_preprocess,
)
from cuda_optical_flow_2_torch.models.lucas_kanade import _validate, coarse_to_fine, preprocess
from cuda_optical_flow_2_torch.models.tvl1 import (
    TVL1Config,
    tvl1_coarse_to_fine,
    tvl1_preprocess,
)
from cuda_optical_flow_2_torch.ops.resize import downsample_flow
from cuda_optical_flow_2_torch.ops.warp import warp_bilinear

__all__ = [
    "FlowState", "RecoveryConfig", "init_state", "step", "process_sequence", "resolve_device",
]


@dataclasses.dataclass(frozen=True)
class RecoveryConfig:
    """Scene-cut detection + warm-state recovery policy for warm streaming.

    The seed is dropped, and the pair solved cold over ``levels`` pyramid
    levels, when the mean photometric residual of the deepest carried level
    warped by the seed is not below ``ratio`` times the zero-flow residual,
    unless the seed's mean magnitude there is below ``seed_floor`` px.  Cold
    starts also solve at ``levels``.  The JAX package's docstring gives the
    measurements behind the defaults.
    """

    levels: int = 3
    ratio: float = 0.7
    seed_floor: float = 0.25

    def __post_init__(self) -> None:
        if self.levels < 1:
            raise ValueError(f"levels must be >= 1, got {self.levels}")
        if not 0.0 < self.ratio:
            raise ValueError(f"ratio must be > 0, got {self.ratio}")
        if self.seed_floor < 0:
            raise ValueError(f"seed_floor must be >= 0, got {self.seed_floor}")


class FlowState(NamedTuple):
    """Carried per-stream state: the previous frame's pyramid (coarse last)
    and, when warm-starting, the previous pair's flow (else None)."""

    pyramid: tuple[torch.Tensor, ...]
    flow: torch.Tensor | None = None


_FAMILIES = (LKConfig, HSConfig, FBConfig, TVL1Config, DISConfig)


def not_ported(config) -> TypeError:
    """The error for a config of no family of the port (a JAX config included:
    ``interop`` converts one)."""
    return TypeError(
        "config must be the port's LKConfig, HSConfig, FBConfig, TVL1Config or DISConfig; "
        f"got {type(config).__module__}.{type(config).__qualname__} (convert a JAX config "
        "with cuda_optical_flow_2_torch.interop)"
    )


def _require_ported(config) -> None:
    if not isinstance(config, _FAMILIES):
        raise not_ported(config)


def _carry_config(config, recovery: RecoveryConfig | None):
    """The config whose pyramid depth the carried state is built at."""
    if recovery is None or recovery.levels <= config.levels:
        return config
    return dataclasses.replace(config, levels=recovery.levels)


def _preprocess(frame: torch.Tensor, config) -> list[torch.Tensor]:
    """Model-generic preprocess, dispatched on the config type."""
    if isinstance(config, HSConfig):
        return hs_preprocess(frame, config)
    if isinstance(config, FBConfig):
        return fb_preprocess(frame, config)
    if isinstance(config, TVL1Config):
        return tvl1_preprocess(frame, config)
    if isinstance(config, DISConfig):
        return dis_preprocess(frame, config)
    return preprocess(frame, config)


def _flow(prev_pyr, next_pyr, config, init_flow=None) -> torch.Tensor:
    """Model-generic coarse-to-fine solve over carried pyramids."""
    if isinstance(config, HSConfig):
        return hs_coarse_to_fine(list(prev_pyr), list(next_pyr), config, init_flow)
    if isinstance(config, FBConfig):
        return fb_coarse_to_fine(list(prev_pyr), list(next_pyr), config, init_flow)
    if isinstance(config, TVL1Config):
        return tvl1_coarse_to_fine(list(prev_pyr), list(next_pyr), config, init_flow)
    if isinstance(config, DISConfig):
        return dis_coarse_to_fine(list(prev_pyr), list(next_pyr), config, init_flow)
    return coarse_to_fine(list(prev_pyr), list(next_pyr), config, init_flow)[0]


def _init_state(frame: torch.Tensor, config, recovery: RecoveryConfig | None = None) -> FlowState:
    """The eager :func:`init_state`."""
    _require_ported(config)
    return FlowState(tuple(_preprocess(frame.to(torch.float32), _carry_config(config, recovery))))


def _prepare(state: FlowState, frame: torch.Tensor, config, warm_start: bool,
             recovery: RecoveryConfig | None):
    """A step's checks, the new frame's pyramid and the warm seed at the
    coarsest tracking level (None unless warm with a carried flow)."""
    _require_ported(config)
    if recovery is not None and not warm_start:
        raise ValueError("recovery requires warm_start=True")
    pyr = _preprocess(frame.to(torch.float32), _carry_config(config, recovery))
    if len(state.pyramid) != len(pyr):
        raise ValueError(
            f"state carries {len(state.pyramid)} pyramid levels but this "
            f"config/recovery needs {len(pyr)}; build the state with "
            f"init_state(frame, config, recovery)"
        )
    init = None
    if warm_start and state.flow is not None:
        init = downsample_flow(
            state.flow, tuple(pyr[config.levels - 1].shape[-2:]), config.use_pallas
        )
    return pyr, init


def _seed_ok(state: FlowState, pyr, config, recovery: RecoveryConfig) -> torch.Tensor:
    """The acquisition check at the deepest carried level: whether every
    stream's seed passes (a 0-dim bool tensor on the frames' device)."""
    prev_c, next_c = state.pyramid[-1], pyr[-1]
    seed_c = downsample_flow(state.flow, tuple(next_c.shape[-2:]), config.use_pallas)
    if config.use_pallas:
        # The default 32 px budget, as the JAX check's LKConfig(levels=1).
        warped = warp_select.warp_bilinear_select(next_c, seed_c)
    else:
        warped = warp_bilinear(next_c, seed_c)
    r_seed = (warped - prev_c).abs().mean(dim=(-2, -1))
    r_zero = (next_c - prev_c).abs().mean(dim=(-2, -1))
    small_seed = seed_c.abs().mean(dim=(-3, -2, -1)) < recovery.seed_floor
    return (small_seed | (r_seed < recovery.ratio * r_zero)).all()


def _warm(state: FlowState, pyr, init: torch.Tensor, config) -> torch.Tensor:
    """The warm solve over the tracking levels, seeded with ``init``."""
    return _flow(state.pyramid[: config.levels], pyr[: config.levels], config, init)


def _cold(state: FlowState, pyr, config, recovery: RecoveryConfig | None) -> torch.Tensor:
    """The unseeded solve over every carried level."""
    return _flow(state.pyramid, pyr, _carry_config(config, recovery), None)


def _step(
    state: FlowState,
    frame: torch.Tensor,
    config,
    warm_start: bool = False,
    recovery: RecoveryConfig | None = None,
) -> tuple[FlowState, torch.Tensor]:
    """The eager :func:`step`."""
    pyr, init = _prepare(state, frame, config, warm_start, recovery)
    if recovery is None:
        flow = _flow(state.pyramid, pyr, config, init)
        return FlowState(tuple(pyr), flow if warm_start else None), flow
    if init is None:
        flow = _cold(state, pyr, config, recovery)
    else:
        flow = capture.cond(_seed_ok(state, pyr, config, recovery),
                            lambda: _warm(state, pyr, init, config),
                            lambda: _cold(state, pyr, config, recovery))
    return FlowState(tuple(pyr), flow), flow


# On CUDA tensors init_state and step replay graphs captured once per key (the
# config, the recovery, warm_start, the tensors' shapes, dtypes and device,
# and whether the state carries a flow), as the JAX package jits them; step
# donates its state, as JAX's step does.
_init_state_graphs = capture.captured(_init_state)
_step_graphs = capture.captured(_step, donate_argnums=(0,))


def init_state(
    frame: torch.Tensor, config, recovery: RecoveryConfig | None = None
) -> FlowState:
    """Build the initial state from the first frame.  ``config`` is the
    port's LKConfig, HSConfig, FBConfig, TVL1Config or DISConfig.  Pass the same ``recovery`` given to
    :func:`step`: the state then carries the deeper acquisition pyramid.

    On CUDA tensors a replay of a captured graph (``capture.captured``); on
    CPU tensors, or under autograd with an input that requires grad, the
    eager body."""
    return _init_state_graphs(frame, config, recovery)


def step(
    state: FlowState,
    frame: torch.Tensor,
    config,
    warm_start: bool = False,
    recovery: RecoveryConfig | None = None,
) -> tuple[FlowState, torch.Tensor]:
    """One frame step: returns (new state, dense flow prev -> frame).

    ``warm_start=True`` seeds the coarsest level with the previous pair's
    flow.  ``recovery`` (warm start only) checks that seed and, if any
    stream of the batch fails the check, re-solves the whole batch at the
    deep config (the JAX package's ``lax.cond`` rule, ``capture.cond``).

    On CUDA tensors one replay of a graph captured for the key, recovery
    included: the check and both solves are in the graph as conditional
    nodes, so the host reads nothing.  The state is donated, as in JAX: a
    state that a warm step returned is the key's own buffers, and passing it
    to the next step copies only the frame in.  Such a state keeps its
    values while the caller holds it (or a view of it); a step writes those
    buffers again only once the caller has let go of them, so a state may be
    kept, or passed twice, at the cost of a copy.  The returned flow is a
    clone that later steps leave alone.  On CPU tensors, or under autograd
    with an input that requires grad, the eager body runs.
    """
    return _step_graphs(state, frame, config, warm_start, recovery)


def resolve_device(device: torch.device | str | None) -> torch.device:
    """The device for data that arrives as arrays: ``device`` when given,
    else the CUDA device; with no CUDA device the caller must ask for the
    CPU explicitly (``device="cpu"``), so nothing runs there unasked."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run on the CPU (plain PyTorch versions)"
        )
    return torch.device("cuda")


def _as_frame(frame, device: torch.device | str | None) -> torch.Tensor:
    """A tensor keeps its device; anything else goes to ``resolve_device``."""
    if isinstance(frame, torch.Tensor):
        return frame
    return torch.as_tensor(frame, device=resolve_device(device))


def process_sequence(
    frames,
    config,
    warm_start: bool = False,
    recovery: RecoveryConfig | None = None,
    device: torch.device | str | None = None,
):
    """Yield (frame_index, flow) for frames[1:].

    ``frames`` is any iterable of (H, W) arrays or tensors.  A tensor stays
    on its device; an array goes to ``device``, which defaults to the CUDA
    device and must be given as ``"cpu"`` to run on the CPU (send uint8
    frames: the cast to float32 happens on the device).  A ``None`` element
    (a decode failure) is skipped: no flow is yielded for it, the next good
    frame pairs with the last good one, and the carried warm flow is
    dropped.  ``config`` (LKConfig, HSConfig, FBConfig, TVL1Config or
    DISConfig) selects the family.
    """
    _require_ported(config)
    it = iter(frames)
    first = None
    offset = 0
    for offset, frame in enumerate(it):
        if frame is not None:
            first = _as_frame(frame, device)
            break
    if first is None:
        return
    _validate(first, first, _carry_config(config, recovery))
    state = init_state(first, config, recovery)
    for i, frame in enumerate(it, start=offset + 1):
        if frame is None:
            if state.flow is not None:
                state = FlowState(state.pyramid, None)
            continue
        state, flow = step(state, _as_frame(frame, device), config, warm_start, recovery)
        yield i, flow
