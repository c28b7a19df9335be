"""Carry configuration and stream state across from the JAX package.

Optical flow has no learned weights: what crosses between the two packages
is the configuration and the carried streaming state.  No function here
imports jax; they read plain dataclass fields and numpy arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cuda_optical_flow_2_torch.config import BilateralConfig, LKConfig
from cuda_optical_flow_2_torch.models.dis import DISConfig
from cuda_optical_flow_2_torch.models.farneback import FBConfig
from cuda_optical_flow_2_torch.models.horn_schunck import HSConfig
from cuda_optical_flow_2_torch.models.streaming import FlowState, resolve_device
from cuda_optical_flow_2_torch.models.tvl1 import TVL1Config

__all__ = [
    "lk_config_from_jax", "hs_config_from_jax", "fb_config_from_jax", "tvl1_config_from_jax",
    "dis_config_from_jax", "flow_state_from_numpy",
]


def _fields(cfg) -> dict:
    fields = dataclasses.asdict(cfg)
    if fields.get("prefilter") is not None:
        fields["prefilter"] = BilateralConfig(**fields["prefilter"])
    return fields


def lk_config_from_jax(cfg) -> LKConfig:
    """The port's :class:`LKConfig` with the fields of ``cfg``, any dataclass
    with ``LKConfig``'s fields (such as the JAX package's)."""
    return LKConfig(**_fields(cfg))


def hs_config_from_jax(cfg) -> HSConfig:
    """The port's :class:`HSConfig` with the fields of ``cfg``, any dataclass
    with ``HSConfig``'s fields (such as the JAX package's)."""
    return HSConfig(**_fields(cfg))


def fb_config_from_jax(cfg) -> FBConfig:
    """The port's :class:`FBConfig` with the fields of ``cfg``, any dataclass
    with ``FBConfig``'s fields (such as the JAX package's)."""
    return FBConfig(**_fields(cfg))


def tvl1_config_from_jax(cfg) -> TVL1Config:
    """The port's :class:`TVL1Config` with the fields of ``cfg``, any dataclass
    with ``TVL1Config``'s fields (such as the JAX package's)."""
    return TVL1Config(**_fields(cfg))


def dis_config_from_jax(cfg) -> DISConfig:
    """The port's :class:`DISConfig` with the fields of ``cfg``, any dataclass
    with ``DISConfig``'s fields (such as the JAX package's)."""
    return DISConfig(**_fields(cfg))


def flow_state_from_numpy(pyramid, flow, device: torch.device | str | None = None) -> FlowState:
    """A streaming :class:`FlowState` from numpy-convertible arrays: the
    pyramid levels (level 0 first) and the carried flow (or None), on
    ``device`` (default the CUDA device; pass ``"cpu"`` for the CPU)."""
    dev = resolve_device(device)

    def tensor(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, np.float32)).to(dev)

    return FlowState(
        tuple(tensor(level) for level in pyramid), None if flow is None else tensor(flow)
    )
