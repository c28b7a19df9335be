"""Carry configuration and stream state across from the JAX package.

Optical flow has no learned weights: what crosses between the two packages
is the configuration and the carried streaming state.  Neither function
imports jax; they read plain dataclass fields and numpy arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cuda_optical_flow_2_torch.config import BilateralConfig, LKConfig
from cuda_optical_flow_2_torch.models.streaming import FlowState

__all__ = ["lk_config_from_jax", "flow_state_from_numpy"]


def lk_config_from_jax(cfg) -> LKConfig:
    """The port's :class:`LKConfig` with the fields of ``cfg``, any dataclass
    with ``LKConfig``'s fields (such as the JAX package's)."""
    fields = dataclasses.asdict(cfg)
    if fields.get("prefilter") is not None:
        fields["prefilter"] = BilateralConfig(**fields["prefilter"])
    return LKConfig(**fields)


def flow_state_from_numpy(pyramid, flow, device: torch.device | str = "cpu") -> FlowState:
    """A streaming :class:`FlowState` from numpy-convertible arrays: the
    pyramid levels (level 0 first) and the carried flow (or None)."""

    def tensor(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, np.float32)).to(device)

    return FlowState(
        tuple(tensor(level) for level in pyramid), None if flow is None else tensor(flow)
    )
