"""The system under test: the port's config and entry points named by a
configuration file.  This module is the only one of the harness that
imports the port (``cuda_optical_flow_2_torch``), and it does so only when
a :class:`Port` is made."""

from __future__ import annotations

import importlib

__all__ = ["Port", "attr"]


def attr(path: str):
    """``"package.module:name"`` -> the object."""
    module, _, name = path.partition(":")
    return getattr(importlib.import_module(module), name)


class Port:
    """The port's config object, its captured pair entry, its streaming
    entries and its capture module, for one configuration file."""

    def __init__(self, config: dict):
        self.config = attr(config["port_config"])(**config["fields"])
        self.entry = attr(config["entry"])
        streaming = importlib.import_module("cuda_optical_flow_2_torch.models.streaming")
        self.init_state = streaming.init_state
        self.step = streaming.step
        self.recovery_config = streaming.RecoveryConfig
        self.capture = importlib.import_module("cuda_optical_flow_2_torch.capture")

    def release(self) -> None:
        """Drop every captured graph and its memory pool."""
        self.capture.clear()
