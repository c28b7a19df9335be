"""A stand-in for the port whose calls take a set time on the host, one of
them far longer: the loops' arithmetic without the flow."""

from __future__ import annotations

import time

import torch


class FakePort:
    def __init__(self, cell, call_s: float, stall_at=None, stall_s: float = 0.3):
        self.config = None
        self.call_s, self.stall_at, self.stall_s = call_s, stall_at, stall_s
        self.calls = 0
        self.recovery_config = lambda **kw: kw

    def _wait(self):
        # the set-up's calls are not counted toward the stall
        time.sleep(self.stall_s if self.calls == self.stall_at else self.call_s)
        self.calls += 1

    def entry(self, prev, nxt, config):
        self._wait()
        return torch.zeros(prev.shape + (2,))

    def init_state(self, frame, config, recovery):
        return "state"

    def step(self, state, frames, config, warm, recovery):
        self._wait()
        return state, torch.zeros(frames.shape + (2,))

    def release(self):
        pass
