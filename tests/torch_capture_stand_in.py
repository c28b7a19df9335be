"""A stand-in for ``capture.Graph`` on the CPU, shared by the captured-entry
tests (``tests/test_torch_capture.py``, ``tests/test_torch_capture_parallel.py``,
``tests/test_torch_capture_donation.py``).

``StandInGraph`` is ``capture.Graph`` with its CUDA methods replaced: no
warm-up; the body runs where the real graph is captured, a ``cond``'s two
branches one after the other as the real capture records both; and on every
replay the body runs again, the launch counters set back around it, with its
results copied into the capture's outputs as a replay rewrites the static
outputs in place.  In a replay each ``cond`` runs the branch its predicate
picks and adds one to that branch's taken count, as the conditional nodes
and the adds in their bodies do on the device.  The buffers, the copy-in,
the counters' delta, the conds' bookkeeping, ``settle`` and the errors are
``capture``'s own code.  The ``stand_in`` fixture routes CPU tensors through
the capture logic with it.
"""

import contextlib

import pytest

from cuda_optical_flow_2_torch import capture


class StandInGraph(capture.Graph):
    built = 0

    def __init__(self, *args, **kwargs):
        self.replaying = False
        super().__init__(*args, **kwargs)
        StandInGraph.built += 1

    def _warm_up(self, body):
        pass

    def _capture(self, body):
        self.body = body
        return body(*self.inputs)

    def _open_cond(self, pred):
        return None, None

    @contextlib.contextmanager
    def _branch(self, handle):
        yield

    def _cond(self, pred, true_fn, false_fn, operands):
        if not self.replaying:
            return super()._cond(pred, true_fn, false_fn, operands)
        taken = self._taken_device[self.next_cond]
        self.next_cond += 1
        which = 0 if bool(pred) else 1
        taken[which] += 1
        return (true_fn, false_fn)[which](*operands)

    def _launch(self):
        counts = capture._counts()
        self.replaying, self.next_cond = True, 0
        try:
            with capture._as_mode(self):
                _, fresh = capture.flatten(self.body(*self.inputs))
        finally:
            self.replaying = False
        capture._set_counts(counts)
        for dst, src in zip(capture.flatten(self.outputs)[1], fresh, strict=True):
            dst.copy_(src)


@pytest.fixture
def stand_in(monkeypatch):
    """Route CPU tensors through the capture logic with ``StandInGraph``."""
    monkeypatch.setattr(capture, "Graph", StandInGraph)
    monkeypatch.setattr(capture, "runs_eagerly", lambda tensors: False)
    capture.clear()
    StandInGraph.built = 0
    yield
    capture.clear()
