"""A stand-in for ``capture.Graph`` on the CPU, shared by the captured-entry
tests (``tests/test_torch_capture.py``, ``tests/test_torch_capture_parallel.py``).

``StandInGraph`` is ``capture.Graph`` with its three CUDA methods replaced:
no warm-up; the body runs where the real graph is captured; and on every
replay the body runs again, the launch counters set back around it, with
its results copied into the capture's outputs as a replay rewrites the
static outputs in place.  The buffers, the copy-in, the counters' delta and
the errors are ``capture.Graph``'s own code.  The ``stand_in`` fixture
routes CPU tensors through the capture logic with it.
"""

import pytest

from cuda_optical_flow_2_torch import capture


class StandInGraph(capture.Graph):
    built = 0

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        StandInGraph.built += 1

    def _warm_up(self, body):
        pass

    def _capture(self, body):
        self.body = body
        return body(*self.inputs)

    def _launch(self):
        counts = capture.snapshot()
        _, fresh = capture.flatten(self.body(*self.inputs))
        capture.restore(counts)
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
