"""Host ms per call inside the entry (key, copy-in, replay, clone; no
synchronise inside), the mean over the window's calls: the benchmark's own
span around the port's entry."""

from flowbench.layers import host_ms


def read(r):
    return host_ms(r)
