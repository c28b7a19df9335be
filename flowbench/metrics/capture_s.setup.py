"""Seconds of warm-up and capture of every graph the run captured (each
graph's own timing, ``capture.stats()``): the part of set-up that capture
takes."""

from flowbench.program import capture_seconds


def read(r):
    return capture_seconds()
