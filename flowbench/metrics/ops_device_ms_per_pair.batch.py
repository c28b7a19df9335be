"""Device ms per pair of the device ops that are not the port's ``of2_``
kernels: the plain torch between kernels (``ops/resize``'s upsample, casts,
stacks) and copies."""

from flowbench.layers import other_ops_ms_per_pair


def read(r):
    return other_ops_ms_per_pair(r)
