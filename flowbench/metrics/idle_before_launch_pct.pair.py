"""Share of the traced slice's device-idle time (gaps between merged device
intervals) that lies between a captured call's start and its launch: the
card idle while the host is inside the port before the replay."""

from flowbench.program import idle_before_launch_pct


def read(r):
    return idle_before_launch_pct(r)
