"""Share of the traced slice in which no kernel or copy ran on the card
(merged device intervals)."""

from flowbench.layers import idle_pct


def read(r):
    return idle_pct(r)
