"""Share of the serving step's replays whose recovery cond took the false
branch (the whole batch solved again at the deep config), from the
graphs' device counts (``capture.stats()``)."""

from flowbench.program import cold_step_pct


def read(r):
    return cold_step_pct()
