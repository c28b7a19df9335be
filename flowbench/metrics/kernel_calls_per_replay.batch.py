"""Kernel calls per replay of the batch entry's graphs: each graph's summed
launch counters' change over its captured call (``capture.stats()``'s
``launches``: the wrappers' ``launches`` totals, not their ``launches_*``
sub-counts such as ``launches_centered``), with its cond branches' changes
per replay that took them, weighted by its replays.  One wrapper call is
one count, whatever CUDA launches it issues (``hs_relax``'s chunks are one
call).  None when the port records no ``launches`` per graph."""

from flowbench.program import stats


def _total(change: dict) -> int:
    return sum(n for name, n in change.items() if name.endswith(".launches"))


def read(r):
    st = stats()
    if st is None:
        return None
    calls = replays = 0
    for entry in st["entries"]:
        for g in entry["graphs"]:
            if "launches" not in g:
                return None
            calls += _total(g["launches"]) * g["replays"]
            for (t, f), (dt, df) in zip(g["taken"], g.get("branch_launches", [])):
                calls += _total(dt) * t + _total(df) * f
            replays += g["replays"]
    return calls / replays if replays else None
