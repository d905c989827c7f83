"""Aggregation time of a cold call (``core/aggregate.py``, K3 and the
capacity ladder): the sum of its passes' ``phase_seconds["aggregate"]``,
in ms, the mean over the window's calls."""

from gvebench.metrics import calls, mean


def read(record):
    cs = calls(record)
    if not cs:
        return None
    return 1e3 * mean(sum(p["aggregate"] for p in c["passes"]) for c in cs)
