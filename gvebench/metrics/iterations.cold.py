"""Move-phase sweeps of a cold call: the sum of its passes'
``iterations``, the mean over the window's calls."""

from gvebench.metrics import calls, mean


def read(record):
    cs = calls(record)
    if not cs:
        return None
    return mean(sum(p["iterations"] for p in c["passes"]) for c in cs)
