"""Move-phase time of a cold call (``core/local_move.py``,
``core/engine.py``, ``core/ell_move.py``): the sum of its passes'
``phase_seconds["local_move"]``, in ms, the mean over the window's calls."""

from gvebench.metrics import calls, mean


def read(record):
    cs = calls(record)
    if not cs:
        return None
    return 1e3 * mean(sum(p["local_move"] for p in c["passes"]) for c in cs)
