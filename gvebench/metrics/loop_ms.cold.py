"""Pass-loop time of a cold call outside the move phase and aggregation
(``core/louvain.py``: renumbering and folding, the per-pass copies of each
level to the host, the final ``np.unique``): the call's
``total_seconds`` less its passes' ``local_move`` and ``aggregate``
seconds, in ms, the mean over the window's calls."""

from gvebench.metrics import calls, mean


def read(record):
    cs = calls(record)
    if not cs:
        return None
    return 1e3 * mean(c["total_seconds"] - sum(p["local_move"] + p["aggregate"]
                                               for p in c["passes"])
                      for c in cs)
