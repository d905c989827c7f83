"""Delta screening's seed frontier (``core/engine.affected_frontier``): the
mean over the window's batches of ``frontier_size / n_vertices``, in per
cent."""

from gvebench.metrics import batches, mean


def read(record):
    bs = batches(record)
    if not bs:
        return None
    return 100.0 * mean(b["frontier_size"] / max(b["n_vertices"], 1)
                        for b in bs)
