"""Warm-update time (``core/dynamic.py``: screening and the warm
``louvain()`` passes): the mean of the window's batches'
``update_seconds``, in ms."""

from gvebench.metrics import batches, mean


def read(record):
    bs = batches(record)
    if not bs:
        return None
    return 1e3 * mean(b["update_seconds"] for b in bs)
