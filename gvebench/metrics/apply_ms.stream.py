"""Batch-apply time (``core/delta.py``, K4): the mean of the window's
batches' ``apply_seconds``, in ms."""

from gvebench.metrics import batches, mean


def read(record):
    bs = batches(record)
    if not bs:
        return None
    return 1e3 * mean(b["apply_seconds"] for b in bs)
