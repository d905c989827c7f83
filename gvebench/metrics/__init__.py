"""Per-layer metric readers, one file per metric named in
``BENCHMARK.json``: ``read(record)`` returns the metric's value, or None
when the run's record holds nothing to read it from (then the metric is
left out of the result line).  ``record`` is what the loop kept of the
window (``kind``, the cold loop's ``calls`` with each call's passes, the
stream loop's ``batches``), ``device_kind``, and with ``--trace 1`` the
reduced profiler trace (``trace``)."""


def calls(record: dict):
    """The cold loop's calls, or None."""
    return record.get("calls") if record.get("kind") == "cold" else None


def batches(record: dict):
    """The stream loop's batches, or None."""
    return record.get("batches") if record.get("kind") == "stream" else None


def mean(values):
    values = list(values)
    return sum(values) / len(values) if values else None
