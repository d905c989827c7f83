"""Per cent of the traced window of streamed batches with nothing running
on the card."""

from gvebench.metrics import batches
from gvebench.trace import idle_share


def read(record):
    return idle_share(record) if batches(record) else None
