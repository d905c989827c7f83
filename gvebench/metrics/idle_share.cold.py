"""Per cent of the traced window of cold calls with nothing running on
the card."""

from gvebench.metrics import calls
from gvebench.trace import idle_share


def read(record):
    return idle_share(record) if calls(record) else None
