"""The compacted scanner's wasted work
(``core/local_move.compact_best_moves``): the share of its rounds whose
frontier slots overflowed the work buffer and fell back to the full scan,
100 x ``scan.compact_fallbacks`` / ``scan.compact_rounds`` over the traced
window, in per cent.  Read from the program's counters
(``repro_torch.core.spans``); None unless every batch of the window is
found in the span store (by its ``dynamic.apply`` span, whose ``seconds``
is the batch's ``apply_seconds``), or when no compacted round ran."""

import sys

from gvebench.metrics import batches


def read(record):
    bs = batches(record)
    spans = sys.modules.get("repro_torch.core.spans")
    if not bs or spans is None:
        return None
    sess = spans.session()
    if sess.matching("dynamic.apply",
                     (b["apply_seconds"] for b in bs)) is None:
        return None
    rounds = sess.counters.get("scan.compact_rounds", 0)
    if not rounds:
        return None
    return 100.0 * sess.counters.get("scan.compact_fallbacks", 0) / rounds
