"""The move phase's rounds through the fused ELL kernel K1 in the cold
calls (``core/ell_move.py``): 100 x ``scan.ell_rounds`` / (``scan.ell_rounds``
+ ``scan.full_rounds`` + ``scan.compact_rounds``) over the traced window, in
per cent.  Read from the program's counters (``repro_torch.core.spans``);
None unless every call of the window is found in the span store (by its
root ``louvain`` span, whose ``seconds`` is the call's ``total_seconds``),
or when no round was counted."""

import sys

from gvebench.metrics import calls

ROUNDS = ("scan.ell_rounds", "scan.full_rounds", "scan.compact_rounds")


def read(record):
    cs = calls(record)
    spans = sys.modules.get("repro_torch.core.spans")
    if not cs or spans is None:
        return None
    sess = spans.session()
    if sess.matching("louvain", (c["total_seconds"] for c in cs)) is None:
        return None
    rounds = sum(sess.counters.get(name, 0) for name in ROUNDS)
    if not rounds:
        return None
    return 100.0 * sess.counters.get("scan.ell_rounds", 0) / rounds
