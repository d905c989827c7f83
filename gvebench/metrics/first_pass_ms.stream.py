"""The first warm pass of a streamed batch (``louvain.pass`` with pass 0
inside its ``dynamic.batch``: the delta-screened pass from the previous
membership, through the compacted scanner when the frontier is small), in
ms, the mean over the window's batches.  Read from the program's span
store (``repro_torch.core.spans``), each batch found by its
``dynamic.apply`` span, whose ``seconds`` is the batch's
``apply_seconds``; None unless every batch is found."""

import sys

from gvebench.metrics import batches, mean


def read(record):
    bs = batches(record)
    spans = sys.modules.get("repro_torch.core.spans")
    if not bs or spans is None:
        return None
    sess = spans.session()
    applies = sess.matching("dynamic.apply",
                            (b["apply_seconds"] for b in bs))
    if applies is None:
        return None
    first = {}
    for s in sess.spans:
        if s.name == "louvain.pass" and s.attrs.get("pass") == 0:
            batch = sess.enclosing(s, "dynamic.batch")
            if batch is not None:
                first[batch.index] = s.seconds
    return 1e3 * mean(first.get(a.parent, 0.0) for a in applies)
