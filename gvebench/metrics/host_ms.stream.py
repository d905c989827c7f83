"""Host work of a streamed batch (``core/dynamic.py``'s host spans,
``dynamic.prepare``, ``dynamic.pad`` and ``dynamic.finish``, and those of
the warm ``louvain()`` inside it, ``louvain.start``, ``louvain.level`` and
``louvain.finish``): the host spans of the window's ``louvain_dynamic``
calls over the batches they streamed, in ms a batch.  Read from the
program's span store (``repro_torch.core.spans``), each batch found by its
``dynamic.apply`` span, whose ``seconds`` is the batch's
``apply_seconds``; None unless every batch is found."""

import sys

from gvebench.metrics import batches


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
    reqs = sess.requests()
    host = sum(s.seconds for r in {a.request for a in applies}
               for s in reqs[r] if s.host)
    return 1e3 * host / len(bs)
