"""Host work of a cold call (``core/louvain.py``'s host spans: the start,
``louvain.start``; each pass's level copy, ``louvain.level``; the final
``np.unique``, ``louvain.finish``): per call, the sum of its host spans,
in ms, the mean over the window's calls.  Read from the program's span
store (``repro_torch.core.spans``, recorded while the profiler runs), each
call found by its root ``louvain`` span, whose ``seconds`` is the call's
``total_seconds``; None unless every call is found."""

import sys

from gvebench.metrics import calls, mean


def read(record):
    cs = calls(record)
    spans = sys.modules.get("repro_torch.core.spans")
    if not cs or spans is None:
        return None
    sess = spans.session()
    roots = sess.matching("louvain", (c["total_seconds"] for c in cs))
    if roots is None:
        return None
    reqs = sess.requests()
    return 1e3 * mean(sum(s.seconds for s in reqs[r.index] if s.host)
                      for r in roots)
