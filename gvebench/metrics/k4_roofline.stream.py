"""K4's share of its bytes-once roofline (``csrc/batch_apply.cu``) over the
traced window's batches: each apply launches K4 once over ``e_cap + 2
b_cap`` slots (twice when the graph regrows); the bound of those slot
counts at the card's HBM peak over K4's device time in the trace, in per
cent."""

from gvebench.kernel_bytes import k4_bytes, roofline
from gvebench.metrics import batches

#: K4's kernel in the profiler's trace.
KERNEL = "resolve_onepass"


def read(record):
    bs = batches(record)
    if not bs:
        return None
    return roofline(record, KERNEL, k4_bytes,
                    (t for b in bs for t in b["k4_slots"]))
