"""K3's share of its bytes-once roofline (``csrc/coarsen.cu``) over the
traced window's calls: each aggregating pass launches K3 once over its
graph's ``e_cap`` slots; the bound of those slot counts at the card's HBM
peak over K3's device time in the trace, in per cent."""

from gvebench.kernel_bytes import k3_bytes, roofline
from gvebench.metrics import calls

#: K3's kernel in the profiler's trace.
KERNEL = "coarsen_onepass"


def read(record):
    cs = calls(record)
    if not cs:
        return None
    return roofline(record, KERNEL, k3_bytes,
                    (p["e_cap"] for c in cs for p in c["passes"]
                     if p["aggregate"] > 0))
