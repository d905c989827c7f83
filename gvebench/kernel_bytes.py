"""The bytes-once models of the port's kernels, frozen with the benchmark:
the least traffic each kernel's function needs, every input byte read
once and every output byte written once (the models ``chip_smoke.py``
used for the kernel table).  Both kernels work over a sorted slot list of
``total`` slots plus one trailing sentinel slot."""

from typing import Iterable, Optional

from gvebench import peaks, trace


def k3_bytes(total: int) -> int:
    """K3 (``csrc/coarsen.cu``): reads ci, cj (int32) and w (float32) of
    each slot, writes emit (1 B), pos, g_src, g_dst (int32) and g_w
    (float32) of each slot and the sentinel."""
    return 12 * total + 17 * (total + 1)


def k4_bytes(total: int) -> int:
    """K4 (``csrc/batch_apply.cu``): reads src, dst (int32), w (float32)
    and the batch flag (1 B) of each slot, writes keep (1 B), pos, src,
    dst (int32), w (float32) and the changed flag (1 B) of each slot and
    the sentinel."""
    return 13 * total + 18 * (total + 1)


def roofline(record: dict, pattern: str, model,
             launches: Iterable[int]) -> Optional[float]:
    """Per cent of the bytes-once bound that the traced launches of the
    kernel named by ``pattern`` reached: the least time the slot counts
    ``launches`` (one per launch) need at the card's HBM peak over the
    launches' device time.  None without a trace, on a card without a
    listed peak, or when the trace's launches are not the ones counted."""
    timed = trace.kernel_time(record, pattern)
    bw = peaks.hbm_bytes_per_s(record.get("device_kind", ""))
    launches = list(launches)
    if timed is None or bw is None or not launches:
        return None
    count, seconds = timed
    if count != len(launches) or seconds <= 0:
        return None
    return 100.0 * sum(model(t) for t in launches) / bw / seconds
