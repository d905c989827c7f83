"""The traced run's reduction: device busy time, kernel time by name and
the idle gaps, read from ``torch.profiler``'s trace of the window.

The window is the span from the start of the benchmark's first
``record_function`` span to the end of its last.  An operation on the
device is every kernel, copy and set that the trace shows on the card;
its busy time is the union of their intervals inside the window.  An idle
gap is a stretch of the window with none of them running, named by the
benchmark span open at its middle and the innermost host operation running
then (what the host was doing while the card waited; "no torch op" is
Python or NumPy work of the host).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

#: Prefix of the benchmark's own spans.
SPAN = "gvebench."
#: Entries kept in each list of the result line's ``breakdown``.
TOP = 10


def _events(prof):
    res = getattr(prof.profiler, "kineto_results", None)
    if res is None:
        raise RuntimeError("torch.profiler gave no kineto results")
    dev, spans, host = [], [], []
    for e in res.events():
        kind = e.device_type().name
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        if kind == "CUDA":
            if not e.is_user_annotation():
                dev.append((start, end, e.name()))
        elif kind == "CPU":
            name = e.name()
            if e.is_user_annotation():
                if name.startswith(SPAN):
                    spans.append((start, end, name))
            else:
                host.append((start, end, name))
    return dev, spans, host


def summarize(prof) -> Optional[dict]:
    """{busy_s, window_s, kernels: {name: [launches, seconds]},
    device_ops, idle_gaps} of a profiled window, or None when the trace
    holds no benchmark span."""
    dev, spans, host = _events(prof)
    if not spans:
        return None
    w0 = min(s for s, _, _ in spans)
    w1 = max(e for _, e, _ in spans)
    kernels = {}
    for s, e, name in dev:
        k = kernels.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += (e - s) / 1e9
    # Union of the device intervals inside the window, and the gaps
    # between them.
    busy, gaps, cursor = 0, [], w0
    for s, e, _ in sorted(dev):
        s, e = max(s, w0), min(e, w1)
        if e <= s or e <= cursor:
            continue
        if s > cursor:
            gaps.append((cursor, s))
        busy += e - max(s, cursor)
        cursor = e
    if cursor < w1:
        gaps.append((cursor, w1))
    gaps.sort(key=lambda g: g[0] - g[1])
    gaps = gaps[:TOP]
    device_ops = sorted(([name[:120], sec] for name, (_, sec)
                         in kernels.items()), key=lambda kv: -kv[1])[:TOP]
    in_span, in_op = _Innermost(spans), _Innermost(host)
    return {"busy_s": busy / 1e9, "window_s": (w1 - w0) / 1e9,
            "kernels": kernels, "device_ops": device_ops,
            "idle_gaps": [[f"{in_span((t + e) // 2) or 'outside spans'} / "
                           f"{in_op((t + e) // 2) or 'no torch op'}",
                           (e - t) / 1e9] for t, e in gaps]}


class _Innermost:
    """The name of the latest-starting event open at a time."""

    def __init__(self, events):
        self.names = [name for _, _, name in events]
        self.start = np.fromiter((s for s, _, _ in events), np.int64,
                                 len(events))
        self.end = np.fromiter((e for _, e, _ in events), np.int64,
                               len(events))

    def __call__(self, t: int) -> Optional[str]:
        open_ = np.nonzero((self.start <= t) & (self.end > t))[0]
        if not open_.size:
            return None
        return self.names[int(open_[np.argmax(self.start[open_])])]


def idle_share(record: dict) -> Optional[float]:
    """Per cent of the traced window with nothing running on the card."""
    tr = record.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def kernel_time(record: dict, pattern: str):
    """(launches, device seconds) of the kernels whose name holds
    ``pattern``, or None without a trace."""
    tr = record.get("trace")
    if not tr:
        return None
    n, sec = 0, 0.0
    for name, (count, total) in tr["kernels"].items():
        if pattern in name:
            n += count
            sec += total
    return n, sec
