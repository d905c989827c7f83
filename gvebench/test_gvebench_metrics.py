"""Each per-layer reader on synthetic records, and the trace reduction on a
synthetic profiler trace."""

from types import SimpleNamespace

import pytest

from gvebench import trace
from gvebench.kernel_bytes import k3_bytes, k4_bytes

H100 = "NVIDIA H100 80GB HBM3"


def _pass(it, lm, agg, e_cap):
    return {"iterations": it, "local_move": lm, "aggregate": agg,
            "e_cap": e_cap}


COLD = {"kind": "cold", "device_kind": H100, "calls": [
    {"total_seconds": 2.0, "passes": [_pass(10, 0.8, 0.05, 1000),
                                      _pass(3, 0.9, 0.0, 200)]},
    {"total_seconds": 2.2, "passes": [_pass(12, 1.0, 0.07, 1000),
                                      _pass(1, 0.8, 0.0, 200)]}]}
STREAM = {"kind": "stream", "device_kind": H100, "batches": [
    {"batch_size": 10, "apply_seconds": 0.05, "update_seconds": 0.4,
     "frontier_size": 50, "n_vertices": 100, "k4_slots": [120]},
    {"batch_size": 10, "apply_seconds": 0.07, "update_seconds": 0.6,
     "frontier_size": 70, "n_vertices": 100, "k4_slots": [140, 260]}]}


def _trace(kernels, busy=1.0, window=4.0):
    return {"busy_s": busy, "window_s": window, "kernels": kernels}


@pytest.mark.parametrize("name,record,want", [
    ("loop_ms.cold", COLD, 1e3 * ((2.0 - 1.75) + (2.2 - 1.87)) / 2),
    ("local_move_ms.cold", COLD, 1e3 * (1.7 + 1.8) / 2),
    ("iterations.cold", COLD, (13 + 13) / 2),
    ("aggregate_ms.cold", COLD, 1e3 * (0.05 + 0.07) / 2),
    ("apply_ms.stream", STREAM, 1e3 * 0.06),
    ("update_ms.stream", STREAM, 1e3 * 0.5),
    ("frontier_frac.stream", STREAM, 60.0),
])
def test_span_and_counter_readers(bench, name, record, want):
    read = bench.reader(name)
    assert read(record) == pytest.approx(want)
    other = STREAM if record is COLD else COLD
    assert read(other) is None
    assert read({"kind": record["kind"]}) is None


def test_k3_roofline(bench):
    read = bench.reader("k3_roofline.cold")
    assert read(COLD) is None                      # no trace, nothing read
    t = 2 * k3_bytes(1000) / 3.35e12 / 0.5         # 50% of the bound
    rec = dict(COLD, trace=_trace({"void coarsen_onepass(int const*)":
                                   [2, t], "other": [9, 1.0]}))
    assert read(rec) == pytest.approx(50.0)
    # Launches that are not the counted ones give no share, nor does a
    # card without a listed peak.
    rec_bad = dict(rec, trace=_trace({"coarsen_onepass": [3, t]}))
    assert read(rec_bad) is None
    assert read(dict(rec, device_kind="other card")) is None


def test_k4_roofline(bench):
    read = bench.reader("k4_roofline.stream")
    t = sum(k4_bytes(s) for s in (120, 140, 260)) / 3.35e12 / 0.8
    rec = dict(STREAM, trace=_trace({"resolve_onepass<>": [3, t]}))
    assert read(rec) == pytest.approx(80.0)
    assert read(dict(STREAM, trace=_trace({}))) is None


@pytest.mark.parametrize("name,record", [("idle_share.cold", COLD),
                                         ("idle_share.stream", STREAM)])
def test_idle_share(bench, name, record):
    read = bench.reader(name)
    assert read(record) is None
    assert read(dict(record, trace=_trace({}, 1.0, 4.0))) == pytest.approx(
        75.0)


class _Event:
    def __init__(self, kind, name, start, end, annotation=False):
        self.kind, self._name = kind, name
        self.start, self.end, self.annotation = start, end, annotation

    def device_type(self):
        return SimpleNamespace(name=self.kind)

    def name(self):
        return self._name

    def start_ns(self):
        return self.start

    def duration_ns(self):
        return self.end - self.start

    def is_user_annotation(self):
        return self.annotation


def test_trace_reduction():
    ev = [_Event("CPU", "gvebench.call", 0, 100, True),
          _Event("CPU", "gvebench.call", 100, 200, True),
          _Event("CUDA", "gvebench.call", 0, 200, True),   # GPU-side span
          _Event("CPU", "aten::sort", 5, 65),
          _Event("CPU", "aten::item", 100, 170),
          _Event("CUDA", "k_a", 10, 40),
          _Event("CUDA", "k_b", 30, 60),                    # overlaps k_a
          _Event("CUDA", "k_a", 170, 190)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: ev)))
    tr = trace.summarize(prof)
    assert tr["window_s"] == pytest.approx(200e-9)
    assert tr["busy_s"] == pytest.approx(70e-9)
    assert tr["kernels"] == {"k_a": [2, pytest.approx(50e-9)],
                             "k_b": [1, pytest.approx(30e-9)]}
    assert tr["device_ops"][0][0] == "k_a"
    gaps = tr["idle_gaps"]
    # Each gap is named by what was open at its middle.
    assert gaps[0] == ["gvebench.call / aten::item", pytest.approx(110e-9)]
    assert [g[1] for g in gaps] == pytest.approx([110e-9, 10e-9, 10e-9])
    assert gaps[1][0] == "gvebench.call / aten::sort"
    assert gaps[2][0] == "gvebench.call / no torch op"
    assert trace.idle_share({"trace": tr}) == pytest.approx(65.0)
