"""The readers of the program's spans and counters (``host_ms.cold``,
``host_ms.stream``, ``first_pass_ms.stream``, ``later_passes_ms.stream``,
``compact_fallback.stream``): each on a synthetic span store joined to a
synthetic record; None on a record the store does not hold (a control run,
a stale store) or without the program's span module; and a number from a
traced CPU run of each cell at its small size."""

import sys
import time

import pytest

from gvebench.conftest import small
from gvebench.harness import run_cell
from gvebench.standins import ReferenceSystem
from repro_torch.core import spans

CELLS = {"graph500-22.cold": ["host_ms.cold"],
         "graph500-22.ds-stream": ["host_ms.stream", "first_pass_ms.stream",
                                   "later_passes_ms.stream"],
         "graph500-22.df-stream": ["host_ms.stream", "first_pass_ms.stream",
                                   "later_passes_ms.stream",
                                   "compact_fallback.stream"]}
READERS = sorted({m for ms in CELLS.values() for m in ms})


def _store(trees):
    """A span store from ``(name, seconds, host, attrs, children)`` trees,
    indexed as the program indexes it (in the order the spans open)."""
    out = []

    def add(tree, parent, request):
        name, seconds, host, attrs, kids = tree
        s = spans.span(name, host, **attrs)
        s.index, s.parent, s.seconds = len(out), parent, seconds
        s.request = s.index if request is None else request
        s.start_ns = s.end_ns = 0
        out.append(s)
        for kid in kids:
            add(kid, s.index, s.request)

    for tree in trees:
        add(tree, -1, None)
    return out


def _t(name, seconds, *kids, host=False, **attrs):
    return (name, seconds, host, attrs, list(kids))


def _louvain(total, passes, start=0.001, level=0.002, finish=0.003):
    """A ``louvain`` tree: its host spans, and ``passes`` (move seconds of
    each pass, each with a level copy)."""
    return _t("louvain", total,
              _t("louvain.start", start, host=True),
              *[_t("louvain.pass", sec + level,
                   _t("louvain.move", sec), _t("louvain.fold", 0.0),
                   _t("louvain.level", level, host=True), **{"pass": p})
                for p, sec in enumerate(passes)],
              _t("louvain.finish", finish, host=True))


def _dynamic(applies, warm_passes):
    """A ``dynamic.call`` tree with one batch per apply seconds, each
    updated by a warm ``louvain`` of the given passes."""
    return _t("dynamic.call", 1.0,
              _t("dynamic.prepare", 0.004, host=True),
              *[_t("dynamic.batch", 0.5,
                   _t("dynamic.apply", a),
                   _t("dynamic.update", 0.4, _louvain(0.39, passes)),
                   _t("dynamic.pad", 0.005, host=True), batch=i)
                for i, (a, passes) in enumerate(zip(applies, warm_passes))],
              _t("dynamic.finish", 0.006, host=True))


COLD_TREES = [_louvain(2.0, [0.5, 0.25]),
              _louvain(2.2, [0.5], start=0.011, finish=0.013)]
COLD = {"kind": "cold", "calls": [
    {"total_seconds": 2.0, "passes": []},
    {"total_seconds": 2.2, "passes": []}]}
# Two calls of one batch and one of two batches.
STREAM_TREES = [_dynamic([0.05], [[0.1, 0.02, 0.01]]),
                _dynamic([0.07], [[0.3]]),
                _dynamic([0.06, 0.08], [[0.2, 0.04], [0.1, 0.06]])]
STORE = _store(COLD_TREES + STREAM_TREES)
STREAM = {"kind": "stream", "batches": [
    {"apply_seconds": a} for a in (0.05, 0.07, 0.06, 0.08)]}
COUNTERS = {"scan.compact_rounds": 40, "scan.compact_fallbacks": 6}

# Host seconds: the call's start, finish and one level copy a pass.
HOST_COLD = ((0.001 + 0.003 + 2 * 0.002) + (0.011 + 0.013 + 0.002)) / 2
# Each call's prepare and finish, and per batch its pad and its warm
# louvain's start, finish and level copies.
HOST_STREAM = (3 * (0.004 + 0.006) + 4 * (0.005 + 0.001 + 0.003)
               + (3 + 1 + 2 + 2) * 0.002) / 4
FIRST = (0.1 + 0.3 + 0.2 + 0.1 + 4 * 0.002) / 4
LATER = (0.02 + 0.01 + 0.04 + 0.06 + 4 * 0.002) / 4

WANT = {"host_ms.cold": (COLD, 1e3 * HOST_COLD),
        "host_ms.stream": (STREAM, 1e3 * HOST_STREAM),
        "first_pass_ms.stream": (STREAM, 1e3 * FIRST),
        "later_passes_ms.stream": (STREAM, 1e3 * LATER),
        "compact_fallback.stream": (STREAM, 15.0)}


@pytest.fixture
def store(monkeypatch):
    """Hands the readers a chosen span store and counters."""
    def use(spans_, counters=None):
        sess = spans.Session(spans_, dict(COUNTERS if counters is None
                                          else counters))
        monkeypatch.setattr(spans, "session", lambda: sess)
    return use


@pytest.mark.parametrize("name", READERS)
def test_reader_on_a_synthetic_store(bench, store, name):
    record, want = WANT[name]
    store(STORE)
    assert bench.reader(name)(record) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_none_where_the_store_does_not_hold_the_record(
        bench, store, monkeypatch, name):
    read = bench.reader(name)
    record, _ = WANT[name]
    kind = "calls" if record["kind"] == "cold" else "batches"
    store(STORE)
    # A stale store: one call or batch of the record is not in it.
    stale = dict(record, **{kind: record[kind] + [
        dict(record[kind][0], total_seconds=9.0, apply_seconds=9.0)]})
    assert read(stale) is None
    assert read({"kind": record["kind"], kind: []}) is None
    # A control run: nothing of the program recorded.
    store([], {})
    assert read(record) is None
    # A program without a span module (the parent of this metric).
    store(STORE)
    monkeypatch.delitem(sys.modules, "repro_torch.core.spans")
    assert read(record) is None


def test_compact_fallback_reads_none_without_a_compacted_round(bench, store):
    read = bench.reader("compact_fallback.stream")
    store(_store(STREAM_TREES), {})
    assert read(STREAM) is None
    store(_store(STREAM_TREES), {"scan.compact_rounds": 8})
    assert read(STREAM) == 0.0


def _run(bench, cell, system=None):
    return run_cell(bench, cell, 2 ** 31 + 211, 0.3, True,
                    t_start=time.perf_counter(), device="cpu",
                    system_factory=system, overrides=small(bench, cell),
                    log=lambda m: None)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_traced_cpu_run_reads_each_new_metric(bench, cell):
    res = _run(bench, cell)
    assert res["correct"] is True
    for name in CELLS[cell]:
        value = res["metrics"][name]["value"]
        assert value >= 0
    counters = spans.session().counters
    if cell.endswith("df-stream"):
        # Vertex screening at the small size takes the compacted scanner.
        assert counters["scan.compact_rounds"] > 0
    else:
        assert "scan.compact_rounds" not in counters
    # The control after it: the store still holds the program's spans,
    # which the control's record does not match.
    res = _run(bench, cell, ReferenceSystem)
    assert not set(CELLS[cell]) & set(res["metrics"])
