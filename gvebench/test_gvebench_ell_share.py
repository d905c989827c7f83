"""The readers of the move phase's K1 share (``ell_share.cold``,
``ell_share.stream``): on a synthetic span store joined to a synthetic
record, 100 and 0 and a mix of rounds; None without the store's record,
without any counted round, or without the program's span module; and a
number from a traced CPU run of each cell that lists them, where
``"auto"`` keeps the sort-reduce scanners (0)."""

import sys

import pytest

from gvebench.test_gvebench_spans import (  # noqa: F401 (store: a fixture)
    COLD, COLD_TREES, STORE, STREAM, STREAM_TREES, _run, _store, store)
from repro_torch.core import spans

READERS = {"ell_share.cold": COLD, "ell_share.stream": STREAM}
CELLS = {"graph500-22.cold": "ell_share.cold",
         "graph500-22.ds-stream": "ell_share.stream",
         "graph500-22.df-stream": "ell_share.stream"}

SHARES = [({"scan.ell_rounds": 28}, 100.0),
          ({"scan.full_rounds": 28}, 0.0),
          ({"scan.compact_rounds": 4}, 0.0),
          ({"scan.ell_rounds": 24, "scan.full_rounds": 4,
            "scan.compact_rounds": 4, "scan.compact_fallbacks": 1}, 75.0)]


@pytest.mark.parametrize("counters,want", SHARES)
@pytest.mark.parametrize("name", sorted(READERS))
def test_ell_share_on_synthetic_counters(bench, store, name, counters, want):
    store(STORE, counters)
    assert bench.reader(name)(READERS[name]) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(READERS))
def test_ell_share_reads_none_without_the_record_or_a_round(
        bench, store, monkeypatch, name):
    read = bench.reader(name)
    record = READERS[name]
    kind = "calls" if record["kind"] == "cold" else "batches"
    rounds = {"scan.ell_rounds": 3}
    # A stale store: one call or batch of the record is not in it.
    store(STORE, rounds)
    stale = dict(record, **{kind: record[kind] + [
        dict(record[kind][0], total_seconds=9.0, apply_seconds=9.0)]})
    assert read(stale) is None
    assert read({"kind": record["kind"], kind: []}) is None
    # The other loop's record.
    other = STREAM if record is COLD else COLD
    assert read(other) is None
    # The record's spans, but no round counted (the parent of the counters).
    store(_store(COLD_TREES + STREAM_TREES), {})
    assert read(record) is None
    # A control run: nothing of the program recorded.
    store([], rounds)
    assert read(record) is None
    # A program without a span module.
    store(STORE, rounds)
    monkeypatch.delitem(sys.modules, "repro_torch.core.spans")
    assert read(record) is None


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_traced_cpu_run_reads_the_ell_share(bench, cell):
    res = _run(bench, cell)
    assert res["correct"] is True
    assert res["metrics"][CELLS[cell]]["value"] == 0.0
    counters = spans.session().counters
    assert "scan.ell_rounds" not in counters
