"""The port's spans and counters (``repro_torch.core.spans``) inside
``louvain()`` and ``louvain_dynamic()``, on the CPU.

Off (no profiler, no ``recording()``) nothing is stored and no
``record_function`` is entered, yet every stats time is filled.  On, the
spans equal the stats they fill, nest inside their parents with one
request id, agree with the profiler trace's ``repro_torch.*`` annotations,
and leave the goldens unchanged; the compacted scanner counts its rounds
and fallbacks.
"""

import os

import networkx as nx
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import (LouvainConfig, from_networkx, louvain,
                         louvain_dynamic, sbm_graph)
from repro_torch.core import spans
from repro_torch.data import sbm_edge_stream

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "engine_memberships.npz")

NAMES = ["lesmis", "sbm", "ring_of_cliques", "gnp"]
PATHS = {"single": LouvainConfig(),
         "single_leiden": LouvainConfig(refine="leiden")}
HOST = {"louvain.start", "louvain.level", "louvain.finish",
        "dynamic.prepare", "dynamic.pad", "dynamic.finish"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def gold():
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def corpora():
    return {
        "lesmis": from_networkx(nx.les_miserables_graph(), device="cpu"),
        "sbm": sbm_graph(8, 16, 0.4, 0.01, seed=2, device="cpu")[0],
        "ring_of_cliques": from_networkx(nx.ring_of_cliques(8, 6),
                                         device="cpu"),
        "gnp": from_networkx(nx.gnp_random_graph(120, 0.05, seed=21),
                             device="cpu"),
    }


def _named(sess, name):
    return [s for s in sess.spans if s.name == name]


def _check_tree(sess):
    """Every child inside its parent, with its parent's request id; roots
    are their own request; the host flag marks the host spans."""
    for s in sess.spans:
        assert s.start_ns <= s.end_ns
        assert s.host == (s.name in HOST)
        if s.parent < 0:
            assert s.request == s.index
            continue
        up = sess.spans[s.parent]
        assert up.index < s.index
        assert up.start_ns <= s.start_ns and s.end_ns <= up.end_ns
        assert s.request == up.request


def test_off_stores_nothing_and_enters_no_record_function(corpora,
                                                          monkeypatch):
    with spans.recording():
        pass                                   # a new, empty recording
    assert not torch.autograd._profiler_enabled()

    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered while off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    res = louvain(corpora["lesmis"], LouvainConfig(refine="leiden"))
    init, batches = sbm_edge_stream(device="cpu")
    dyn = louvain_dynamic(init, batches[:2])
    sess = spans.session()
    assert sess.spans == [] and sess.counters == {}
    assert res.total_seconds > 0 and dyn.total_seconds > 0
    for p in res.passes:
        assert p.seconds > 0
        assert set(p.phase_seconds) == {"local_move", "other", "aggregate",
                                        "refine"}
        assert all(v >= 0 for v in p.phase_seconds.values())
    assert len(dyn.batch_stats) == 2
    for s in dyn.batch_stats:
        assert s.apply_seconds > 0 and s.update_seconds > 0


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("name", NAMES)
def test_louvain_spans_equal_its_stats(gold, corpora, name, path):
    with spans.recording():
        res = louvain(corpora[name], PATHS[path])
    sess = spans.session()
    np.testing.assert_array_equal(res.membership, gold[f"{path}__{name}"])
    _check_tree(sess)
    (root,) = [s for s in sess.spans if s.parent < 0]
    assert root.name == "louvain" and root.seconds == res.total_seconds
    assert [s.name for s in sess.spans[1:2]] == ["louvain.start"]
    assert sess.spans[-1].name == "louvain.finish"
    pass_spans = _named(sess, "louvain.pass")
    assert len(pass_spans) == len(res.passes)
    for p, (sp, st) in enumerate(zip(pass_spans, res.passes)):
        assert sp.attrs == {"pass": p} and sp.parent == root.index
        assert sp.seconds == st.seconds
        kids = {s.name: s for s in sess.spans if s.parent == sp.index}
        assert kids["louvain.move"].seconds == st.phase_seconds["local_move"]
        assert (kids["louvain.fold"].seconds + kids["louvain.level"].seconds
                == st.phase_seconds["other"])
        agg = kids.get("louvain.aggregate")
        assert (agg.seconds if agg else 0.0) == st.phase_seconds["aggregate"]
        assert (agg is None) == (p == len(res.passes) - 1)
        if path == "single_leiden":
            assert kids["louvain.refine"].seconds == \
                st.phase_seconds["refine"]
        else:
            assert "louvain.refine" not in kids


@pytest.mark.parametrize("n_batches", [2, 8])
def test_louvain_dynamic_spans_equal_its_stats(gold, n_batches):
    init, batches = sbm_edge_stream(device="cpu")
    with spans.recording():
        res = louvain_dynamic(init, batches[:n_batches])
    sess = spans.session()
    _check_tree(sess)
    (root,) = [s for s in sess.spans if s.parent < 0]
    assert root.name == "dynamic.call" and root.seconds == res.total_seconds
    # The cold louvain() that gives prev nests under the call.
    cold = _named(sess, "louvain")[0]
    assert cold.parent == root.index
    batch_spans = _named(sess, "dynamic.batch")
    assert [b.attrs for b in batch_spans] == [{"batch": i}
                                              for i in range(n_batches)]
    assert all(b.parent == root.index for b in batch_spans)
    for b, st in zip(batch_spans, res.batch_stats):
        kids = [s for s in sess.spans if s.parent == b.index]
        assert [s.name for s in kids] == ["dynamic.apply", "dynamic.update",
                                          "dynamic.pad"]
        assert kids[0].seconds == st.apply_seconds
        assert kids[1].seconds == st.update_seconds
        (warm,) = [s for s in sess.spans if s.parent == kids[1].index]
        assert warm.name == "louvain"
    assert [s.name for s in sess.spans if s.parent == root.index] == (
        ["louvain", "dynamic.prepare"] + ["dynamic.batch"] * n_batches
        + ["dynamic.finish"])
    if n_batches == 8:
        np.testing.assert_array_equal(res.membership,
                                      gold["dynamic__sbm_stream"])


def test_spans_agree_with_the_profiler_trace(corpora):
    init, batches = sbm_edge_stream(device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        louvain(corpora["gnp"], LouvainConfig(refine="leiden"))
        louvain_dynamic(init, batches[:2], screening="vertex")
    sess = spans.session()
    stored = sorted((spans.PREFIX + s.name, s.start_ns, s.end_ns)
                    for s in sess.spans)
    traced = sorted((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.is_user_annotation()
                    and e.name().startswith(spans.PREFIX))
    assert len(stored) > 20
    assert [s[0] for s in stored] == [t[0] for t in traced]
    for (_, s0, s1), (_, t0, t1) in zip(stored, traced):
        assert abs(s0 - t0) < 1_000_000 and abs(s1 - t1) < 1_000_000
    # Recording ended with the profiler; the store stays readable.
    assert not torch.autograd._profiler_enabled()
    louvain(corpora["gnp"])
    assert spans.session().spans == sess.spans


@pytest.mark.parametrize("cap_frac,overflows", [(0.0, True), (1.0, False)])
def test_compact_scanner_counts_rounds_and_fallbacks(gold, corpora, cap_frac,
                                                     overflows):
    """With pruning off the frontier stays whole, so a 64-slot work buffer
    overflows in every round and a buffer of ``e_cap`` slots in none."""
    g = corpora["lesmis"]
    everyone = torch.ones(g.n_cap + 1, dtype=torch.bool)
    cfg = LouvainConfig(scan_backend="compact", compact_cap_frac=cap_frac,
                        use_pruning=False)
    with spans.recording():
        res = louvain(g, cfg, init_frontier=everyone)
    counters = spans.session().counters
    assert res.passes[0].scan_backend == "compact"
    rounds = counters["scan.compact_rounds"]
    assert rounds >= res.passes[0].iterations > 0
    assert counters.get("scan.compact_fallbacks", 0) == (
        rounds if overflows else 0)
    full = louvain(g, LouvainConfig(use_pruning=False),
                   init_frontier=everyone)
    np.testing.assert_array_equal(res.membership, full.membership)
