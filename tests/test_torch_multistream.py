"""Batched multi-stream serving of the PyTorch port against the JAX package,
on the CPU.

The reference fleet (``sbm_holdout_stream`` seeds 10-13, ``n_cap`` 128,
``e_cap`` 1400, 4 steps, ``b_cap`` 8) goes through the JAX
``louvain_batched`` / ``louvain_dynamic_batched`` (its Pallas paths in
interpret mode, as its own tests run them) and through the port's.
Memberships, ``n_communities``, ``frontier_sizes``, ``n_regrows``,
``pass_stats`` and the final live edge multisets are exact; Q is within
1e-5.  Each stream's result also equals the port's own solo ``louvain()`` /
``louvain_dynamic()``: the batched drivers are a pure batching transform.
The fleet forms of the batch apply and of aggregation resolve every
stream's groups in ONE call of K4 / K3 (their plain versions here).
"""

import os

import jax
import numpy as np
import pytest
import torch

from golden import capture_engine_golden as capture
from test_oracle_golden import (_STREAM_SCREENING, _deletion_stream,
                                _reweight_stream)

from repro.core import engine as jengine
from repro.core.aggregate import community_vertices_csr as jcvcsr
from repro.core.delta import make_edge_batch as jmake_batch
from repro.core.graph import (build_csr as jbuild_csr,
                              connected_total_weight_check as jtotal_check,
                              empty_like_caps as jempty, rebucket_graph)
from repro.core.louvain import LouvainConfig as JConfig, louvain as jlouvain
from repro.core.multistream import (FleetCapacityOverflow as JOverflow,
                                    louvain_batched as jbatched,
                                    louvain_dynamic_batched as jdyn_batched,
                                    stack_graphs as jstack_graphs)
from repro.data import sbm_graph as jsbm_graph
from repro.data import sbm_holdout_stream as jholdout

from repro_torch import (FleetCapacityOverflow, LouvainConfig, louvain,
                         louvain_batched, louvain_dynamic,
                         louvain_dynamic_batched, membership_modularity,
                         stack_batches, stack_graphs)
from repro_torch.core import aggregate as taggregate
from repro_torch.core import delta as tdelta
from repro_torch.core.aggregate import (aggregate_fleet, aggregate_graph,
                                        community_vertices_csr,
                                        renumber_communities)
from repro_torch.core.delta import _apply_edge_batch, apply_fleet_batch
from repro_torch.core.engine import resolve_screening_host
from repro_torch.core.graph import (FleetGraph, connected_total_weight_check,
                                    empty_like_caps)
from repro_torch.core.local_move import move_phase
from repro_torch.core.louvain import singleton_init
from repro_torch.data import sbm_holdout_stream
from repro_torch.interop import edge_batch_from_numpy, graph_from_numpy
from repro_torch.kernels.aggregate.coarsen import coarsen_groups_ref
from repro_torch.kernels.batch_apply.resolve import resolve_groups_ref

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "engine_memberships.npz")
SEEDS = (10, 11, 12, 13)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def to_port(jg):
    return graph_from_numpy(np.asarray(jg.indptr), np.asarray(jg.indices),
                            np.asarray(jg.weights), np.asarray(jg.src),
                            int(jg.n_valid), int(jg.e_valid), device="cpu")


def to_port_batches(jbatches):
    return [edge_batch_from_numpy(b.src, b.dst, b.weight, b.b_valid,
                                  device="cpu") for b in jbatches]


def _case(seed, **kw):
    init, batches, _ = jholdout(seed, n_cap=kw.pop("n_cap", 128),
                                e_cap=kw.pop("e_cap", 1400), n_hold=32,
                                n_steps=4, b_cap=kw.pop("b_cap", 8))
    return init, batches


@pytest.fixture(scope="module")
def jfleet():
    cases = [_case(seed) for seed in SEEDS]
    return [c[0] for c in cases], [c[1] for c in cases]


@pytest.fixture(scope="module")
def tfleet(jfleet):
    graphs, streams = jfleet
    return [to_port(g) for g in graphs], [to_port_batches(s) for s in streams]


@pytest.fixture(scope="module")
def jdyn(jfleet):
    """The reference's ``louvain_dynamic_batched`` on the fleet, one run
    per keyword set, shared by the tests."""
    graphs, streams = jfleet
    memo = {}

    def run(**kw):
        key = repr(sorted(kw.items()))
        if key not in memo:
            jkw = dict(kw)
            if "config" in jkw:
                jkw["config"] = JConfig(**jkw["config"])
            if jkw.get("apply_backend") == "kernel":
                jkw["apply_backend"] = "pallas"
            memo[key] = jdyn_batched(graphs, streams, track_modularity=True,
                                     **jkw)
        return memo[key]
    return run


def live_edges(graph):
    """Sorted (src, dst, w) rows of a ``CSRGraph``'s live slots."""
    src = graph.src.cpu().numpy()
    live = src < graph.n_cap
    rows = np.stack([src[live], graph.indices.cpu().numpy()[live],
                     graph.weights.cpu().numpy()[live].astype(np.float64)])
    return rows[:, np.lexsort(rows[::-1])]


def jlive_edges(gb, s, n_cap):
    src = np.asarray(gb.src[s])
    live = src < n_cap
    rows = np.stack([src[live], np.asarray(gb.indices[s])[live],
                     np.asarray(gb.weights[s])[live].astype(np.float64)])
    return rows[:, np.lexsort(rows[::-1])]


def assert_dynamic_equal(got, want, n_cap):
    np.testing.assert_array_equal(got.membership, np.asarray(want.membership))
    np.testing.assert_array_equal(got.n_communities, want.n_communities)
    np.testing.assert_array_equal(got.frontier_sizes, want.frontier_sizes)
    assert got.n_regrows == want.n_regrows
    assert got.graphs.e_cap == np.asarray(want.graphs.indices).shape[1]
    np.testing.assert_array_equal(got.graphs.n_valid,
                                  np.asarray(want.graphs.n_valid))
    np.testing.assert_array_equal(got.graphs.e_valid,
                                  np.asarray(want.graphs.e_valid))
    keys = ("iterations", "n_vertices", "frontier_size", "n_cap", "e_cap",
            "screening", "scan_backend", "downgraded")
    assert ([[getattr(p, k) for k in keys] for p in got.pass_stats]
            == [[getattr(p, k) for k in keys] for p in want.pass_stats])
    for s in range(got.membership.shape[0]):
        np.testing.assert_array_equal(live_edges(got.graphs.stream(s)),
                                      jlive_edges(want.graphs, s, n_cap))
    if want.modularity is not None:
        np.testing.assert_allclose(got.modularity, want.modularity,
                                   rtol=0, atol=1e-5)


# -- inputs and small pieces ------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_sbm_holdout_stream_equals_reference(seed):
    jinit, jb, jfull = jholdout(seed, n_cap=128, e_cap=1400, n_hold=32,
                                n_steps=4, b_cap=8)
    init, batches, full = sbm_holdout_stream(
        seed, n_cap=128, e_cap=1400, n_hold=32, n_steps=4, b_cap=8,
        device="cpu")
    for got, want in ((init, jinit), (full, jfull)):
        for name in ("indptr", "indices", "weights", "src"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)))
        assert (got.n_valid, got.e_valid) == (int(want.n_valid),
                                              int(want.e_valid))
    assert len(batches) == len(jb)
    for got, want in zip(batches, jb):
        for name in ("src", "dst", "weight"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)))
        assert got.b_valid == int(want.b_valid)


@pytest.mark.parametrize("mode", [None, "community", "vertex", "auto"])
@pytest.mark.parametrize("frac", [None, 0.0, 1 / 16, 1 / 16 + 1e-6, 0.5])
def test_resolve_screening_host_equals_reference(mode, frac):
    assert (resolve_screening_host(mode, frac)
            == jengine.resolve_screening_host(mode, frac))


@pytest.mark.parametrize("name", ["lesmis", "sbm", "gnp"])
def test_community_vertices_csr_equals_reference(name):
    jg = capture.corpora()[name]
    g = to_port(jg)
    comm = louvain(g).membership
    mem = np.full(g.n_cap + 1, g.n_cap, np.int32)
    mem[:len(comm)] = comm
    want = jcvcsr(jax.numpy.asarray(mem), jg.n_valid, g.n_cap)
    got = community_vertices_csr(torch.from_numpy(mem), g.n_valid, g.n_cap)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_empty_like_caps_and_total_weight_check_equal_reference():
    want = jempty(16, 40)
    got = empty_like_caps(16, 40, device="cpu")
    for name in ("indptr", "indices", "weights", "src"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    assert (got.n_valid, got.e_valid) == (int(want.n_valid),
                                          int(want.e_valid))
    jg = capture.corpora()["lesmis"]
    assert connected_total_weight_check(to_port(jg)) == jtotal_check(jg)


def test_stack_graphs_rejects_mixed_capacities():
    g1 = to_port(_case(0, e_cap=1400)[0])
    g2 = to_port(_case(1, e_cap=1500)[0])
    with pytest.raises(ValueError, match="capacities differ"):
        stack_graphs([g1, g2])


def test_stack_batches_rejects_mixed_capacities():
    b1 = to_port_batches(_case(0, b_cap=8)[1])
    b2 = to_port_batches(_case(1, b_cap=16)[1])
    with pytest.raises(ValueError, match="capacities differ"):
        stack_batches([b1[0], b2[0]])


def test_fleet_refuses_more_flat_ids_than_int32():
    # Expanded views: no memory behind the (2^16, 2^15 + 1) shapes.
    big = torch.zeros(1, dtype=torch.int32).expand(1 << 16, (1 << 15) + 1)
    w = torch.zeros(1).expand(1 << 16, 1)
    with pytest.raises(ValueError, match="int32"):
        FleetGraph(indptr=big, indices=big[:, :1], weights=w,
                   src=big[:, :1], n_valid=np.zeros(1 << 16),
                   e_valid=np.zeros(1 << 16))


def test_fleet_move_phase_stops_each_stream_on_its_own(tfleet):
    """``MoveEngine.run`` over a fleet: each stream sweeps as it would alone (its
    own m, dQ, stop and stream-local round gate), and a stream at tolerance
    +inf runs no sweep and keeps its start."""
    graphs, _ = tfleet
    fleet = stack_graphs(graphs)
    view = fleet.view()
    comm0, sigma0, frontier0 = singleton_init(view)
    tols = np.array([0.01, np.inf, 0.01, 0.001])
    comm, iters, _ = move_phase(view, comm0, sigma0, frontier0, tols)
    comm = fleet.local_vertex_ids(comm)
    assert iters[1] == 0
    assert torch.equal(comm[1], fleet.local_vertex_ids(comm0)[1])
    for s in (0, 2, 3):
        want, w_iters, _ = move_phase(graphs[s], *singleton_init(graphs[s]),
                                      float(tols[s]))
        assert iters[s] == w_iters > 0
        n = graphs[s].n_valid
        assert torch.equal(comm[s, :n], want[:n]), s


# -- the fleet forms of K4 and K3: one call for all streams ----------------

def _counting(monkeypatch, module, name, ref):
    calls = []

    def wrapped(*args, **kw):
        calls.append(kw["sent"])
        return ref(*args, **kw)
    monkeypatch.setattr(module, name, wrapped)
    return calls


@pytest.mark.parametrize("backend", ["sort", "kernel"])
def test_fleet_apply_equals_each_stream_alone(tfleet, monkeypatch, backend):
    graphs, streams = tfleet
    calls = _counting(monkeypatch, tdelta, "resolve_groups",
                      resolve_groups_ref)
    fleet = stack_graphs(graphs)
    for step in range(len(streams[0])):
        batch = stack_batches([s[step] for s in streams])
        got, touched, e_new, n_touched = apply_fleet_batch(fleet, batch,
                                                           backend=backend)
        for s, g in enumerate(graphs):
            want, w_touched, w_e = _apply_edge_batch(
                fleet.stream(s), streams[s][step], backend="sort")
            alone = got.stream(s)
            for name in ("indptr", "indices", "weights", "src"):
                assert torch.equal(getattr(alone, name),
                                   getattr(want, name)), (step, s, name)
            assert (alone.n_valid, alone.e_valid) == (want.n_valid,
                                                      want.e_valid)
            assert torch.equal(touched[s], w_touched)
            assert e_new[s] == w_e and n_touched[s] == int(w_touched.sum())
        fleet = got
    # One K4 call per fleet apply, keyed by the flat sentinel.
    sent = fleet.n_streams * (fleet.n_cap + 1)
    assert calls == ([sent] * len(streams[0]) if backend == "kernel" else [])


@pytest.mark.parametrize("backend", ["sort", "kernel"])
def test_fleet_aggregate_equals_each_stream_alone(tfleet, monkeypatch,
                                                  backend):
    graphs, _ = tfleet
    calls = _counting(monkeypatch, taggregate, "coarsen_groups",
                      coarsen_groups_ref)
    fleet = stack_graphs(graphs)
    comms, n_comms = [], []
    for g in graphs:
        mem = torch.from_numpy(np.concatenate([
            louvain(g, LouvainConfig(max_passes=1)).membership,
            np.full(g.n_cap + 1 - g.n_valid, g.n_cap, np.int32)]))
        c, n = renumber_communities(mem, g.n_valid)
        comms.append(c)
        n_comms.append(n)
    calls.clear()
    got = aggregate_fleet(fleet, torch.stack(comms), n_comms,
                          backend=backend)
    assert calls == ([fleet.n_streams * (fleet.n_cap + 1)]
                     if backend == "kernel" else [])
    for s, g in enumerate(graphs):
        want = aggregate_graph(g, comms[s], n_comms[s], backend="sort")
        alone = got.stream(s)
        for name in ("indptr", "indices", "weights", "src"):
            assert torch.equal(getattr(alone, name), getattr(want, name)), s
        assert (alone.n_valid, alone.e_valid) == (want.n_valid, want.e_valid)


# -- louvain_batched --------------------------------------------------------

@pytest.mark.parametrize("refine", ["none", "leiden"])
def test_batched_cold_equals_reference_and_solo(jfleet, tfleet, refine):
    jres = jbatched(jstack_graphs(jfleet[0]), JConfig(refine=refine))
    graphs, _ = tfleet
    cfg = LouvainConfig(refine=refine)
    res = louvain_batched(stack_graphs(graphs), cfg)
    np.testing.assert_array_equal(res.membership.numpy(),
                                  np.asarray(jres.membership))
    np.testing.assert_array_equal(res.n_communities, jres.n_communities)
    assert res.n_passes == jres.n_passes
    for s, g in enumerate(graphs):
        solo = louvain(g, cfg)
        np.testing.assert_array_equal(res.membership[s, :g.n_valid].numpy(),
                                      solo.membership)
        assert res.n_communities[s] == solo.n_communities


def test_batched_leiden_one_stream_reproduces_golden():
    g = to_port(capture.corpora()["gnp"])
    res = louvain_batched(stack_graphs([g]), LouvainConfig(refine="leiden"))
    np.testing.assert_array_equal(res.membership[0, :g.n_valid].numpy(),
                                  np.load(GOLDEN)["single_leiden__gnp"])


def test_batched_ladder_membership_padding_is_sentinel():
    """Laddered fleet passes leave the ORIGINAL sentinel in invalid
    membership slots, with and without the ladder, as the reference."""
    j1, _ = jsbm_graph(16, 48, p_in=0.25, p_out=0.004, seed=2)
    j2, _ = jsbm_graph(12, 64, p_in=0.30, p_out=0.003, seed=3)
    n_cap = max(j1.n_cap, j2.n_cap)
    e_cap = max(j1.e_cap, j2.e_cap)
    jg = [rebucket_graph(j, n_cap, e_cap) for j in (j1, j2)]
    for ladder in (True, False):
        want = jbatched(jstack_graphs(jg), JConfig(use_ladder=ladder))
        res = louvain_batched(stack_graphs([to_port(j) for j in jg]),
                              LouvainConfig(use_ladder=ladder))
        mem = res.membership.numpy()
        np.testing.assert_array_equal(mem, np.asarray(want.membership))
        for s, j in enumerate((j1, j2)):
            assert np.all(mem[s, int(j.n_valid):] == n_cap), (ladder, s)


@pytest.mark.parametrize("driver", ["louvain_batched",
                                    "louvain_dynamic_batched"])
def test_batched_rejects_ell_config(tfleet, driver):
    graphs, streams = tfleet
    cfg = LouvainConfig(use_ell_kernel=True)
    with pytest.raises(ValueError, match="sort-reduce"):
        if driver == "louvain_batched":
            louvain_batched(stack_graphs(graphs), cfg)
        else:
            louvain_dynamic_batched(graphs, streams, config=cfg)


# -- per-stream scalars on weights whose float32 sums are not exact ---------

def _reweighted(graphs, streams, kind):
    """The fleet with each undirected edge {u, v} weighted from one seeded
    symmetric table: ``"float"`` uniform in [0.1, 2) (float32 sums of these
    round), ``"heavy"`` integers below 2^16, so each stream's total weight
    exceeds 2^24.  Deletions keep weight 0."""
    n_cap = graphs[0].n_cap
    rng = np.random.default_rng(7)
    if kind == "float":
        tab = rng.uniform(0.1, 2.0, (n_cap + 1, n_cap + 1))
    else:
        tab = rng.integers(1, 1 << 16, (n_cap + 1, n_cap + 1))
    tab = tab.astype(np.float32)

    def w_of(u, v):
        return tab[np.minimum(u, v), np.maximum(u, v)]

    out_g = []
    for g in graphs:
        src, dst = g.src.numpy(), g.indices.numpy()
        w = np.where(src < n_cap, w_of(src, dst), 0.0).astype(np.float32)
        out_g.append(graph_from_numpy(g.indptr.numpy(), dst, w, src,
                                      g.n_valid, g.e_valid, device="cpu"))
    out_s = []
    for st in streams:
        out_s.append([edge_batch_from_numpy(
            b.src.numpy(), b.dst.numpy(),
            np.where(b.weight.numpy() > 0, w_of(b.src.numpy(),
                                                b.dst.numpy()), 0.0),
            b.b_valid, device="cpu") for b in st])
    return out_g, out_s


@pytest.mark.parametrize("kind", ["float", "heavy"])
def test_fleet_total_weight_equals_each_stream_alone(tfleet, kind):
    graphs, streams = _reweighted(*tfleet, kind)
    m = stack_graphs(graphs).total_weight()
    for s, g in enumerate(graphs):
        exact = g.weights.numpy().astype(np.float64).sum()
        if kind == "heavy":
            assert exact > 2 ** 24
        assert m[s] == g.total_weight() == np.float32(exact) * 0.5


@pytest.mark.parametrize("refine", ["none", "leiden"])
@pytest.mark.parametrize("kind", ["float", "heavy"])
def test_batched_cold_equals_solo_on_weights_past_float32(tfleet, kind,
                                                          refine):
    graphs, _ = _reweighted(*tfleet, kind)
    cfg = LouvainConfig(refine=refine)
    res = louvain_batched(stack_graphs(graphs), cfg)
    for s, g in enumerate(graphs):
        solo = louvain(g, cfg)
        np.testing.assert_array_equal(res.membership[s, :g.n_valid].numpy(),
                                      solo.membership)
        assert res.n_communities[s] == solo.n_communities


@pytest.mark.parametrize("kind", ["float", "heavy"])
def test_batched_dynamic_equals_solo_on_weights_past_float32(tfleet, kind):
    graphs, streams = _reweighted(*tfleet, kind)
    got = louvain_dynamic_batched(graphs, streams)
    for s, g in enumerate(graphs):
        solo = louvain_dynamic(g, streams[s])
        np.testing.assert_array_equal(got.stream_membership(s),
                                      solo.membership)
        assert list(got.frontier_sizes[:, s]) == [
            b.frontier_size for b in solo.batch_stats]
        np.testing.assert_array_equal(live_edges(got.graphs.stream(s)),
                                      live_edges(solo.graph))


# -- louvain_dynamic_batched ------------------------------------------------

@pytest.mark.parametrize("kw", [
    {},
    {"screening": "vertex"},
    {"screening": False},
    {"apply_backend": "kernel"},
    {"config": {"scan_backend": "compact"}},
    {"config": {"refine": "leiden"}},
], ids=["community", "vertex", "unscreened", "k4", "compact", "leiden"])
def test_batched_dynamic_equals_reference_and_solo(jdyn, tfleet, kw):
    want = jdyn(**kw)
    graphs, streams = tfleet
    pkw = dict(kw)
    if "config" in pkw:
        pkw["config"] = LouvainConfig(**pkw["config"])
    got = louvain_dynamic_batched(graphs, streams, track_modularity=True,
                                  **pkw)
    assert_dynamic_equal(got, want, graphs[0].n_cap)
    for s, g in enumerate(graphs):
        solo = louvain_dynamic(g, streams[s], **pkw)
        np.testing.assert_array_equal(got.stream_membership(s),
                                      solo.membership)
        assert list(got.frontier_sizes[:, s]) == [
            b.frontier_size for b in solo.batch_stats]
        np.testing.assert_array_equal(live_edges(got.graphs.stream(s)),
                                      live_edges(solo.graph))
        assert abs(got.modularity[s] - membership_modularity(
            solo.graph, solo.membership)) < 1e-5


def test_batched_vertex_screening_seeds_fewer_vertices(jdyn, tfleet):
    graphs, streams = tfleet
    res_c = louvain_dynamic_batched(graphs, streams, screening="community",
                                    track_modularity=True)
    res_v = louvain_dynamic_batched(graphs, streams, screening="vertex",
                                    track_modularity=True)
    assert np.all(res_v.frontier_sizes <= res_c.frontier_sizes)
    assert np.all(res_v.frontier_sizes.sum(0) < res_c.frontier_sizes.sum(0))
    assert np.all(res_v.modularity > res_c.modularity - 0.02)


def test_batched_fallback_path_equals_reference_and_solo(jfleet, tfleet):
    """Singleton warm starts make step 0 sweep more than once, so the step
    goes through the general pass loop."""
    graphs, streams = tfleet
    prevs = [np.arange(g.n_valid, dtype=np.int32) for g in graphs]
    want = jdyn_batched(*jfleet, prevs=prevs)
    got = louvain_dynamic_batched(graphs, streams, prevs=prevs)
    assert got.pass_stats[0].iterations > 1
    assert_dynamic_equal(got, want, graphs[0].n_cap)
    for s, g in enumerate(graphs):
        solo = louvain_dynamic(g, streams[s], prev=prevs[s])
        np.testing.assert_array_equal(got.stream_membership(s),
                                      solo.membership)


def test_batched_zero_step_streams(tfleet):
    graphs, _ = tfleet
    prevs = [louvain(g).membership for g in graphs]
    res = louvain_dynamic_batched(graphs, [[] for _ in graphs], prevs=prevs)
    assert res.frontier_sizes.shape == (0, len(graphs))
    assert res.pass_stats == []
    for s, p in enumerate(prevs):
        np.testing.assert_array_equal(res.stream_membership(s), p)


def test_batched_accepts_sentinel_padded_prevs(tfleet):
    graphs, streams = tfleet
    flat = [louvain(g).membership for g in graphs]
    n_cap = graphs[0].n_cap
    padded = [np.concatenate([p, np.full(n_cap + 1 - len(p), n_cap,
                                         np.int32)]) for p in flat]
    res_flat = louvain_dynamic_batched(graphs, streams, prevs=flat)
    res_pad = louvain_dynamic_batched(graphs, streams, prevs=padded)
    np.testing.assert_array_equal(res_flat.membership, res_pad.membership)


def test_batched_auto_screening_resolves_host_side(jfleet, tfleet):
    """``screening="auto"``: the mode of each step comes from the previous
    step's worst touched fraction (the first step a flagged downgrade to
    "community"), as in the reference; replaying the stream with the
    recorded mode per step reproduces the run."""
    graphs, streams = tfleet
    prevs = [louvain(g).membership for g in graphs]
    want = jdyn_batched(*jfleet, prevs=prevs, screening="auto")
    res = louvain_dynamic_batched(graphs, streams, prevs=prevs,
                                  screening="auto")
    assert_dynamic_equal(res, want, graphs[0].n_cap)
    modes = [s.screening for s in res.pass_stats]
    assert modes[0] == "community" and res.pass_stats[0].downgraded
    assert all(m in ("community", "vertex") for m in modes)
    cur, mems = list(graphs), list(prevs)
    for t, mode in enumerate(modes):
        step = louvain_dynamic_batched(
            cur, [s[t:t + 1] for s in streams], prevs=mems, screening=mode)
        mems = [step.membership[s] for s in range(len(cur))]
        cur = [step.graphs.stream(s) for s in range(len(cur))]
    np.testing.assert_array_equal(res.membership, np.stack(mems))


def test_batched_scan_auto_downgrade_is_explicit(jdyn, tfleet):
    graphs, streams = tfleet
    res_auto = louvain_dynamic_batched(
        graphs, streams, config=LouvainConfig(scan_backend="auto"),
        screening="community")
    assert all(s.scan_backend == "full" and s.downgraded
               for s in res_auto.pass_stats)
    res_full = louvain_dynamic_batched(
        graphs, streams, config=LouvainConfig(scan_backend="full"),
        screening="community")
    assert not any(s.downgraded for s in res_full.pass_stats)
    np.testing.assert_array_equal(res_auto.membership, res_full.membership)
    want = jdyn(config={"scan_backend": "full"})
    assert [s.downgraded for s in res_full.pass_stats] == [
        s.downgraded for s in want.pass_stats]


def test_batched_stream_compact_one_stream_bit_for_bit():
    """One-stream serving with the compacted scanner equals the solo
    compact driver and the ``dynamic__sbm_stream`` golden."""
    jinit, jbatches = capture.dynamic_stream()
    init, batches = to_port(jinit), to_port_batches(jbatches)
    prev = louvain(init).membership
    cfg = LouvainConfig(scan_backend="compact")
    bat = louvain_dynamic_batched([init], [batches], prevs=[prev], config=cfg)
    seq = louvain_dynamic(init, batches, prev=prev, config=cfg)
    np.testing.assert_array_equal(bat.stream_membership(0), seq.membership)
    np.testing.assert_array_equal(bat.stream_membership(0),
                                  np.load(GOLDEN)["dynamic__sbm_stream"])


@pytest.mark.parametrize("stream", ["deletion_only", "reweight_heavy"])
def test_oracle_streams_batched_equal_reference(stream):
    init, batches, final = (_deletion_stream() if stream == "deletion_only"
                            else _reweight_stream())
    screening = _STREAM_SCREENING[stream]
    want = jdyn_batched([init], [batches], screening=screening)
    got = louvain_dynamic_batched([to_port(init)], [to_port_batches(batches)],
                                  screening=screening)
    assert_dynamic_equal(got, want, init.n_cap)
    assert int(got.graphs.e_valid[0]) == int(final.e_valid)
    assert np.all(got.frontier_sizes < got.graphs.n_valid[0])


# -- capacity growth ----------------------------------------------------------

def _tight_whale_fleet():
    """A 2-stream fleet with almost no edge headroom plus a batch of new
    edges that cannot fit the envelope (the reference test's fleet)."""
    full, _ = jsbm_graph(n_communities=4, size=8, p_in=0.5, p_out=0.05,
                         seed=1)
    e = int(full.e_valid)
    g = jbuild_csr(np.asarray(full.src)[:e], np.asarray(full.indices)[:e],
                   np.asarray(full.weights)[:e], int(full.n_valid),
                   e_cap=e + 2)
    batch = jmake_batch([0, 1, 2, 3], [17, 18, 19, 20], [1.0] * 4, g.n_cap,
                        b_cap=4)
    return g, batch


def test_batched_overflow_is_loud_without_growth():
    jg, jb = _tight_whale_fleet()
    prevs = [jlouvain(jg).membership] * 2
    with pytest.raises(JOverflow) as want:
        jdyn_batched([jg, jg], [[jb], [jb]], prevs=prevs,
                     grow_capacity=False)
    g, b = to_port(jg), to_port_batches([jb])[0]
    with pytest.raises(FleetCapacityOverflow,
                       match="overflows capacity") as got:
        louvain_dynamic_batched([g, g], [[b], [b]], prevs=prevs,
                                grow_capacity=False)
    assert isinstance(got.value, ValueError)
    assert ((got.value.step, got.value.e_need, got.value.e_cap)
            == (want.value.step, want.value.e_need, want.value.e_cap))


def test_batched_overflow_regrows_and_matches():
    """A whale overflowing the envelope re-buckets the fleet and replays the
    step; the run equals the reference's and the same fleet provisioned
    with ample headroom up front."""
    jg, jb = _tight_whale_fleet()
    prevs = [jlouvain(jg).membership] * 2
    want = jdyn_batched([jg, jg], [[jb], [jb]], prevs=prevs)
    g, b = to_port(jg), to_port_batches([jb])[0]
    grown = louvain_dynamic_batched([g, g], [[b], [b]], prevs=prevs)
    assert grown.n_regrows >= 1
    assert_dynamic_equal(grown, want, g.n_cap)
    e = g.e_valid
    ample = to_port(jbuild_csr(np.asarray(jg.src)[:e],
                               np.asarray(jg.indices)[:e],
                               np.asarray(jg.weights)[:e], int(jg.n_valid),
                               e_cap=grown.graphs.e_cap))
    ref = louvain_dynamic_batched([ample, ample], [[b], [b]], prevs=prevs)
    assert ref.n_regrows == 0
    np.testing.assert_array_equal(grown.membership, ref.membership)


def test_midstream_overflow_replay_matches_oneshot_bitforbit():
    """A batch overflowing MID-stream (earlier steps committed, step 0
    forced through the general pass loop by singleton warm starts) regrows
    and replays from the PRE-apply fleet: memberships and live edges equal
    the reference's and the amply provisioned run's."""
    full, _ = jsbm_graph(n_communities=4, size=8, p_in=0.5, p_out=0.05,
                         seed=5)
    e, n = int(full.e_valid), int(full.n_valid)
    jg = jbuild_csr(np.asarray(full.src)[:e], np.asarray(full.indices)[:e],
                    np.asarray(full.weights)[:e], n, e_cap=e + 6)

    def batch(k, seed):
        r = np.random.default_rng(seed)
        s = r.integers(0, n, k)
        d = (s + 1 + r.integers(0, n - 1, k)) % n
        return jmake_batch(s, d, np.ones(k, np.float32), jg.n_cap, b_cap=8)

    jstreams = [[batch(2, 1), batch(8, 2), batch(2, 3)],
                [batch(2, 4), batch(8, 5), batch(2, 6)]]
    prevs = [np.arange(n, dtype=np.int32)] * 2
    want = jdyn_batched([jg, jg], jstreams, prevs=prevs)
    g = to_port(jg)
    streams = [to_port_batches(s) for s in jstreams]
    grown = louvain_dynamic_batched([g, g], streams, prevs=prevs)
    assert grown.n_regrows >= 1
    assert_dynamic_equal(grown, want, g.n_cap)
    ample = to_port(jbuild_csr(np.asarray(jg.src)[:e],
                               np.asarray(jg.indices)[:e],
                               np.asarray(jg.weights)[:e], n,
                               e_cap=grown.graphs.e_cap))
    ref = louvain_dynamic_batched([ample, ample], streams, prevs=prevs)
    assert ref.n_regrows == 0
    np.testing.assert_array_equal(grown.membership, ref.membership)
    for s in range(2):
        np.testing.assert_array_equal(live_edges(grown.graphs.stream(s)),
                                      live_edges(ref.graphs.stream(s)))
