"""Streaming Louvain of the PyTorch port against the JAX package, on the CPU.

Delta screening (``affected_frontier`` in its three modes), ``warm_init``,
the frontier-compacted scanner and ``louvain(init_membership=,
init_frontier=)`` are held against their references element for element on
the golden corpora.  ``louvain_dynamic`` must reproduce the committed
``dynamic__sbm_stream`` golden for every scanner x batch-apply backend and
over the ladder / aggregation-backend matrix, and equal the JAX
``louvain_dynamic`` on the deletion-only and reweight-heavy oracle streams
(``e_valid``, per-batch ``n_touched`` and ``frontier_size``, final
membership).  Everything here is
exact: memberships, masks and integer-weighted community weights.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden import capture_engine_golden as capture
from test_oracle_golden import (_STREAM_SCREENING, _deletion_stream,
                                _reweight_stream)

from repro.core import engine as jengine
from repro.core.dynamic import louvain_dynamic as jdynamic
from repro.core.local_move import (compact_best_moves as jcompact_best,
                                   gather_frontier_slots as jgather)
from repro.core.louvain import (LouvainConfig as JConfig, _move_phase as jmove,
                                louvain as jlouvain, warm_init as jwarm_init)

from repro_torch import LouvainConfig, louvain, louvain_dynamic
from repro_torch.configs.louvain_arch import compact_work_cap
from repro_torch.core import engine as tengine
from repro_torch.core.local_move import (compact_best_moves,
                                         gather_frontier_slots, move_phase)
from repro_torch.core.louvain import screened_frontier, warm_init
from repro_torch.data import sbm_edge_stream
from repro_torch.interop import edge_batch_from_numpy, graph_from_numpy

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "engine_memberships.npz")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def gold():
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def corpora():
    return capture.corpora()


def to_port(jg):
    return graph_from_numpy(np.asarray(jg.indptr), np.asarray(jg.indices),
                            np.asarray(jg.weights), np.asarray(jg.src),
                            int(jg.n_valid), int(jg.e_valid), device="cpu")


def to_port_batches(jbatches):
    return [edge_batch_from_numpy(b.src, b.dst, b.weight, b.b_valid,
                                  device="cpu") for b in jbatches]


def warm_inputs(rng, n, n_cap):
    """A perturbed (n_cap + 1,) membership: 20% of the vertices moved to a
    random id, a few set past n_cap (vertices without an assignment)."""
    mem = np.arange(n_cap + 1, dtype=np.int32)
    mem[:n] = rng.integers(0, max(n // 4, 1), n)
    moved = rng.random(n) < 0.2
    mem[:n][moved] = rng.integers(0, n, int(moved.sum()))
    mem[rng.integers(0, n, 3)] = n_cap + 5
    return mem


# ---------------------------------------------------------------------------
# Screening, warm start, compact scanner.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["community", "vertex", "auto"])
@pytest.mark.parametrize("n_touched", [1, 6, 40])
def test_affected_frontier_equals_reference(mode, n_touched):
    rng = np.random.default_rng(n_touched)
    cap, n_valid = 96, 80
    mem = rng.integers(0, 20, cap + 1).astype(np.int32)
    mem[cap] = cap
    mem[5] = cap + 3                          # an id past the capacity
    touched = np.zeros(cap + 1, bool)
    touched[rng.integers(0, cap, n_touched)] = True
    want = jengine.affected_frontier(jnp.asarray(touched), jnp.asarray(mem),
                                     jnp.int32(n_valid), mode)
    t_args = (torch.from_numpy(touched), torch.from_numpy(mem), n_valid)
    got = tengine.affected_frontier(*t_args, mode)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(screened_frontier(*t_args, mode), got)
    assert tengine.AUTO_SCREEN_TOUCHED_DENOM == \
        jengine.AUTO_SCREEN_TOUCHED_DENOM


def test_normalize_screening_matches_reference():
    for arg in (True, False, None, "community", "vertex", "auto"):
        assert tengine.normalize_screening(arg) == \
            jengine.normalize_screening(arg)
    for bad in ("all", 1.5):
        with pytest.raises(ValueError):
            tengine.normalize_screening(bad)
    with pytest.raises(ValueError, match="screening mode"):
        tengine.affected_frontier(torch.zeros(3, dtype=torch.bool),
                                  torch.zeros(3, dtype=torch.int32), 2, "x")


@pytest.mark.parametrize("with_frontier", [False, True])
@pytest.mark.parametrize("name", ["lesmis", "sbm"])
def test_warm_init_equals_reference(corpora, name, with_frontier):
    jg = corpora[name]
    tg = to_port(jg)
    rng = np.random.default_rng(len(name))
    mem = warm_inputs(rng, tg.n_valid, tg.n_cap)
    fr = rng.random(tg.n_cap + 1) < 0.3 if with_frontier else None
    want = jwarm_init(jg, jnp.asarray(mem),
                      None if fr is None else jnp.asarray(fr))
    got = warm_init(tg, torch.from_numpy(mem),
                    None if fr is None else torch.from_numpy(fr))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("work_cap", [40, 4000])
def test_compact_scan_equals_reference(corpora, work_cap):
    jg = corpora["sbm"]
    tg = to_port(jg)
    rng = np.random.default_rng(work_cap)
    n_cap = tg.n_cap
    comm = np.arange(n_cap + 1, dtype=np.int32)
    comm[: tg.n_valid] = rng.integers(0, 30, tg.n_valid)
    front = rng.random(n_cap + 1) < 0.15
    front[n_cap] = False
    sigma = np.array(jax.ops.segment_sum(
        jg.vertex_weights()[:n_cap], jnp.asarray(comm[:n_cap]),
        num_segments=n_cap + 1))
    k, m = jg.vertex_weights(), jg.total_weight()
    jargs = (jnp.asarray(comm), jnp.asarray(sigma), k, jnp.asarray(front), m)
    targs = (torch.from_numpy(comm), torch.from_numpy(sigma),
             tg.vertex_weights(), torch.from_numpy(front), tg.total_weight())
    want = jgather(jg, jnp.asarray(front), work_cap)
    got = gather_frontier_slots(tg, torch.from_numpy(front), work_cap)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    want = jcompact_best(jg, *jargs, work_cap)
    got = compact_best_moves(tg, *targs, work_cap)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[2] == bool(want[2]) == (work_cap == 40)


@pytest.mark.parametrize("work_cap", [64, 300])
def test_compact_move_phase_equals_reference(corpora, work_cap):
    jg = corpora["gnp"]
    tg = to_port(jg)
    rng = np.random.default_rng(1)
    n_cap = tg.n_cap
    front = rng.random(n_cap + 1) < 0.1
    comm0 = jnp.arange(n_cap + 1, dtype=jnp.int32)
    want = jmove(jg, comm0, jg.vertex_weights(),
                 jnp.asarray(front) & (comm0 < jg.n_valid), jnp.float32(0.01),
                 max_iterations=20, use_pruning=True, work_cap=work_cap)
    tcomm0 = torch.arange(n_cap + 1, dtype=torch.int32)
    got = move_phase(tg, tcomm0, tg.vertex_weights(),
                     torch.from_numpy(front) & (tcomm0 < tg.n_valid), 0.01,
                     work_cap=work_cap)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[1] == int(want[1])
    assert compact_work_cap(10) == 10 and compact_work_cap(10 ** 6) == 250000


@pytest.mark.parametrize("refine", [False, True])
@pytest.mark.parametrize("work_cap", [0, 64])
@pytest.mark.parametrize("name", ["sbm", "gnp"])
def test_louvain_move_equals_reference(corpora, name, work_cap, refine):
    """``local_move.louvain_move``, the reference's engine adapter with the
    caller's K and m (a seed frontier masked to the valid vertices, the
    compacted scanner, the constrained sweep)."""
    from repro.core.local_move import louvain_move as jlouvain_move
    from repro_torch.core.local_move import louvain_move
    jg = corpora[name]
    tg = to_port(jg)
    n_cap = tg.n_cap
    rng = np.random.default_rng(3)
    front = rng.random(n_cap + 1) < 0.3
    outer = rng.integers(0, 4, n_cap + 1).astype(np.int32)
    kw = dict(work_cap=work_cap, max_iterations=20, gate_fraction=2)
    comm0 = np.arange(n_cap + 1, dtype=np.int32)
    want = jlouvain_move(jg, jnp.asarray(comm0), jg.vertex_weights(),
                         jg.vertex_weights(), jg.total_weight(),
                         tolerance=jnp.float32(0.01),
                         frontier0=jnp.asarray(front),
                         refine_outer=jnp.asarray(outer) if refine else None,
                         **kw)
    got = louvain_move(tg, torch.from_numpy(comm0), tg.vertex_weights(),
                       tg.vertex_weights(), tg.total_weight(),
                       tolerance=0.01, frontier0=torch.from_numpy(front),
                       refine_outer=torch.from_numpy(outer) if refine
                       else None, **kw)
    np.testing.assert_array_equal(got.comm.numpy(), np.asarray(want.comm))
    assert got.iters == int(want.iters)
    assert float(got.dq_sum) == pytest.approx(float(want.dq_sum), rel=1e-6)
    # No seed frontier: every valid vertex, as move_phase's cold start.
    full = louvain_move(tg, torch.from_numpy(comm0), tg.vertex_weights(),
                        tg.vertex_weights(), tg.total_weight(),
                        tolerance=0.01)
    cold = move_phase(tg, torch.from_numpy(comm0), tg.vertex_weights(),
                      torch.from_numpy(comm0) < tg.n_valid, 0.01)
    assert torch.equal(full.comm, cold[0]) and full.iters == cold[1]


@pytest.mark.parametrize("name", ["lesmis", "gnp"])
def test_scan_communities_sorted_equals_reference(corpora, name):
    from repro.core.local_move import scan_communities_sorted as jscan
    from repro_torch.core.local_move import scan_communities_sorted
    jg = corpora[name]
    rng = np.random.default_rng(5)
    comm = rng.integers(0, 6, jg.n_cap + 1).astype(np.int32)
    comm[-1] = jg.n_cap
    want = jscan(jg, jnp.asarray(comm))
    got = scan_communities_sorted(to_port(jg), torch.from_numpy(comm))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("mode", ["community", "vertex"])
def test_delta_frontier_equals_reference(mode):
    """``dynamic.delta_frontier``, the historical alias of the screening
    rule, on the reference's case and random ones."""
    from repro.core.dynamic import delta_frontier as jdelta
    from repro_torch.core.dynamic import delta_frontier
    assert delta_frontier is screened_frontier
    cases = [(np.array([0, 0, 2, 2, 4, 4, 6], np.int32),
              np.array([1, 0, 0, 0, 0, 0, 0], bool), 6)]
    rng = np.random.default_rng(2)
    for _ in range(5):
        n_cap = 30
        mem = rng.integers(0, n_cap + 3, n_cap + 1).astype(np.int32)
        mem[-1] = n_cap
        cases.append((mem, rng.random(n_cap + 1) < 0.1,
                      int(rng.integers(1, n_cap + 1))))
    for mem, touched, n_valid in cases:
        want = jdelta(jnp.asarray(touched), jnp.asarray(mem),
                      jnp.int32(n_valid), mode)
        got = delta_frontier(torch.from_numpy(touched),
                             torch.from_numpy(mem), n_valid, mode)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", ["membership", "frontier", "both"])
@pytest.mark.parametrize("name", ["lesmis", "sbm", "ring_of_cliques", "gnp"])
def test_warm_louvain_equals_reference(corpora, name, case):
    """Warm start, screened frontier over a cold start, and both; a 10%
    frontier makes ``scan_backend="auto"`` take the compact scanner."""
    jg = corpora[name]
    tg = to_port(jg)
    rng = np.random.default_rng(3)
    mem = (warm_inputs(rng, tg.n_valid, tg.n_cap)
           if case != "frontier" else None)
    fr = None
    if case != "membership":
        fr = np.zeros(tg.n_cap + 1, bool)
        fr[rng.choice(tg.n_valid, max(tg.n_valid // 10, 1),
                      replace=False)] = True
    want = jlouvain(jg, JConfig(), init_membership=mem,
                    init_frontier=None if fr is None else jnp.asarray(fr))
    got = louvain(tg, LouvainConfig(), init_membership=mem,
                  init_frontier=None if fr is None else torch.from_numpy(fr))
    np.testing.assert_array_equal(got.membership, want.membership)
    assert len(got.levels) == len(want.levels)
    for a, b in zip(got.levels, want.levels):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got.passes, want.passes):
        assert (a.iterations, a.n_communities, a.frontier_size,
                a.n_cap, a.e_cap) == (b.iterations, b.n_communities,
                                      b.frontier_size, b.n_cap, b.e_cap)
    if fr is not None:
        assert got.passes[0].scan_backend == "compact"


# ---------------------------------------------------------------------------
# The streaming entry point.
# ---------------------------------------------------------------------------

def test_stream_recipe_equals_reference():
    """The port's ``sbm_edge_stream`` (its own ``sbm_graph`` and numpy) is
    the reference's ``capture.dynamic_stream`` buffer for buffer."""
    jinit, jbatches = capture.dynamic_stream()
    tinit, tbatches = sbm_edge_stream(device="cpu")
    for name in ("indptr", "indices", "weights", "src"):
        np.testing.assert_array_equal(getattr(tinit, name).numpy(),
                                      np.asarray(getattr(jinit, name)))
    assert (tinit.n_valid, tinit.e_valid) == (int(jinit.n_valid),
                                              int(jinit.e_valid))
    assert len(tbatches) == len(jbatches)
    for tb, jb in zip(tbatches, jbatches):
        for name in ("src", "dst", "weight"):
            np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                          np.asarray(getattr(jb, name)))
        assert tb.b_valid == int(jb.b_valid)


@pytest.mark.parametrize("apply_backend", ["sort", "kernel"])
@pytest.mark.parametrize("scan_backend", ["full", "compact", "auto"])
def test_dynamic_stream_reproduces_golden(gold, scan_backend, apply_backend):
    init, batches = sbm_edge_stream(device="cpu")
    res = louvain_dynamic(init, batches,
                          config=LouvainConfig(scan_backend=scan_backend),
                          apply_backend=apply_backend)
    np.testing.assert_array_equal(res.membership, gold["dynamic__sbm_stream"])
    assert len(res.batch_stats) == 8
    assert all(s.n_touched > 0 for s in res.batch_stats)
    want = "full" if scan_backend == "auto" else scan_backend
    assert all(s.scan_backend == want for s in res.batch_stats)
    assert res.updates_per_second > 0


@pytest.mark.parametrize("cfg", [LouvainConfig(use_ladder=False),
                                 LouvainConfig(agg_backend="kernel")],
                         ids=["no-ladder", "agg-kernel"])
def test_dynamic_stream_ladder_agg_matrix(gold, cfg):
    init, batches = sbm_edge_stream(device="cpu")
    res = louvain_dynamic(init, batches, config=cfg)
    np.testing.assert_array_equal(res.membership, gold["dynamic__sbm_stream"])
    assert res.graph.e_cap == init.e_cap     # the stream graph never ladders


@pytest.mark.parametrize("apply_backend", ["sort", "kernel"])
@pytest.mark.parametrize("stream", ["deletion_only", "reweight_heavy"])
def test_oracle_streams_equal_reference(stream, apply_backend):
    init, batches, final = (_deletion_stream() if stream == "deletion_only"
                            else _reweight_stream())
    screening = _STREAM_SCREENING[stream]
    want = jdynamic(init, batches, screening=screening)
    got = louvain_dynamic(to_port(init), to_port_batches(batches),
                          screening=screening, apply_backend=apply_backend,
                          track_modularity=True)
    assert got.graph.e_valid == int(want.graph.e_valid) == int(final.e_valid)
    assert [s.n_touched for s in got.batch_stats] == \
        [s.n_touched for s in want.batch_stats]
    assert [s.frontier_size for s in got.batch_stats] == \
        [s.frontier_size for s in want.batch_stats]
    np.testing.assert_array_equal(got.membership, want.membership)
    for name in ("indptr", "indices", "weights", "src"):
        np.testing.assert_array_equal(getattr(got.graph, name).numpy(),
                                      np.asarray(getattr(want.graph, name)))
    assert all(np.isfinite(s.modularity) for s in got.batch_stats)
