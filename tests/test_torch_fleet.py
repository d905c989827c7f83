"""The multi-tenant sharded serving fleet of the port
(``repro_torch.core.fleet``) against its own solo ``louvain_dynamic_sharded``,
the committed goldens and the JAX package's ``repro.core.fleet``, on the CPU.

The correctness bar: every tenant served through the fleet gets, bit for
bit, the membership it gets from ``louvain_dynamic_sharded`` alone, on
every control path (fused accept, fallback replay, whale migration, empty
and uneven streams, ``"auto"`` screening, both state layouts), at world
size 1 and on 4 gloo ranks; and at one shard the port's fleet is the JAX
``FleetRouter`` (memberships, per-tenant ``PassStats``, fallbacks,
migrations, rounds, priced bytes, envelopes).  The lane-batched apply and
move phase are held against each lane alone on float weights, with K4
counted once per bucket step.
"""

import json
import os
import subprocess
import sys

import jax  # noqa: F401  (the parity files import both frameworks)
import numpy as np
import pytest
import torch
try:
    from hypothesis import given, settings, strategies as st
except ImportError:         # optional dev dep: tests/_hypothesis_fallback
    from _hypothesis_fallback import given, settings, st

from golden import capture_engine_golden as capture

from repro.compat import make_mesh
from repro.configs import louvain_arch as jarch
from repro.core.delta import make_edge_batch as jmake_edge_batch
from repro.core.fleet import FleetRouter as JRouter, serve_fleet as jserve
from repro.core.graph import build_csr as jbuild_csr
from repro.core.louvain import LouvainConfig as JConfig
from repro.data import sbm_holdout_stream as jsbm_holdout_stream

from repro_torch import (FleetRouter, LouvainConfig, ShardGroup,
                         apply_edge_batch, louvain, louvain_dynamic_sharded,
                         serve_fleet)
from repro_torch.configs import louvain_arch as tarch
from repro_torch.core import collectives, delta as tdelta
from repro_torch.core import distributed as tdist
from repro_torch.core import distributed_dynamic as tdd
from repro_torch.core.engine import EngineConfig
from repro_torch.core.louvain import pad_membership
from repro_torch.interop import edge_batch_from_numpy, graph_from_numpy

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "engine_memberships.npz")
#: The hard limit of one spawned multi-rank run (seconds).
RANK_TIMEOUT = 240
ONE = ShardGroup.single("cpu")
AXES = ("shard",)
SETTINGS = settings(deadline=None, max_examples=40)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def gold():
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh((1,), AXES)


def arrays(jg) -> dict:
    return dict(indptr=np.asarray(jg.indptr), indices=np.asarray(jg.indices),
                weights=np.asarray(jg.weights), src=np.asarray(jg.src),
                n_valid=int(jg.n_valid), e_valid=int(jg.e_valid))


def batch_arrays(b) -> dict:
    return dict(src=np.asarray(b.src), dst=np.asarray(b.dst),
                weight=np.asarray(b.weight), b_valid=int(b.b_valid))


def to_port(jg):
    return graph_from_numpy(**arrays(jg), device="cpu")


def to_port_batches(jbatches):
    return [edge_batch_from_numpy(**batch_arrays(b), device="cpu")
            for b in jbatches]


def _case(seed, n_steps=3, b_cap=8):
    """The reference's ``tests/test_fleet.py`` tenant: an SBM stream."""
    init, batches, _ = jsbm_holdout_stream(seed, n_cap=128, e_cap=1400,
                                           n_hold=24, n_steps=n_steps,
                                           b_cap=b_cap)
    return init, batches


def _ring_whale(n=64, n_batches=8, k=12):
    """The reference's whale: a sparse ring whose envelope is tight, and
    dense insert batches that blow through it mid-stream."""
    s = np.arange(n, dtype=np.int64)
    d = (s + 1) % n
    g = jbuild_csr(np.concatenate([s, d]), np.concatenate([d, s]),
                   np.ones(2 * n, np.float32), n, e_cap=2 * n + 4 * k)
    rng = np.random.default_rng(7)
    batches = []
    for _ in range(n_batches):
        bs = rng.integers(0, n, k)
        bd = (bs + 2 + rng.integers(0, n - 3, k)) % n
        batches.append(jmake_edge_batch(bs, bd, np.ones(k, np.float32),
                                        g.n_cap, b_cap=k))
    return g, batches


def _auto_case(seed=40):
    """An SBM stream whose batch sizes alternate between bulky (16 touched
    of 128: community screening) and small (at most 1/16 touched: vertex
    screening), so what each step's ``"auto"`` resolution sees decides
    the mode it runs."""
    init, batches = _case(seed, n_steps=3)
    entries = []
    for b in batches:
        k = int(b.b_valid)
        entries += list(zip(np.asarray(b.src)[:k], np.asarray(b.dst)[:k],
                            np.asarray(b.weight)[:k]))
    out, at = [], 0
    for size in (8, 2, 8, 2, 2, 2):
        chunk = entries[at:at + size]
        at += size
        out.append(jmake_edge_batch([c[0] for c in chunk],
                                    [c[1] for c in chunk],
                                    [c[2] for c in chunk], init.n_cap,
                                    b_cap=8))
    return init, out


def _solo(init, jbatches, config=LouvainConfig(), screening=True,
          prev=None):
    return louvain_dynamic_sharded(to_port(init), ONE,
                                   to_port_batches(jbatches), prev=prev,
                                   config=config, screening=screening)


def _serve(cases: dict, **kw):
    return serve_fleet({t: to_port(c[0]) for t, c in cases.items()},
                       {t: to_port_batches(c[1]) for t, c in cases.items()},
                       ONE, **kw)


# -- envelope policies ------------------------------------------------------------

def test_fleet_constants_equal_reference():
    for name in ("FLEET_E_SLACK", "FLEET_MIN_V_PER", "FLEET_MIN_E_PER",
                 "FLEET_GROW_FACTOR"):
        assert getattr(tarch, name) == getattr(jarch, name), name
    env = tarch.FleetEnvelope(64, 256, 8)
    assert (env.v_cap(4), env.e_cap(4)) == (256, 1024)
    assert tuple(env) == tuple(jarch.FleetEnvelope(64, 256, 8))


@SETTINGS
@given(n_cap=st.integers(1, 5000), owned=st.integers(0, 100000),
       b_cap=st.integers(1, 3000), n_shards=st.sampled_from([1, 2, 3, 4, 8]),
       e_need=st.integers(0, 10 ** 6))
def test_envelope_policies_equal_reference(n_cap, owned, b_cap, n_shards,
                                           e_need):
    assert (tarch.fleet_v_per_shard(n_cap, n_shards)
            == jarch.fleet_v_per_shard(n_cap, n_shards))
    env = tarch.fleet_envelope(n_cap, owned, b_cap, n_shards)
    assert tuple(env) == tuple(jarch.fleet_envelope(n_cap, owned, b_cap,
                                                    n_shards))
    assert tuple(tarch.migrate_envelope(env, e_need)) == tuple(
        jarch.migrate_envelope(jarch.FleetEnvelope(*env), e_need))


@SETTINGS
@given(sizings=st.lists(st.tuples(st.integers(1, 600),
                                  st.integers(0, 4000),
                                  st.integers(1, 40)), max_size=12),
       n_shards=st.sampled_from([1, 2, 4]))
def test_plan_fleet_equals_reference(sizings, n_shards):
    got = tarch.plan_fleet(sizings, n_shards)
    want = jarch.plan_fleet(sizings, n_shards)
    assert [(tuple(k), v) for k, v in got.items()] == [
        (tuple(k), v) for k, v in want.items()]


# -- refusals and admission edge cases ----------------------------------------------

def test_serve_zero_tenants():
    res = FleetRouter(ONE).serve({})
    assert res.membership == {} and res.n_dispatches == 0
    assert res.bytes_on_wire == 0 and res.buckets == {}
    assert res.wire_bytes == 0 and res.apply_seconds == []


def test_refusals():
    with pytest.raises(ValueError, match="refine"):
        FleetRouter(ONE, LouvainConfig(refine="leiden"))
    init, _ = _case(20)
    router = FleetRouter(ONE)
    router.admit("a", to_port(init), b_cap=8)
    with pytest.raises(ValueError, match="already admitted"):
        router.admit("a", to_port(init), b_cap=8)
    with pytest.raises(ValueError, match="not admitted"):
        router.serve({"ghost": []})
    with pytest.raises(ValueError, match="apply"):
        FleetRouter(ONE, apply_backend="xla")


def test_oversized_batch_rejected():
    init, _ = _case(21)
    router = FleetRouter(ONE)
    env = router.admit("a", to_port(init), b_cap=1)
    big = jmake_edge_batch(np.array([0, 1]), np.array([2, 3]),
                           np.ones(2, np.float32), init.n_cap,
                           b_cap=4 * env.b_cap)
    with pytest.raises(ValueError, match="exceeds"):
        router.serve({"a": to_port_batches([big])})


def test_empty_stream_keeps_admission_state():
    init, _ = _case(22)
    prev = louvain(to_port(init)).membership
    router = FleetRouter(ONE)
    router.admit("a", to_port(init), prev=prev, b_cap=8)
    res = router.serve({"a": []})
    np.testing.assert_array_equal(res.membership["a"],
                                  np.asarray(prev)[:int(init.n_valid)])
    assert res.n_dispatches == 0 and res.pass_stats["a"] == []


# -- the goldens ------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["gather", "delta"])
@pytest.mark.parametrize("layout", ["replicated", "hybrid"])
@pytest.mark.parametrize("n_tenants", [1, 2])
def test_fleet_reaches_the_sharded_stream_golden(gold, n_tenants, layout,
                                                 backend):
    """One tenant, and two in one bucket (one K4 launch per step for
    both), land on ``sharded_dynamic__sbm_stream`` under both layouts."""
    init, batches = capture.dynamic_stream()
    tids = "ab"[:n_tenants]
    calls = _count_k4()
    try:
        res = _serve({t: (init, batches) for t in tids},
                     screening="community", apply_backend="kernel",
                     config=LouvainConfig(state_layout=layout,
                                          comm_backend=backend))
    finally:
        tdelta.resolve_groups = calls.inner
    for t in tids:
        np.testing.assert_array_equal(res.membership[t],
                                      gold["sharded_dynamic__sbm_stream"])
    assert res.state_layout == layout and len(res.buckets) == 1
    assert res.n_dispatches == len(batches) == calls.n
    assert (res.halo_bytes > 0) == (layout == "hybrid")
    assert res.wire_bytes > 0 and res.comm_rounds > 0


def test_one_tenant_fleet_is_the_solo_stream_on_the_wire():
    """A one-lane bucket runs the solo step: its rounds, priced bytes and
    wire bytes are the solo stream's when every step is accepted; two
    equal tenants under the delta exchange ship exactly twice the wire."""
    init, batches = capture.dynamic_stream()
    cfg = LouvainConfig(comm_backend="delta")
    solo = _solo(init, batches, cfg, screening="community",
                 prev=louvain_dynamic_sharded(to_port(init), ONE, [],
                                              config=cfg).membership)
    one = _serve({"a": (init, batches)}, screening="community", config=cfg)
    two = _serve({"a": (init, batches), "b": (init, batches)},
                 screening="community", config=cfg)
    assert one.n_fallbacks == 0
    assert (one.comm_rounds, one.bytes_on_wire, one.wire_bytes) == (
        solo.comm_rounds, solo.bytes_on_wire, solo.wire_bytes)
    assert two.wire_bytes == 2 * one.wire_bytes
    assert two.bytes_on_wire == 2 * one.bytes_on_wire


# -- fleet == solo on every control path ------------------------------------------

@pytest.mark.parametrize("layout", ["replicated", "hybrid"])
def test_uneven_streams_equal_solo(layout):
    """Lanes whose stream already ended stay idle without perturbing their
    resident state."""
    a, b = _case(34), _case(35)
    cfg = LouvainConfig(state_layout=layout)
    res = _serve({"a": a, "b": (b[0], b[1][:1])}, screening="community",
                 config=cfg)
    np.testing.assert_array_equal(
        res.membership["a"], _solo(*a, cfg, "community").membership)
    np.testing.assert_array_equal(
        res.membership["b"], _solo(b[0], b[1][:1], cfg,
                                   "community").membership)
    assert len(res.pass_stats["b"]) == 1 and len(res.pass_stats["a"]) == 3


def test_fallback_replay_equals_solo():
    """Lanes that never meet the accept rule (aggregation always goes on)
    are replayed through the solo pass loop, invisibly."""
    cfg = LouvainConfig(aggregation_tolerance=1.0, initial_tolerance=0.0)
    cases = {"a": _case(36), "b": _case(37)}
    router = FleetRouter(ONE, cfg, screening="community")
    for tid, (init, _) in cases.items():
        router.admit(tid, to_port(init),
                     prev=np.arange(init.n_cap, dtype=np.int32), b_cap=8)
    res = router.serve({t: to_port_batches(c[1]) for t, c in cases.items()})
    assert res.n_fallbacks > 0
    for tid, (init, batches) in cases.items():
        solo = _solo(init, batches, cfg, "community",
                     prev=np.arange(init.n_cap, dtype=np.int32))
        np.testing.assert_array_equal(res.membership[tid], solo.membership)


@pytest.mark.parametrize("buddy", [True, False])
def test_whale_migrates_and_equals_solo(buddy):
    """The whale overflows its envelope mid-stream and migrates (its old
    lane freezes, its bucket may go all-frozen), finishing as it would
    alone; a buddy in another bucket is untouched."""
    whale = _ring_whale()
    cases = {"whale": whale}
    if buddy:
        cases["buddy"] = _case(39, n_steps=len(whale[1]))
    calls = _count_k4()
    try:
        res = _serve(cases, screening="community", apply_backend="kernel")
    finally:
        tdelta.resolve_groups = calls.inner
    assert res.n_migrations >= 1
    for tid, c in cases.items():
        np.testing.assert_array_equal(
            res.membership[tid], _solo(*c, screening="community").membership)
    homes = [env for env, tids in res.buckets.items() if "whale" in tids]
    assert len(homes) == 1
    assert homes[0].e_per_shard > 2 * int(whale[0].n_valid)
    # One K4 launch per dispatch, plus one per migration's re-apply.
    assert calls.n == res.n_dispatches + res.n_migrations


@pytest.mark.parametrize("replay", [False, True])
def test_auto_screening_replays_through_the_solo_driver(replay):
    """``"auto"`` is host routing over concrete modes: replaying each
    step's recorded mode through the solo driver reproduces the fleet.
    The stream alternates bulky and small batches, so the two-step stale
    measurement matters (and, with every step replayed, the one-step
    stale one of a redispatched bucket)."""
    init, batches = _auto_case()
    cfg = (LouvainConfig(aggregation_tolerance=1.0, initial_tolerance=0.0)
           if replay else LouvainConfig())
    g = to_port(init)
    # From singletons every replayed step needs more than one sweep.
    prev = np.arange(init.n_cap, dtype=np.int32) if replay else None
    router = FleetRouter(ONE, cfg, screening="auto")
    router.admit("a", g, prev=prev, b_cap=8)
    res = router.serve({"a": to_port_batches(batches)})
    stats = res.pass_stats["a"]
    assert stats[0].screening == "community" and stats[0].downgraded
    assert "vertex" in [s.screening for s in stats]
    assert res.n_fallbacks > 0 or not replay
    cur = (prev if replay else
           louvain_dynamic_sharded(g, ONE, [], config=cfg).membership)
    for t, s in enumerate(stats):
        solo = louvain_dynamic_sharded(
            g, ONE, to_port_batches(batches[t:t + 1]), prev=cur,
            config=cfg, screening=s.screening if s.screening else False)
        cur = solo.membership
        g, _ = apply_edge_batch(g, to_port_batches(batches[t:t + 1])[0])
    np.testing.assert_array_equal(res.membership["a"], cur)


# -- the lane-batched apply and move phase -----------------------------------------

class _count_k4:
    """Counts the calls of K4 (its plain version on the CPU) at its
    by-name import in ``core/delta``."""

    def __init__(self):
        self.inner = tdelta.resolve_groups
        self.n = 0

        def counted(*args, **kwargs):
            self.n += 1
            return self.inner(*args, **kwargs)
        tdelta.resolve_groups = counted


def _float_lanes(seed, n_lanes, n_shards):
    """``n_lanes`` random float-weighted graphs in one layout of
    ``n_shards`` ranks (global numpy slot arrays), their batches (inserts,
    reweights, deletions, endpoints past the limit, one lane with an empty
    batch) and per-lane limits."""
    rng = np.random.default_rng(seed)
    n_cap = 40
    graphs, batches = [], []
    for i in range(n_lanes):
        # Lane 0 fills the layout: from singletons its movers overflow the
        # delta exchange's caps.
        n = n_cap if i == 0 else int(rng.integers(20, n_cap + 1))
        e0 = int(rng.integers(2 * n, 4 * n))
        src, dst = rng.integers(0, n, e0), rng.integers(0, n, e0)
        w = (rng.random(e0) + 0.05).astype(np.float32)
        graphs.append(to_port(jbuild_csr(src, dst, w, n, symmetrize=True,
                                         dedup=True, n_cap=n_cap,
                                         e_cap=16 * n_cap)))
        k = 0 if i == 1 else int(rng.integers(1, 9))
        us, vs = rng.integers(0, n + 2, k), rng.integers(0, n + 2, k)
        ws = np.where(rng.random(k) < 0.3, 0.0,
                      rng.random(k) * 2 + 0.1).astype(np.float32)
        batches.append(jmake_edge_batch(us, vs, ws, n_cap, b_cap=8))
    parts = [tdist.partition_graph_host(g, n_shards, n_target=n_cap)
             for g in graphs]
    spec = parts[0][3]._replace(
        e_per_shard=max(p[3].e_per_shard for p in parts) + 6)
    glob = []
    for src, dst, w, sp in parts:
        live = src < sp.sentinel
        glob.append(tdist.bucket_slots_host(src[live], dst[live], w[live],
                                            spec))
    limits = [g.n_valid + (i % 2) for i, g in enumerate(graphs)]
    return graphs, glob, spec, batches, limits


@pytest.mark.parametrize("backend", ["sort", "kernel"])
@pytest.mark.parametrize("seed", range(4))
def test_lane_batched_apply_equals_each_lane_alone(seed, backend):
    """Three lanes on each of 4 ranks: one slot list, one sort, ONE K4
    call per rank; each lane's slots, touched mask and uncapped count
    equal its own apply, and a lane pushed past ``e_per_shard`` leaves its
    neighbours as they are alone."""
    graphs, glob, spec, jbatches, limits = _float_lanes(seed, 3, 4)
    tb = to_port_batches(jbatches)
    lanes = tdist.LaneLayout(spec, 3)
    e, v = spec.e_per_shard, spec.v_per_shard
    for rank in range(4):
        alone = [tdist.rank_slice(*glob[i], spec, rank, "cpu")
                 for i in range(3)]
        flat = lanes.flat_slots(alone)
        calls = _count_k4()
        try:
            got = tdd.apply_batch_shard(
                spec, rank, *flat, torch.stack([b.src for b in tb]),
                torch.stack([b.dst for b in tb]),
                torch.stack([b.weight for b in tb]),
                [b.b_valid for b in tb], limits, backend=backend)
        finally:
            tdelta.resolve_groups = calls.inner
        assert calls.n == (backend == "kernel")
        for i in range(3):
            want = tdd.apply_batch_shard(spec, rank, *alone[i], tb[i].src,
                                         tb[i].dst, tb[i].weight,
                                         tb[i].b_valid, limits[i],
                                         backend=backend)
            blk = slice(i * e, (i + 1) * e)
            assert torch.equal(lanes.tenant_ids(got[0][blk]), want[0])
            assert torch.equal(lanes.tenant_ids(got[1][blk]), want[1])
            assert torch.equal(got[2][blk].view(torch.int32),
                               want[2].view(torch.int32))
            assert torch.equal(got[3][i * v:(i + 1) * v], want[3])
            assert int(got[4][i]) == int(want[4])


@pytest.mark.parametrize("seed", range(3))
def test_lane_overflow_stays_in_its_block(seed):
    """Blocks that hold exactly the widest lane's live slots: a lane that
    overflows keeps its excess out of its neighbour's block, and every
    lane equals its apply alone (its count uncapped)."""
    graphs, glob, spec, jbatches, limits = _float_lanes(seed, 3, 1)
    live = [int((g[0] < spec.sentinel).sum()) for g in glob]
    # The widest lane's block holds exactly its live slots, and its batch
    # inserts three new edges.
    wide = int(np.argmax(live))
    src, dst = glob[wide][0], glob[wide][1]
    have = set(zip(src[src < spec.sentinel].tolist(),
                   dst[src < spec.sentinel].tolist()))
    new = [(u, v) for u in range(graphs[wide].n_valid)
           for v in range(u + 1, graphs[wide].n_valid)
           if (u, v) not in have][:3]
    jbatches[wide] = jmake_edge_batch([u for u, _ in new],
                                      [v for _, v in new],
                                      np.full(3, 0.75, np.float32), 40,
                                      b_cap=8)
    limits[wide] = 40
    tb = to_port_batches(jbatches)
    tight = spec._replace(e_per_shard=max(live))
    glob_t = [tdist.bucket_slots_host(g[0][g[0] < spec.sentinel],
                                      g[1][g[0] < spec.sentinel],
                                      g[2][g[0] < spec.sentinel], tight)
              for g in glob]
    lanes = tdist.LaneLayout(tight, 3)
    e = tight.e_per_shard
    alone = [tdist.rank_slice(*glob_t[i], tight, 0, "cpu") for i in range(3)]
    flat = lanes.flat_slots(alone)
    got = tdd.apply_batch_shard(
        tight, 0, *flat, torch.stack([b.src for b in tb]),
        torch.stack([b.dst for b in tb]), torch.stack([b.weight for b in tb]),
        [b.b_valid for b in tb], limits, backend="kernel")
    for i in range(3):
        want = tdd.apply_batch_shard(tight, 0, *alone[i], tb[i].src,
                                     tb[i].dst, tb[i].weight, tb[i].b_valid,
                                     limits[i], backend="kernel")
        blk = slice(i * e, (i + 1) * e)
        assert torch.equal(lanes.tenant_ids(got[0][blk]), want[0])
        assert torch.equal(got[2][blk].view(torch.int32),
                           want[2].view(torch.int32))
        assert int(got[4][i]) == int(want[4])
    assert max(int(x) for x in got[4]) > e


@pytest.mark.parametrize("layout,backend", [
    ("replicated", "gather"), ("replicated", "delta"), ("hybrid", "gather"),
    ("hybrid", "delta")])
@pytest.mark.parametrize("seed", range(3))
def test_lane_batched_move_phase_equals_each_lane_alone(seed, layout,
                                                        backend):
    """Three float-weighted lanes through ONE ``distributed_move``: a cold
    lane whose movers overflow the delta caps and a warm one that does not
    share every round, each lane taking its own exchange; memberships,
    Sigma, iterations, dQ, rounds and fallback rounds equal each lane's
    phase alone, bit for bit."""
    graphs, glob, spec, _, _ = _float_lanes(seed, 3, 1)
    lanes = tdist.LaneLayout(spec, 3)
    alone = [tdist.rank_slice(*glob[i], spec, 0, "cpu") for i in range(3)]
    flat = lanes.flat_slots(alone)
    n_pad = spec.n_pad
    mems = []
    for i, g in enumerate(graphs):
        if i == 1:      # a warm lane: its converged membership
            mem = louvain(g).membership
        else:           # a cold lane: singletons
            mem = np.arange(g.n_valid)
        mems.append(torch.from_numpy(pad_membership(
            mem.astype(np.int32), n_pad)))
    nv = [g.n_valid for g in graphs]
    cfg = EngineConfig()
    kw = dict(config=cfg, comm_backend=backend, state_layout=layout)
    thr = lanes.thresholds(nv, "cpu")
    k = tdist._vertex_k(ONE, lanes.flat, flat[0], flat[2])
    m = tdist._total_weight(ONE, flat[2], 3)
    comm0, sigma0 = tdist._warm_comm_sigma(
        lanes.flat_membership(torch.stack(mems)), k, thr)
    front = torch.arange(lanes.flat.n_pad + 1) < thr
    got = tdist.distributed_move(ONE, spec, *flat, comm0, sigma0, k, front,
                                 m, np.full(3, 0.01), n_lanes=3, **kw)
    rows = lanes.tenant_rows(got[0])
    fallbacks = []
    for i in range(3):
        k_i = tdist._vertex_k(ONE, spec, alone[i][0], alone[i][2])
        m_i = tdist._total_weight(ONE, alone[i][2])
        c0, s0 = tdist._warm_comm_sigma(mems[i], k_i, nv[i])
        fr = torch.arange(n_pad + 1) < nv[i]
        want = tdist.distributed_move(ONE, spec, *alone[i], c0, s0, k_i, fr,
                                      m_i, 0.01, **kw)
        assert torch.equal(rows[i], want[0])
        sig = lanes.rows(got[1]).view(torch.int32)
        assert torch.equal(sig[i], want[1][:n_pad].view(torch.int32))
        assert int(got[2][i]) == want[2]
        assert got[3][i].view(torch.int32) == want[3].view(torch.int32)
        assert (int(got[4][i]), int(got[5][i])) == (want[4], want[5])
        fallbacks.append(want[5])
    if backend == "delta":
        assert fallbacks[0] > 0 and fallbacks[1] == 0


# -- direct parity with the JAX fleet at one shard ---------------------------------

def _compare_with_reference(jres, tres):
    assert set(jres.membership) == set(tres.membership)
    for tid in jres.membership:
        np.testing.assert_array_equal(tres.membership[tid],
                                      np.asarray(jres.membership[tid]))
        assert tres.n_communities[tid] == jres.n_communities[tid]
    for f in ("n_fallbacks", "n_migrations", "comm_rounds", "bytes_on_wire",
              "halo_bytes", "state_layout", "comm_backend",
              "boundary_frac"):
        assert getattr(tres, f) == getattr(jres, f), f
    assert [(tuple(k), v) for k, v in tres.buckets.items()] == [
        (tuple(k), v) for k, v in jres.buckets.items()]
    assert [(tuple(k), v) for k, v in tres.bucket_layouts.items()] == [
        (tuple(k), v) for k, v in jres.bucket_layouts.items()]
    for tid, jstats in jres.pass_stats.items():
        tstats = tres.pass_stats[tid]
        assert len(tstats) == len(jstats)
        for a, b in zip(tstats, jstats):
            for f in ("iterations", "n_communities", "n_vertices",
                      "frontier_size", "n_cap", "e_cap", "screening",
                      "scan_backend", "downgraded"):
                assert getattr(a, f) == getattr(b, f), (tid, f)
            assert a.dq_sum == pytest.approx(float(b.dq_sum), rel=1e-6,
                                             abs=1e-7)


@pytest.mark.parametrize("screening", ["community", "auto"])
@pytest.mark.parametrize("cfg", [{}, {"state_layout": "hybrid"},
                                 {"comm_backend": "delta"}],
                         ids=["default", "hybrid", "delta"])
def test_fused_accept_equals_the_reference_fleet(mesh, cfg, screening):
    cases = {"t0": _case(30), "t1": _case(31), "t2": _auto_case(41)}
    jres = jserve({t: c[0] for t, c in cases.items()},
                  {t: c[1] for t, c in cases.items()}, mesh, AXES,
                  screening=screening, config=JConfig(**cfg))
    tres = _serve(cases, screening=screening, config=LouvainConfig(**cfg))
    _compare_with_reference(jres, tres)
    assert tres.n_fallbacks == 0 and tres.n_migrations == 0


@pytest.mark.parametrize("screening", ["community", "auto"])
def test_fallback_equals_the_reference_fleet(mesh, screening):
    cfg = dict(aggregation_tolerance=1.0, initial_tolerance=0.0)
    cases = {"a": _case(36), "b": _auto_case(37)}
    jr = JRouter(mesh, AXES, JConfig(**cfg), screening=screening)
    tr = FleetRouter(ONE, LouvainConfig(**cfg), screening=screening)
    for tid, (init, _) in cases.items():
        prev = np.arange(init.n_cap, dtype=np.int32)
        jr.admit(tid, init, prev=prev, b_cap=8)
        tr.admit(tid, to_port(init), prev=prev, b_cap=8)
    jres = jr.serve({t: c[1] for t, c in cases.items()})
    tres = tr.serve({t: to_port_batches(c[1]) for t, c in cases.items()})
    _compare_with_reference(jres, tres)
    assert tres.n_fallbacks > 0


@pytest.mark.parametrize("screening", ["community", "auto"])
@pytest.mark.parametrize("buddy", [True, False])
def test_migration_equals_the_reference_fleet(mesh, buddy, screening):
    whale = _ring_whale()
    cases = {"whale": whale}
    if buddy:
        cases["buddy"] = _case(39, n_steps=len(whale[1]))
    jres = jserve({t: c[0] for t, c in cases.items()},
                  {t: c[1] for t, c in cases.items()}, mesh, AXES,
                  screening=screening)
    tres = _serve(cases, screening=screening)
    _compare_with_reference(jres, tres)
    assert tres.n_migrations >= 1


def test_cold_admission_and_uneven_streams_equal_the_reference_fleet(mesh):
    a, b = _case(34), _case(35)
    cases = {"a": a, "b": (b[0], b[1][:1]), "c": (_case(33)[0], [])}
    jres = jserve({t: c[0] for t, c in cases.items()},
                  {t: c[1] for t, c in cases.items()}, mesh, AXES,
                  screening="auto")
    tres = _serve(cases, screening="auto")
    _compare_with_reference(jres, tres)


# -- four gloo ranks ------------------------------------------------------------------

FLEET_CONFIGS = [({}, "community"), ({"state_layout": "hybrid"}, "auto"),
                 ({"aggregation_tolerance": 1.0, "initial_tolerance": 0.0},
                  "community")]


def _four_rank_runs():
    """The 4-rank launch's runs: each fleet of ``FLEET_CONFIGS`` (two SBM
    tenants; the last from singleton memberships, so its lanes replay), a
    whale with its buddy, and every tenant's solo stream under the same
    knobs."""
    graphs, runs, solos = {}, [], []
    tenants = {"a": _case(30), "b": _auto_case(31)}
    # On 4 ranks the envelope's batch headroom is a quarter of a rank's
    # share, so the whale overflows only after 15 of its batches.
    whale = {"whale": _ring_whale(n_batches=20),
             "buddy": _case(39, n_steps=20)}
    for tid, (init, _) in {**tenants, **whale}.items():
        graphs[tid] = arrays(init)
    for j, (cfg, screening) in enumerate(FLEET_CONFIGS):
        fleet = {}
        for tid, (init, batches) in tenants.items():
            prev = (np.arange(init.n_cap, dtype=np.int32)
                    if j == 2 else None)
            bl = [batch_arrays(b) for b in batches]
            fleet[tid] = {"graph": tid, "batches": bl, "prev": prev}
            solos.append((tid, {"batches": bl, "config": cfg,
                                "screening": screening, "prev": prev}))
        runs.append(("a", {"tenants": fleet, "config": cfg,
                           "screening": screening}))
    fleet = {}
    for tid, (init, batches) in whale.items():
        bl = [batch_arrays(b) for b in batches]
        fleet[tid] = {"graph": tid, "batches": bl, "prev": None}
        solos.append((tid, {"batches": bl, "screening": "community"}))
    runs.append(("a", {"tenants": fleet, "screening": "community"}))
    return graphs, runs + solos


@pytest.fixture(scope="module")
def four_ranks():
    graphs, runs = _four_rank_runs()
    return runs, collectives.launch(tdist.rank_runs, 4, graphs, runs,
                                    backend="gloo", devices=["cpu"] * 4,
                                    timeout=RANK_TIMEOUT)


def test_four_ranks_fleet_equals_solo_and_world_size_one(four_ranks):
    runs, out = four_ranks
    n_fleets = len(FLEET_CONFIGS) + 1
    fleets, solos = runs[:n_fleets], runs[n_fleets:]
    solo_res = iter(out[0]["results"][n_fleets:])
    for f, (_, kwargs) in enumerate(fleets):
        res = out[0]["results"][f]
        for r in range(1, 4):
            other = out[r]["results"][f]
            assert other.membership.keys() == res.membership.keys()
            for tid in res.membership:
                np.testing.assert_array_equal(other.membership[tid],
                                              res.membership[tid])
            assert (other.comm_rounds, other.wire_bytes) == (
                res.comm_rounds, res.wire_bytes)
        for tid in kwargs["tenants"]:
            np.testing.assert_array_equal(res.membership[tid],
                                          next(solo_res).membership)
        # World size 1, in process, through the same rank entry.
        one = tdist.rank_runs(ONE, _four_rank_runs()[0],
                              [fleets[f]])["results"][0]
        # (Fallbacks and migrations may fall on other steps: a sweep's dQ
        # is summed over other partials, and a rank holds fewer slots.)
        for tid in one.membership:
            np.testing.assert_array_equal(res.membership[tid],
                                          one.membership[tid])
    assert out[0]["results"][2].n_fallbacks > 0
    assert out[0]["results"][3].n_migrations >= 1
    assert out[0]["results"][1].state_layout == "hybrid"
    assert all(o["branch_reads"] > 0 for o in out)


# -- four port ranks against four JAX host devices (slow) -------------------------

_JAX_SCRIPT = r"""
import os, json, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, "tests")
import numpy as np
from test_torch_fleet import _case, _auto_case, _ring_whale, FLEET_CONFIGS
from repro.compat import make_mesh
from repro.core.fleet import FleetRouter
from repro.core.louvain import LouvainConfig
mesh = make_mesh((2, 2), ("data", "model"))
out = []
for j, (cfg, screening) in enumerate(FLEET_CONFIGS):
    cases = {"a": _case(30), "b": _auto_case(31)}
    router = FleetRouter(mesh, ("data", "model"), LouvainConfig(**cfg),
                         screening=screening)
    for tid, (init, _) in cases.items():
        prev = np.arange(init.n_cap, dtype=np.int32) if j == 2 else None
        router.admit(tid, init, prev=prev, b_cap=8)
    res = router.serve({t: c[1] for t, c in cases.items()})
    out.append({"membership": {t: np.asarray(m).tolist()
                               for t, m in res.membership.items()},
                "n_fallbacks": res.n_fallbacks, "comm_rounds": res.comm_rounds,
                "bytes_on_wire": res.bytes_on_wire,
                "halo_bytes": res.halo_bytes,
                "screening": {t: [s.screening for s in v]
                              for t, v in res.pass_stats.items()}})
print(json.dumps(out))
"""


@pytest.mark.slow
def test_four_port_ranks_equal_four_jax_devices_fleet(four_ranks):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _JAX_SCRIPT], env=env,
                          capture_output=True, text=True, timeout=1200,
                          cwd=root)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    _, out = four_ranks
    for f, w in enumerate(want):
        got = out[0]["results"][f]
        for tid, mem in w["membership"].items():
            np.testing.assert_array_equal(got.membership[tid],
                                          np.asarray(mem))
        for k in ("n_fallbacks", "comm_rounds", "bytes_on_wire",
                  "halo_bytes"):
            assert getattr(got, k) == w[k], k
        assert {t: [s.screening for s in v]
                for t, v in got.pass_stats.items()} == w["screening"]
