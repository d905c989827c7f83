"""Sharded streaming Louvain of the port
(``repro_torch.core.distributed_dynamic``) against the JAX package's
``repro.core.distributed_dynamic`` and the committed goldens, on the CPU.

The per-rank batch apply is held against the reference's shard by shard,
through the sort chain and through K4's plain version; the stream at world
size 1 reproduces both ``sharded_dynamic*`` goldens under the replicated
and the hybrid layouts, equals the port's ``louvain_dynamic`` and carries
the reference's result fields; ONE spawned run of 4 gloo CPU ranks holds
the multi-rank stream to world size 1.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden import capture_engine_golden as capture

from repro.compat import make_mesh
from repro.core import distributed as jdist
from repro.core import distributed_dynamic as jdd
from repro.core.delta import make_edge_batch as jmake_edge_batch
from repro.core.graph import build_csr as jbuild_csr
from repro.core.louvain import LouvainConfig as JConfig
from repro.data import sbm_graph as jsbm_graph

from repro_torch import (LouvainConfig, ShardGroup, build_csr, louvain,
                         louvain_dynamic, louvain_dynamic_sharded,
                         make_edge_batch, membership_modularity, rmat_graph,
                         sbm_edge_stream)
from repro_torch.core import collectives, distributed as tdist
from repro_torch.core import distributed_dynamic as tdd
from repro_torch.interop import (edge_batch_from_numpy, graph_from_numpy,
                                 sharded_from_numpy)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "engine_memberships.npz")
#: The hard limit of one spawned multi-rank run (seconds).
RANK_TIMEOUT = 240
ONE = ShardGroup.single("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def gold():
    return np.load(GOLDEN)


def arrays(jg) -> dict:
    return dict(indptr=np.asarray(jg.indptr), indices=np.asarray(jg.indices),
                weights=np.asarray(jg.weights), src=np.asarray(jg.src),
                n_valid=int(jg.n_valid), e_valid=int(jg.e_valid))


def to_port(jg):
    return graph_from_numpy(**arrays(jg), device="cpu")


def batch_arrays(b) -> dict:
    return dict(src=np.asarray(b.src), dst=np.asarray(b.dst),
                weight=np.asarray(b.weight), b_valid=int(b.b_valid))


def to_port_batches(jbatches):
    return [edge_batch_from_numpy(**batch_arrays(b), device="cpu")
            for b in jbatches]


def gold_key(refine):
    return (f"sharded_dynamic{'_leiden' if refine == 'leiden' else ''}"
            "__sbm_stream")


# -- the per-rank batch apply ---------------------------------------------------

def _random_graph(rng):
    n = int(rng.integers(6, 16))
    e0 = int(rng.integers(2, 3 * n))
    src = rng.integers(0, n, e0)
    dst = rng.integers(0, n, e0)
    w = (rng.random(e0) + 0.1).astype(np.float32)
    return n, jbuild_csr(src, dst, w, n, symmetrize=True, dedup=True,
                         n_cap=16, e_cap=192)


@pytest.mark.parametrize("backend", ["sort", "kernel"])
@pytest.mark.parametrize("seed", range(6))
def test_apply_batch_shard_equals_reference(seed, backend):
    """Random insert / delete / reweight batches on a 4-rank layout: every
    rank's slots, touched-owned mask and uncapped count equal the
    reference's shard for shard, batch after batch."""
    rng = np.random.default_rng(seed)
    n, g = _random_graph(rng)
    src_g, dst_g, w_g, jspec = jdist.partition_graph_host(
        g, 4, n_target=g.n_cap, e_per_shard=64)
    spec = tdist.ShardedGraphSpec(*jspec)
    e_per = spec.e_per_shard
    jslots = [[x[s * e_per:(s + 1) * e_per] for x in (src_g, dst_g, w_g)]
              for s in range(4)]
    tslots = [list(sharded_from_numpy(src_g, dst_g, w_g, jspec, s, "cpu"))
              for s in range(4)]
    for _ in range(3):
        b = int(rng.integers(1, 8))
        us, vs = rng.integers(0, n, b), rng.integers(0, n, b)
        ws = np.where(rng.random(b) < 0.3, 0.0,
                      rng.random(b) * 2 + 0.1).astype(np.float32)
        jb = jmake_edge_batch(us, vs, ws, g.n_cap, b_cap=8)
        tb = edge_batch_from_numpy(**batch_arrays(jb), device="cpu")
        for s in range(4):
            want = jdd.apply_batch_shard(jspec, jnp.asarray(s, jnp.int32),
                                         *jslots[s], jb.src, jb.dst,
                                         jb.weight, jb.b_valid)
            got = tdd.apply_batch_shard(spec, s, *tslots[s], tb.src, tb.dst,
                                        tb.weight, tb.b_valid,
                                        backend=backend)
            for a, w in zip(got[:4], want[:4]):
                np.testing.assert_array_equal(a.numpy(), np.asarray(w))
            assert int(got[4]) == int(want[4])
            jslots[s], tslots[s] = list(want[:3]), list(got[:3])


@pytest.mark.parametrize("backend", ["sort", "kernel"])
def test_apply_batch_shard_drops_out_of_capacity_endpoints(backend):
    """n_pad (12) exceeds n_cap (10) at 4 ranks: an entry with an endpoint
    in [n_cap, n_pad) is dropped as the single-device apply drops it."""
    g = jbuild_csr(np.array([0, 1]), np.array([1, 0]),
                   np.ones(2, np.float32), 10, n_cap=10, e_cap=32)
    src_g, dst_g, w_g, jspec = jdist.partition_graph_host(
        g, 4, n_target=g.n_cap, e_per_shard=16)
    assert jspec.n_pad > g.n_cap
    jb = jmake_edge_batch([10, 2], [3, 3], [1.0, 1.0], g.n_cap, b_cap=4)
    tb = edge_batch_from_numpy(**batch_arrays(jb), device="cpu")
    spec = tdist.ShardedGraphSpec(*jspec)
    live = {}
    for s in range(4):
        sl = sharded_from_numpy(src_g, dst_g, w_g, jspec, s, "cpu")
        got = tdd.apply_batch_shard(spec, s, *sl, tb.src, tb.dst, tb.weight,
                                    tb.b_valid, n_limit=g.n_cap,
                                    backend=backend)
        e = jspec.e_per_shard
        want = jdd.apply_batch_shard(
            jspec, jnp.asarray(s, jnp.int32), src_g[s * e:(s + 1) * e],
            dst_g[s * e:(s + 1) * e], w_g[s * e:(s + 1) * e], jb.src, jb.dst,
            jb.weight, jb.b_valid, n_limit=g.n_cap)
        for a, w in zip(got[:4], want[:4]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(w))
        keep = got[0] < spec.sentinel
        live.update(zip(zip(got[0][keep].tolist(), got[1][keep].tolist()),
                        got[2][keep].tolist()))
    assert (2, 3) in live and (3, 2) in live
    assert not any(u >= g.n_cap or v >= g.n_cap for u, v in live)


@pytest.mark.parametrize("seed", range(3))
def test_grow_slots_equals_the_reference_rebucket(seed):
    """Growth pads every rank's slots; the reference re-buckets the gathered
    live slots on the host into the same arrays."""
    rng = np.random.default_rng(seed)
    _, g = _random_graph(rng)
    src_g, dst_g, w_g, jspec = jdist.partition_graph_host(
        g, 4, n_target=g.n_cap)
    grown = jspec._replace(e_per_shard=2 * jspec.e_per_shard + 3)
    want = jdd._rebucket_host(src_g, dst_g, w_g, grown)
    spec = tdist.ShardedGraphSpec(*jspec)
    parts = [tdd._grow_slots(spec, *sharded_from_numpy(
        src_g, dst_g, w_g, jspec, s, "cpu"), grown.e_per_shard)
        for s in range(4)]
    assert tuple(parts[0][3]) == tuple(grown)
    for i in range(3):
        np.testing.assert_array_equal(
            torch.cat([p[i] for p in parts]).numpy(), np.asarray(want[i]))
    with pytest.raises(ValueError, match="shrink"):
        tdd._grow_slots(spec, *parts[0][:3], 1)


# -- world size 1 ----------------------------------------------------------------

@pytest.mark.parametrize("refine", ["none", "leiden"])
@pytest.mark.parametrize("state_layout", ["replicated", "hybrid"])
@pytest.mark.parametrize("comm_backend", ["gather", "delta"])
def test_sharded_stream_reproduces_the_goldens(gold, refine, state_layout,
                                               comm_backend):
    init, batches = sbm_edge_stream(device="cpu")
    res = louvain_dynamic_sharded(
        init, ONE, batches,
        config=LouvainConfig(refine=refine, state_layout=state_layout,
                             comm_backend=comm_backend))
    np.testing.assert_array_equal(res.membership, gold[gold_key(refine)])
    assert res.state_layout == state_layout and res.comm_rounds > 0
    assert (res.halo_bytes > 0) == (state_layout == "hybrid")
    assert len(res.batch_stats) == 8 and res.n_regrows == 0
    assert all(s.n_touched > 0 for s in res.batch_stats)


@pytest.mark.parametrize("kw", [
    {"reshard": "auto", "pipeline_fetch": True, "comm_backend": "delta"},
    {"use_ladder": False}, {"state_layout": "auto"}],
    ids=["reshard-pipeline", "no-ladder", "auto-layout"])
def test_sharded_stream_knobs_keep_the_golden(gold, kw):
    init, batches = sbm_edge_stream(device="cpu")
    res = louvain_dynamic_sharded(init, ONE, batches,
                                  config=LouvainConfig(**kw))
    np.testing.assert_array_equal(res.membership,
                                  gold["sharded_dynamic__sbm_stream"])
    assert res.reshard_passes == 0 and res.reshard_bytes == 0


def _rmat_holdout_stream(scale, seed=13, b_cap=64, n_batches=8):
    """Phase 5's recipe of ``chip_smoke.py`` at a small scale: an R-MAT
    graph with 1% of its undirected edges held out, then batches of 0.1%
    of them, 80% inserts of held-out edges and 20% deletions."""
    g = rmat_graph(scale, 16, seed=0, device="cpu")
    e = g.e_valid
    src, dst = g.src[:e], g.indices[:e]
    und = src < dst
    us, ud = src[und].numpy(), dst[und].numpy()
    n_und = len(us)
    n_hold, b_size = n_und // 100, n_und // 1000
    n_ins = b_size * 4 // 5
    n_del = b_size - n_ins
    rng = np.random.default_rng(seed)
    pick = rng.choice(n_und, n_hold + n_batches * n_del, replace=False)
    hold, dele = pick[:n_hold], pick[n_hold:]
    keep = np.ones(n_und, bool)
    keep[hold] = False
    init = build_csr(us[keep], ud[keep], np.ones(int(keep.sum()), np.float32),
                     g.n_valid, e_cap=e + 2 * b_cap, symmetrize=True,
                     dedup=False, device="cpu")
    batches = []
    for i in range(n_batches):
        idx = np.concatenate([hold[i * n_ins:(i + 1) * n_ins],
                              dele[i * n_del:(i + 1) * n_del]])
        w = np.concatenate([np.ones(n_ins), np.zeros(n_del)])
        perm = rng.permutation(len(idx))
        batches.append(make_edge_batch(us[idx[perm]], ud[idx[perm]],
                                       w[perm], g.n_cap, b_cap=b_cap,
                                       device="cpu"))
    return init, batches


@pytest.fixture(scope="module")
def rmat_stream():
    init, batches = _rmat_holdout_stream(10)
    return init, batches, louvain(init).membership


@pytest.mark.parametrize("screening", [True, "vertex", "auto", False])
def test_sharded_stream_equals_louvain_dynamic(rmat_stream, screening):
    """At world size 1 the sharded stream is ``louvain_dynamic`` label for
    label on phase 5's mix (deletions included), with the same touched
    counts and frontiers."""
    init, batches, prev = rmat_stream
    want = louvain_dynamic(init, batches, prev=prev, screening=screening)
    got = louvain_dynamic_sharded(init, ONE, batches, prev=prev,
                                  screening=screening)
    np.testing.assert_array_equal(got.membership, want.membership)
    for a, b in zip(got.batch_stats, want.batch_stats):
        assert (a.n_touched, a.frontier_size, a.n_vertices,
                a.n_communities) == (b.n_touched, b.frontier_size,
                                     b.n_vertices, b.n_communities)
    assert got.updates_per_second > 0 and got.partition_seconds >= 0.0


def _holdout_stream(n_comms, size, n_hold, n_batches, seed):
    """The reference's ``tests/test_distributed_dynamic.py`` stream."""
    full, _ = jsbm_graph(n_communities=n_comms, size=size, p_in=0.4,
                         p_out=0.005, seed=seed)
    e = int(full.e_valid)
    src = np.asarray(full.src)[:e]
    dst = np.asarray(full.indices)[:e]
    w = np.asarray(full.weights)[:e]
    und = src < dst
    us, ud, uw = src[und], dst[und], w[und]
    rng = np.random.default_rng(seed)
    hold = rng.choice(len(us), n_hold, replace=False)
    keep = np.ones(len(us), bool)
    keep[hold] = False
    init = jbuild_csr(np.concatenate([us[keep], ud[keep]]),
                      np.concatenate([ud[keep], us[keep]]),
                      np.concatenate([uw[keep], uw[keep]]),
                      int(full.n_valid), e_cap=e + 8)
    batches = [jmake_edge_batch(us[hold[i::n_batches]], ud[hold[i::n_batches]],
                                uw[hold[i::n_batches]], init.n_cap, b_cap=8)
               for i in range(n_batches)]
    return full, init, batches


@pytest.fixture(scope="module")
def holdout():
    full, init, batches = _holdout_stream(16, 16, 60, 10, seed=7)
    prev = louvain(to_port(init)).membership
    return full, init, batches, prev


def test_capacity_growth_regrows_and_equals_reference(holdout):
    """``e_per_shard=1`` regrows (the reference's growth law) and gives the
    reference's membership and layout; ``grow_capacity=False`` raises."""
    full, init, jbatches, prev = holdout
    mesh = make_mesh((1,), ("shard",))
    want = jdd.louvain_dynamic_sharded(init, mesh, ("shard",), jbatches,
                                       prev=prev, e_per_shard=1)
    got = louvain_dynamic_sharded(to_port(init), ONE,
                                  to_port_batches(jbatches), prev=prev,
                                  e_per_shard=1)
    assert got.n_regrows == want.n_regrows >= 1
    assert tuple(got.spec) == tuple(want.spec) and got.spec.e_per_shard > 1
    np.testing.assert_array_equal(got.membership, want.membership)
    ample = louvain_dynamic_sharded(to_port(init), ONE,
                                    to_port_batches(jbatches), prev=prev)
    g_full = to_port(full)
    assert abs(membership_modularity(g_full, got.membership)
               - membership_modularity(g_full, ample.membership)) < 0.02
    with pytest.raises(ValueError, match="overflow"):
        louvain_dynamic_sharded(to_port(init), ONE,
                                to_port_batches(jbatches), prev=prev,
                                e_per_shard=1, grow_capacity=False)


FIELDS = ("n_communities", "n_regrows", "comm_backend", "comm_rounds",
          "comm_fallback_rounds", "bytes_on_wire", "reshard_passes",
          "reshard_bytes", "max_shard_load_frac_before",
          "max_shard_load_frac_after", "coarse_e_per_max", "state_layout",
          "halo_bytes", "boundary_frac")


@pytest.mark.parametrize("cfg,kw", [
    ({}, {}),
    ({"comm_backend": "delta", "state_layout": "hybrid"}, {}),
    ({"refine": "leiden"}, {"screening": "vertex"}),
    ({"comm_backend": "gather"}, {"screening": False,
                                  "track_modularity": True}),
], ids=["default", "hybrid-delta", "leiden-vertex", "naive-tracked"])
def test_result_fields_equal_reference_at_one_shard(holdout, cfg, kw):
    _, init, jbatches, prev = holdout
    mesh = make_mesh((1,), ("shard",))
    want = jdd.louvain_dynamic_sharded(init, mesh, ("shard",), jbatches,
                                       prev=prev, config=JConfig(**cfg),
                                       **kw)
    got = louvain_dynamic_sharded(to_port(init), ONE,
                                  to_port_batches(jbatches), prev=prev,
                                  config=LouvainConfig(**cfg), **kw)
    np.testing.assert_array_equal(got.membership, want.membership)
    for f in FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    assert tuple(got.spec) == tuple(want.spec)
    assert got.bytes_per_round == want.bytes_per_round
    assert got.halo_bytes_per_round == want.halo_bytes_per_round
    for a, b in zip(got.batch_stats, want.batch_stats):
        assert (a.batch_size, a.n_touched, a.frontier_size, a.n_vertices,
                a.n_communities) == (b.batch_size, b.n_touched,
                                     b.frontier_size, b.n_vertices,
                                     b.n_communities)
        if kw.get("track_modularity"):
            assert a.modularity == pytest.approx(float(b.modularity),
                                                 abs=1e-5)


@pytest.mark.parametrize("cfg", [
    {"comm_backend": "gather"}, {"comm_backend": "delta"},
    {"comm_backend": "gather", "state_layout": "hybrid"},
    {"comm_backend": "delta", "state_layout": "hybrid"}],
    ids=["gather", "delta", "hybrid-gather", "hybrid-delta"])
def test_stream_wire_bytes_beside_the_priced_bytes(holdout, cfg):
    """``wire_bytes`` sums the pass rows' wire beside ``bytes_on_wire``, the
    reference's price: equal for a delta stream whose rounds never fell
    back, above it for the gather exchange and the hybrid layout."""
    _, init, jbatches, prev = holdout
    res = louvain_dynamic_sharded(to_port(init), ONE,
                                  to_port_batches(jbatches), prev=prev,
                                  config=LouvainConfig(**cfg))
    if cfg == {"comm_backend": "delta"} and res.comm_fallback_rounds == 0:
        assert res.wire_bytes == res.bytes_on_wire
    else:
        assert res.wire_bytes > res.bytes_on_wire
    assert res.comm_rounds > 0


# -- four gloo ranks ---------------------------------------------------------------

STREAM_CONFIGS = [{}, {"comm_backend": "gather"},
                  {"state_layout": "hybrid"},
                  {"state_layout": "hybrid", "comm_backend": "gather"},
                  {"refine": "leiden"},
                  {"reshard": "auto", "pipeline_fetch": True}]


@pytest.fixture(scope="module")
def four_ranks():
    """One spawned run of 4 gloo CPU ranks: the golden stream under each of
    ``STREAM_CONFIGS`` and with ``e_per_shard=1`` (growth)."""
    jinit, jbatches = capture.dynamic_stream()
    graphs = {"stream": arrays(jinit)}
    bl = [batch_arrays(b) for b in jbatches]
    runs = [("stream", {"batches": bl, "config": c}) for c in STREAM_CONFIGS]
    runs.append(("stream", {"batches": bl, "e_per_shard": 1}))
    return collectives.launch(tdist.rank_runs, 4, graphs, runs,
                              backend="gloo", devices=["cpu"] * 4,
                              timeout=RANK_TIMEOUT)


@pytest.mark.parametrize("i", range(len(STREAM_CONFIGS) + 1),
                         ids=[str(c) for c in STREAM_CONFIGS] + ["grow"])
def test_four_ranks_equal_world_size_one(gold, four_ranks, i):
    res = four_ranks[0]["results"][i]
    cfg = STREAM_CONFIGS[i] if i < len(STREAM_CONFIGS) else {}
    np.testing.assert_array_equal(res.membership,
                                  gold[gold_key(cfg.get("refine", "none"))])
    for r in range(1, 4):
        other = four_ranks[r]["results"][i]
        np.testing.assert_array_equal(other.membership, res.membership)
        assert other.comm_rounds == res.comm_rounds
    assert res.spec.n_shards == 4
    assert res.wire_bytes >= res.bytes_on_wire - res.reshard_bytes > 0
    assert all(four_ranks[r]["results"][i].wire_bytes == res.wire_bytes
               for r in range(1, 4))
    assert res.state_layout == cfg.get("state_layout", "replicated")
    if i == len(STREAM_CONFIGS):
        assert res.n_regrows >= 1


# -- four port ranks against four JAX host devices (slow) -----------------------

_JAX_SCRIPT = r"""
import os, json, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, "tests")
import dataclasses
import numpy as np
from golden import capture_engine_golden as capture
from test_torch_distributed_dynamic import STREAM_CONFIGS
from repro.compat import make_mesh
from repro.core.distributed_dynamic import louvain_dynamic_sharded
from repro.core.louvain import LouvainConfig
mesh = make_mesh((2, 2), ("data", "model"))
init, batches = capture.dynamic_stream()
out = []
for cfg in STREAM_CONFIGS:
    res = louvain_dynamic_sharded(init, mesh, ("data", "model"), batches,
                                  config=LouvainConfig(**cfg))
    row = {k: v for k, v in dataclasses.asdict(res).items()
           if k in ("n_communities", "n_regrows", "comm_backend",
                    "comm_rounds", "comm_fallback_rounds", "bytes_on_wire",
                    "reshard_passes", "reshard_bytes", "coarse_e_per_max",
                    "state_layout", "halo_bytes", "boundary_frac")}
    row["membership"] = np.asarray(res.membership).tolist()
    row["touched"] = [s.n_touched for s in res.batch_stats]
    row["frontier"] = [s.frontier_size for s in res.batch_stats]
    out.append(row)
print(json.dumps(out))
"""


@pytest.mark.slow
def test_four_port_ranks_equal_four_jax_devices_streaming():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _JAX_SCRIPT], env=env,
                          capture_output=True, text=True, timeout=1200,
                          cwd=root)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    jinit, jbatches = capture.dynamic_stream()
    bl = [batch_arrays(b) for b in jbatches]
    runs = [("stream", {"batches": bl, "config": c}) for c in STREAM_CONFIGS]
    out = collectives.launch(tdist.rank_runs, 4, {"stream": arrays(jinit)},
                             runs, backend="gloo", devices=["cpu"] * 4,
                             timeout=600)
    for w, got in zip(want, out[0]["results"]):
        np.testing.assert_array_equal(got.membership,
                                      np.asarray(w.pop("membership")))
        assert [s.n_touched for s in got.batch_stats] == w.pop("touched")
        assert [s.frontier_size for s in got.batch_stats] == w.pop("frontier")
        for k, v in w.items():
            assert getattr(got, k) == v, k
