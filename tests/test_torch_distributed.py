"""The sharded static driver of the port (``repro_torch.core.distributed``,
``distributed_louvain`` over a ``ShardGroup``) against the JAX package's
``repro.core.distributed`` and the committed goldens, on the CPU.

World size 1 runs in this process (``ShardGroup.single``); the multi-rank
cases spawn 4 gloo ranks on the CPU through ``collectives.launch``, whose
rank entry (``distributed.rank_runs``) lives in the port so that the ranks
import no JAX.  Sharding must not change a single label: the sharded
goldens were captured on one shard and equal the single-device ones, and
the 4-rank runs are held to the same goldens.
"""

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

from repro_torch import (AggregationOverflow, ShardGroup,
                         distributed_louvain)
from repro_torch.core import collectives, distributed as tdist
from repro_torch.interop import graph_from_numpy, sharded_from_numpy

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "engine_memberships.npz")
NAMES = ["lesmis", "sbm", "ring_of_cliques", "gnp"]
#: The hard limit of one spawned multi-rank run (seconds).
RANK_TIMEOUT = 240
#: Stats columns that must equal the reference's exactly.
EXACT = ("iterations", "n_communities", "n_vertices", "n_pad",
         "e_per_shard", "comm_backend", "comm_rounds",
         "comm_fallback_rounds", "comm_bytes", "state_layout", "halo_bytes",
         "boundary_frac", "refine_iterations", "n_refined", "reshard",
         "reshard_bytes", "max_shard_load_frac_before",
         "max_shard_load_frac_after")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def gold():
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def corpora():
    return capture.corpora()


def arrays(jg) -> dict:
    return dict(indptr=np.asarray(jg.indptr), indices=np.asarray(jg.indices),
                weights=np.asarray(jg.weights), src=np.asarray(jg.src),
                n_valid=int(jg.n_valid), e_valid=int(jg.e_valid))


def to_port(jg):
    return graph_from_numpy(**arrays(jg), device="cpu")


def key(refine, name):
    return f"sharded{'_leiden' if refine == 'leiden' else ''}__{name}"


def same_rows(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for col in EXACT:
            assert g[col] == w[col], (col, g[col], w[col])
        assert g["dq_sum"] == pytest.approx(w["dq_sum"], rel=1e-5, abs=1e-7)
        assert g["seconds"] >= 0.0


# -- host partition ------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("n_shards,kwargs", [(1, {}), (3, {}), (4, {}),
                                             (8, {}), (4, {"e_per_shard": 300}),
                                             (2, {"n_target": 200})])
def test_partition_graph_host_equals_reference(corpora, name, n_shards,
                                               kwargs):
    jg = corpora[name]
    *want, jspec = jdist.partition_graph_host(jg, n_shards, **kwargs)
    *got, spec = tdist.partition_graph_host(to_port(jg), n_shards, **kwargs)
    assert tuple(spec) == tuple(jspec) and spec.sentinel == jspec.sentinel
    for a, b in zip(got, want):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))
    for rank in range(n_shards):
        mine = tdist.rank_slice(*got, spec, rank, torch.device("cpu"))
        theirs = sharded_from_numpy(*[np.asarray(b) for b in want], jspec,
                                    rank, device="cpu")
        for a, b in zip(mine, theirs):
            assert torch.equal(a, b)


def test_bucket_slots_host_equals_reference_and_refuses_overflow():
    rng = np.random.default_rng(3)
    spec = tdist.ShardedGraphSpec(4, 10, 30, 40)
    src = np.sort(rng.integers(0, 40, 90)).astype(np.int32)
    rng.shuffle(src)
    dst = rng.integers(0, 40, 90).astype(np.int32)
    w = rng.random(90).astype(np.float32)
    got = tdist.bucket_slots_host(src, dst, w, spec)
    want = jdist.bucket_slots_host(src, dst, w, jdist.ShardedGraphSpec(*spec))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    with pytest.raises(ValueError):
        tdist.bucket_slots_host(src, dst, w, spec._replace(e_per_shard=5))


# -- world size 1 ---------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("refine", ["none", "leiden"])
@pytest.mark.parametrize("comm_backend", ["gather", "delta"])
def test_goldens_at_world_size_one(gold, corpora, name, refine,
                                   comm_backend):
    mem, n, stats = distributed_louvain(
        to_port(corpora[name]), ShardGroup.single("cpu"), refine=refine,
        comm_backend=comm_backend)
    np.testing.assert_array_equal(mem, gold[key(refine, name)])
    assert n == len(np.unique(mem))
    assert all(s["comm_backend"] == comm_backend for s in stats)
    if comm_backend == "gather":
        assert all(s["comm_fallback_rounds"] == 0 for s in stats)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("kwargs", [
    {"use_ladder": False}, {"pipeline_fetch": True},
    {"use_ladder": False, "pipeline_fetch": True, "refine": "leiden"},
    {"pipeline_fetch": True, "refine": "leiden", "comm_backend": "delta"},
    {"reshard": "auto"}, {"state_layout": "auto"}])
def test_ladder_pipeline_fetch_and_one_rank_knobs_keep_goldens(
        gold, corpora, name, kwargs):
    """The ladder off, the pipelined fetch, and the knobs that are no-ops
    on one rank (``reshard="auto"``, ``state_layout="auto"``) change no
    membership; the stats rows equal the reference's."""
    jg = corpora[name]
    mem, _, stats = distributed_louvain(to_port(jg),
                                        ShardGroup.single("cpu"), **kwargs)
    np.testing.assert_array_equal(
        mem, gold[key(kwargs.get("refine", "none"), name)])
    jmem, _, jstats = jdist.distributed_louvain(
        jg, make_mesh((1,), ("shard",)), ("shard",), **kwargs)
    np.testing.assert_array_equal(mem, jmem)
    same_rows(stats, jstats)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("refine", ["none", "leiden"])
@pytest.mark.parametrize("comm_backend", ["gather", "delta", "auto"])
def test_stats_rows_equal_reference_at_one_shard(corpora, name, refine,
                                                 comm_backend):
    jg = corpora[name]
    _, _, stats = distributed_louvain(to_port(jg), ShardGroup.single("cpu"),
                                      refine=refine,
                                      comm_backend=comm_backend)
    _, _, jstats = jdist.distributed_louvain(
        jg, make_mesh((1,), ("shard",)), ("shard",), refine=refine,
        comm_backend=comm_backend)
    same_rows(stats, jstats)


def test_warm_start_equals_reference(corpora):
    jg = corpora["sbm"]
    n = int(jg.n_valid)
    init = (np.arange(n) // 3).astype(np.int32)
    front = np.arange(n) % 4 == 0
    mem, _, stats = distributed_louvain(
        to_port(jg), ShardGroup.single("cpu"), init_membership=init,
        init_frontier=front)
    jmem, _, jstats = jdist.distributed_louvain(
        jg, make_mesh((1,), ("shard",)), ("shard",), init_membership=init,
        init_frontier=front)
    np.testing.assert_array_equal(mem, jmem)
    same_rows(stats, jstats)


def test_replicated_renumber_and_modularity_equal_reference(corpora, gold):
    rng = np.random.default_rng(1)
    for cap in (1, 7, 64):
        comm = rng.integers(0, cap + 1, cap + 1).astype(np.int32)
        got, n = tdist.replicated_renumber(torch.from_numpy(comm))
        want, jn = jdist.replicated_renumber(jnp.asarray(comm))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert n == int(jn)
    jg = corpora["lesmis"]
    *glob, spec = tdist.partition_graph_host(to_port(jg), 1)
    sl = tdist.rank_slice(*glob, spec, 0, torch.device("cpu"))
    mem = gold["sharded__lesmis"]
    comm = np.concatenate([mem, [spec.n_pad]]).astype(np.int32)
    q = tdist.sharded_modularity(ShardGroup.single("cpu"), *sl,
                                 torch.from_numpy(comm))
    jq = float(jdist.sharded_modularity(*map(jnp.asarray, glob),
                                        jnp.asarray(comm)))
    assert q == pytest.approx(jq, abs=1e-5)
    forced = tdist.sentinel_forced_membership(torch.arange(5, dtype=torch.int32),
                                              3, 5)
    assert forced.tolist() == [0, 1, 2, 5, 5, 5]


def test_hybrid_layout_is_refused_naming_the_next_item(corpora, gold):
    """The hybrid state layout runs: at world size 1 it gives the golden
    and the reference's stats rows.  An unknown exchange backend is
    refused."""
    jg = corpora["lesmis"]
    g = to_port(jg)
    mem, _, stats = distributed_louvain(g, ShardGroup.single("cpu"),
                                        state_layout="hybrid")
    np.testing.assert_array_equal(mem, gold["sharded__lesmis"])
    jmem, _, jstats = jdist.distributed_louvain(
        jg, make_mesh((1,), ("shard",)), ("shard",), state_layout="hybrid")
    np.testing.assert_array_equal(mem, jmem)
    same_rows(stats, jstats)
    assert all(s["state_layout"] == "hybrid" for s in stats)
    with pytest.raises(ValueError):
        distributed_louvain(g, ShardGroup.single("cpu"),
                            comm_backend="allreduce")


def test_shard_group_rules():
    assert collectives.mesh_rank((1, 2), (2, 4)) == 6
    assert collectives.mesh_rank((0, 3), (2, 4)) == 3
    with pytest.raises(ValueError):
        collectives.mesh_rank((2, 0), (2, 4))
    with pytest.raises(ValueError, match="NCCL"):
        ShardGroup.init("nccl", 0, 1, "file:///nonexistent", device="cpu")
    with pytest.raises(ValueError):
        ShardGroup.init("mpi", 0, 1, "file:///nonexistent", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ShardGroup.single()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ShardGroup.init("gloo", 0, 1, "file:///nonexistent")
    one = ShardGroup.single("cpu")
    x = torch.arange(4, dtype=torch.float32)
    assert one.psum(x) is x and one.all_gather(x) is x
    assert one.all_gather(x, tiled=False).shape == (1, 4)


# -- four gloo ranks ---------------------------------------------------------------

@pytest.fixture(scope="module")
def four_ranks(corpora):
    """One spawned run of 4 gloo CPU ranks: lesmis and sbm under gather and
    delta and both refine modes; a 4-rank partition whose boundary
    fraction sends ``state_layout="auto"`` to the hybrid layout, and
    ``reshard="auto"``; the pass loop without the overflow retry, which
    raises ``AggregationOverflow``."""
    graphs = {n: arrays(corpora[n]) for n in NAMES}
    runs = [(n, {"comm_backend": cb, "refine": r})
            for n in ("lesmis", "sbm") for cb in ("gather", "delta")
            for r in ("none", "leiden")]
    runs += [("gnp", {"comm_backend": cb, "refine": "none"})
             for cb in ("gather", "delta")]
    runs += [("ring_of_cliques", {"state_layout": "auto"}),
             ("lesmis", {"reshard": "auto"}),
             ("gnp", {"regrow": False, "expect": "AggregationOverflow"})]
    return runs, collectives.launch(tdist.rank_runs, 4, graphs, runs,
                                    backend="gloo", devices=["cpu"] * 4,
                                    timeout=RANK_TIMEOUT)


def test_four_gloo_ranks_reproduce_the_goldens(gold, four_ranks):
    runs, out = four_ranks
    assert len(out) == 4
    fallbacks = 0
    for i, (name, kwargs) in enumerate(runs[:10]):
        mem, n, stats = out[0]["results"][i]
        np.testing.assert_array_equal(mem, gold[key(kwargs["refine"], name)])
        for r in range(1, 4):        # every rank holds the same answer
            other = out[r]["results"][i]
            np.testing.assert_array_equal(other[0], mem)
            assert other[2] == stats or all(
                {k: v for k, v in a.items() if k not in ("seconds",
                                                         "phase_seconds")}
                == {k: v for k, v in b.items() if k not in (
                    "seconds", "phase_seconds")}
                for a, b in zip(other[2], stats))
        assert all(s["n_pad"] % 4 == 0 for s in stats)
        if kwargs["comm_backend"] == "delta":
            fallbacks += sum(s["comm_fallback_rounds"] for s in stats)
    # The delta runs overflow their mover caps in early rounds (cap 8 on
    # 20- and 32-vertex shards) and take the dense exchange there.
    assert fallbacks > 0
    assert all(o["branch_reads"] > 0 and o["staged_bytes"] == 0
               for o in out)


def test_four_gloo_ranks_wire_bytes_keep_their_relation(four_ranks):
    """Every pass row of the 4-rank runs (gather, delta, the hybrid
    layout of ``"auto"``, a re-shard) hands the collectives its priced
    bytes plus the port's stated excess, the same on every rank."""
    from test_torch_comm import expected_wire_bytes
    runs, out = four_ranks
    for i in range(len(runs) - 1):
        for r in range(4):
            for row in out[r]["results"][i][2]:
                assert row["wire_bytes"] == expected_wire_bytes(row, 4), (
                    runs[i], row)


def test_four_gloo_ranks_retry_an_aggregation_overflow(four_ranks):
    """gnp's pass-0 communities (ids 0 .. 30) fall on ranks 0 and 1 of the
    seed owner map, and rank 0 owns more coarse edges than its 200 slots:
    without the retry the pass loop raises; with it the layout grows
    (the owner map cannot shrink below 30 per rank here) and the
    membership is the golden's."""
    runs, out = four_ranks
    for i in (8, 9):
        stats = out[0]["results"][i][2]
        assert stats[0]["e_per_shard"] == 200
        assert stats[1]["e_per_shard"] > 200
    msg = out[0]["results"][12]
    assert "aggregation overflow" in msg and "capacity 200" in msg


def test_four_gloo_ranks_refuse_hybrid_and_reshard(corpora, gold,
                                                  four_ranks):
    """Both knobs run on 4 ranks: the boundary fraction of ring_of_cliques
    sends ``state_layout="auto"`` to the hybrid layout, which gives the
    golden, and ``reshard="auto"`` re-shards lesmis."""
    runs, out = four_ranks
    *glob, spec = tdist.partition_graph_host(
        to_port(corpora["ring_of_cliques"]), 4)
    assert tdist.measure_boundary_frac(glob[0], glob[1], spec) <= 0.5
    mem, _, stats = out[0]["results"][10]
    np.testing.assert_array_equal(mem, gold["sharded__ring_of_cliques"])
    assert all(s["state_layout"] == "hybrid" for s in stats)
    assert stats[0]["boundary_frac"] <= 0.5
    # On lesmis the uniform owner map parks every coarse edge on rank 0, so
    # both aggregations re-shard; the relabelled layout numbers the same
    # communities in another order, as the reference's does on 4 host
    # devices (the --runslow comparisons hold it label for label).
    mem, _, stats = out[0]["results"][11]
    want = gold["sharded__lesmis"]
    pairs = set(zip(mem.tolist(), want.tolist()))
    assert len(pairs) == len(set(mem.tolist())) == len(set(want.tolist()))
    assert [s["reshard"] for s in stats] == [True, True, False]
    assert all(s["max_shard_load_frac_after"]
               < s["max_shard_load_frac_before"] for s in stats[:2])
    for r in range(1, 4):
        for i in (10, 11):
            np.testing.assert_array_equal(out[r]["results"][i][0],
                                          out[0]["results"][i][0])


def test_a_failing_rank_is_an_error_not_a_partial_result(corpora):
    graphs = {"lesmis": arrays(corpora["lesmis"])}
    with pytest.raises(collectives.RankFailure, match="KeyError"):
        collectives.launch(tdist.rank_runs, 2, graphs,
                           [("no_such_graph", {})], backend="gloo",
                           devices=["cpu"] * 2, timeout=RANK_TIMEOUT)


# -- four port ranks against four JAX host devices (slow) -----------------------

_JAX_SCRIPT = r"""
import os, json, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, "tests")
import numpy as np
from golden import capture_engine_golden as capture
from repro.compat import make_mesh
from repro.core.distributed import distributed_louvain
mesh = make_mesh((2, 2), ("data", "model"))
out = []
for name, jg in capture.corpora().items():
    for cb in ("gather", "delta"):
        for refine in ("none", "leiden"):
            mem, n, stats = distributed_louvain(jg, mesh, ("data", "model"),
                                                comm_backend=cb,
                                                refine=refine)
            out.append([name, cb, refine, np.asarray(mem).tolist(), stats])
print(json.dumps(out))
"""


@pytest.mark.slow
def test_four_port_ranks_equal_four_jax_devices(corpora):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _JAX_SCRIPT], env=env,
                          capture_output=True, text=True, timeout=900,
                          cwd=root)
    assert proc.returncode == 0, proc.stderr[-3000:]
    import json
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    graphs = {n: arrays(g) for n, g in corpora.items()}
    runs = [(name, {"comm_backend": cb, "refine": refine})
            for name, cb, refine, _, _ in want]
    out = collectives.launch(tdist.rank_runs, 4, graphs, runs,
                             backend="gloo", devices=["cpu"] * 4,
                             timeout=600)
    for (name, cb, refine, jmem, jstats), got in zip(
            want, out[0]["results"]):
        np.testing.assert_array_equal(got[0], np.asarray(jmem))
        same_rows(got[2], jstats)
