"""The hybrid state layout of the port (``state_layout="hybrid"``,
``repro_torch.core.distributed.HybridShardedScanner`` /
``HybridGatherScanner``) against the JAX package's and the committed
goldens, on the CPU.

World size 1 runs in this process; the multi-rank cases spawn ONE run of 4
gloo CPU ranks (``collectives.launch``).  The layout moves data, never
labels: every sharded golden must come back under it, at one rank and, on
these integer-weight corpora, at four.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from golden import capture_engine_golden as capture

from repro.compat import make_mesh
from repro.core import distributed as jdist

from repro_torch import ShardGroup, distributed_louvain
from repro_torch.configs import louvain_arch as tarch
from repro_torch.core import collectives, distributed as tdist
from repro_torch.core.engine import EngineConfig, MoveEngine
from repro_torch.interop import graph_from_numpy

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


# -- world size 1 ---------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("refine", ["none", "leiden"])
@pytest.mark.parametrize("comm_backend", ["gather", "delta"])
@pytest.mark.parametrize("use_ladder", [True, False])
def test_hybrid_goldens_at_world_size_one(gold, corpora, name, refine,
                                          comm_backend, use_ladder):
    mem, n, stats = distributed_louvain(
        to_port(corpora[name]), ShardGroup.single("cpu"), refine=refine,
        comm_backend=comm_backend, state_layout="hybrid",
        use_ladder=use_ladder)
    np.testing.assert_array_equal(mem, gold[key(refine, name)])
    assert n == len(np.unique(mem))
    assert all(s["state_layout"] == "hybrid" for s in stats)
    # One rank has no boundary: no mover label ever travels.
    assert all(s["boundary_frac"] == 0.0 for s in stats)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("refine", ["none", "leiden"])
@pytest.mark.parametrize("comm_backend", ["gather", "delta"])
def test_hybrid_stats_rows_equal_reference_at_one_shard(corpora, name, refine,
                                                        comm_backend):
    """comm_rounds, comm_fallback_rounds, comm_bytes (the per-phase resync
    included), halo_bytes and boundary_frac equal JAX's one-shard rows."""
    jg = corpora[name]
    mem, _, stats = distributed_louvain(
        to_port(jg), ShardGroup.single("cpu"), refine=refine,
        comm_backend=comm_backend, state_layout="hybrid")
    jmem, _, jstats = jdist.distributed_louvain(
        jg, make_mesh((1,), ("shard",)), ("shard",), refine=refine,
        comm_backend=comm_backend, state_layout="hybrid")
    np.testing.assert_array_equal(mem, jmem)
    same_rows(stats, jstats)


@pytest.mark.parametrize("name", NAMES)
def test_auto_layout_is_replicated_on_one_rank(gold, corpora, name):
    """No boundary measurement can justify partitioning one rank: "auto"
    resolves to the replicated layout, as in the reference."""
    mem, _, stats = distributed_louvain(to_port(corpora[name]),
                                        ShardGroup.single("cpu"),
                                        state_layout="auto")
    np.testing.assert_array_equal(mem, gold[key("none", name)])
    assert all(s["state_layout"] == "replicated" for s in stats)
    assert all(s["boundary_frac"] is None for s in stats)


def _random_round(seed, n=48):
    """A mid-phase state of one rank: random membership, K, Sigma of that
    membership, moves and targets."""
    rng = np.random.default_rng(seed)
    comm = np.concatenate([rng.integers(0, n, n), [n]]).astype(np.int32)
    k = np.concatenate([rng.random(n) * 3 + 0.1, [0.0]]).astype(np.float32)
    sig = np.zeros(n + 1, np.float64)
    np.add.at(sig, comm[:n], k[:n])
    sizes = np.bincount(comm[:n], minlength=n + 1).astype(np.int32)
    do_move = rng.random(n) < 0.4
    best_c = rng.integers(0, n, n).astype(np.int32)
    do_move &= best_c != comm[:n]
    t = torch.from_numpy
    return (n, t(comm), t(k), t(sig.astype(np.float32)), t(sizes),
            t(do_move), t(best_c))


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("flavor", ["gather", "delta"])
def test_hybrid_round_equals_the_gather_exchange_bit_for_bit(seed, flavor):
    """One exchange round at one rank: the hybrid scanner's Sigma, sizes and
    membership equal the gather exchange's (``sigma + add - sub``) bit for
    bit on float weights."""
    n, comm, k, sigma, sizes, do_move, best_c = _random_round(seed)
    spec = tdist.ShardedGraphSpec(1, n, 4, n)
    slots = (torch.full((4,), n, dtype=torch.int32),) * 2
    w = torch.zeros(4)
    one = ShardGroup.single("cpu")
    hyb = tdist.HYBRID_SCANNERS[flavor](one, spec, *slots, w, k, 1.0)
    ref = tdist.ShardedScanner(one, spec, *slots, w, k, 1.0)
    comm_l = comm[:n]
    dq = torch.tensor([0.5])
    got = hyb.exchange_round(comm, sigma, sizes, comm_l, do_move, best_c, dq)
    moved_k = torch.where(do_move, k[:n], 0.0)
    add = tdist.segment_sum(moved_k, torch.where(do_move, best_c, n), n + 1)
    sub = tdist.segment_sum(moved_k, torch.where(do_move, comm_l, n), n + 1)
    want_sigma = ref.combine_sigma(sigma, add, sub)
    want_comm = ref.gather_comm(torch.where(do_move, best_c, comm_l))
    want_sizes = torch.bincount(want_comm[:n].long(),
                                minlength=n + 1).to(torch.int32)
    assert torch.equal(got[1].view(torch.int32), want_sigma.view(torch.int32))
    assert torch.equal(got[0], want_comm)
    assert torch.equal(got[2], want_sizes)
    assert torch.equal(got[3][:n], do_move)
    # The delta flavor's caps (a quarter of the vertices) overflow here
    # for some seeds; the dense resync gives the same state.
    assert got[4] in (0, 1) and (flavor == "delta" or got[4] == 0)


def test_hybrid_phase_resyncs_the_membership(corpora):
    """``distributed_move`` under hybrid returns the replicated membership
    of the engine's run (one owned-slice gather at the phase end)."""
    jg = corpora["sbm"]
    g = to_port(jg)
    one = ShardGroup.single("cpu")
    *glob, spec = tdist.partition_graph_host(g, 1)
    sl = tdist.rank_slice(*glob, spec, 0, torch.device("cpu"))
    k = tdist._vertex_k(one, spec, sl[0], sl[2])
    m = tdist._total_weight(one, sl[2])
    comm0 = torch.arange(spec.n_pad + 1, dtype=torch.int32)
    front = torch.ones(spec.n_pad + 1, dtype=torch.bool)
    cfg = EngineConfig()
    out = {}
    for layout in ("replicated", "hybrid"):
        out[layout] = tdist.distributed_move(
            one, spec, *sl, comm0, k, k, front, m, 0.01, config=cfg,
            state_layout=layout)
    assert torch.equal(out["hybrid"][0], out["replicated"][0])
    assert torch.equal(out["hybrid"][1].view(torch.int32),
                       out["replicated"][1].view(torch.int32))
    scanner = tdist.HybridGatherScanner(one, spec, *sl, k, m)
    st = MoveEngine(scanner, cfg).run(comm0, k, front[:spec.n_pad], 0.01)
    assert torch.equal(scanner.resync_comm(st.comm), out["hybrid"][0])


# -- four gloo ranks ----------------------------------------------------------------

RUNS4 = [(n, cb, r) for n in NAMES for cb in ("gather", "delta")
         for r in ("none", "leiden")]


@pytest.fixture(scope="module")
def four_ranks(corpora):
    """One spawned run of 4 gloo CPU ranks: every corpus under the hybrid
    layout with both exchanges and both refine modes, and
    ``state_layout="auto"`` on every corpus."""
    graphs = {n: arrays(corpora[n]) for n in NAMES}
    runs = [(n, {"comm_backend": cb, "refine": r, "state_layout": "hybrid"})
            for n, cb, r in RUNS4]
    runs += [(n, {"state_layout": "auto"}) for n in NAMES]
    return collectives.launch(tdist.rank_runs, 4, graphs, runs,
                              backend="gloo", devices=["cpu"] * 4,
                              timeout=RANK_TIMEOUT)


@pytest.mark.parametrize("i", range(len(RUNS4)),
                         ids=["-".join(r) for r in RUNS4])
def test_four_ranks_reproduce_the_goldens_under_hybrid(gold, four_ranks, i):
    name, _, refine = RUNS4[i]
    mem, n, stats = four_ranks[0]["results"][i]
    np.testing.assert_array_equal(mem, gold[key(refine, name)])
    for r in range(1, 4):
        np.testing.assert_array_equal(four_ranks[r]["results"][i][0], mem)
    assert all(s["state_layout"] == "hybrid" for s in stats)
    assert stats[0]["boundary_frac"] > 0.0
    assert all(s["halo_bytes"] > 0 for s in stats if s["comm_rounds"])


def test_four_ranks_delta_fallback_rounds_appear(four_ranks):
    """The hybrid delta flavor's caps (8 movers on 20- and 32-vertex ranks)
    overflow in early rounds and take the dense resync there; the gather
    flavor never does."""
    fb = {"gather": 0, "delta": 0}
    for i, (_, cb, _) in enumerate(RUNS4):
        stats = four_ranks[0]["results"][i][2]
        fb[cb] += sum(s["comm_fallback_rounds"] for s in stats)
    assert fb["gather"] == 0 and fb["delta"] > 0
    assert all(o["branch_reads"] > 0 for o in four_ranks)


def test_four_ranks_hybrid_wire_bytes_keep_their_relation(four_ranks):
    """On 4 ranks a hybrid round hands the collectives exactly 4 *
    touched_cap B a rank more than its price (Sigma's add and sub as two
    lanes), a hybrid fallback round also the dense size deltas."""
    from test_torch_comm import expected_wire_bytes
    for i in range(len(RUNS4) + len(NAMES)):
        for row in four_ranks[0]["results"][i][2]:
            assert row["wire_bytes"] == expected_wire_bytes(row, 4), row
            if (row["state_layout"] == "hybrid"
                    and row["comm_fallback_rounds"] == 0
                    and row["refine_iterations"] is None
                    and row["comm_backend"] == "delta"):
                v_per = row["n_pad"] // 4
                assert (row["wire_bytes"] - row["comm_bytes"]
                        == 4 * 4 * tarch.hybrid_touched_cap(v_per)
                        * row["comm_rounds"])


@pytest.mark.parametrize("j", range(len(NAMES)), ids=NAMES)
def test_four_ranks_auto_layout_follows_the_boundary(gold, corpora,
                                                     four_ranks, j):
    """``"auto"`` measures the 4-rank partition's boundary fraction and
    takes the hybrid layout at or below 0.5 (ring_of_cliques), else the
    replicated one; the goldens come back either way."""
    name = NAMES[j]
    *glob, spec = tdist.partition_graph_host(to_port(corpora[name]), 4)
    frac = tdist.measure_boundary_frac(glob[0], glob[1], spec,
                                       int(corpora[name].n_valid))
    mem, _, stats = four_ranks[0]["results"][len(RUNS4) + j]
    np.testing.assert_array_equal(mem, gold[key("none", name)])
    want = "hybrid" if frac <= 0.5 else "replicated"
    assert all(s["state_layout"] == want for s in stats)
    assert (name == "ring_of_cliques") == (want == "hybrid")


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
                                                refine=refine,
                                                state_layout="hybrid")
            out.append([name, cb, refine, np.asarray(mem).tolist(), stats])
print(json.dumps(out))
"""


@pytest.mark.slow
def test_four_port_ranks_equal_four_jax_devices_under_hybrid(corpora):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _JAX_SCRIPT], env=env,
                          capture_output=True, text=True, timeout=900,
                          cwd=root)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    graphs = {n: arrays(g) for n, g in corpora.items()}
    runs = [(name, {"comm_backend": cb, "refine": refine,
                    "state_layout": "hybrid"})
            for name, cb, refine, _, _ in want]
    out = collectives.launch(tdist.rank_runs, 4, graphs, runs,
                             backend="gloo", devices=["cpu"] * 4,
                             timeout=600)
    for (name, cb, refine, jmem, jstats), got in zip(
            want, out[0]["results"]):
        np.testing.assert_array_equal(got[0], np.asarray(jmem))
        same_rows(got[2], jstats)
