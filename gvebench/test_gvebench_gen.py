"""The generator gives one edge set for one seed, or for a configuration's
edge_seed whatever the seed, and keeps only the vertices with edges; the
cold loop's graph does not depend on the seed; the stream's batches keep
their mix and never run dry."""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gvebench.gen import graph500
from gvebench.harness import checkout_root
from gvebench.loops import cold, stream
from gvebench.system import Program

CPU = torch.device("cpu")
G500 = {"scale": 10, "edge_factor": 16, "a": 0.57, "b": 0.19, "c": 0.19}
SKEWED = {"scale": 12, "edge_factor": 4, "a": 0.7, "b": 0.1, "c": 0.1}
PARAMS = json.loads((checkout_root() / "gvebench" / "configs"
                     / "graph500-22.json").read_text())["louvain"]


def _pairs(sizes, seed):
    n, us, ud = graph500.generate(sizes, seed, CPU)
    return n, us.numpy(), ud.numpy()


@pytest.mark.parametrize("sizes", [G500, SKEWED], ids=["g500", "skewed"])
def test_one_seed_one_edge_set(sizes):
    big = 2 ** 31 + 12345
    n, us, ud = _pairs(sizes, big)
    n2, us2, ud2 = _pairs(sizes, big)
    assert n == n2 and np.array_equal(us, us2) and np.array_equal(ud, ud2)
    _, us3, _ = _pairs(sizes, big + 1)
    assert us3.shape != us.shape or not np.array_equal(us3, us)
    assert us.dtype == np.int32 and np.all(us < ud) and ud.max() < n
    key = us.astype(np.int64) * n + ud
    assert np.all(np.diff(key) > 0)


@pytest.mark.parametrize("sizes", [G500, SKEWED], ids=["g500", "skewed"])
def test_edge_seed_gives_every_run_one_graph(sizes):
    fixed = dict(sizes, edge_seed=7)
    big = 2 ** 31 + 12345
    n, us, ud = _pairs(fixed, big)
    n2, us2, ud2 = _pairs(fixed, big + 1)
    assert n == n2 and np.array_equal(us, us2) and np.array_equal(ud, ud2)
    n3, us3, ud3 = _pairs(sizes, 7)
    assert n == n3 and np.array_equal(us, us3) and np.array_equal(ud, ud3)
    _, us4, _ = _pairs(dict(sizes, edge_seed=8), big)
    assert us4.shape != us.shape or not np.array_equal(us4, us)


def test_cold_loop_builds_one_graph_whatever_the_seed():
    """The seed orders the edge list the graph build gets; the graph built
    is the same."""
    n, us, ud = graph500.generate(dict(G500, edge_seed=1), 0, CPU)
    handed, graphs = [], []
    for seed in (2 ** 31 + 5, 2 ** 31 + 6):
        system = Program(PARAMS, CPU)
        build = system.build
        system.build = lambda n, u, v: (handed.append(u.clone()),
                                        build(n, u, v))[1]
        graphs.append(cold.Loop(system, n, us, ud, {}, seed, CPU).graph)
    assert not torch.equal(handed[0], handed[1])
    a, b = graphs
    for field in ("indptr", "indices", "weights", "src"):
        assert torch.equal(getattr(a, field), getattr(b, field)), field


@pytest.mark.parametrize("sizes", [G500, SKEWED], ids=["g500", "skewed"])
def test_graph500_keeps_only_vertices_with_edges(sizes):
    n, us, ud = _pairs(sizes, 5)
    ids = 1 << sizes["scale"]
    # Isolated ids go, as in Graphalytics' graph500 datasets.
    assert n < ids
    assert np.array_equal(np.unique(np.concatenate([us, ud])), np.arange(n))
    # Repeats and self loops go: fewer than edge_factor * 2^scale remain.
    assert 0.5 * sizes["edge_factor"] * ids < us.shape[0] \
        < sizes["edge_factor"] * ids


def test_relabel_dense_keeps_the_order():
    us = torch.tensor([1, 1, 4, 6], dtype=torch.int32)
    ud = torch.tensor([4, 9, 6, 9], dtype=torch.int32)
    n, a, b = graph500.relabel_dense(10, us, ud)
    assert n == 4
    assert a.tolist() == [0, 0, 1, 2] and b.tolist() == [1, 3, 2, 3]
    assert a.dtype == b.dtype == torch.int32


class _Recorder:
    """A system that records the stream's batches and answers trivially."""

    def build(self, n, us, ud, e_headroom=0):
        return SimpleNamespace(e_cap=2 * us.shape[0] + e_headroom)

    def make_batch(self, u, v, w, n, b_cap):
        return (u, v, w, b_cap)

    def louvain(self, graph):
        return SimpleNamespace(membership=np.zeros(1, np.int32))

    def louvain_dynamic(self, graph, batch, prev, screening):
        return SimpleNamespace(graph=graph, membership=prev, batch_stats=[])


def test_stream_keeps_its_mix_and_never_runs_dry():
    n, us, ud = graph500.generate(G500, 3, CPU)
    traffic = {"batch_frac": 0.004, "insert_share": 0.8,
               "max_batches": 60, "e_headroom": 512,
               "screening": "community"}
    loop = stream.Loop(_Recorder(), n, us, ud, traffic, 3, CPU)
    full = set((us.long() * n + ud.long()).tolist())
    present = set((loop.us.long() * n + loop.ud.long()).tolist())
    b = int(traffic["batch_frac"] * us.shape[0])
    assert len(loop.batches) == traffic["max_batches"]
    # Exactly the inserts of max_batches batches are held out.
    assert len(full) - len(present) == traffic["max_batches"] * int(b * 0.8)
    for u, v, w in loop.entries:
        assert len(u) == b and int((w == 1).sum()) == int(b * 0.8)
        for a, c, x in zip(u.tolist(), v.tolist(), w.tolist()):
            key = a * n + c
            assert key in full
            if x == 1:
                assert key not in present      # an insert of a held-out edge
                present.add(key)
            else:
                assert key in present          # a deletion of a live edge
                present.remove(key)


def test_stream_refuses_a_mix_larger_than_the_graph():
    n, us, ud = graph500.generate(G500, 3, CPU)
    traffic = {"batch_frac": 0.05, "insert_share": 0.8,
               "max_batches": 1000, "e_headroom": 0,
               "screening": "vertex"}
    with pytest.raises(ValueError, match="needs more"):
        stream.Loop(_Recorder(), n, us, ud, traffic, 3, CPU)


#: Undirected edges of LDBC Graphalytics' graph500-22.
GRAPH500_22_EDGES = 64_155_735
STREAM_MIXES = sorted(
    p.stem for p in (checkout_root() / "gvebench" / "traffic").glob("*.json")
    if json.loads(p.read_text())["loop"] == "stream")


@pytest.mark.parametrize("mix", STREAM_MIXES)
def test_stream_mix_fits_its_headroom(mix):
    """The net growth of max_batches batches fits the spare slots, so no
    batch regrows the graph, and the hold-out stays a few percent."""
    t = json.loads((checkout_root() / "gvebench" / "traffic"
                    / f"{mix}.json").read_text())
    b = int(t["batch_frac"] * GRAPH500_22_EDGES)
    n_ins = int(b * t["insert_share"])
    growth = 2 * (n_ins - (b - n_ins)) * t["max_batches"]
    assert growth <= t["e_headroom"]
    assert t["max_batches"] * n_ins < 0.05 * GRAPH500_22_EDGES
