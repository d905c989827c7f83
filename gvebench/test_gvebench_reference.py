"""The plain reference: float64 modularity on hand-checked graphs, the
edge-set semantics of a batch, and GVE-Louvain's memberships equal to the
program's label for label on small graphs (cold, and a warm step under
both screening modes)."""

import json

import numpy as np
import pytest
import torch

from gvebench.gen import graph500
from gvebench.harness import checkout_root
from gvebench.reference import louvain as ref
from gvebench.reference.edges import EdgeSet, frontier

CPU = torch.device("cpu")
PARAMS = ref.Params.of(json.loads((checkout_root() / "gvebench" / "configs"
                                   / "graph500-22.json").read_text())
                       ["louvain"])


def _graph(n, pairs):
    us = torch.tensor([min(p) for p in pairs], dtype=torch.int32)
    ud = torch.tensor([max(p) for p in pairs], dtype=torch.int32)
    return EdgeSet.of_pairs(n, us, ud).graph()


TWO_TRIANGLES = [(0, 1), (1, 2), (0, 2), (3, 4), (4, 5), (3, 5), (2, 3)]


@pytest.mark.parametrize("membership,q", [
    ([0, 0, 0, 1, 1, 1], 5 / 14),           # 12/14 - 2 * (7/14)^2
    ([0, 0, 0, 0, 0, 0], 0.0),              # one community: 1 - 1
    ([0, 1, 2, 3, 4, 5], -34 / 196),        # singletons: -sum (k/2m)^2
])
def test_modularity_by_hand(membership, q):
    g = _graph(6, TWO_TRIANGLES)
    assert ref.modularity64(g, torch.tensor(membership)) == pytest.approx(
        q, abs=1e-15)


def test_louvain_finds_the_two_triangles():
    mem = ref.louvain(_graph(6, TWO_TRIANGLES), PARAMS).tolist()
    assert mem[0] == mem[1] == mem[2] != mem[3] == mem[4] == mem[5]


def test_batch_semantics():
    s = EdgeSet.of_pairs(5, torch.tensor([0, 1, 2]), torch.tensor([1, 2, 3]))
    # Insert {3, 4}, delete {1, 2}, delete the absent {0, 4}, re-insert the
    # present {0, 1} at its weight, and set {2, 3} twice: the later wins.
    out, touched = s.apply([4, 2, 0, 0, 2, 3], [3, 1, 4, 1, 3, 2],
                           [1.0, 0.0, 0.0, 1.0, 0.0, 2.0])
    assert out.keys.tolist() == [0 * 5 + 1, 2 * 5 + 3, 3 * 5 + 4]
    assert out.w.tolist() == [1.0, 2.0, 1.0]
    assert torch.nonzero(touched).flatten().tolist() == [1, 2, 3, 4]
    comm = torch.tensor([0, 0, 1, 1, 4])
    assert frontier(touched, comm, 5, "vertex").nonzero().flatten(
    ).tolist() == [1, 2, 3, 4]
    assert frontier(touched, comm, 5, "community").nonzero().flatten(
    ).tolist() == [0, 1, 2, 3, 4]


def _program(sizes_gen):
    from repro_torch import LouvainConfig, build_csr
    gen, sizes, seed = sizes_gen
    n, us, ud = gen.generate(sizes, seed, CPU)
    g = build_csr(us, ud, torch.ones(us.shape[0]), n, symmetrize=True,
                  dedup=False, device="cpu")
    cfg = LouvainConfig(**{f: getattr(PARAMS, f)
                           for f in PARAMS.__dataclass_fields__})
    return n, us, ud, g, cfg


CASES = [(graph500, {"scale": 10, "edge_factor": 16, "a": 0.57, "b": 0.19,
                     "c": 0.19}, 2 ** 31 + 5),
         (graph500, {"scale": 11, "edge_factor": 8, "a": 0.45, "b": 0.15,
                     "c": 0.15}, 17),
         (graph500, {"scale": 12, "edge_factor": 2, "a": 0.57, "b": 0.19,
                     "c": 0.19}, 4)]


@pytest.mark.parametrize("case", CASES, ids=["g500-10", "rmat-11", "sparse-12"])
def test_cold_equals_the_program(case):
    from repro_torch import louvain
    n, us, ud, g, cfg = _program(case)
    want = louvain(g, cfg).membership
    got = ref.louvain(EdgeSet.of_pairs(n, us, ud).graph(), PARAMS)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["community", "vertex"])
def test_warm_step_equals_the_program(mode):
    from repro_torch import louvain, louvain_dynamic, make_edge_batch
    n, us, ud, g, cfg = _program(CASES[1])
    prev = louvain(g, cfg).membership
    rng = np.random.default_rng(0)
    pick = rng.choice(us.shape[0], 40, replace=False)
    u = np.concatenate([us.numpy()[pick[:10]], rng.integers(0, n, 30)])
    v = np.concatenate([ud.numpy()[pick[:10]], rng.integers(0, n, 30)])
    w = np.concatenate([np.zeros(10), np.ones(30)]).astype(np.float32)
    res = louvain_dynamic(g, [make_edge_batch(u, v, w, n, device="cpu")],
                          prev=prev, config=cfg, screening=mode)
    after, touched = EdgeSet.of_pairs(n, us, ud).apply(u, v, w)
    prev_t = torch.from_numpy(prev)
    got = ref.louvain(after.graph(), PARAMS, prev=prev_t,
                      frontier=frontier(touched, prev_t, n, mode))
    assert np.array_equal(got.numpy(), res.membership)
    e = res.graph.e_valid
    key = (res.graph.src[:e].long() * n + res.graph.indices[:e].long())
    assert torch.equal(torch.sort(key).values, after.directed()[0])


def test_bfloat16_scoring_changes_the_membership():
    n, us, ud, _, _ = _program(CASES[0])
    g = EdgeSet.of_pairs(n, us, ud).graph()
    assert not torch.equal(ref.louvain(g, PARAMS),
                           ref.louvain(g, PARAMS, dq_dtype=torch.bfloat16))
