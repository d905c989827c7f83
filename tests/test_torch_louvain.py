"""The PyTorch port's ``louvain()`` end to end on the CPU.

It must reproduce the committed ``single__*`` and ``ell__*`` goldens
(``tests/golden/engine_memberships.npz``) element for element on the four
corpora, and equal the JAX ``louvain()`` on seeded R-MAT graphs: the same
membership, the same dendrogram levels and the same per-pass iterations,
community counts and ladder capacities.  networkx builds the corpora here
only; the port takes the graph object duck-typed.
"""

import dataclasses
import os

import networkx as nx
import numpy as np
import pytest
import torch

from repro.core.graph import build_csr as jbuild_csr
from repro.core.louvain import (LouvainConfig as JConfig, louvain as jlouvain,
                                pad_membership as jpad_membership)
from repro.data import rmat_graph as jrmat

from repro_torch import (LouvainConfig, build_csr, from_networkx, louvain,
                         membership_modularity, rmat_graph, sbm_graph)
from repro_torch.core.louvain import pad_membership
from repro_torch.interop import config_from_dict

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
    return {
        "lesmis": from_networkx(nx.les_miserables_graph(), device="cpu"),
        "sbm": sbm_graph(8, 16, 0.4, 0.01, seed=2, device="cpu")[0],
        "ring_of_cliques": from_networkx(nx.ring_of_cliques(8, 6),
                                         device="cpu"),
        "gnp": from_networkx(nx.gnp_random_graph(120, 0.05, seed=21),
                             device="cpu"),
    }


NAMES = ["lesmis", "sbm", "ring_of_cliques", "gnp"]
PATHS = {
    "single": LouvainConfig(),
    "ell": LouvainConfig(use_ell_kernel=True),
}


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("name", NAMES)
def test_goldens_element_for_element(gold, corpora, name, path):
    res = louvain(corpora[name], PATHS[path])
    np.testing.assert_array_equal(res.membership, gold[f"{path}__{name}"])
    assert res.n_communities == len(np.unique(res.membership))
    np.testing.assert_array_equal(res.levels[-1], res.membership)


@pytest.mark.parametrize("name", NAMES)
def test_backend_matrix_reproduces_goldens(gold, corpora, name):
    """Every scanner, aggregation and ladder choice of the slice lands on
    the same goldens: the scan-only ELL kernel, the aggregation kernel's
    plain version, and the un-laddered capacities."""
    for cfg, key in ((LouvainConfig(scan_backend="ell"), "ell"),
                     (LouvainConfig(scan_backend="ell_fused",
                                    agg_backend="kernel"), "ell"),
                     (LouvainConfig(agg_backend="kernel"), "single"),
                     (LouvainConfig(scan_backend="full", use_ladder=False),
                      "single")):
        res = louvain(corpora[name], cfg)
        np.testing.assert_array_equal(res.membership, gold[f"{key}__{name}"])


def _pass_table(res):
    return [(p.iterations, p.n_communities, p.n_vertices, p.n_cap, p.e_cap)
            for p in res.passes]


@pytest.mark.parametrize("scale,seed,config", [
    (8, 0, {}),
    (8, 0, {"use_ell_kernel": True}),
    (10, 2, {}),
    (9, 1, {"agg_backend": "pallas", "gate_fraction": 3}),
])
def test_equals_reference_on_rmat(scale, seed, config):
    jcfg = JConfig(**config)
    jres = jlouvain(jrmat(scale, 8, seed=seed), jcfg)
    tg = rmat_graph(scale, 8, seed=seed, device="cpu")
    tres = louvain(tg, config_from_dict(dataclasses.asdict(jcfg)))
    np.testing.assert_array_equal(tres.membership, jres.membership)
    assert len(tres.levels) == len(jres.levels)
    for a, b in zip(tres.levels, jres.levels):
        np.testing.assert_array_equal(a, b)
    assert _pass_table(tres) == _pass_table(jres)
    for a, b in zip(tres.passes, jres.passes):
        assert a.dq_sum == pytest.approx(b.dq_sum, rel=1e-5, abs=1e-7)
    assert membership_modularity(tg, tres.membership) > 0.0


def test_ell_scan_and_fused_give_the_same_memberships():
    tg = rmat_graph(9, 8, seed=6, device="cpu")
    a = louvain(tg, LouvainConfig(scan_backend="ell"))
    b = louvain(tg, LouvainConfig(scan_backend="ell_fused"))
    np.testing.assert_array_equal(a.membership, b.membership)
    assert _pass_table(a) == _pass_table(b)


def test_track_modularity_records_each_pass(corpora):
    g = corpora["sbm"]
    res = louvain(g, LouvainConfig(track_modularity=True))
    assert all(p.modularity is not None for p in res.passes)
    assert res.passes[-1].modularity == pytest.approx(
        membership_modularity(g, res.membership), rel=1e-6)


def test_pad_membership_matches_reference():
    mem = np.array([3, 1, 1, 0, 2], np.int32)
    for n_cap in (5, 9):
        np.testing.assert_array_equal(pad_membership(mem, n_cap),
                                      jpad_membership(mem, n_cap))


@pytest.mark.parametrize("kind", ["no-edges", "self-loops-and-weights"])
def test_equals_reference_on_edge_cases(kind):
    """Zero-edge graphs (m == 0: the m_safe guards) and integer-weighted
    graphs with self loops, through both scanner families."""
    rng = np.random.default_rng(9)
    if kind == "no-edges":
        src = dst = np.zeros(0, np.int32)
        w = np.zeros(0, np.float32)
        n = 6
    else:
        n = 60
        src = rng.integers(0, n, 240)
        dst = rng.integers(0, n, 240)
        dst[:12] = src[:12]
        w = rng.integers(1, 6, 240).astype(np.float32)
    jg = jbuild_csr(src, dst, w, n, symmetrize=True,
                    e_cap=max(8, 2 * len(src)))
    tg = build_csr(src, dst, w, n, symmetrize=True,
                   e_cap=max(8, 2 * len(src)), device="cpu")
    for cfg in ({}, {"use_ell_kernel": True}):
        jres = jlouvain(jg, JConfig(**cfg))
        tres = louvain(tg, LouvainConfig(**cfg))
        np.testing.assert_array_equal(tres.membership, jres.membership)
        assert _pass_table(tres) == _pass_table(jres)
