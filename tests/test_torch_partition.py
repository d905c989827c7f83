"""The port's Louvain partitioner (``repro_torch.core.partition``) against
``repro.core.partition`` on the CPU: assignment, order, cut, total and
balance equal exactly, on the four golden corpora and on
``connected_caveman_graph(24, 12)``, under the default configuration and
the ELL kernel's route (its plain version on the CPU)."""


import networkx as nx
import numpy as np
import pytest
import torch

from golden import capture_engine_golden as capture

from repro.core.graph import from_networkx as jfrom_networkx
from repro.core.louvain import LouvainConfig as JConfig
from repro.core import partition as jpartition

from repro_torch import LouvainConfig
from repro_torch.core import partition
from repro_torch.interop import graph_from_numpy

NAMES = ["lesmis", "sbm", "ring_of_cliques", "gnp", "caveman"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def graphs():
    out = dict(capture.corpora())
    out["caveman"] = jfrom_networkx(nx.connected_caveman_graph(24, 12))
    return {k: (jg, graph_from_numpy(
        np.asarray(jg.indptr), np.asarray(jg.indices),
        np.asarray(jg.weights), np.asarray(jg.src), int(jg.n_valid),
        int(jg.e_valid), device="cpu")) for k, jg in out.items()}


def same(got, want):
    np.testing.assert_array_equal(got.assignment, want.assignment)
    assert got.assignment.dtype == want.assignment.dtype
    np.testing.assert_array_equal(got.order, want.order)
    assert got.order.dtype == want.order.dtype
    assert (got.cut_edges, got.total_edges, got.balance) == (
        want.cut_edges, want.total_edges, want.balance)
    assert got.cut_fraction == want.cut_fraction


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("n_devices", [2, 8])
def test_louvain_partition_equals_the_reference(graphs, name, n_devices):
    jg, tg = graphs[name]
    same(partition.louvain_partition(tg, n_devices),
         jpartition.louvain_partition(jg, n_devices))


@pytest.mark.parametrize("name", ["sbm", "caveman"])
def test_louvain_partition_through_the_ell_route(graphs, name):
    jg, tg = graphs[name]
    same(partition.louvain_partition(tg, 4, LouvainConfig(
        use_ell_kernel=True)), jpartition.louvain_partition(
        jg, 4, JConfig(use_ell_kernel=True)))


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("seed", [0, 3])
def test_random_partition_equals_the_reference(graphs, name, seed):
    jg, tg = graphs[name]
    same(partition.random_partition(tg, 4, seed=seed),
         jpartition.random_partition(jg, 4, seed=seed))


def test_edge_cut_equals_the_reference(graphs):
    jg, tg = graphs["caveman"]
    rng = np.random.default_rng(5)
    for _ in range(3):
        a = rng.integers(0, 6, tg.n_valid).astype(np.int32)
        assert partition.edge_cut(tg, a) == jpartition.edge_cut(jg, a)


def test_caveman_partition_cuts_little(graphs):
    """The technique's point: Louvain packing cuts far fewer slots than a
    hashed assignment, with every cave kept on one device."""
    _, tg = graphs["caveman"]
    lp = partition.louvain_partition(tg, 8)
    rp = partition.random_partition(tg, 8)
    assert lp.cut_fraction < 0.1 < rp.cut_fraction
    assert lp.balance == 1.0
    assert sorted(lp.order.tolist()) == list(range(tg.n_valid))


def test_louvain_equals_the_reference_on_the_products_generator():
    """``chip_smoke.py`` phase 10's planted-class generator at 20,000
    vertices (``products_scale_witness.witness``): both packages give one
    membership, and it finds the planted classes (Q within 0.005 of
    theirs); the float32 Q is within 1e-6 of a float64 one."""
    import products_scale_witness
    out = products_scale_witness.witness(20_000)
    assert out["memberships_equal"]
    assert out["port"]["q"] == out["jax"]["q"]
    assert abs(out["port"]["q_f64"] - out["port"]["q"]) < 1e-6
    assert out["planted_q_f64"] - out["port"]["q_f64"] < 0.005
