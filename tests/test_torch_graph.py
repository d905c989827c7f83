"""The PyTorch port's graph container, generators and modularity against the
JAX package (``repro.core.graph``, ``repro.data.graphs``,
``repro.core.modularity``), on the CPU.

Buffers, vertex weights, total weight, ELL blocks and re-bucketed buffers
must be identical on integer weights (vertex weights of float-weighted
input agree to 1e-6 relative: the port sums them in float64).  Modularity
is identical on the golden corpora and agrees to 1e-6 relative on random
R-MAT partitions, where its float32 sums run in another order.  Inputs come from seeded numpy generators fed to both.
"""

import os

import jax.numpy as jnp
import networkx as nx
import numpy as np
import pytest
import torch

from golden import capture_engine_golden as capture

from repro.core import graph as jgraph
from repro.core.modularity import modularity as jmodularity
from repro.data import rmat_graph as jrmat, sbm_graph as jsbm

from repro_torch.core import graph as tgraph
from repro_torch.core.modularity import modularity as tmodularity
from repro_torch.data import rmat_graph as trmat, sbm_graph as tsbm
from repro_torch.interop import graph_from_numpy

BUFFERS = ("indptr", "indices", "weights", "src")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "engine_memberships.npz")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _port_corpora():
    return {
        "lesmis": tgraph.from_networkx(nx.les_miserables_graph(),
                                       device="cpu"),
        "sbm": tsbm(8, 16, 0.4, 0.01, seed=2, device="cpu")[0],
        "ring_of_cliques": tgraph.from_networkx(nx.ring_of_cliques(8, 6),
                                                device="cpu"),
        "gnp": tgraph.from_networkx(nx.gnp_random_graph(120, 0.05, seed=21),
                                    device="cpu"),
    }


@pytest.fixture(scope="module")
def corpora():
    jax_c = capture.corpora()
    port_c = _port_corpora()
    return {k: (jax_c[k], port_c[k]) for k in jax_c}


def assert_same_graph(jg, tg):
    for f in BUFFERS:
        np.testing.assert_array_equal(np.asarray(getattr(jg, f)),
                                      getattr(tg, f).numpy(), err_msg=f)
        assert getattr(tg, f).dtype == (torch.float32 if f == "weights"
                                        else torch.int32)
    assert int(jg.n_valid) == tg.n_valid
    assert int(jg.e_valid) == tg.e_valid


def test_corpora_buffers_weights_and_modularity(corpora):
    gold = np.load(GOLDEN)
    for name, (jg, tg) in corpora.items():
        assert_same_graph(jg, tg)
        np.testing.assert_array_equal(np.asarray(jg.vertex_weights()),
                                      tg.vertex_weights().numpy())
        assert float(jg.total_weight()) == float(tg.total_weight())
        mem = np.full(tg.n_cap + 1, tg.n_cap, np.int32)
        mem[:tg.n_valid] = gold[f"single__{name}"]
        q_j = float(jmodularity(jg, jnp.asarray(mem)))
        q_t = float(tmodularity(tg, torch.from_numpy(mem)))
        assert q_t == q_j


@pytest.mark.parametrize("scale,edge_factor,seed", [(6, 8, 0), (8, 8, 3),
                                                    (9, 4, 7)])
def test_rmat_edges_byte_identical(scale, edge_factor, seed):
    jg = jrmat(scale, edge_factor, seed=seed)
    tg = trmat(scale, edge_factor, seed=seed, device="cpu")
    assert_same_graph(jg, tg)
    np.testing.assert_array_equal(np.asarray(jg.vertex_weights()),
                                  tg.vertex_weights().numpy())
    assert float(jg.total_weight()) == float(tg.total_weight())
    # Modularity of a seeded random partition.
    rng = np.random.default_rng(seed)
    mem = np.full(tg.n_cap + 1, tg.n_cap, np.int32)
    mem[:tg.n_valid] = rng.integers(0, 9, tg.n_valid)
    assert float(tmodularity(tg, torch.from_numpy(mem))) == pytest.approx(
        float(jmodularity(jg, jnp.asarray(mem))), rel=1e-6)


@pytest.mark.parametrize("seed", [0, 2, 5])
def test_sbm_edges_and_labels_byte_identical(seed):
    jg, jlab = jsbm(6, 12, 0.3, 0.02, seed=seed)
    tg, tlab = tsbm(6, 12, 0.3, 0.02, seed=seed, device="cpu")
    assert_same_graph(jg, tg)
    np.testing.assert_array_equal(jlab, tlab)


@pytest.mark.parametrize("symmetrize,dedup", [(True, True), (False, True),
                                              (True, False), (False, False)])
def test_build_csr_options_and_capacity(symmetrize, dedup):
    """Weighted multigraph input (parallel slots, self loops, float
    weights) with explicit capacities."""
    rng = np.random.default_rng(11)
    src = rng.integers(0, 20, 90)
    dst = rng.integers(0, 20, 90)
    w = (rng.random(90) * 3).astype(np.float32)
    e_cap = 300
    jg = jgraph.build_csr(src, dst, w, 20, n_cap=32, e_cap=e_cap,
                          symmetrize=symmetrize, dedup=dedup)
    tg = tgraph.build_csr(src, dst, w, 20, n_cap=32, e_cap=e_cap,
                          symmetrize=symmetrize, dedup=dedup, device="cpu")
    assert_same_graph(jg, tg)
    # Float weights: the port sums K_i in float64 and rounds once (so CUDA's
    # atomic order cannot change it); the reference sums in float32.
    np.testing.assert_allclose(tg.vertex_weights().numpy(),
                               np.asarray(jg.vertex_weights()), rtol=1e-6)


def test_build_csr_rejects_small_capacity():
    with pytest.raises(ValueError):
        tgraph.build_csr(np.array([0, 1]), np.array([1, 2]),
                         np.ones(2, np.float32), 3, n_cap=2, device="cpu")


@pytest.mark.parametrize("widths,row_align", [((16, 64, 256, 1024), 8),
                                              ((2, 4, 8), 8), ((3, 5), 4)])
def test_to_ell_blocks_identical(corpora, widths, row_align):
    cases = list(corpora.values()) + [(jrmat(8, 8, seed=1),
                                       trmat(8, 8, seed=1, device="cpu"))]
    for jg, tg in cases:
        jblocks, jleft = jgraph.to_ell_blocks(jg, widths, row_align=row_align)
        tblocks, tleft = tgraph.to_ell_blocks(tg, widths, row_align=row_align)
        assert len(jblocks) == len(tblocks)
        for jb, tb in zip(jblocks, tblocks):
            assert jb.width == tb.width
            for f in ("rows", "cols", "w"):
                np.testing.assert_array_equal(np.asarray(getattr(jb, f)),
                                              getattr(tb, f).numpy())
        np.testing.assert_array_equal(jleft, tleft.numpy())


@pytest.mark.parametrize("widths,row_align", [((16, 64, 256, 1024), 8),
                                              ((2, 4, 8), 8), ((3, 5), 4)])
def test_ell_bucket_rows_identical(corpora, widths, row_align):
    """The rows-only bucketing (what the kernels take on the card) gives
    the reference's ELL rows and leftover ids, and ``ell_block`` rebuilds
    each bucket's padded matrices from them."""
    cases = list(corpora.values()) + [(jrmat(8, 8, seed=1),
                                       trmat(8, 8, seed=1, device="cpu"))]
    for jg, tg in cases:
        jblocks, jleft = jgraph.to_ell_blocks(jg, widths, row_align=row_align)
        rows, tleft = tgraph.ell_bucket_rows(tg, widths, row_align=row_align)
        assert len(rows) == len(jblocks)
        for width, jb, r in zip(widths, jblocks, rows):
            assert r.dtype == torch.int32
            np.testing.assert_array_equal(np.asarray(jb.rows), r.numpy())
            tb = tgraph.ell_block(tg.indptr, tg.indices, tg.weights, r,
                                  width)
            np.testing.assert_array_equal(np.asarray(jb.cols),
                                          tb.cols.numpy())
            np.testing.assert_array_equal(np.asarray(jb.w), tb.w.numpy())
        np.testing.assert_array_equal(jleft, tleft.numpy())


def test_rebucket_round_trip_bit_identical():
    jg = jrmat(7, 8, seed=4)
    tg = trmat(7, 8, seed=4, device="cpu")
    for n_new, e_new in ((256, 4096), (128, tg.e_valid), (1024, 16384)):
        jr = jgraph.rebucket_graph(jg, n_new, e_new)
        tr = tgraph.rebucket_graph(tg, n_new, e_new)
        assert_same_graph(jr, tr)
        back = tgraph.rebucket_graph(tr, tg.n_cap, tg.e_cap)
        assert_same_graph(jg, back)
    with pytest.raises(ValueError):
        tgraph.rebucket_graph(tg, tg.n_valid - 1, tg.e_cap)


def test_graph_from_numpy_carries_jax_state():
    jg = jgraph.build_csr(np.array([0, 1, 2]), np.array([1, 2, 0]),
                          np.ones(3, np.float32), 3, n_cap=8, e_cap=12,
                          symmetrize=True)
    tg = graph_from_numpy(*(np.asarray(getattr(jg, f)) for f in BUFFERS),
                          int(jg.n_valid), int(jg.e_valid), device="cpu")
    assert_same_graph(jg, tg)
    assert (tg.n_cap, tg.e_cap) == (jg.n_cap, jg.e_cap)
