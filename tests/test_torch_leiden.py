"""Leiden refinement (``refine="leiden"``) of the PyTorch port against the JAX
package, on the CPU, and wide ELL rows (widths above 1024).

The engine pieces (``sanitize_outer``, ``assert_outer_sane``,
``mask_cross_outer_slots``), the constrained sweeps (``_refine_phase`` and
``move_phase_ell(refine_outer=...)``, scan-only and fused; the reference's
Pallas kernels run in interpret mode), ``_leiden_warm_membership`` and the
masked ELL tiles are held against their references element for element.
``louvain()`` / ``louvain_dynamic()`` with ``refine="leiden"`` must reproduce
the nine committed Leiden goldens, ``ell_leiden__*`` through both the fused
(K1) and the scan-only (K2) route, and keep the reference's properties: no
disconnected community, Q not below ``refine="none"``, outer levels and the
refinement's pass statistics.  Memberships, iterations and counts are
exact; the phases' dQ sums and Q add float32 fractions in another order
than XLA and are held float32-close.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:         # optional dev dep: tests/_hypothesis_fallback
    from _hypothesis_fallback import given, settings, st

from _oracle import disconnected_communities, modularity_np, \
    oracle_graph_slots
from _wide_rows import hub_graph_slots, star_graph_slots
from golden import capture_engine_golden as capture

from repro.core import ell_move as jell_move
from repro.core import engine as jengine
from repro.core.graph import build_csr as jbuild_csr, to_ell_blocks as jell
from repro.core.louvain import (LouvainConfig as JConfig,
                                _leiden_warm_membership as jwarm,
                                _refine_phase as jrefine, louvain as jlouvain,
                                louvain_modularity as jlouvain_modularity)

from repro_torch import (LouvainConfig, build_csr, louvain, louvain_dynamic,
                         sbm_edge_stream)
from repro_torch.core import engine as tengine
from repro_torch.core.aggregate import renumber_communities
from repro_torch.core.ell_move import move_phase_ell
from repro_torch.core.graph import ell_block, ell_bucket_rows
from repro_torch.core.local_move import cross_outer_masked
from repro_torch.core.louvain import (_leiden_warm_membership,
                                      _refine_phase, louvain_modularity,
                                      singleton_init)
from repro_torch.interop import config_from_dict, graph_from_numpy
from repro_torch.kernels.louvain_scan.louvain_scan import (SMEM_MAX_WIDTH,
                                                           ELLWidthError)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "engine_memberships.npz")
NAMES = ["lesmis", "sbm", "ring_of_cliques", "gnp"]
TOL = 0.01


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def gold():
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def corpora():
    """The golden corpora as (JAX graph, port graph) pairs."""
    return {name: (jg, to_port(jg)) for name, jg in capture.corpora().items()}


def to_port(jg):
    return graph_from_numpy(np.asarray(jg.indptr), np.asarray(jg.indices),
                            np.asarray(jg.weights), np.asarray(jg.src),
                            int(jg.n_valid), int(jg.e_valid), device="cpu")


def outer_of(jg) -> np.ndarray:
    """The reference's refine="none" membership padded to (n_cap + 1,)
    with the sentinel: the outer partition a refine phase receives."""
    n = int(jg.n_valid)
    mem = np.asarray(jlouvain(jg).membership)
    return np.concatenate([mem, np.full(jg.n_cap + 1 - n, jg.n_cap)]
                          ).astype(np.int32)


# ---------------------------------------------------------------------------
# sanitize_outer, assert_outer_sane, mask_cross_outer_slots.
# ---------------------------------------------------------------------------

def test_sanitize_outer_cases_equal_reference():
    """The reference's case (stale 99 and -1 become singletons, slots past
    n_valid the sentinel), plus an all-valid and an all-invalid layout."""
    for outer, n_valid, sent in (([2, 2, 99, -1, 7, 0], 4, 5),
                                 ([0, 0, 1, 2, 4], 4, 4),
                                 ([3, 1, 7, 0], 0, 3)):
        want = np.asarray(jengine.sanitize_outer(
            jnp.asarray(outer, jnp.int32), jnp.int32(n_valid), sent))
        got = tengine.sanitize_outer(torch.tensor(outer, dtype=torch.int32),
                                     n_valid, sent)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tengine.sanitize_outer(torch.tensor([2, 2, 99, -1, 7, 0]), 4,
                               5).numpy(), [2, 2, 2, 3, 5, 5])


def _random_outer(seed, cap):
    """A (cap + 1,) outer membership with stale labels on both sides of the
    valid range, and n_valid in [0, cap]."""
    rng = np.random.default_rng(seed)
    n_valid = int(rng.integers(0, cap + 1))
    outer = rng.integers(-3, cap + 6, cap + 1).astype(np.int32)
    good = rng.random(cap + 1) < 0.6
    outer[good] = rng.integers(0, max(n_valid, 1), int(good.sum()))
    return outer, n_valid


@settings(max_examples=30, deadline=None)
@given(st.integers(0, 10 ** 6), st.integers(1, 40))
def test_sanitize_outer_random_equals_reference(seed, cap):
    outer, n_valid = _random_outer(seed, cap)
    want = np.asarray(jengine.sanitize_outer(jnp.asarray(outer),
                                             jnp.int32(n_valid), cap))
    got = tengine.sanitize_outer(torch.from_numpy(outer), n_valid, cap)
    np.testing.assert_array_equal(got.numpy(), want)
    # A sanitized membership passes the eager check.
    tengine.assert_outer_sane(got, n_valid, cap)


def test_assert_outer_sane_cases_equal_reference():
    good = [0, 0, 1, 5, 5, 5]
    jengine.assert_outer_sane(jnp.asarray(good, jnp.int32), jnp.int32(3), 5)
    tengine.assert_outer_sane(torch.tensor(good, dtype=torch.int32), 3, 5)
    for bad in ([0, 42, 1, 5, 5, 5], [0, 0, -1, 5, 5, 5],
                [0, 0, 1, 2, 5, 5]):
        with pytest.raises(ValueError, match="outer"):
            jengine.assert_outer_sane(jnp.asarray(bad, jnp.int32),
                                      jnp.int32(3), 5)
        with pytest.raises(ValueError, match="outer"):
            tengine.assert_outer_sane(torch.tensor(bad, dtype=torch.int32),
                                      3, 5)


@settings(max_examples=30, deadline=None)
@given(st.integers(0, 10 ** 6), st.integers(1, 40))
def test_assert_outer_sane_random_agrees_with_reference(seed, cap):
    outer, n_valid = _random_outer(seed, cap)
    try:
        jengine.assert_outer_sane(jnp.asarray(outer), jnp.int32(n_valid),
                                  cap)
        ref_raised = False
    except ValueError:
        ref_raised = True
    if ref_raised:
        with pytest.raises(ValueError, match="stale outer"):
            tengine.assert_outer_sane(torch.from_numpy(outer), n_valid, cap)
    else:
        tengine.assert_outer_sane(torch.from_numpy(outer), n_valid, cap)


def test_mask_cross_outer_slots_case_equals_reference():
    outer = [0, 0, 1, 1, 4]
    src, dst, w = [0, 1, 2], [1, 2, 3], [1.0, 2.0, 3.0]
    dst2, w2 = tengine.mask_cross_outer_slots(
        torch.tensor(src, dtype=torch.int32),
        torch.tensor(dst, dtype=torch.int32), torch.tensor(w),
        torch.tensor(outer, dtype=torch.int32), 4)
    np.testing.assert_array_equal(dst2.numpy(), [1, 4, 3])
    np.testing.assert_array_equal(w2.numpy(), [1.0, 0.0, 3.0])
    assert (dst2.dtype, w2.dtype) == (torch.int32, torch.float32)


@settings(max_examples=30, deadline=None)
@given(st.integers(0, 10 ** 6), st.integers(1, 30), st.integers(0, 90))
def test_mask_cross_outer_slots_random_equals_reference(seed, cap, e):
    """Random slots, padding (src = dst = sentinel) included, over a
    sanitized outer membership."""
    rng = np.random.default_rng(seed)
    outer, n_valid = _random_outer(seed, cap)
    outer = np.array(jengine.sanitize_outer(jnp.asarray(outer),
                                            jnp.int32(n_valid), cap))
    src = rng.integers(0, cap + 1, e).astype(np.int32)
    dst = rng.integers(0, cap + 1, e).astype(np.int32)
    pad = rng.random(e) < 0.2
    src[pad] = dst[pad] = cap
    w = rng.integers(0, 5, e).astype(np.float32)
    want = jengine.mask_cross_outer_slots(jnp.asarray(src), jnp.asarray(dst),
                                          jnp.asarray(w), jnp.asarray(outer),
                                          cap)
    got = tengine.mask_cross_outer_slots(
        torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(w),
        torch.from_numpy(outer), cap)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# The constrained sweeps.
# ---------------------------------------------------------------------------

def _same_phase(got, want):
    """(comm, iters, dq_sum) of a port phase equal the reference's: comm
    and iters exactly, dq_sum (a float32 sum of the movers' dQ fractions,
    in another order than XLA's) as ``tests/test_torch_louvain.py`` holds
    it."""
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[1] == int(want[1])
    assert float(got[2]) == pytest.approx(float(want[2]), rel=1e-5,
                                          abs=1e-7)


@pytest.mark.parametrize("name", NAMES)
def test_refine_phase_equals_reference(corpora, name):
    jg, tg = corpora[name]
    outer = outer_of(jg)
    want = jrefine(jg, jnp.asarray(outer), jnp.float32(TOL),
                   max_iterations=20, use_pruning=True)
    got = _refine_phase(tg, torch.from_numpy(outer), TOL, max_iterations=20,
                        use_pruning=True)
    _same_phase(got, want)
    # The result refines the outer partition.
    n = tg.n_valid
    refined = got[0].numpy()[:n]
    for r in np.unique(refined):
        assert len(np.unique(outer[:n][refined == r])) == 1


@pytest.mark.parametrize("fused", [False, True], ids=["scan", "fused"])
@pytest.mark.parametrize("name", NAMES)
def test_move_phase_ell_refine_equals_reference(corpora, name, fused):
    """The recipe of ``tests/test_fused_ell_kernel.py``'s refinement test:
    the reference's Pallas kernels in interpret mode over the masked
    blocks, the port's plain K1/K2 over the masked CSR."""
    jg, tg = corpora[name]
    outer = outer_of(jg)
    want = jell_move.move_phase_ell(jg, jnp.float32(TOL), fused=fused,
                                    interpret=True,
                                    refine_outer=jnp.asarray(outer))
    got = move_phase_ell(tg, *singleton_init(tg), TOL, fused=fused,
                         refine_outer=torch.from_numpy(outer))
    _same_phase(got, want)


@pytest.mark.parametrize("name", NAMES)
def test_masked_tiles_equal_reference_masked_blocks(corpora, name):
    """Masking the CSR masks the tiles: the plain kernels' tiles
    (``ell_block`` over the masked ``indices``/``weights``) equal the
    reference's ``_mask_blocks_cross_outer`` blocks, and the buckets come
    from the unmasked ``indptr``."""
    jg, tg = corpora[name]
    outer = outer_of(jg)
    widths = (16, 64, 256)
    jblocks, jleft = jell(jg, widths)
    jouter = jengine.sanitize_outer(jnp.asarray(outer), jg.n_valid,
                                    jg.n_cap)
    jmasked = jell_move._mask_blocks_cross_outer(jblocks, jouter, jg.n_cap)
    t_outer, masked = cross_outer_masked(tg, torch.from_numpy(outer))
    np.testing.assert_array_equal(t_outer.numpy(), np.asarray(jouter))
    assert masked.indptr is tg.indptr and masked.src is tg.src
    rows, left = ell_bucket_rows(masked, widths)
    np.testing.assert_array_equal(left.numpy(), np.asarray(jleft))
    for jb, r, width in zip(jmasked, rows, widths):
        tb = ell_block(masked.indptr, masked.indices, masked.weights, r,
                       width)
        for field in ("rows", "cols", "w"):
            np.testing.assert_array_equal(getattr(tb, field).numpy(),
                                          np.asarray(getattr(jb, field)))


def test_refine_phase_sanitizes_stale_outer_end_to_end():
    """A stale outer id (past the capacity) does not raise: the slot refines
    as its own singleton, everyone else refines the real outer partition,
    and the result equals the reference's."""
    import networkx as nx
    from repro.core.graph import from_networkx as jfrom_networkx

    jg = jfrom_networkx(nx.karate_club_graph())
    tg = to_port(jg)
    n = tg.n_valid
    outer = outer_of(jg)
    v = next(i for i in range(n) if i not in np.unique(outer[:n]))
    stale = outer.copy()
    stale[v] = tg.n_cap + 7
    want = jrefine(jg, jnp.asarray(stale), jnp.float32(TOL),
                   max_iterations=20, use_pruning=True)
    got = _refine_phase(tg, torch.from_numpy(stale), TOL, max_iterations=20,
                        use_pruning=True)
    _same_phase(got, want)
    ell = move_phase_ell(tg, *singleton_init(tg), TOL, fused=True,
                         refine_outer=torch.from_numpy(stale))
    np.testing.assert_array_equal(ell[0].numpy(), got[0].numpy())
    refined = got[0].numpy()[:n]
    assert np.sum(refined == refined[v]) == 1
    rest = np.arange(n) != v
    for r in np.unique(refined[rest]):
        assert len(np.unique(outer[:n][(refined == r) & rest])) == 1


# ---------------------------------------------------------------------------
# _leiden_warm_membership.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_leiden_warm_membership_equals_reference_on_corpora(corpora, name):
    """On a real pass: the renumbered outer and refined partitions of the
    corpus's first pass."""
    jg, tg = corpora[name]
    outer = torch.from_numpy(outer_of(jg))
    refined, _, _ = _refine_phase(tg, outer, TOL, max_iterations=20,
                                  use_pruning=True)
    outer_ren, _ = renumber_communities(outer, tg.n_valid)
    comm_ren, n_agg = renumber_communities(refined, tg.n_valid)
    want = jwarm(jnp.asarray(comm_ren.numpy()), jnp.asarray(outer_ren.numpy()),
                 jnp.int32(tg.n_valid), jnp.int32(n_agg))
    got = _leiden_warm_membership(comm_ren, outer_ren, tg.n_valid, n_agg)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@settings(max_examples=30, deadline=None)
@given(st.integers(0, 10 ** 6), st.integers(1, 50))
def test_leiden_warm_membership_random_equals_reference(seed, cap):
    """Random refined partitions of n_valid <= cap vertices into n_agg
    dense ids, each refined community inside one outer community."""
    rng = np.random.default_rng(seed)
    n_valid = int(rng.integers(0, cap + 1))
    n_agg = int(rng.integers(1, max(n_valid, 1) + 1)) if n_valid else 0
    comm = np.full(cap + 1, cap, np.int32)
    if n_valid:
        comm[:n_valid] = np.concatenate([np.arange(n_agg), rng.integers(
            0, n_agg, n_valid - n_agg)])[rng.permutation(n_valid)]
    n_outer = max(n_agg // 2, 1)
    outer_of_ref = rng.integers(0, n_outer, max(n_agg, 1)).astype(np.int32)
    outer = np.full(cap + 1, cap, np.int32)
    outer[:n_valid] = outer_of_ref[comm[:n_valid]]
    want = jwarm(jnp.asarray(comm), jnp.asarray(outer), jnp.int32(n_valid),
                 jnp.int32(n_agg))
    got = _leiden_warm_membership(torch.from_numpy(comm),
                                  torch.from_numpy(outer), n_valid, n_agg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# louvain() and louvain_dynamic() with refine="leiden".
# ---------------------------------------------------------------------------

LEIDEN_PATHS = {
    "single_leiden": LouvainConfig(refine="leiden"),
    "ell_leiden-k1": LouvainConfig(refine="leiden", use_ell_kernel=True),
    "ell_leiden-k2": LouvainConfig(refine="leiden", scan_backend="ell"),
}


@pytest.mark.parametrize("path", sorted(LEIDEN_PATHS))
@pytest.mark.parametrize("name", NAMES)
def test_leiden_goldens_element_for_element(gold, corpora, name, path):
    res = louvain(corpora[name][1], LEIDEN_PATHS[path])
    np.testing.assert_array_equal(res.membership,
                                  gold[f"{path.split('-')[0]}__{name}"])
    assert res.n_communities == len(np.unique(res.membership))
    want = "full" if path == "single_leiden" else (
        "ell_fused" if path.endswith("k1") else "ell")
    assert all(p.scan_backend == want for p in res.passes)


def test_dynamic_leiden_stream_reproduces_golden(gold):
    """``louvain_dynamic`` carries refine="leiden" through its cold start
    and every warm-started, delta-screened batch."""
    init, batches = sbm_edge_stream(device="cpu")
    res = louvain_dynamic(init, batches,
                          config=LouvainConfig(refine="leiden"))
    np.testing.assert_array_equal(res.membership,
                                  gold["dynamic_leiden__sbm_stream"])
    assert len(res.batch_stats) == 8


@pytest.mark.parametrize("config", [
    {"refine": "leiden"},
    {"refine": "leiden", "use_ell_kernel": True, "gate_fraction": 3},
    {"refine": "leiden", "agg_backend": "pallas", "use_ladder": False},
    {"refine": "leiden", "track_modularity": True},
])
def test_leiden_pass_table_equals_reference(corpora, config):
    """Every pass's reported and refined counts, iterations, capacities and
    level on the badly connected corpus, and Q per pass."""
    jg, tg = corpora["gnp"]
    jcfg = JConfig(**config)
    want = jlouvain(jg, jcfg)
    got = louvain(tg, config_from_dict(dataclasses.asdict(jcfg)))
    np.testing.assert_array_equal(got.membership, want.membership)
    fields = ("iterations", "n_communities", "n_vertices", "n_cap", "e_cap",
              "refine_iterations", "n_refined")
    assert ([[getattr(p, f) for f in fields] for p in got.passes]
            == [[getattr(p, f) for f in fields] for p in want.passes])
    for a, b in zip(got.levels, want.levels):
        np.testing.assert_array_equal(a, b)
    # Q sums float32 fractions in another order than XLA: float32-close.
    for a, b in zip(got.passes, want.passes):
        assert (a.modularity is None) == (b.modularity is None)
        if a.modularity is not None:
            assert a.modularity == pytest.approx(b.modularity, rel=1e-6)
    assert louvain_modularity(tg, got) == pytest.approx(
        jlouvain_modularity(jg, want), rel=1e-6)


def test_leiden_communities_all_connected(corpora):
    """No community of refine="leiden" is disconnected on any corpus
    (``_oracle.disconnected_communities``), on the sort-reduce and both
    ELL routes; refine="none" leaves one on the gnp corpus."""
    for name in NAMES:
        jg, tg = corpora[name]
        src, dst, _, _ = oracle_graph_slots(jg)
        for cfg in LEIDEN_PATHS.values():
            mem = louvain(tg, cfg).membership
            assert disconnected_communities(src, dst, mem) == [], name
    jg, tg = corpora["gnp"]
    src, dst, _, _ = oracle_graph_slots(jg)
    assert len(disconnected_communities(src, dst,
                                        louvain(tg).membership)) >= 1


def _disconnected(src, dst, n, membership) -> int:
    """Communities of ``membership`` whose intra-community subgraph is not
    connected, counted as components minus communities."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components
    keep = (src < dst) & (membership[src] == membership[dst])
    adj = coo_matrix((np.ones(int(keep.sum())), (src[keep], dst[keep])),
                     shape=(n, n))
    return (connected_components(adj.tocsr(), directed=False)[0]
            - len(np.unique(membership)))


def test_connectivity_audit_equals_reference_on_rmat():
    """On R-MAT scale 11 the reference's synchronous rounds leave
    disconnected communities, both in the reported Leiden partition and in
    a refine phase's partition (two singletons that join a third one's
    community in one round, while it moves away, need not be adjacent).
    The port gives the reference's memberships, so the same counts; and
    Leiden still leaves fewer than refine="none"."""
    from repro.data import rmat_graph as jrmat
    from repro_torch import rmat_graph

    jg = jrmat(11, 16, seed=0)
    tg = rmat_graph(11, 16, seed=0, device="cpu")
    n = tg.n_valid
    src, dst, _, _ = oracle_graph_slots(jg)
    want = jlouvain(jg, JConfig(refine="leiden"))
    got = louvain(tg, LouvainConfig(refine="leiden"))
    np.testing.assert_array_equal(got.membership, want.membership)
    outer = np.concatenate([got.membership, np.full(tg.n_cap + 1 - n,
                                                    tg.n_cap)]
                           ).astype(np.int32)
    j_ref = np.asarray(jrefine(jg, jnp.asarray(outer), jnp.float32(TOL),
                               max_iterations=20, use_pruning=True)[0])[:n]
    t_ref = _refine_phase(tg, torch.from_numpy(outer), TOL,
                          max_iterations=20, use_pruning=True)[0][:n]
    np.testing.assert_array_equal(t_ref.numpy(), j_ref)
    counts = [_disconnected(src, dst, n, m) for m in (
        got.membership, t_ref.numpy(), louvain(tg).membership)]
    assert counts[0] > 0 and counts[1] > 0
    assert counts[0] < counts[2]


def test_leiden_modularity_not_worse(corpora):
    for name in NAMES:
        jg, tg = corpora[name]
        src, dst, w, _ = oracle_graph_slots(jg)
        q_none = modularity_np(src, dst, w, louvain(tg).membership)
        q_ref = modularity_np(src, dst, w, louvain(
            tg, LouvainConfig(refine="leiden")).membership)
        assert q_ref >= q_none - 1e-9, (name, q_none, q_ref)


def test_refine_pass_stats_populated(corpora):
    tg = corpora["gnp"][1]
    res = louvain(tg, LouvainConfig(refine="leiden"))
    assert all(p.refine_iterations is not None for p in res.passes)
    assert all(p.n_refined is not None and p.n_refined >= p.n_communities
               for p in res.passes)
    assert all("refine" in p.phase_seconds for p in res.passes)
    res_none = louvain(tg)
    assert all(p.refine_iterations is None and p.n_refined is None
               and "refine" not in p.phase_seconds for p in res_none.passes)


def test_levels_leiden_reports_outer_per_pass(corpora):
    """Levels are the outer partitions: the last is the membership, each
    has its pass's community count, and Q does not fall across them."""
    jg, tg = corpora["gnp"]
    src, dst, w, _ = oracle_graph_slots(jg)
    res = louvain(tg, LouvainConfig(refine="leiden"))
    assert len(res.levels) == res.n_passes
    np.testing.assert_array_equal(res.levels[-1], res.membership)
    for lvl, p in zip(res.levels, res.passes):
        assert len(np.unique(lvl)) == p.n_communities
    qs = [modularity_np(src, dst, w, lvl) for lvl in res.levels]
    assert all(b >= a - 1e-9 for a, b in zip(qs, qs[1:])), qs


def test_refine_rejects_unknown_mode():
    with pytest.raises(ValueError, match="refine"):
        LouvainConfig(refine="bogus")
    with pytest.raises(ValueError, match="refine"):
        config_from_dict({"refine": "bogus"})


# ---------------------------------------------------------------------------
# Wide ELL rows (widths above 1024).
# ---------------------------------------------------------------------------

def test_wide_ell_widths_equal_reference():
    """``ell_widths=(16, 64, 256, 2048)`` on a graph with one row above
    degree 1024: the fused (K1) and scan-only (K2) routes give the
    reference's membership and pass table."""
    s, d, w, n = hub_graph_slots()
    jg = jbuild_csr(s, d, w, n, symmetrize=True)
    tg = build_csr(s, d, w, n, symmetrize=True, device="cpu")
    assert int(np.diff(np.asarray(jg.indptr)).max()) > 1024
    widths = (16, 64, 256, 2048)
    want = jlouvain(jg, JConfig(use_ell_kernel=True, ell_widths=widths))
    rows, left = ell_bucket_rows(tg, widths)
    assert left.numel() == 0 and int((rows[3] < tg.n_cap).sum()) == 1
    for cfg in (LouvainConfig(use_ell_kernel=True, ell_widths=widths),
                LouvainConfig(scan_backend="ell", ell_widths=widths)):
        got = louvain(tg, cfg)
        np.testing.assert_array_equal(got.membership, want.membership)
        assert ([(p.iterations, p.n_communities) for p in got.passes]
                == [(p.iterations, p.n_communities) for p in want.passes])


@pytest.mark.parametrize("widths", [(16, 64, 0), (16, -1, 256),
                                    (0, 64)])
def test_ell_widths_outside_the_kernels_raise_at_config_time(widths):
    """A width no kernel layout takes (below 1) is refused by
    ``LouvainConfig`` on every device, with the named error, before any
    launch; widths past the shared-memory layout's are accepted."""
    with pytest.raises(ELLWidthError, match="below 1"):
        LouvainConfig(ell_widths=widths)
    with pytest.raises(ELLWidthError):
        config_from_dict({"use_ell_kernel": True, "ell_widths": list(widths)})
    assert issubclass(ELLWidthError, ValueError)
    for wide in (SMEM_MAX_WIDTH, SMEM_MAX_WIDTH + 1, 1 << 15, 1 << 24):
        assert LouvainConfig(ell_widths=(16, wide)).ell_widths[-1] == wide


def test_ell_width_above_shared_memory_equals_reference():
    """``ell_widths=(16, 64, 256, 32768)`` on an sbm block whose vertex 0 is
    the hub of 17,000 leaves: its row (degree above 16,384) takes the
    32768-wide bucket, the kernels' global-scratch layout on the card and
    the plain versions here.  The reference cannot run that bucket on the
    CPU: its Pallas tile holds a (8, 32768, 32768) equality block.  Its
    ELL path with the default widths sends the hub row to the sort-reduce
    scan instead, the same Eq. 2 on the same exact sums (unit weights), so
    the memberships and pass tables must be equal, and equal to its
    sort-reduce ``louvain()``."""
    s, d, w, n = star_graph_slots()
    jg = jbuild_csr(s, d, w, n, symmetrize=True)
    tg = build_csr(s, d, w, n, symmetrize=True, device="cpu")
    widths = (16, 64, 256, 32768)
    rows, left = ell_bucket_rows(tg, widths)
    assert left.numel() == 0
    hub = rows[3][rows[3] < tg.n_cap]
    assert hub.tolist() == [0]
    assert int(tg.indptr[1] - tg.indptr[0]) > SMEM_MAX_WIDTH
    want = jlouvain(jg, JConfig(use_ell_kernel=True))
    sort_ref = jlouvain(jg)
    np.testing.assert_array_equal(want.membership, sort_ref.membership)
    for cfg in (LouvainConfig(use_ell_kernel=True, ell_widths=widths),
                LouvainConfig(scan_backend="ell", ell_widths=widths)):
        got = louvain(tg, cfg)
        np.testing.assert_array_equal(got.membership, want.membership)
        assert ([(p.iterations, p.n_communities) for p in got.passes]
                == [(p.iterations, p.n_communities) for p in want.passes])
