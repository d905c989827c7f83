"""``scan_backend="auto"``'s route to the fused ELL kernel K1: the rule of
``configs/louvain_arch.resolve_scan_backend`` (table-driven), the degree
tiers of ``core/graph.degree_tiers``, and ``louvain()`` /
``louvain_dynamic()`` through the route on the CPU, where K1 runs its plain
version: the resolver is told the graph is on a CUDA device.  The route
must give the sort-reduce scan's memberships label for label."""

import os
import types

import numpy as np
import pytest
import torch

from repro_torch import LouvainConfig, louvain, louvain_dynamic
from repro_torch.configs.louvain_arch import (FLOAT32_EXACT_SUM,
                                              resolve_scan_backend)
from repro_torch.core import louvain as louvain_mod
from repro_torch.core import spans
from repro_torch.core.ell_move import AUTO_ELL_WIDTHS
from repro_torch.core.graph import build_csr, degree_tiers, ell_bucket_rows
from repro_torch.data import sbm_edge_stream
from repro_torch.data.graphs import rmat_graph

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "engine_memberships.npz")
CUDA = torch.device("cuda")
CPU = torch.device("cpu")
UNIT = torch.ones(6)
K_SMALL = torch.tensor([3.0, 2.0, 1.0, 0.0])

#: (backend, use_ell_kernel, frontier_frac, device, weights, k) -> scanner.
RULE = {
    "auto-cuda-no-frontier": (("auto", False, None, CUDA, UNIT, K_SMALL),
                              "ell_fused"),
    "auto-cuda-wide-frontier": (("auto", False, 0.5, CUDA, UNIT, K_SMALL),
                                "ell_fused"),
    "auto-cuda-small-frontier": (("auto", False, 0.05, CUDA, UNIT, K_SMALL),
                                 "compact"),
    "auto-cuda-frontier-at-10%": (("auto", False, 0.10, CUDA, UNIT, K_SMALL),
                                  "compact"),
    "auto-cuda-float-weights": (("auto", False, None, CUDA,
                                 torch.tensor([1.0, 0.5]), K_SMALL), "full"),
    "auto-cuda-negative-weight": (("auto", False, None, CUDA,
                                   torch.tensor([1.0, -1.0]), K_SMALL),
                                  "full"),
    "auto-cuda-k-at-2^24": (("auto", False, None, CUDA, UNIT,
                             torch.tensor([float(FLOAT32_EXACT_SUM)])),
                            "full"),
    "auto-cuda-k-above-2^24": (("auto", False, 0.5, CUDA, UNIT,
                                torch.tensor([2.0 ** 25])), "full"),
    "auto-cuda-k-below-2^24": (("auto", False, None, CUDA, UNIT,
                                torch.tensor([FLOAT32_EXACT_SUM - 1.0])),
                               "ell_fused"),
    "auto-cuda-no-weights": (("auto", False, None, CUDA, None, None), "full"),
    "auto-cpu": (("auto", False, None, CPU, UNIT, K_SMALL), "full"),
    "auto-cpu-wide-frontier": (("auto", False, 0.5, CPU, UNIT, K_SMALL),
                               "full"),
    "auto-cpu-small-frontier": (("auto", False, 0.05, CPU, UNIT, K_SMALL),
                                "compact"),
    "full-cuda": (("full", False, None, CUDA, UNIT, K_SMALL), "full"),
    "compact-cuda": (("compact", False, 0.5, CUDA, UNIT, K_SMALL),
                     "compact"),
    "compact-cuda-no-frontier": (("compact", False, None, CUDA, UNIT,
                                  K_SMALL), "full"),
    "ell-cuda": (("ell", False, None, CUDA, UNIT, K_SMALL), "ell"),
    "ell_fused-cpu": (("ell_fused", False, None, CPU, UNIT, K_SMALL),
                      "ell_fused"),
    "auto-use_ell_kernel": (("auto", True, 0.05, CPU, None, None),
                            "ell_fused"),
    "full-use_ell_kernel": (("full", True, None, CUDA, UNIT, K_SMALL),
                            "ell"),
}


@pytest.mark.parametrize("case", sorted(RULE))
def test_resolve_scan_backend_rule(case):
    (backend, use_ell, frac, device, weights, k), want = RULE[case]
    assert resolve_scan_backend(backend, use_ell_kernel=use_ell,
                                frontier_frac=frac, device=device,
                                weights=weights, k=k) == want


def test_resolve_scan_backend_refusals():
    with pytest.raises(ValueError):
        resolve_scan_backend("bogus", device=CUDA)
    with pytest.raises(ValueError):
        resolve_scan_backend("compact", use_ell_kernel=True, device=CUDA)


def _histogram_graph(degrees):
    """A stand-in graph holding only the CSR's ``indptr`` of the given
    vertex degrees, which is all the degree tiers read."""
    indptr = torch.tensor(np.concatenate([[0], np.cumsum(degrees)]),
                          dtype=torch.int32)
    n = len(degrees)
    return types.SimpleNamespace(indptr=indptr, n_valid=n, n_cap=n + 3,
                                 device=CPU)


def test_degree_tiers_keep_the_tiers_that_hold_rows():
    # Degrees 0-16 and 257-2048 only, and two rows above the widest tier.
    degrees = [0, 5, 16, 300, 2048, 40000, 9, 32769, 1]
    g = _histogram_graph(degrees)
    tiers, leftover = degree_tiers(g, AUTO_ELL_WIDTHS)
    assert [w for w, _ in tiers] == [16, 2048]
    rows, left_all = ell_bucket_rows(g, AUTO_ELL_WIDTHS)
    np.testing.assert_array_equal(tiers[0][1].numpy(),
                                  [0, 1, 2, 6, 8, 12, 12, 12])
    np.testing.assert_array_equal(tiers[1][1].numpy(),
                                  [3, 4] + [12] * 6)
    for (w, r) in tiers:
        np.testing.assert_array_equal(
            r.numpy(), rows[AUTO_ELL_WIDTHS.index(w)].numpy())
    np.testing.assert_array_equal(leftover.numpy(), [5, 7])
    np.testing.assert_array_equal(left_all.numpy(), [5, 7])
    # The empty tiers are pad rows alone in the full bucketing.
    for w, r in zip(AUTO_ELL_WIDTHS, rows):
        if w not in (16, 2048):
            np.testing.assert_array_equal(r.numpy(), [12] * 8)


def test_degree_tiers_refuse_widths_out_of_order():
    with pytest.raises(ValueError):
        degree_tiers(_histogram_graph([1, 2]), (64, 16))


@pytest.fixture
def card_route(monkeypatch):
    """``louvain()``'s resolver told that the graph lies on a CUDA device,
    so that ``"auto"`` takes the K1 route (K1's plain version on the
    CPU)."""
    real = louvain_mod.resolve_scan_backend

    def on_card(*args, **kwargs):
        return real(*args, **dict(kwargs, device=CUDA))

    monkeypatch.setattr(louvain_mod, "resolve_scan_backend", on_card)


@pytest.fixture(scope="module")
def wide_graph():
    """R-MAT scale 11 (degrees up to ~800) with hubs of 3,000, 10,000 and
    20,000 new leaves (the 4096, 16384 and 32768 tiers) and one of 33,000
    (above the widest): rows in each of ``AUTO_ELL_WIDTHS`` and above."""
    base = rmat_graph(11, 16, seed=3, device="cpu")
    e = base.e_valid
    src = base.src[:e].numpy().astype(np.int64)
    dst = base.indices[:e].numpy().astype(np.int64)
    n = base.n_valid
    hubs = [(7, 3000), (9, 10000), (13, 20000), (11, 33000)]
    for hub, leaves in hubs:
        src = np.concatenate([src, np.full(leaves, hub)])
        dst = np.concatenate([dst, np.arange(n, n + leaves)])
        n += leaves
    return build_csr(src, dst, np.ones(len(src), np.float32), n,
                     symmetrize=True, device="cpu")


def test_wide_graph_fills_every_tier(wide_graph):
    tiers, leftover = degree_tiers(wide_graph, AUTO_ELL_WIDTHS)
    assert tuple(w for w, _ in tiers) == AUTO_ELL_WIDTHS
    assert leftover.numel() == 1


@pytest.mark.parametrize("refine", ["none", "leiden"])
def test_auto_route_equals_the_full_scan(card_route, wide_graph, refine):
    with spans.recording():
        got = louvain(wide_graph, LouvainConfig(refine=refine))
        counters = spans.session().counters
    assert got.passes[0].scan_backend == "ell_fused"
    assert counters.get("scan.ell_rounds", 0) > 0
    with spans.recording():
        want = louvain(wide_graph,
                       LouvainConfig(refine=refine, scan_backend="full"))
        counters = spans.session().counters
    assert counters.get("scan.full_rounds", 0) > 0
    assert "scan.ell_rounds" not in counters
    np.testing.assert_array_equal(got.membership, want.membership)
    assert len(got.levels) == len(want.levels)
    for a, b in zip(got.levels, want.levels):
        np.testing.assert_array_equal(a, b)
    assert ([p.iterations for p in got.passes]
            == [p.iterations for p in want.passes])


def test_auto_route_keeps_float_weights_on_the_full_scan(card_route,
                                                         wide_graph):
    """Weights of 1.5 keep pass 0 on the sort-reduce scan; a coarse pass
    whose summed weights come out integer may take K1, and the memberships
    stay the full scan's."""
    g = wide_graph
    w = torch.where(g.src < g.n_cap, g.weights * 1.5, g.weights)
    g = type(g)(**{**g.__dict__, "weights": w})
    got = louvain(g, LouvainConfig())
    assert got.passes[0].scan_backend == "full"
    want = louvain(g, LouvainConfig(scan_backend="full"))
    np.testing.assert_array_equal(got.membership, want.membership)


def test_auto_route_reproduces_the_stream_golden(card_route):
    init, batches = sbm_edge_stream(device="cpu")
    res = louvain_dynamic(init, batches, config=LouvainConfig())
    np.testing.assert_array_equal(res.membership,
                                  np.load(GOLDEN)["dynamic__sbm_stream"])
    assert "ell_fused" in {s.scan_backend for s in res.batch_stats}
