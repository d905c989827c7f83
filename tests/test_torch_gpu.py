"""The PyTorch port's CUDA kernels on the card: K1, K2, K3 and K4 against
their plain PyTorch versions on the same CUDA tensors (K1/K2 in all three
row layouts, the one-row-per-block layout for widths above 1024 included),
the batch apply's kernel backend against its sort backend, ``louvain()``
and ``louvain_dynamic()`` on the card against the committed sbm goldens,
``refine="leiden"`` included, the batched multi-stream drivers against
the solo ones, with K3/K4 launched once per fleet operation, and the
sharded drivers: their sbm goldens through NCCL at world size 1 (the
hybrid state layout and ``louvain_dynamic_sharded`` included), K3 in the
aggregation, K4 in each rank's batch apply, and staged gloo ranks on the
one card; and the multi-tenant sharded serving fleet (``serve_fleet``):
its goldens through NCCL, the whale and fallback paths against the solo
driver, and K4 over a bucket's flat, lane-keyed slot list.

Every test here is marked ``gpu`` and skips without a card (the decision is
made inside the ``cuda`` fixture, never at import).  The machine with the
card has no JAX, so this file imports torch only and runs without the
repository's conftest:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_gpu.py

Exactness: K1 and K2 add each community's weights in ascending slot order
(the plain versions add the same values in the same order, plus +0.0 for the
other slots) and evaluate dQ in the reference's order without FMA, so they
agree bit for bit on any weights; K3's weight sums
associate differently and agree bit for bit on integer weights and within
m * 2^-23 * sum |w| over the m slots summed on float weights, and K3 gives
bit-identical outputs from call to call; K4 selects weights and never sums
them, so it agrees bit for bit on any weights.
"""

import os

import numpy as np
import pytest
import torch

from _k3_bounds import k3_tolerances
from _wide_rows import hub_graph_slots, star_graph_slots, wide_csr_arrays
from repro_torch import (FleetCapacityOverflow, LouvainConfig, ShardGroup,
                         apply_edge_batch, build_csr, distributed_louvain,
                         louvain, louvain_dynamic_sharded,
                         louvain_batched, louvain_dynamic,
                         louvain_dynamic_batched, make_edge_batch,
                         sbm_edge_stream, sbm_graph, sbm_holdout_stream,
                         stack_batches, stack_graphs)
from repro_torch.core.aggregate import (aggregate_fleet,
                                        sorted_fleet_aggregate_slots)
from repro_torch.core.delta import apply_fleet_batch, sorted_fleet_slots
from repro_torch.kernels.aggregate import coarsen
from repro_torch.kernels.batch_apply import resolve
from repro_torch.kernels.louvain_scan import ops

pytestmark = pytest.mark.gpu
GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "engine_memberships.npz")
SENTINEL = 1 << 20


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


#: Degrees every random CSR holds (three rows each, where they fit).
SPECIAL_DEGREES = (0, 1, 16, 17, 32, 33, 64, 65, 256)


def _random_csr(rng, n, max_deg, integer_w, dev):
    """A random CSR of ``n`` vertices (``n_cap = n + 8``) and its per-vertex
    state, as tensors on ``dev``.  Rows hit every degree of
    ``SPECIAL_DEGREES`` up to ``max_deg``; vertex 0 (degree 16) and vertex
    1 (degree 65, where it fits) hold only self loops, vertex 2 only
    neighbours of one community, vertex 3 two neighbours of equal weight
    in two communities of equal Sigma (an exact dQ tie); a few slots hold
    the sentinel column (dead, like padding).  Sigma takes three values
    and most sizes are 1, so ties and the singleton-swap guard occur."""
    n_cap = n + 8
    n_ids = max(8, n // 6)
    lo = rng.random(n) < 0.7
    deg = np.where(lo, rng.integers(0, 17, n),
                   rng.integers(min(17, max_deg), max_deg + 1, n))
    special = [d for d in SPECIAL_DEGREES if d <= max_deg]
    deg[8:8 + 3 * len(special)] = np.repeat(special, 3)
    deg[0], deg[2], deg[3] = 16, min(max_deg, 200), 2
    deg[1] = 65 if max_deg >= 65 else max_deg
    comm = np.arange(n_cap + 1, dtype=np.int32)
    comm[:n] = rng.integers(0, n_ids, n)
    indptr = np.zeros(n_cap + 1, np.int64)
    indptr[1:n + 1] = np.cumsum(deg)
    indptr[n + 1:] = indptr[n]
    cols = rng.integers(0, n, int(indptr[n])).astype(np.int32)
    for v in (0, 1):
        cols[indptr[v]:indptr[v + 1]] = v
    members = np.flatnonzero(comm[:n] == comm[5])
    cols[indptr[2]:indptr[3]] = rng.choice(members, deg[2])
    a, b = (np.flatnonzero(comm[:n] == c)[0] for c in np.unique(
        comm[10:n])[:2])
    cols[indptr[3]:indptr[4]] = [a, b]
    comm[3] = n_ids          # in neither community, alone in its own
    cols[rng.random(len(cols)) < 0.01] = n_cap
    if integer_w:
        w = rng.integers(1, 4, len(cols)).astype(np.float32)
    else:
        w = (rng.random(len(cols)) + 0.05).astype(np.float32)
    w[indptr[3]:indptr[4]] = 2.0
    sigma = (rng.integers(1, 4, n_cap + 1) * 4).astype(np.float32)
    sigma[comm[b]] = sigma[comm[a]]
    sizes = np.where(rng.random(n_cap + 1) < 0.7, 1, 2).astype(np.int32)
    k = rng.integers(1, 6, n_cap + 1).astype(np.float32)
    front = rng.random(n_cap + 1) < 0.7
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    csr = (t(indptr.astype(np.int32)), t(cols), t(w))
    state = dict(comm=t(comm), sigma=t(sigma), sizes=t(sizes), k=t(k),
                 front=t(front))
    m = torch.tensor(float(rng.integers(40, 900)), device=dev)
    return csr, state, deg, m


def _bucket(rng, deg, n_cap, lo, hi, dev):
    """The vertices of degree in (lo, hi] (and isolated ones when lo == 0)
    in random order, then pad rows (``n_cap``)."""
    sel = np.flatnonzero((deg <= hi) & ((deg > lo) | (lo == 0)))
    rows = np.concatenate([rng.permutation(sel), np.full(7, n_cap)])
    return torch.from_numpy(rows.astype(np.int32)).to(dev)


def _k1_k2(rows, csr, st, m, width, round_ix, gate_fraction, sentinel,
           plain):
    scan = ops.louvain_scan_rows_ref if plain else ops.louvain_scan
    fuse = ops.louvain_fused_rows_ref if plain else ops.louvain_fused
    got = scan(rows, *csr, st["comm"], st["sigma"], st["k"], m, width=width)
    fgot = fuse(rows, *csr, st["comm"], st["sigma"], st["sizes"], st["k"],
                st["front"], m, round_ix, width=width,
                gate_fraction=gate_fraction, sentinel=sentinel)
    return list(got) + list(fgot)


@pytest.mark.parametrize("integer_w", [True, False])
@pytest.mark.parametrize("gate_fraction", [1, 2, 4])
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256, 512, 1024])
def test_k1_k2_equal_plain_on_the_card(cuda, d, gate_fraction, integer_w):
    """K1 and K2 bit-equal to their plain versions on a random CSR bucket:
    every row of degree <= d (all degrees of ``SPECIAL_DEGREES`` that fit,
    self-loop rows, a one-community row, a tie row), in random order, with
    pad rows.  Each d launches its own kernel instantiation (one row per
    thread at 16; one row per warp with sorts of up to d keys above)."""
    rng = np.random.default_rng(d + gate_fraction)
    csr, st, deg, m = _random_csr(rng, 3000, d, integer_w, cuda)
    n_cap = st["comm"].numel() - 1
    rows = _bucket(rng, deg, n_cap, 0, d, cuda)
    n1, n2 = ops.louvain_fused.launches, ops.louvain_scan.launches
    got = _k1_k2(rows, csr, st, m, d, 12345, gate_fraction, n_cap, False)
    want = _k1_k2(rows, csr, st, m, d, 12345, gate_fraction, n_cap, True)
    torch.cuda.synchronize()
    assert (ops.louvain_fused.launches, ops.louvain_scan.launches) == (
        n1 + 1, n2 + 1)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert bool(got[4].any()) and bool((got[0] < 0).any())


@pytest.mark.parametrize("integer_w", [True, False])
@pytest.mark.parametrize("gate_fraction", [1, 2, 4])
def test_k1_k2_equal_plain_on_default_buckets(cuda, gate_fraction,
                                               integer_w):
    """The default ELL widths (16, 64, 256), each on its own degree range,
    and two odd widths (5, 40), over two rounds."""
    rng = np.random.default_rng(100 + gate_fraction)
    csr, st, deg, m = _random_csr(rng, 4000, 256, integer_w, cuda)
    n_cap = st["comm"].numel() - 1
    for lo, hi in ((0, 16), (16, 64), (64, 256), (0, 5), (5, 40)):
        rows = _bucket(rng, deg, n_cap, lo, hi, cuda)
        for round_ix in (0, 7):
            got = _k1_k2(rows, csr, st, m, hi, round_ix, gate_fraction,
                         n_cap, False)
            want = _k1_k2(rows, csr, st, m, hi, round_ix, gate_fraction,
                          n_cap, True)
            for a, b in zip(got, want):
                assert torch.equal(a, b), (lo, hi, round_ix)


def _wide_csr(rng, n, degs, integer_w, dev):
    """``_wide_rows.wide_csr_arrays`` as tensors on ``dev``."""
    csr, state, deg, m = wide_csr_arrays(rng, n, degs, integer_w)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    return (tuple(t(x) for x in csr), {k: t(v) for k, v in state.items()},
            deg, torch.tensor(m, device=dev))


@pytest.mark.parametrize("integer_w", [True, False])
@pytest.mark.parametrize("gate_fraction", [1, 2])
@pytest.mark.parametrize("width", [1100, 2048, 4096, 8192, 16384])
def test_k1_k2_cta_rows_equal_plain_on_the_card(cuda, width, gate_fraction,
                                                 integer_w):
    """The one-row-per-block layout (widths above 1024) bit-equal to the
    plain versions: rows of degree 1025, the width, one below it, a power
    of two plus one and random degrees in between, a self-loop row, a
    one-community row and a tie row of that size, ten narrow rows and pad
    rows, in random order."""
    rng = np.random.default_rng(width + 10 * gate_fraction + integer_w)
    degs = [width, width - 1, 1025, min(width, 2049)]
    degs += list(rng.integers(1025, width + 1, 4))
    csr, st, deg, m = _wide_csr(rng, 3000, degs, integer_w, cuda)
    n_cap = st["comm"].numel() - 1
    wide = np.flatnonzero((deg > 1024) & (deg <= width))
    narrow = rng.choice(np.flatnonzero(deg <= 16), 10, replace=False)
    rows = torch.from_numpy(np.concatenate([
        rng.permutation(np.concatenate([wide, narrow])),
        np.full(7, n_cap)]).astype(np.int32)).to(cuda)
    n1, n2 = ops.louvain_fused.cta_launches, ops.louvain_scan.cta_launches
    got = _k1_k2(rows, csr, st, m, width, 77, gate_fraction, n_cap, False)
    want = _k1_k2(rows, csr, st, m, width, 77, gate_fraction, n_cap, True)
    torch.cuda.synchronize()
    assert (ops.louvain_fused.cta_launches,
            ops.louvain_scan.cta_launches) == (n1 + 1, n2 + 1)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert bool((got[0] >= 0).any())
    # The tie row (vertex 2) goes to the smaller of its two communities.
    r2 = int(torch.nonzero(rows == 2)[0])
    ties = sorted(int(c) for c in torch.unique(st["comm"][csr[1][
        int(csr[0][2]):int(csr[0][3])].long()]))
    assert int(got[0][r2]) == ties[0]


@pytest.mark.parametrize("integer_w", [True, False])
@pytest.mark.parametrize("width", [16385, 32768, 40000])
def test_k1_k2_wide_rows_equal_plain_on_the_card(cuda, width, integer_w):
    """Widths above 16,384 (one row per block, keys and weights in global
    scratch) bit-equal to the plain versions, rows as in the shared-memory
    test: the width, one below it, 16,385, random degrees in between, a
    self-loop row, a one-community row and a tie row of that size."""
    rng = np.random.default_rng(width + integer_w)
    degs = [width, width - 1, 16385, min(width, 16400)]
    degs += list(rng.integers(16385, width + 1, 3))
    csr, st, deg, m = _wide_csr(rng, 3000, degs, integer_w, cuda)
    n_cap = st["comm"].numel() - 1
    wide = np.flatnonzero((deg > 1024) & (deg <= width))
    narrow = rng.choice(np.flatnonzero(deg <= 16), 10, replace=False)
    rows = torch.from_numpy(np.concatenate([
        rng.permutation(np.concatenate([wide, narrow])),
        np.full(7, n_cap)]).astype(np.int32)).to(cuda)
    n1, n2 = ops.louvain_fused.wide_launches, ops.louvain_scan.wide_launches
    got = _k1_k2(rows, csr, st, m, width, 77, 2, n_cap, False)
    want = _k1_k2(rows, csr, st, m, width, 77, 2, n_cap, True)
    torch.cuda.synchronize()
    assert (ops.louvain_fused.wide_launches,
            ops.louvain_scan.wide_launches) == (n1 + 1, n2 + 1)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    r2 = int(torch.nonzero(rows == 2)[0])
    ties = sorted(int(c) for c in torch.unique(st["comm"][csr[1][
        int(csr[0][2]):int(csr[0][3])].long()]))
    assert int(got[0][r2]) == ties[0]


def test_k1_k2_wide_rows_loop_over_a_small_scratch(cuda, monkeypatch):
    """A scratch that holds one block's slice: the grid is one block, which
    loops over every row, and the outputs stay bit-equal."""
    from repro_torch.kernels.louvain_scan import louvain_scan as k2
    monkeypatch.setattr(k2, "SCRATCH_BYTES", 12 * 32768)
    rng = np.random.default_rng(5)
    width = 20000
    degs = [width, width - 1, 16385] + list(rng.integers(16385, width, 3))
    csr, st, deg, m = _wide_csr(rng, 2000, degs, False, cuda)
    n_cap = st["comm"].numel() - 1
    assert k2.scratch_layout(width, 50, csr[1].numel()) == (32768, 1)
    rows = torch.from_numpy(np.concatenate([
        rng.permutation(np.flatnonzero(deg <= width)[:40]),
        np.full(3, n_cap)]).astype(np.int32)).to(cuda)
    got = _k1_k2(rows, csr, st, m, width, 5, 2, n_cap, False)
    want = _k1_k2(rows, csr, st, m, width, 5, 2, n_cap, True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_star_hub_above_shared_memory_on_the_card_equals_the_cpu(cuda):
    """``ell_widths=(16, 64, 256, 32768)`` on the star of 17,000 leaves:
    the card's K1 and K2 routes, the hub row in global scratch, give the
    CPU's membership."""
    widths = (16, 64, 256, 32768)
    s, d, w, n = star_graph_slots()
    want = louvain(build_csr(s, d, w, n, symmetrize=True, device="cpu"),
                   LouvainConfig(use_ell_kernel=True, ell_widths=widths))
    g = build_csr(s, d, w, n, symmetrize=True, device=cuda)
    for cfg, fn in ((LouvainConfig(use_ell_kernel=True, ell_widths=widths),
                     ops.louvain_fused),
                    (LouvainConfig(scan_backend="ell", ell_widths=widths),
                     ops.louvain_scan)):
        before = fn.wide_launches
        got = louvain(g, cfg)
        np.testing.assert_array_equal(got.membership, want.membership)
        assert fn.wide_launches > before


def _rmat_state(g, seed):
    """A mid-sweep state of graph ``g`` on its device: half the vertices in
    communities of n/3 ids, Sigma and sizes consistent, a random
    frontier."""
    from repro_torch.core.graph import segment_sum
    from repro_torch.core.modularity import community_weights
    rng = np.random.default_rng(seed)
    n, n_cap, dev = g.n_valid, g.n_cap, g.device
    comm = np.arange(n_cap + 1, dtype=np.int32)
    joined = rng.random(n) < 0.5
    comm[:n][joined] = rng.integers(0, n // 3, int(joined.sum()))
    comm = torch.from_numpy(comm).to(dev)
    valid = torch.arange(n_cap + 1, device=dev) < n
    sizes = segment_sum(valid.to(torch.int32), comm, n_cap + 1)
    front = torch.from_numpy(rng.random(n_cap + 1) < 0.8).to(dev) & valid
    return dict(comm=comm, sigma=community_weights(g, comm), sizes=sizes,
                k=g.vertex_weights(), front=front)


@pytest.mark.parametrize("width", [2048, 4096])
def test_k1_k2_cta_rows_equal_plain_on_rmat_hubs(cuda, width):
    """An R-MAT graph (scale 14, rows up to degree 3,582): the bucket
    (256, width] of ``ell_widths=(16, 64, 256, width)``, every row of it
    one block, bit-equal to the plain versions in the first round's
    singleton state and in a mid-sweep state."""
    from repro_torch import rmat_graph
    from repro_torch.core.graph import ell_bucket_rows
    g = rmat_graph(14, 16, seed=0, device=cuda)
    rows, _ = ell_bucket_rows(g, (16, 64, 256, width))
    wide = rows[3]
    deg = g.indptr[1:] - g.indptr[:-1]
    assert int(deg[wide[wide < g.n_cap].long()].max()) > 1024
    m = g.total_weight()
    csr = (g.indptr, g.indices, g.weights)
    valid = torch.arange(g.n_cap + 1, device=cuda) < g.n_valid
    singles = dict(comm=torch.arange(g.n_cap + 1, dtype=torch.int32,
                                     device=cuda),
                   sigma=g.vertex_weights(), sizes=valid.to(torch.int32),
                   k=g.vertex_weights(), front=valid)
    for st in (singles, _rmat_state(g, width)):
        got = _k1_k2(wide, csr, st, m, width, 3, 2, g.n_cap, False)
        want = _k1_k2(wide, csr, st, m, width, 3, 2, g.n_cap, True)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert bool(got[4].any())


@pytest.mark.parametrize("total", [0, 1, 2047, 2048, 2049, 4095, 4096, 4097,
                                   100000])
def test_k3_equal_plain_on_the_card(cuda, total):
    rng = np.random.default_rng(total)
    n_ids = 300
    keys = np.sort(rng.integers(0, n_ids * n_ids, total))
    ci = (keys // n_ids).astype(np.int32)
    cj = (keys % n_ids).astype(np.int32)
    tail = total // 9                       # trailing sentinel padding
    if tail:
        ci[-tail:] = n_ids
        cj[-tail:] = n_ids
    w = rng.integers(1, 5, total).astype(np.float32)
    args = [torch.from_numpy(x).to(cuda) for x in (ci, cj, w)]
    before = coarsen.coarsen_groups.launches
    got = coarsen.coarsen_groups(*args, sent=n_ids)
    want = coarsen.coarsen_groups_ref(*args, sent=n_ids)
    torch.cuda.synchronize()
    assert coarsen.coarsen_groups.launches == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


#: Slots per tile of the one-pass K3/K4 kernels.
TILE = coarsen.CHUNK_SLOTS


def _k3_slots(rng, total, n_ids, long_group=0, integer_w=True, dead=0):
    """A (ci, cj)-sorted slot list of ``total`` slots: random keys over
    ``n_ids`` x ``n_ids``, one key repeated ``long_group`` times and
    ``dead`` trailing sentinel slots."""
    live = total - dead
    keys = np.sort(rng.integers(0, n_ids * n_ids, live - long_group))
    mid = keys[len(keys) // 2] if len(keys) else 7
    keys = np.sort(np.concatenate([keys, np.full(long_group, mid)]))
    return _k3_from_keys(rng, keys, n_ids, integer_w, dead)


def _k3_from_keys(rng, keys, n_ids, integer_w=True, dead=0):
    ci = np.concatenate([keys // n_ids, np.full(dead, n_ids)]).astype(np.int32)
    cj = np.concatenate([keys % n_ids, np.full(dead, n_ids)]).astype(np.int32)
    total = len(ci)
    if integer_w:
        w = rng.integers(1, 5, total).astype(np.float32)
    else:
        w = (rng.random(total) + 0.05).astype(np.float32)
    return ci, cj, w


def _boundary_keys(rng, total, boundary, n_ids):
    """Sorted keys below n_ids^2 whose group changes exactly at slot
    ``boundary``: the ``TILE`` + 5 slots before it hold one key (a group
    across a tile that ends on the boundary), the slots from it on hold
    larger keys."""
    half = n_ids * n_ids // 2
    left = np.sort(rng.integers(0, half - 1, boundary))
    left[-min(boundary, TILE + 5):] = half - 1
    right = np.sort(rng.integers(half, 2 * half, total - boundary))
    return np.concatenate([left, right])


def _k3_check(cuda, ci, cj, w, sent, integer_w, calls=10):
    """K3 on the card against its plain version: keys, flags and positions
    exact, weight sums exact on integer weights and otherwise within both
    the stated m * 2^-23 * sum |w| and the tighter sqrt(m) * 2^-23 * sum |w|
    (``_k3_bounds``); ``calls`` launches give bit-identical outputs."""
    args = [torch.from_numpy(x).to(cuda) for x in (ci, cj, w)]
    before = coarsen.coarsen_groups.launches
    got = coarsen.coarsen_groups(*args, sent=sent)
    want = coarsen.coarsen_groups_ref(*args, sent=sent)
    torch.cuda.synchronize()
    assert coarsen.coarsen_groups.launches == before + 1
    for a, b in zip(got[:4], want[:4]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    if integer_w:
        assert torch.equal(got[4], want[4])
    else:
        err = (got[4].double() - want[4].double()).abs().cpu().numpy()
        stated, tight = k3_tolerances(ci, cj, w)
        assert (err <= stated).all() and (err <= tight).all()
    for _ in range(calls - 1):
        again = coarsen.coarsen_groups(*args, sent=sent)
        for a, b in zip(again, got):
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    return got


@pytest.mark.parametrize("integer_w", [True, False])
@pytest.mark.parametrize("total,long_group", [
    (70000 + 5000, 70000), (1000003 + 5000, 1000003), (1000003, 1000003),
    (TILE + 1, 0), (300001, 0)])
def test_k3_long_groups_and_float_weights_on_the_card(cuda, total,
                                                       long_group, integer_w):
    """One key over 70,000 and over 1,000,003 slots (a group across
    hundreds of tiles, once the whole list), integer and float weights;
    float sums within the stated and the tight tolerance; 10 calls
    bit-identical."""
    rng = np.random.default_rng(total + long_group)
    ci, cj, w = _k3_slots(rng, total, 300, long_group, integer_w,
                          dead=min(total - long_group, 1000))
    _k3_check(cuda, ci, cj, w, 300, integer_w)


@pytest.mark.parametrize("boundary", [TILE, 2 * TILE, 3 * TILE - 1])
def test_k3_group_ending_on_a_tile_boundary_on_the_card(cuda, boundary):
    rng = np.random.default_rng(boundary)
    keys = _boundary_keys(rng, 4 * TILE + 17, boundary, 40)
    ci, cj, w = _k3_from_keys(rng, keys, 40)
    got = _k3_check(cuda, ci, cj, w, 40, True, calls=3)
    assert bool(got[0][boundary]) and int(got[4][boundary]) >= TILE + 5


@pytest.mark.parametrize("integer_w", [True, False])
def test_k3_offset_views_on_the_card(cuda, integer_w):
    """Inputs that are views with an offset (``x[1:]``, not 16-byte
    aligned) take the kernel's scalar loads and give the same records."""
    rng = np.random.default_rng(5)
    ci, cj, w = _k3_slots(rng, 3 * TILE + 101, 300, long_group=5000,
                          integer_w=integer_w, dead=50)
    args = [torch.from_numpy(np.concatenate([x[:1], x])).to(cuda)[1:]
            for x in (ci, cj, w)]
    assert all(a.is_contiguous() and a.data_ptr() % 16 for a in args)
    got = coarsen.coarsen_groups(*args, sent=300)
    want = _k3_check(cuda, ci, cj, w, 300, integer_w, calls=1)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def test_louvain_on_the_card_reproduces_sbm_goldens(cuda):
    gold = np.load(GOLDEN)
    g, _ = sbm_graph(8, 16, 0.4, 0.01, seed=2, device=cuda)
    for cfg, key in ((LouvainConfig(), "single__sbm"),
                     (LouvainConfig(use_ell_kernel=True), "ell__sbm"),
                     (LouvainConfig(scan_backend="ell"), "ell__sbm")):
        before = coarsen.coarsen_groups.launches
        res = louvain(g, cfg)
        np.testing.assert_array_equal(res.membership, gold[key])
        assert coarsen.coarsen_groups.launches > before


def test_louvain_leiden_on_the_card_reproduces_sbm_goldens(cuda):
    """``single_leiden__sbm`` (sort-reduce scan + K3), ``ell_leiden__sbm``
    through K1 and through K2, and ``dynamic_leiden__sbm_stream`` with K4
    on every batch."""
    gold = np.load(GOLDEN)
    g, _ = sbm_graph(8, 16, 0.4, 0.01, seed=2, device=cuda)
    for cfg, key, fn in (
            (LouvainConfig(refine="leiden"), "single_leiden__sbm",
             coarsen.coarsen_groups),
            (LouvainConfig(refine="leiden", use_ell_kernel=True),
             "ell_leiden__sbm", ops.louvain_fused),
            (LouvainConfig(refine="leiden", scan_backend="ell"),
             "ell_leiden__sbm", ops.louvain_scan)):
        before = fn.launches
        res = louvain(g, cfg)
        np.testing.assert_array_equal(res.membership, gold[key])
        assert fn.launches > before
        assert all(p.refine_iterations and p.n_refined for p in res.passes)
    init, batches = sbm_edge_stream(device=cuda)
    before = resolve.resolve_groups.launches
    res = louvain_dynamic(init, batches,
                          config=LouvainConfig(refine="leiden"))
    np.testing.assert_array_equal(res.membership,
                                  gold["dynamic_leiden__sbm_stream"])
    assert resolve.resolve_groups.launches == before + len(batches)


def test_wide_ell_widths_on_the_card_equal_the_cpu(cuda):
    """``ell_widths=(16, 64, 256, 2048)``: the card's K1 and K2 routes
    (the hub row in a one-row block) give the CPU's membership."""
    widths = (16, 64, 256, 2048)
    s, d, w, n = hub_graph_slots()
    want = louvain(build_csr(s, d, w, n, symmetrize=True, device="cpu"),
                   LouvainConfig(use_ell_kernel=True, ell_widths=widths))
    g = build_csr(s, d, w, n, symmetrize=True, device=cuda)
    for cfg, fn in ((LouvainConfig(use_ell_kernel=True, ell_widths=widths),
                     ops.louvain_fused),
                    (LouvainConfig(scan_backend="ell", ell_widths=widths),
                     ops.louvain_scan)):
        before = fn.cta_launches
        got = louvain(g, cfg)
        np.testing.assert_array_equal(got.membership, want.membership)
        assert fn.cta_launches > before


def test_wrappers_reject_bad_inputs_on_the_card(cuda):
    rng = np.random.default_rng(0)
    csr, st, deg, m = _random_csr(rng, 500, 64, True, cuda)
    n_cap = st["comm"].numel() - 1
    rows = _bucket(rng, deg, n_cap, 0, 64, cuda)
    args = [st["comm"], st["sigma"], st["k"]]
    with pytest.raises(ValueError):
        ops.louvain_scan(rows, csr[0], csr[1], csr[2].double(), *args, m,
                         width=64)
    with pytest.raises(ValueError):
        ops.louvain_scan(rows, *csr, *args, m.cpu(), width=64)
    with pytest.raises(ValueError):
        ops.louvain_scan(rows, *csr, st["comm"].cpu(), *args[1:], m,
                         width=64)
    with pytest.raises(ValueError, match="width 16"):
        ops.louvain_scan(rows, *csr, *args, m, width=16)
    with pytest.raises(ValueError, match="width 16"):
        ops.louvain_fused(rows, *csr, st["comm"], st["sigma"], st["sizes"],
                          st["k"], st["front"], m, 0, width=16,
                          gate_fraction=2, sentinel=n_cap)
    with pytest.raises(ValueError):
        ops.louvain_fused(rows, *csr, st["comm"], st["sigma"],
                          st["sizes"].long(), st["k"], st["front"], m, 0,
                          width=64, gate_fraction=2, sentinel=n_cap)
    with pytest.raises(ValueError, match="outside"):
        ops.louvain_scan(rows + n_cap + 1, *csr, *args, m, width=64)
    x = torch.zeros(10, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        coarsen.coarsen_groups(x, x, x.float()[::2], sent=1)


def _resolve_slots(rng, total, n_ids, dead, long_group):
    """A (src, dst)-sorted batch-apply slot list of ``total`` slots: per key
    an optional existing slot then batch slots, one key repeated
    ``long_group`` times (a group across chunk boundaries), ``dead``
    trailing sentinel slots, float weights with deletes."""
    live = total - dead
    keys = np.sort(rng.integers(0, n_ids * n_ids, max(live - long_group, 0)))
    keys = np.sort(np.concatenate([keys, np.full(min(long_group, live),
                                                 keys[len(keys) // 2]
                                                 if len(keys) else 7)]))
    first = np.ones(live, bool)
    first[1:] = keys[1:] != keys[:-1]
    batch = ~first | (rng.random(live) < 0.3)
    w = np.where(rng.random(live) < 0.25, 0.0,
                 rng.choice([0.25, 3.0, 1.0, 0.7], live)).astype(np.float32)
    src = np.concatenate([keys // n_ids, np.full(dead, n_ids)])
    dst = np.concatenate([keys % n_ids, np.full(dead, n_ids)])
    w = np.concatenate([w, np.zeros(dead, np.float32)])
    batch = np.concatenate([batch, rng.random(dead) < 0.5])
    return (src.astype(np.int32), dst.astype(np.int32), w, batch)


@pytest.mark.parametrize("dead", [0, 1000])
@pytest.mark.parametrize("total", [0, 1, 2047, 2048, 2049, 4095, 4096, 4097,
                                   6000, 300001])
def test_k4_equal_plain_on_the_card(cuda, total, dead):
    rng = np.random.default_rng(total + dead)
    args = _resolve_slots(rng, total, 300, min(dead, total),
                          long_group=min(total // 2, 5000))
    t = [torch.from_numpy(x).to(cuda) for x in args]
    before = resolve.resolve_groups.launches
    got = resolve.resolve_groups(*t, sent=300)
    want = resolve.resolve_groups_ref(*t, sent=300)
    torch.cuda.synchronize()
    assert resolve.resolve_groups.launches == before + 1
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _k4_check(cuda, args, sent, calls=10, views=False):
    """K4 on the card bit for bit against its plain version and across
    ``calls`` launches; with ``views`` the inputs are ``x[1:]`` views (not
    16-byte aligned)."""
    if views:
        t = [torch.from_numpy(np.concatenate([x[:1], x])).to(cuda)[1:]
             for x in args]
        assert all(a.is_contiguous() and a.data_ptr() % 16 for a in t)
    else:
        t = [torch.from_numpy(x).to(cuda) for x in args]
    before = resolve.resolve_groups.launches
    got = resolve.resolve_groups(*t, sent=sent)
    want = resolve.resolve_groups_ref(*t, sent=sent)
    torch.cuda.synchronize()
    assert resolve.resolve_groups.launches == before + 1
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    for _ in range(calls - 1):
        for a, b in zip(resolve.resolve_groups(*t, sent=sent), got):
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    return got


@pytest.mark.parametrize("views", [False, True])
@pytest.mark.parametrize("total,long_group", [
    (70000 + 5000, 70000), (1000003 + 5000, 1000003), (1000003, 1000003),
    (3 * TILE + 101, 5000)])
def test_k4_long_groups_and_views_on_the_card(cuda, total, long_group, views):
    """One key over 70,000 and over 1,000,003 slots (a group across
    hundreds of tiles), aligned inputs and ``x[1:]`` views; bit for bit and
    across 10 calls."""
    rng = np.random.default_rng(total + long_group)
    args = _resolve_slots(rng, total, 300, min(total - long_group, 1000),
                          long_group)
    _k4_check(cuda, args, 300, views=views)


@pytest.mark.parametrize("boundary", [TILE, 2 * TILE, 3 * TILE - 1])
def test_k4_group_ending_on_a_tile_boundary_on_the_card(cuda, boundary):
    rng = np.random.default_rng(boundary)
    keys = _boundary_keys(rng, 4 * TILE + 17, boundary, 40)
    first = np.ones(len(keys), bool)
    first[1:] = keys[1:] != keys[:-1]
    batch = ~first | (rng.random(len(keys)) < 0.3)
    w = np.where(rng.random(len(keys)) < 0.25, 0.0,
                 rng.choice([0.25, 3.0, 1.0, 0.7], len(keys)))
    args = ((keys // 40).astype(np.int32), (keys % 40).astype(np.int32),
            w.astype(np.float32), batch)
    got = _k4_check(cuda, args, 40, calls=3)
    assert int(got[2][boundary]) * 40 + int(got[3][boundary]) == keys[
        boundary - 1] != keys[boundary]


def test_apply_kernel_equals_sort_on_the_card(cuda):
    """A stream of insert, delete and reweight batches (endpoints past
    n_valid too) applied by K4 and by the sort chain: equal graphs and
    touched masks, K4 launched once per kernel apply."""
    rng = np.random.default_rng(4)
    n = 3000
    us = rng.integers(0, n, 20000)
    ud = rng.integers(0, n, 20000)
    g = build_csr(us, ud, rng.uniform(0.25, 4.0, 20000).astype(np.float32),
                  n, n_cap=n + 16, e_cap=60000, symmetrize=True, device=cuda)
    g_k = g_s = g
    for _ in range(4):
        pick = rng.integers(0, g_k.e_valid, 300)
        bsrc = np.concatenate([rng.integers(0, n + 16, 1500),
                               g_k.src[pick].cpu().numpy()])
        bdst = np.concatenate([rng.integers(0, n + 16, 1500),
                               g_k.indices[pick].cpu().numpy()])
        bw = np.where(rng.random(1800) < 0.3, 0.0,
                      rng.choice([0.25, 3.0, 1.5], 1800))
        batch = make_edge_batch(bsrc, bdst, bw, g.n_cap, b_cap=2048,
                                device=cuda)
        before = resolve.resolve_groups.launches
        g_k, t_k = apply_edge_batch(g_k, batch)
        assert resolve.resolve_groups.launches == before + 1
        g_s, t_s = apply_edge_batch(g_s, batch, backend="sort")
        assert resolve.resolve_groups.launches == before + 1
        for name in ("indptr", "indices", "weights", "src"):
            assert torch.equal(getattr(g_k, name), getattr(g_s, name)), name
        assert (g_k.n_valid, g_k.e_valid) == (g_s.n_valid, g_s.e_valid)
        assert torch.equal(t_k, t_s)
    assert g_k.n_valid > n


def test_louvain_dynamic_on_the_card_reproduces_sbm_stream_golden(cuda):
    gold = np.load(GOLDEN)
    for scan_backend in ("full", "compact", "auto"):
        init, batches = sbm_edge_stream(device=cuda)
        before = resolve.resolve_groups.launches
        res = louvain_dynamic(init, batches,
                              config=LouvainConfig(scan_backend=scan_backend))
        np.testing.assert_array_equal(res.membership,
                                      gold["dynamic__sbm_stream"])
        assert resolve.resolve_groups.launches == before + len(batches)


# -- batched multi-stream serving: K3/K4 once per fleet operation -----------

def _sbm_fleet(dev):
    """The reference fleet of the multi-stream tests (``sbm_holdout_stream``
    seeds 10-13, n_cap 128, e_cap 1400, 4 steps of b_cap 8)."""
    cases = [sbm_holdout_stream(seed, n_cap=128, e_cap=1400, n_hold=32,
                                n_steps=4, b_cap=8, device=dev)
             for seed in (10, 11, 12, 13)]
    return [c[0] for c in cases], [c[1] for c in cases]


def test_fleet_k4_k3_launch_once_and_equal_plain_on_the_card(cuda):
    """The fleet apply launches K4 once for all four streams and the fleet
    aggregation K3 once; on the fleet's flat, stream-keyed slot lists both
    equal their plain versions bit for bit, and each stream's result equals
    its own apply / aggregation."""
    graphs, streams = _sbm_fleet(cuda)
    fleet = stack_graphs(graphs)
    sent = fleet.sentinel
    for step in range(len(streams[0])):
        batch = stack_batches([s[step] for s in streams])
        slots = sorted_fleet_slots(fleet, batch)
        got = resolve.resolve_groups(*slots, sent=sent)
        want = resolve.resolve_groups_ref(*slots, sent=sent)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
        before = resolve.resolve_groups.launches
        fleet2, touched, e_new, _ = apply_fleet_batch(fleet, batch)
        assert resolve.resolve_groups.launches == before + 1
        for s in range(len(graphs)):
            want_g, want_t = apply_edge_batch(
                fleet.stream(s), streams[s][step], backend="sort")
            got_g = fleet2.stream(s)
            for name in ("indptr", "indices", "weights", "src"):
                assert torch.equal(getattr(got_g, name),
                                   getattr(want_g, name)), (step, s, name)
            assert torch.equal(touched[s], want_t)
        fleet = fleet2
    first = louvain_batched(fleet, LouvainConfig(max_passes=1)).membership
    comm = torch.cat([first, torch.full((fleet.n_streams, 1), fleet.n_cap,
                                        dtype=torch.int32, device=cuda)], 1)
    s_ci, s_cj, s_w = sorted_fleet_aggregate_slots(fleet, comm)
    got = coarsen.coarsen_groups(s_ci, s_cj, s_w, sent=sent)
    want = coarsen.coarsen_groups_ref(s_ci, s_cj, s_w, sent=sent)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    n_comms = [int(c.max()) + 1 for c in first]
    before = coarsen.coarsen_groups.launches
    coarse = aggregate_fleet(fleet, comm, n_comms, backend="kernel")
    assert coarsen.coarsen_groups.launches == before + 1
    sort = aggregate_fleet(fleet, comm, n_comms, backend="sort")
    for name in ("indptr", "indices", "weights", "src"):
        assert torch.equal(getattr(coarse, name), getattr(sort, name)), name
    np.testing.assert_array_equal(coarse.e_valid, sort.e_valid)


@pytest.mark.parametrize("refine", ["none", "leiden"])
def test_fleet_equals_solo_drivers_on_the_card(cuda, refine):
    graphs, streams = _sbm_fleet(cuda)
    cfg = LouvainConfig(refine=refine)
    before = coarsen.coarsen_groups.launches
    res = louvain_batched(stack_graphs(graphs), cfg)
    assert coarsen.coarsen_groups.launches == before + res.n_passes - 1
    for s, g in enumerate(graphs):
        np.testing.assert_array_equal(
            res.membership[s, :g.n_valid].cpu().numpy(),
            louvain(g, cfg).membership)
    before = resolve.resolve_groups.launches
    dyn = louvain_dynamic_batched(graphs, streams, config=cfg)
    assert resolve.resolve_groups.launches == before + len(streams[0])
    for s, g in enumerate(graphs):
        solo = louvain_dynamic(g, streams[s], config=cfg)
        np.testing.assert_array_equal(dyn.stream_membership(s),
                                      solo.membership)
        got = dyn.graphs.stream(s)
        for name in ("indptr", "indices", "weights", "src"):
            assert torch.equal(getattr(got, name),
                               getattr(solo.graph, name)), (s, name)
        assert list(dyn.frontier_sizes[:, s]) == [
            b.frontier_size for b in solo.batch_stats]


def test_fleet_regrow_on_the_card(cuda):
    """A two-stream fleet without room for a batch of new edges regrows,
    replays the step and equals the fleet provisioned amply up front."""
    full, _ = sbm_graph(4, 8, 0.5, 0.05, seed=1, device=cuda)
    e = full.e_valid
    tight = build_csr(full.src[:e], full.indices[:e], full.weights[:e],
                      full.n_valid, e_cap=e + 2, device=cuda)
    batch = make_edge_batch([0, 1, 2, 3], [17, 18, 19, 20], [1.0] * 4,
                            tight.n_cap, b_cap=4, device=cuda)
    prevs = [louvain(tight).membership] * 2
    with pytest.raises(FleetCapacityOverflow, match="overflows capacity"):
        louvain_dynamic_batched([tight, tight], [[batch], [batch]],
                                prevs=prevs, grow_capacity=False)
    grown = louvain_dynamic_batched([tight, tight], [[batch], [batch]],
                                    prevs=prevs)
    assert grown.n_regrows >= 1
    ample = build_csr(full.src[:e], full.indices[:e], full.weights[:e],
                      full.n_valid, e_cap=grown.graphs.e_cap, device=cuda)
    ref = louvain_dynamic_batched([ample, ample], [[batch], [batch]],
                                  prevs=prevs)
    assert ref.n_regrows == 0
    np.testing.assert_array_equal(grown.membership, ref.membership)
    for s in range(2):
        for name in ("indptr", "indices", "weights", "src"):
            assert torch.equal(getattr(grown.graphs.stream(s), name),
                               getattr(ref.graphs.stream(s), name))


# ---------------------------------------------------------------------------
# The sharded driver on the card.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def nccl_group(cuda, tmp_path_factory):
    """One NCCL rank on the card (world size 1): its collectives run
    through NCCL."""
    store = tmp_path_factory.mktemp("nccl") / "store"
    group = ShardGroup.init("nccl", 0, 1, f"file://{store}", device=cuda)
    yield group
    group.destroy()


def test_nccl_refuses_more_ranks_than_cards(cuda):
    """NCCL runs one rank per GPU: a second rank on the one card is refused
    before the group forms (gloo is the caller's choice for that)."""
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match="one rank per GPU"):
        ShardGroup.init("nccl", 0, n + 1, "file:///nonexistent", device=cuda)


@pytest.mark.parametrize("state_layout", ["replicated", "hybrid"])
@pytest.mark.parametrize("refine", ["none", "leiden"])
@pytest.mark.parametrize("comm_backend", ["gather", "delta"])
def test_sharded_sbm_goldens_through_nccl(nccl_group, cuda, refine,
                                          comm_backend, state_layout):
    gold = np.load(GOLDEN)
    g, _ = sbm_graph(8, 16, 0.4, 0.01, seed=2, device=cuda)
    before = coarsen.coarsen_groups.launches
    mem, _, stats = distributed_louvain(g, nccl_group, refine=refine,
                                        comm_backend=comm_backend,
                                        state_layout=state_layout)
    key = f"sharded{'_leiden' if refine == 'leiden' else ''}__sbm"
    np.testing.assert_array_equal(mem, gold[key])
    assert coarsen.coarsen_groups.launches - before == 2 * (len(stats) - 1)
    assert nccl_group.collectives > 0


def test_sharded_aggregation_k3_equals_plain_on_the_card(nccl_group, cuda):
    """R-MAT scale 14 at world size 1: the sharded driver gives the card's
    ``louvain()`` membership with K3 launched twice per aggregation, and
    both launches of its first aggregation (the local partial reduce, the
    owner-side re-reduce) equal the plain version bit for bit."""
    from repro_torch import rmat_graph
    from repro_torch.core import distributed as dist_mod
    g = rmat_graph(14, 16, seed=3, device=cuda)
    res = louvain(g)
    before = coarsen.coarsen_groups.launches
    mem, _, stats = distributed_louvain(g, nccl_group)
    np.testing.assert_array_equal(mem, res.membership)
    assert coarsen.coarsen_groups.launches - before == 2 * (len(stats) - 1)
    n, e = g.n_valid, g.e_valid
    comm = torch.full((n + 1,), n, dtype=torch.int32, device=cuda)
    comm[:n] = torch.from_numpy(res.levels[0].astype(np.int32)).to(cuda)
    local = dist_mod.sorted_relabelled_slots(g.src[:e], g.indices[:e],
                                             g.weights[:e], comm, n)
    partial = dist_mod.reduce_sorted_slots(*local, n, e)
    owner = dist_mod.owner_sorted_slots(*partial[:3], 0, n, n)
    for slots in (local, owner):
        got = coarsen.coarsen_groups(*slots, sent=n)
        want = coarsen.coarsen_groups_ref(*slots, sent=n)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_staged_gloo_ranks_on_one_card_equal_world_size_one(nccl_group,
                                                            cuda):
    """Two gloo ranks on the one card, their collectives staged through
    pinned host memory, under gather and delta: the world-size-1
    membership, with staged bytes counted."""
    from repro_torch import rmat_graph
    from repro_torch.core import collectives
    from repro_torch.core import distributed as dist_mod
    g = rmat_graph(12, 16, seed=4, device=cuda)
    want = distributed_louvain(g, nccl_group)[0]
    graphs = {"g": {k: getattr(g, k).cpu().numpy()
                    for k in ("indptr", "indices", "weights", "src")}}
    graphs["g"].update(n_valid=g.n_valid, e_valid=g.e_valid)
    out = collectives.launch(dist_mod.rank_runs, 2, graphs,
                             [("g", {"comm_backend": "gather"}),
                              ("g", {"comm_backend": "delta"})],
                             backend="gloo", devices=["cuda"] * 2,
                             timeout=300)
    for o in out:
        assert o["staged_bytes"] > 0
        for mem, _, _ in o["results"]:
            np.testing.assert_array_equal(mem, want)


@pytest.mark.parametrize("state_layout", ["replicated", "hybrid"])
@pytest.mark.parametrize("refine", ["none", "leiden"])
def test_sharded_stream_goldens_through_nccl(nccl_group, cuda, refine,
                                             state_layout):
    """``louvain_dynamic_sharded`` on the card reproduces both
    ``sharded_dynamic*`` goldens, K4 launched once per batch."""
    gold = np.load(GOLDEN)
    init, batches = sbm_edge_stream(device=cuda)
    before = resolve.resolve_groups.launches
    res = louvain_dynamic_sharded(
        init, nccl_group, batches,
        config=LouvainConfig(refine=refine, state_layout=state_layout))
    key = (f"sharded_dynamic{'_leiden' if refine == 'leiden' else ''}"
           "__sbm_stream")
    np.testing.assert_array_equal(res.membership, gold[key])
    assert resolve.resolve_groups.launches - before == len(batches)


@pytest.mark.parametrize("dead", [False, True])
def test_per_rank_k4_equals_plain_on_the_card(cuda, dead):
    """Each rank of a 4-rank layout of an R-MAT graph at scale 14 resolves a
    batch of inserts, deletions and reweights (endpoints past n_cap too,
    with ``dead``): K4 on the rank's sorted slot list equals the plain
    version bit for bit, and the rank's apply through K4 equals the sort
    chain's."""
    from repro_torch import rmat_graph
    from repro_torch.core import distributed as dist_mod
    from repro_torch.core import distributed_dynamic as dd
    g = rmat_graph(14, 16, seed=5, device=cuda)
    *glob, spec = dist_mod.partition_graph_host(g, 4, n_target=g.n_cap,
                                                e_per_shard=g.e_valid // 2)
    rng = np.random.default_rng(6)
    e = g.e_valid
    pick = rng.integers(0, e, 1000)
    hi = g.n_cap + (8 if dead else 0)
    bsrc = np.concatenate([rng.integers(0, hi, 3000),
                           g.src[pick].cpu().numpy()])
    bdst = np.concatenate([rng.integers(0, hi, 3000),
                           g.indices[pick].cpu().numpy()])
    bw = np.where(rng.random(4000) < 0.3, 0.0,
                  rng.choice([0.25, 3.0, 1.5], 4000)).astype(np.float32)
    batch = make_edge_batch(np.minimum(bsrc, g.n_cap),
                            np.minimum(bdst, g.n_cap), bw, g.n_cap,
                            b_cap=4096, device=cuda)
    for rank in range(4):
        sl = dist_mod.rank_slice(*glob, spec, rank, cuda)
        args = (*sl, batch.src, batch.dst, batch.weight, batch.b_valid)
        slots = dd.sorted_shard_batch_slots(spec, rank, *args,
                                            n_limit=g.n_cap)
        got = resolve.resolve_groups(*slots, sent=spec.sentinel)
        want = resolve.resolve_groups_ref(*slots, sent=spec.sentinel)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        before = resolve.resolve_groups.launches
        k = dd.apply_batch_shard(spec, rank, *args, n_limit=g.n_cap,
                                 backend="kernel")
        assert resolve.resolve_groups.launches == before + 1
        srt = dd.apply_batch_shard(spec, rank, *args, n_limit=g.n_cap,
                                   backend="sort")
        for a, b in zip(k, srt):
            assert torch.equal(a, b)


def test_staged_gloo_ranks_hybrid_and_stream_equal_world_size_one(
        nccl_group, cuda):
    """Two gloo ranks on the one card: the hybrid layout under both
    exchanges, and ``louvain_dynamic_sharded`` on the golden stream, equal
    world size 1."""
    from repro_torch import rmat_graph
    from repro_torch.core import collectives
    from repro_torch.core import distributed as dist_mod
    gold = np.load(GOLDEN)
    g = rmat_graph(12, 16, seed=4, device=cuda)
    want = distributed_louvain(g, nccl_group)[0]
    init, batches = sbm_edge_stream(device=cuda)

    def arrays(x):
        out = {k: getattr(x, k).cpu().numpy()
               for k in ("indptr", "indices", "weights", "src")}
        out.update(n_valid=x.n_valid, e_valid=x.e_valid)
        return out

    bl = [{"src": b.src.cpu().numpy(), "dst": b.dst.cpu().numpy(),
           "weight": b.weight.cpu().numpy(), "b_valid": b.b_valid}
          for b in batches]
    out = collectives.launch(
        dist_mod.rank_runs, 2, {"g": arrays(g), "stream": arrays(init)},
        [("g", {"comm_backend": "gather", "state_layout": "hybrid"}),
         ("g", {"comm_backend": "delta", "state_layout": "hybrid"}),
         ("stream", {"batches": bl})],
        backend="gloo", devices=["cuda"] * 2, timeout=300)
    for o in out:
        assert o["staged_bytes"] > 0
        for mem, _, _ in o["results"][:2]:
            np.testing.assert_array_equal(mem, want)
        np.testing.assert_array_equal(o["results"][2].membership,
                                      gold["sharded_dynamic__sbm_stream"])


# ---------------------------------------------------------------------------
# The multi-tenant sharded serving fleet on the card.
# ---------------------------------------------------------------------------

def _ring_whale(dev, n=64, n_batches=8, k=12):
    """A sparse ring whose envelope is tight and dense insert batches that
    blow through it (the reference's ``tests/test_fleet.py`` whale)."""
    s = np.arange(n, dtype=np.int64)
    d = (s + 1) % n
    g = build_csr(np.concatenate([s, d]), np.concatenate([d, s]),
                  np.ones(2 * n, np.float32), n, e_cap=2 * n + 4 * k,
                  device=dev)
    rng = np.random.default_rng(7)
    batches = []
    for _ in range(n_batches):
        bs = rng.integers(0, n, k)
        bd = (bs + 2 + rng.integers(0, n - 3, k)) % n
        batches.append(make_edge_batch(bs, bd, np.ones(k, np.float32),
                                       g.n_cap, b_cap=k, device=dev))
    return g, batches


@pytest.mark.parametrize("state_layout", ["replicated", "hybrid"])
@pytest.mark.parametrize("n_tenants", [1, 2])
def test_fleet_sbm_goldens_through_nccl(nccl_group, cuda, n_tenants,
                                        state_layout):
    """One tenant and two in one bucket reach ``sharded_dynamic__sbm_stream``
    through NCCL, K4 launched once per bucket dispatch."""
    from repro_torch import serve_fleet
    gold = np.load(GOLDEN)
    init, batches = sbm_edge_stream(device=cuda)
    tids = "ab"[:n_tenants]
    before = resolve.resolve_groups.launches
    res = serve_fleet({t: init for t in tids}, {t: batches for t in tids},
                      nccl_group, screening="community",
                      config=LouvainConfig(state_layout=state_layout))
    for t in tids:
        np.testing.assert_array_equal(res.membership[t],
                                      gold["sharded_dynamic__sbm_stream"])
    assert resolve.resolve_groups.launches - before == res.n_dispatches == 8
    assert (res.halo_bytes > 0) == (state_layout == "hybrid")


def test_fleet_whale_and_fallback_equal_solo_on_the_card(nccl_group, cuda):
    """The whale migrates and its buddy sails through; a fallback
    configuration replays lanes through the solo pass loop (K3 in its
    aggregations): every tenant equals its ``louvain_dynamic_sharded``."""
    from repro_torch import FleetRouter, serve_fleet
    whale = _ring_whale(cuda)
    buddy_g, buddy_b, _ = sbm_holdout_stream(39, n_cap=128, e_cap=1400,
                                             n_hold=24, n_steps=8, b_cap=8,
                                             device=cuda)
    cases = {"whale": whale, "buddy": (buddy_g, buddy_b)}
    res = serve_fleet({t: c[0] for t, c in cases.items()},
                      {t: c[1] for t, c in cases.items()}, nccl_group,
                      screening="community")
    assert res.n_migrations >= 1
    for t, (g, b) in cases.items():
        solo = louvain_dynamic_sharded(g, nccl_group, b,
                                       screening="community")
        np.testing.assert_array_equal(res.membership[t], solo.membership)
    cfg = LouvainConfig(aggregation_tolerance=1.0, initial_tolerance=0.0)
    router = FleetRouter(nccl_group, cfg, screening="community")
    streams = {}
    for tid, seed in (("a", 36), ("b", 37)):
        g, b, _ = sbm_holdout_stream(seed, n_cap=128, e_cap=1400, n_hold=24,
                                     n_steps=3, b_cap=8, device=cuda)
        router.admit(tid, g, prev=np.arange(g.n_cap, dtype=np.int32),
                     b_cap=8)
        streams[tid] = (g, b)
    k3 = coarsen.coarsen_groups.launches
    res = router.serve({t: s[1] for t, s in streams.items()})
    assert res.n_fallbacks > 0 and coarsen.coarsen_groups.launches > k3
    for tid, (g, b) in streams.items():
        solo = louvain_dynamic_sharded(
            g, nccl_group, b, prev=np.arange(g.n_cap, dtype=np.int32),
            config=cfg, screening="community")
        np.testing.assert_array_equal(res.membership[tid], solo.membership)


def test_fleet_bucket_k4_equals_plain_on_the_card(cuda):
    """A 3-lane bucket of R-MAT tenants on each of 4 ranks: K4 on the
    flat, lane-keyed sorted slot list equals the plain version bit for bit,
    and the lane-batched apply through K4 equals the sort chain's."""
    from repro_torch import rmat_graph
    from repro_torch.core import distributed as dist_mod
    from repro_torch.core import distributed_dynamic as dd
    rng = np.random.default_rng(8)
    graphs = [rmat_graph(12, 16, seed=s, device=cuda) for s in (9, 10, 11)]
    parts = [dist_mod.partition_graph_host(g, 4, n_target=g.n_cap)
             for g in graphs]
    spec = parts[0][3]._replace(e_per_shard=max(
        p[3].e_per_shard for p in parts) + 4096)
    glob = [dist_mod.bucket_slots_host(s[s < p.sentinel], d[s < p.sentinel],
                                       w[s < p.sentinel], spec)
            for s, d, w, p in parts]
    lanes = dist_mod.LaneLayout(spec, 3)
    n_cap = graphs[0].n_cap
    bs = torch.from_numpy(rng.integers(0, n_cap, (3, 2048))).to(
        cuda, torch.int32)
    bd = torch.from_numpy(rng.integers(0, n_cap, (3, 2048))).to(
        cuda, torch.int32)
    bw = torch.from_numpy(np.where(rng.random((3, 2048)) < 0.3, 0.0,
                                   1.5).astype(np.float32)).to(cuda)
    for rank in range(4):
        alone = [dist_mod.rank_slice(*glob[i], spec, rank, cuda)
                 for i in range(3)]
        flat = lanes.flat_slots(alone)
        args = (*flat, bs, bd, bw, [2048, 1000, 0], [n_cap] * 3)
        slots = dd.sorted_shard_batch_slots(spec, rank, *args)
        sent = lanes.flat.sentinel
        got = resolve.resolve_groups(*slots, sent=sent)
        want = resolve.resolve_groups_ref(*slots, sent=sent)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        before = resolve.resolve_groups.launches
        k = dd.apply_batch_shard(spec, rank, *args, backend="kernel")
        assert resolve.resolve_groups.launches == before + 1
        srt = dd.apply_batch_shard(spec, rank, *args, backend="sort")
        for a, b in zip(k, srt):
            assert torch.equal(a, b)
