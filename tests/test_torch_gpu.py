"""The PyTorch port's CUDA kernels on the card: K1, K2, K3 and K4 against
their plain PyTorch versions on the same CUDA tensors, the batch apply's
kernel backend against its sort backend, and ``louvain()`` and
``louvain_dynamic()`` on the card against the committed sbm goldens.

Every test here is marked ``gpu`` and skips without a card (the decision is
made inside the ``cuda`` fixture, never at import).  The machine with the
card has no JAX, so this file imports torch only and runs without the
repository's conftest:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_gpu.py

Exactness: the kernels repeat their plain versions' arithmetic operation for
operation (row sums in ascending slot order, dQ in the reference's order, no
FMA), so K1 and K2 agree bit for bit on any weights; K3's weight sums
associate differently and agree bit for bit on integer weights; K4 selects
weights and never sums them, so it agrees bit for bit on any weights.
"""

import os

import numpy as np
import pytest
import torch

from repro_torch import (LouvainConfig, apply_edge_batch, build_csr, louvain,
                         louvain_dynamic, make_edge_batch, sbm_edge_stream,
                         sbm_graph)
from repro_torch.kernels.aggregate import coarsen
from repro_torch.kernels.batch_apply import resolve
from repro_torch.kernels.louvain_scan import fused, ops, ref

pytestmark = pytest.mark.gpu
GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "engine_memberships.npz")
SENTINEL = 1 << 20


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _tiles(rng, n_rows, d, integer_w, dev):
    n_ids = max(4, d // 8)
    c = rng.integers(0, n_ids, (n_rows, d)).astype(np.int32)
    dead = rng.random((n_rows, d)) < 0.3
    dead[3] = True
    dead[-8:] = True
    c[dead] = -1
    w = (rng.integers(1, 3, (n_rows, d)).astype(np.float32) if integer_w
         else (rng.random((n_rows, d)) + 0.05).astype(np.float32))
    w[dead] = 0
    sig_tab = rng.integers(1, 4, n_ids).astype(np.float32) * 4
    size_tab = np.where(rng.random(n_ids) < 0.7, 1, 2).astype(np.int32)
    live = c >= 0
    sig = np.where(live, sig_tab[np.maximum(c, 0)], 0).astype(np.float32)
    size = np.where(live, size_tab[np.maximum(c, 0)], 0).astype(np.int32)
    c_own = rng.integers(0, n_ids, (n_rows, 1)).astype(np.int32)
    k_i = rng.integers(1, 6, (n_rows, 1)).astype(np.float32)
    sig_own = (sig_tab[c_own[:, 0]][:, None] + k_i).astype(np.float32)
    size_own = size_tab[c_own[:, 0]][:, None].astype(np.int32)
    rows = rng.integers(-2 ** 31, 2 ** 31 - 1, (n_rows, 1)).astype(np.int32)
    rows[-8:] = SENTINEL
    front = rng.integers(0, 2, (n_rows, 1)).astype(np.int32)
    t = lambda x: torch.from_numpy(x).to(dev)
    scan = [t(x) for x in (c, w, sig, k_i, c_own, sig_own)]
    fused_in = [t(x) for x in (c, w, sig, size, k_i, c_own, sig_own,
                               size_own, rows, front)]
    m = torch.tensor(float(rng.integers(40, 900)), device=dev)
    return scan, fused_in, m


@pytest.mark.parametrize("integer_w", [True, False])
@pytest.mark.parametrize("gate_fraction", [1, 2, 4])
@pytest.mark.parametrize("d", [16, 64, 256, 1024])
def test_k1_k2_equal_plain_on_the_card(cuda, d, gate_fraction, integer_w):
    rng = np.random.default_rng(d + gate_fraction)
    scan, fused_in, m = _tiles(rng, 1000, d, integer_w, cuda)
    n1, n2 = ops.louvain_fused.launches, ops.louvain_scan.launches
    got = ops.louvain_scan(*scan, m)
    want = ref.louvain_scan_ref(*scan, m)
    fgot = ops.louvain_fused(*fused_in, m, 12345, gate_fraction=gate_fraction,
                             sentinel=SENTINEL)
    fwant = fused.louvain_fused_ref(*fused_in, m, 12345,
                                    gate_fraction=gate_fraction,
                                    sentinel=SENTINEL)
    torch.cuda.synchronize()
    assert (ops.louvain_fused.launches, ops.louvain_scan.launches) == (
        n1 + 1, n2 + 1)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for a, b in zip(fgot, fwant):
        assert torch.equal(a, b)


@pytest.mark.parametrize("total", [0, 1, 2047, 2048, 2049, 100000])
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


def test_wrappers_reject_bad_inputs_on_the_card(cuda):
    rng = np.random.default_rng(0)
    scan, _, m = _tiles(rng, 64, 16, True, cuda)
    with pytest.raises(ValueError):
        ops.louvain_scan(scan[0], scan[1].double(), *scan[2:], m)
    with pytest.raises(ValueError):
        ops.louvain_scan(*scan, m.cpu())
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
@pytest.mark.parametrize("total", [0, 1, 2047, 2048, 2049, 6000, 300001])
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
