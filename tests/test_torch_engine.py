"""The PyTorch port's move engine, sort-reduce scanner, ELL scanners and
backend policy against the JAX package, on the CPU.

The Weyl gate must agree on extreme int32 ids and round indices (the
reference wraps in int32); the move decision, the best-move scan and whole
local-moving phases must agree element for element on integer-weighted
graphs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import louvain_arch as jarch
from repro.core import engine as jengine
from repro.core.graph import build_csr as jbuild_csr
from repro.core.local_move import best_moves as jbest_moves
from repro.core.louvain import _move_phase as jmove_phase
from repro.data import rmat_graph as jrmat

from repro_torch.configs import louvain_arch as tarch
from repro_torch.core import engine as tengine
from repro_torch.core.ell_move import (ELLScanner, FusedELLScanner,
                                       move_phase_ell)
from repro_torch.core.graph import build_csr, ell_bucket_rows
from repro_torch.core.local_move import best_moves, move_phase
from repro_torch.core.louvain import singleton_init
from repro_torch.data import rmat_graph as trmat

I32_MIN, I32_MAX = -2 ** 31, 2 ** 31 - 1
EXTREME_IDS = np.array([0, 1, 2, 8191, 8192, I32_MAX, I32_MAX - 1, I32_MIN,
                        I32_MIN + 1, -1, -8192, 123456789, -987654321],
                       np.int32)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_gate_constants():
    assert tengine.GATE_MUL == int(jengine.GATE_MUL)
    assert tengine.GATE_INC == int(jengine.GATE_INC)


@pytest.mark.parametrize("round_ix", [0, 1, 7, 40503, I32_MAX, I32_MIN,
                                      -1, 2 ** 30 + 3])
def test_gate_hash_and_round_gate_wrap_like_int32(round_ix):
    rng = np.random.default_rng(abs(round_ix) % 97)
    ids = np.concatenate([EXTREME_IDS, rng.integers(I32_MIN, I32_MAX, 300,
                                                    dtype=np.int64)
                          .astype(np.int32)])
    want = np.asarray(jengine.gate_hash(jnp.asarray(ids),
                                        jnp.int32(round_ix)))
    got = tengine.gate_hash(torch.from_numpy(ids), round_ix)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    for gf in (1, 2, 3, 4, 7):
        np.testing.assert_array_equal(
            tengine.round_gate(torch.from_numpy(ids), round_ix, gf).numpy(),
            np.asarray(jengine.round_gate(jnp.asarray(ids),
                                          jnp.int32(round_ix), gf)))


@pytest.mark.parametrize("with_masks", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gated_move_mask_matches_reference(seed, with_masks):
    rng = np.random.default_rng(seed)
    n, sent = 200, 200
    comm = rng.integers(0, 30, n + 1).astype(np.int32)
    best_c = rng.integers(0, 31, n + 1).astype(np.int32)
    best_c[rng.random(n + 1) < 0.1] = sent
    best_dq = rng.normal(0, 1, n + 1).astype(np.float32)
    best_dq[rng.random(n + 1) < 0.1] = -np.inf
    sizes = rng.integers(0, 3, sent + 1).astype(np.int32)
    frontier = rng.random(n + 1) < 0.7
    move_valid = rng.random(n + 1) < 0.9 if with_masks else None
    gate = rng.random(n + 1) < 0.5 if with_masks else None
    conv_t = lambda x: None if x is None else torch.from_numpy(x)
    conv_j = lambda x: None if x is None else jnp.asarray(x)
    args = (best_c, best_dq, comm, sizes, frontier)
    want = jengine.gated_move_mask(*map(conv_j, args), sent,
                                   conv_j(move_valid), conv_j(gate))
    got = tengine.gated_move_mask(*map(conv_t, args), sent,
                                  conv_t(move_valid), conv_t(gate))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _state(rng, n_cap, n_valid, k):
    comm = np.full(n_cap + 1, n_cap, np.int32)
    comm[:n_valid] = rng.integers(0, n_valid, n_valid)
    sigma = np.zeros(n_cap + 1, np.float32)
    np.add.at(sigma, comm[:n_cap], k[:n_cap])
    frontier = (rng.random(n_cap + 1) < 0.8) & (np.arange(n_cap + 1)
                                                < n_valid)
    return comm, sigma, frontier


@pytest.mark.parametrize("seed", [0, 3])
def test_best_moves_matches_reference(seed):
    jg = jrmat(7, 8, seed=seed)
    tg = trmat(7, 8, seed=seed, device="cpu")
    k = tg.vertex_weights()
    comm, sigma, frontier = _state(np.random.default_rng(seed), tg.n_cap,
                                   tg.n_valid, k.numpy())
    jc, jdq = jbest_moves(jg, jnp.asarray(comm), jnp.asarray(sigma),
                          jg.vertex_weights(), jnp.asarray(frontier),
                          jg.total_weight())
    tc, tdq = best_moves(tg, torch.from_numpy(comm), torch.from_numpy(sigma),
                         k, torch.from_numpy(frontier), tg.total_weight())
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tdq.numpy(), np.asarray(jdq))


@pytest.mark.parametrize("gate_fraction,use_pruning", [(1, True), (2, True),
                                                       (3, False)])
def test_move_phase_matches_reference(gate_fraction, use_pruning):
    jg = jrmat(8, 8, seed=5)
    tg = trmat(8, 8, seed=5, device="cpu")
    n_cap = tg.n_cap
    comm0 = np.arange(n_cap + 1, dtype=np.int32)
    frontier0 = np.arange(n_cap + 1) < tg.n_valid
    kw = dict(max_iterations=20, use_pruning=use_pruning,
              gate_fraction=gate_fraction)
    jc, jit, jdq = jmove_phase(jg, jnp.asarray(comm0), jg.vertex_weights(),
                               jnp.asarray(frontier0), jnp.float32(0.01),
                               **kw)
    tc, tit, tdq = move_phase(tg, torch.from_numpy(comm0),
                              tg.vertex_weights(), torch.from_numpy(frontier0),
                              0.01, **kw)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert tit == int(jit)
    assert float(tdq) == pytest.approx(float(jdq), rel=1e-5)
    # The ELL scanners run the same sweep (narrow widths force hub rows
    # onto the sort-reduce fallback).
    for fused in (False, True):
        ec, eit, _ = move_phase_ell(tg, *singleton_init(tg), 0.01,
                                    widths=(4, 8), fused=fused, **kw)
        np.testing.assert_array_equal(ec.numpy(), tc.numpy())
        assert eit == tit


def test_fused_decision_equals_scan_plus_gated_mask_with_hub_rows():
    """``FusedELLScanner.decide_moves`` (K1 per block + the hub fallback)
    must equal ``ELLScanner.scan`` + the engine's ``gated_move_mask``."""
    rng = np.random.default_rng(4)
    tg = trmat(8, 8, seed=2, device="cpu")
    n_cap = tg.n_cap
    rows, leftover = ell_bucket_rows(tg, (4, 16))
    buckets = list(zip((4, 16), rows))
    assert leftover.numel() > 0
    k, m = tg.vertex_weights(), tg.total_weight()
    comm, sigma, frontier = _state(rng, n_cap, tg.n_valid, k.numpy())
    comm, sigma, frontier = map(torch.from_numpy, (comm, sigma, frontier))
    fused = FusedELLScanner(tg, buckets, leftover, k, m, gate_fraction=2)
    plain = ELLScanner(tg, buckets, leftover, k, m)
    sizes = tengine.segment_sum(fused.count_ones(comm), comm, n_cap + 1)
    for round_ix in (0, 1, 5):
        mv, bc, bdq = fused.decide_moves(comm, sigma, frontier, comm, sizes,
                                         round_ix)
        sc, sdq = plain.scan(comm, sigma, frontier)
        gate = tengine.round_gate(plain.local_ids, round_ix, 2)
        want = tengine.gated_move_mask(sc, sdq, comm, sizes, frontier, n_cap,
                                       plain.move_valid, gate)
        np.testing.assert_array_equal(mv.numpy(), want.numpy())
        assert mv.any()
        live = mv.numpy()
        np.testing.assert_array_equal(bc.numpy()[live], sc.numpy()[live])
        np.testing.assert_array_equal(bdq.numpy()[live], sdq.numpy()[live])


def test_backend_policy_matches_reference():
    for backend in tarch.SCAN_BACKENDS:
        for ell in (False, True):
            for frac in (None, 0.05, 0.5):
                try:
                    want = jarch.resolve_scan_backend(
                        backend, use_ell_kernel=ell, frontier_frac=frac)
                except ValueError:
                    with pytest.raises(ValueError):
                        tarch.resolve_scan_backend(
                            backend, use_ell_kernel=ell, frontier_frac=frac)
                    continue
                assert tarch.resolve_scan_backend(
                    backend, use_ell_kernel=ell, frontier_frac=frac) == want
    for n_comms, e_valid, n_cap, e_cap in [(10, 30, 1024, 8192),
                                           (500, 4000, 1024, 8192),
                                           (1, 0, 64, 256),
                                           (3000, 100000, 4096, 131072)]:
        assert tarch.resolve_coarse_capacity(n_comms, e_valid, n_cap,
                                             e_cap) == \
            jarch.resolve_coarse_capacity(n_comms, e_valid, n_cap, e_cap)
    for name in ("LADDER_MIN_N_CAP", "LADDER_MIN_E_CAP", "LADDER_SLACK",
                 "LADDER_HYSTERESIS", "COMPACT_WORK_FRAC",
                 "AUTO_COMPACT_MAX_FRONTIER_FRAC"):
        assert getattr(tarch, name) == getattr(jarch, name)
    assert tarch.resolve_agg_backend("auto", torch.device("cpu")) == "sort"
    assert tarch.resolve_agg_backend("auto", torch.device("cuda")) == "kernel"
    assert tarch.resolve_agg_backend("kernel", torch.device("cpu")) == "kernel"
    with pytest.raises(ValueError):
        tarch.resolve_agg_backend("pallas", torch.device("cpu"))
