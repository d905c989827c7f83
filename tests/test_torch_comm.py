"""The port's ``core/comm.py`` against ``repro.core.comm`` on the same numpy
inputs: bit packing (the lanes bit for bit, read as uint32), mover
compaction, touched-community compaction, the boundary mask, and the byte
pricing over a grid; plus the properties of ``tests/test_comm_delta.py``
and ``tests/test_comm_halo.py`` on the port's functions."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
try:
    from hypothesis import given, settings, strategies as st
except ImportError:         # optional dev dep: tests/_hypothesis_fallback
    from _hypothesis_fallback import given, settings, st

from repro.configs import louvain_arch as jarch
from repro.core import comm as jcomm
from repro.core.distributed import (ShardedGraphSpec as JSpec,
                                    measure_boundary_frac as jmeasure,
                                    sharded_comm_plan as jsharded_plan)

from repro_torch.configs import louvain_arch as tarch
from repro_torch.core import comm as tcomm
from repro_torch.core.distributed import (ShardedGraphSpec,
                                          measure_boundary_frac,
                                          sharded_comm_plan)

SETTINGS = settings(deadline=None, max_examples=30)


def t(x, dtype=None):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=dtype))


def lanes_u32(x) -> np.ndarray:
    """The reference's uint32 lanes, or the port's int32 bit patterns, as
    uint32."""
    if isinstance(x, torch.Tensor):
        assert x.dtype == torch.int32
        return x.numpy().view(np.uint32)
    return np.asarray(x).astype(np.uint32)


# -- widths and lanes ---------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 2, 3, 4, 5, 255, 256, 257, 2 ** 31])
def test_label_bits_and_lanes_equal_reference(n):
    assert tcomm.label_bits(n) == jcomm.label_bits(n)
    for width in (1, 7, 32):
        assert (tcomm.packed_lanes(n % 1000, width)
                == jcomm.packed_lanes(n % 1000, width))
    assert tcomm.size_delta_width(n % 5000) == jcomm.size_delta_width(
        n % 5000)


# -- bit packing --------------------------------------------------------------

@pytest.mark.parametrize("width", [1, 3, 4, 7, 13, 17, 31, 32])
@pytest.mark.parametrize("count", [0, 1, 5, 37, 64, 100])
def test_pack_bits_equals_reference_bit_for_bit(width, count):
    rng = np.random.default_rng(width * 1000 + count)
    vals = rng.integers(0, 2 ** width, count, dtype=np.int64)
    if width == 32:
        vals = vals.astype(np.uint32).view(np.int32)
    else:
        vals = vals.astype(np.int32)
    want = jcomm.pack_bits(jnp.asarray(vals), width)
    got = tcomm.pack_bits(t(vals), width)
    np.testing.assert_array_equal(lanes_u32(got), lanes_u32(want))
    back = tcomm.unpack_bits(got, width, count)
    jback = jcomm.unpack_bits(want, width, count)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jback))
    np.testing.assert_array_equal(back.numpy(), vals)


@given(st.integers(1, 32), st.lists(st.integers(0, 2 ** 32 - 1),
                                    max_size=80))
@SETTINGS
def test_pack_unpack_random_equal_reference(width, raw):
    vals = (np.asarray(raw, np.uint64) & ((1 << width) - 1)).astype(
        np.uint32).view(np.int32)
    want = jcomm.pack_bits(jnp.asarray(vals), width)
    got = tcomm.pack_bits(t(vals), width)
    np.testing.assert_array_equal(lanes_u32(got), lanes_u32(want))
    np.testing.assert_array_equal(
        tcomm.unpack_bits(got, width, len(vals)).numpy(), vals)


def test_pack_masks_to_width_and_straddles():
    vals = np.array([7, 1, 6, 3, 5, 2, 0, 4, 1, 7, 6], np.int32)
    got = tcomm.pack_bits(t(vals), 3)        # 33 bits: straddles lane 0
    assert got.numel() == 2
    np.testing.assert_array_equal(tcomm.unpack_bits(got, 3, 11).numpy(),
                                  vals)
    over = tcomm.pack_bits(t(np.array([0xFF], np.int32)), 4)
    np.testing.assert_array_equal(tcomm.unpack_bits(over, 4, 1).numpy(),
                                  [0xF])


@pytest.mark.parametrize("width", [0, 33, -1])
def test_pack_bits_rejects_bad_width(width):
    with pytest.raises(ValueError):
        tcomm.pack_bits(t(np.zeros(3, np.int32)), width)
    with pytest.raises(ValueError):
        tcomm.unpack_bits(t(np.zeros(1, np.int32)), width, 3)


# -- mover compaction ----------------------------------------------------------

@given(st.lists(st.booleans(), min_size=1, max_size=120),
       st.integers(1, 40), st.integers(0, 2 ** 20))
@SETTINGS
def test_compact_movers_equals_reference(flags, cap, seed):
    flag = np.asarray(flags)
    vals = np.random.default_rng(seed).integers(
        0, 1 << 20, len(flag)).astype(np.int32)
    want = jcomm.compact_movers(jnp.asarray(flag), jnp.asarray(vals), cap,
                                jnp.int32(-7))
    got = tcomm.compact_movers(t(flag), t(vals), cap, -7)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got[2].dtype == torch.int32 and int(got[2]) == int(flag.sum())


def test_compact_movers_empty_full_and_overflow():
    flag = np.zeros(10, bool)
    idx, val, n = tcomm.compact_movers(t(flag), t(np.arange(10, dtype=np.int32)),
                                       4, -1)
    assert int(n) == 0 and idx.tolist() == [10] * 4 and val.tolist() == [-1] * 4
    flag[:] = True
    idx, val, n = tcomm.compact_movers(t(flag), t(np.arange(10, dtype=np.int32)),
                                       10, -1)
    assert int(n) == 10 and idx.tolist() == list(range(10))
    idx, val, n = tcomm.compact_movers(t(flag), t(np.arange(10, dtype=np.int32)),
                                       3, -1)
    assert int(n) == 10 and idx.tolist() == [0, 1, 2]


# -- touched communities --------------------------------------------------------

@given(st.integers(1, 90), st.integers(1, 30), st.integers(0, 2 ** 20),
       st.floats(0.0, 1.0))
@SETTINGS
def test_topk_touched_deltas_equals_reference(sent, cap, seed, frac):
    rng = np.random.default_rng(seed)
    touched = rng.random(sent + 1) < frac
    delta = (rng.random(sent + 1) - 0.5).astype(np.float32)
    want = jcomm.topk_touched_deltas(jnp.asarray(delta),
                                     jnp.asarray(touched), cap, sent)
    got = tcomm.topk_touched_deltas(t(delta), t(touched), cap, sent)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ids = got[0].numpy()
    live = ids[ids < sent]
    assert np.all(np.diff(live) > 0)            # ascending, deduplicated
    assert int(got[2]) == int(touched[:sent].sum())


def test_topk_touched_ignores_sentinel_slot_and_flags_overflow():
    touched = np.ones(9, bool)
    c, d, n = tcomm.topk_touched_deltas(t(np.ones(9, np.float32)),
                                        t(touched), 3, 8)
    assert int(n) == 8 and c.tolist() == [0, 1, 2]
    c, d, n = tcomm.topk_touched_deltas(t(np.ones(9, np.float32)),
                                        t(np.zeros(9, bool)), 3, 8)
    assert int(n) == 0 and c.tolist() == [8, 8, 8] and d.tolist() == [0] * 3


# -- boundary mask ----------------------------------------------------------------

def _shard_slots(src, dst, s, v_per, sent, e_per):
    """One shard's slots under symmetric placement (the reference test's
    helper): edge (u, v) yields (u, v) on owner(u) and (v, u) on owner(v)."""
    su = np.concatenate([src, dst])
    sv = np.concatenate([dst, src])
    own = su // v_per == s
    sl_s = np.full(e_per, sent, np.int32)
    sl_d = np.full(e_per, sent, np.int32)
    k = int(own.sum())
    sl_s[:k], sl_d[:k] = su[own], sv[own]
    return sl_s, sl_d


@given(st.integers(1, 5), st.integers(1, 20), st.integers(0, 2 ** 20))
@SETTINGS
def test_boundary_mask_equals_reference(S, v_per, seed):
    rng = np.random.default_rng(seed)
    n = S * v_per
    m = int(rng.integers(0, 3 * n + 1))
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    for s in range(S):
        sl_s, sl_d = _shard_slots(src, dst, s, v_per, n, 2 * m + 3)
        want = jcomm.boundary_mask(jnp.asarray(sl_s), jnp.asarray(sl_d),
                                   s * v_per, v_per, n)
        got = tcomm.boundary_mask(t(sl_s), t(sl_d), s * v_per, v_per, n)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_boundary_mask_matches_measured_fraction():
    rng = np.random.default_rng(5)
    S, v_per = 4, 16
    n = S * v_per
    spec = ShardedGraphSpec(S, v_per, 256, n)
    src = rng.integers(0, n, 80).astype(np.int32)
    dst = ((src + 1 + rng.integers(0, n - 1, 80)) % n).astype(np.int32)
    n_bnd = sum(int(tcomm.boundary_mask(
        *map(t, _shard_slots(src, dst, s, v_per, n, 256)), s * v_per, v_per,
        n).sum()) for s in range(S))
    su, sv = np.concatenate([src, dst]), np.concatenate([dst, src])
    got = measure_boundary_frac(su, sv, spec)
    assert got == pytest.approx(n_bnd / np.unique(su).size)
    assert got == jmeasure(jnp.asarray(su), jnp.asarray(sv),
                           JSpec(*spec))


def test_symmetric_placement_freshness_invariant():
    """Any remote dst a shard reads is flagged boundary by its owner."""
    rng = np.random.default_rng(11)
    S, v_per = 4, 16
    n = S * v_per
    src = rng.integers(0, n, 120).astype(np.int32)
    dst = ((src + 1 + rng.integers(0, n - 1, 120)) % n).astype(np.int32)
    masks = [tcomm.boundary_mask(*map(t, _shard_slots(src, dst, s, v_per, n,
                                                      300)),
                                 s * v_per, v_per, n).numpy()
             for s in range(S)]
    for s in range(S):
        sl_s, sl_d = _shard_slots(src, dst, s, v_per, n, 300)
        live = (sl_s < n) & (sl_d < n)
        for d in np.unique(sl_d[live & (sl_d // v_per != s)]):
            assert masks[d // v_per][d - (d // v_per) * v_per]


# -- byte pricing ----------------------------------------------------------------

GRID = list(itertools.product(("gather", "delta"), ("replicated", "hybrid"),
                              (1, 2, 8), (1, 33, 4096), (0, 8, 700)))


@pytest.mark.parametrize("backend,layout,S,v_per,cap", GRID)
def test_comm_plan_and_phase_bytes_equal_reference(backend, layout, S, v_per,
                                                   cap):
    n_pad = S * v_per
    want = jcomm.comm_plan(backend, S, v_per, n_pad, cap,
                           state_layout=layout, touched_cap=2 * cap)
    got = tcomm.comm_plan(backend, S, v_per, n_pad, cap,
                          state_layout=layout, touched_cap=2 * cap)
    assert tuple(got) == tuple(want)
    for rounds, fb, rs in ((0, 0, 0), (7, 3, 0), (4, 9, 120), (12, 0, 36)):
        assert (tcomm.phase_bytes(got, rounds, fb, rs)
                == jcomm.phase_bytes(want, rounds, fb, rs))
    assert (tcomm.reshard_bytes(S * v_per, 3 * cap)
            == jcomm.reshard_bytes(S * v_per, 3 * cap))


@pytest.mark.parametrize("S,v_per,e_per", [(1, 77, 254), (4, 20, 145),
                                           (8, 4096, 9000)])
@pytest.mark.parametrize("backend", ["gather", "delta"])
def test_sharded_comm_plan_and_caps_equal_reference(S, v_per, e_per,
                                                    backend):
    spec = ShardedGraphSpec(S, v_per, e_per, S * v_per)
    assert tuple(sharded_comm_plan(spec, backend)) == tuple(
        jsharded_plan(JSpec(*spec), backend))
    assert tarch.delta_move_cap(v_per) == jarch.delta_move_cap(v_per)
    assert tarch.hybrid_touched_cap(v_per) == jarch.hybrid_touched_cap(v_per)


def test_comm_plan_rejects_unknown_backend_and_layout():
    with pytest.raises(ValueError):
        tcomm.comm_plan("allreduce", 2, 4, 8)
    with pytest.raises(ValueError):
        tcomm.comm_plan("gather", 2, 4, 8, state_layout="sharded")


def test_phase_bytes_clamps_fallbacks_and_adds_resync_once():
    plan = tcomm.comm_plan("delta", 4, 100, 400, 25)
    assert tcomm.phase_bytes(plan, 3, 10) == 3 * plan.fallback_bytes
    hyb = tcomm.comm_plan("delta", 4, 100, 400, 25, state_layout="hybrid",
                          touched_cap=50)
    assert tcomm.phase_bytes(hyb, 0) == 0
    assert (tcomm.phase_bytes(hyb, 2) == 2 * hyb.round_bytes
            + hyb.phase_fixed_bytes)


# -- policies ---------------------------------------------------------------------

@pytest.mark.parametrize("knob", ["auto", "gather", "delta"])
@pytest.mark.parametrize("S", [1, 2, 8])
def test_resolve_comm_backend_equals_reference(knob, S):
    assert (tarch.resolve_comm_backend(knob, S)
            == jarch.resolve_comm_backend(knob, S))


@pytest.mark.parametrize("layout", ["auto", "replicated", "hybrid"])
@pytest.mark.parametrize("S,frac", [(1, None), (1, 0.1), (4, None),
                                    (4, 0.3), (4, 0.5), (4, 0.9)])
def test_resolve_state_layout_equals_reference(layout, S, frac):
    assert (tarch.resolve_state_layout(layout, S, frac)
            == jarch.resolve_state_layout(layout, S, frac))


def test_policy_knobs_reject_unknown_values():
    for fn, bad in ((lambda: tarch.resolve_comm_backend("nccl", 2), 1),
                    (lambda: tarch.resolve_state_layout("sharded", 2), 1),
                    (lambda: tarch.resolve_reshard("always"), 1)):
        with pytest.raises(ValueError):
            fn()
    assert tarch.RESHARD_MODES == jarch.RESHARD_MODES
    assert tarch.STATE_LAYOUTS == jarch.STATE_LAYOUTS
    assert tarch.COMM_BACKENDS == jarch.COMM_BACKENDS
    assert tarch.resolve_reshard("auto") == jarch.resolve_reshard("auto")


# -- lane-batched primitives -------------------------------------------------------

@pytest.mark.parametrize("width", [1, 5, 13, 32])
@pytest.mark.parametrize("rows,count", [(1, 7), (3, 33), (4, 0), (2, 64)])
def test_pack_bits_rows_equal_each_row_alone(width, rows, count):
    """A (rows, count) batch packs and unpacks row by row exactly as each
    row would alone (a sharded fleet's lanes)."""
    rng = np.random.default_rng(width * 100 + rows)
    vals = rng.integers(0, 2 ** min(width, 31), (rows, count)).astype(
        np.int64)
    packed = tcomm.pack_bits(t(vals), width)
    for r in range(rows):
        alone = tcomm.pack_bits(t(vals[r]), width)
        assert torch.equal(packed[r], alone)
    back = tcomm.unpack_bits(packed, width, count)
    np.testing.assert_array_equal(back.numpy().astype(np.int64) & (
        (1 << width) - 1), vals)


@pytest.mark.parametrize("cap", [1, 4, 9])
def test_compact_and_touched_rows_equal_each_row_alone(cap):
    rng = np.random.default_rng(cap)
    flag = rng.random((3, 12)) < 0.4
    vals = rng.integers(0, 50, (3, 12)).astype(np.int32)
    delta = rng.random((3, 12)).astype(np.float32)
    got = tcomm.compact_movers(t(flag), t(vals), cap, -7)
    got_t = tcomm.topk_touched_deltas(t(delta), t(flag), cap, 10)
    for r in range(3):
        want = tcomm.compact_movers(t(flag[r]), t(vals[r]), cap, -7)
        want_t = tcomm.topk_touched_deltas(t(delta[r]), t(flag[r]), cap, 10)
        for a, b in zip(got, want):
            assert torch.equal(a[r], b)
        for a, b in zip(got_t, want_t):
            assert torch.equal(a[r], b)


# -- wire_bytes against comm_bytes ---------------------------------------------------

def expected_wire_bytes(row: dict, n_shards: int) -> int:
    """The bytes a pass row's move and refine phases hand to the
    collectives over all ranks, from the row's priced ``comm_bytes`` (less
    its re-shard cost) and the port's stated excess per rank and round:
    ``4 * (n_pad + 1)`` B in a replicated gather round and in every
    fallback round, ``4 * touched_cap`` B in every hybrid round, and one
    more resync (``4 * v_per``) in a hybrid Leiden pass
    (``distributed.sharded_louvain_passes``)."""
    rep = row["n_pad"] + 1
    v_per = row["n_pad"] // n_shards
    rounds = row["comm_rounds"]
    fb = min(row["comm_fallback_rounds"], rounds)
    hybrid = row["state_layout"] == "hybrid"
    gather = row["comm_backend"] == "gather"
    excess = 4 * rep * (rounds if gather and not hybrid else fb)
    if hybrid:
        tcap = 2 * v_per if gather else tarch.hybrid_touched_cap(v_per)
        excess += 4 * tcap * rounds
        if row["refine_iterations"] is not None:
            excess += 4 * v_per          # the refine phase's own resync
    return row["comm_bytes"] - row["reshard_bytes"] + n_shards * excess


@pytest.mark.parametrize("refine", ["none", "leiden"])
@pytest.mark.parametrize("layout", ["replicated", "hybrid"])
@pytest.mark.parametrize("backend", ["gather", "delta"])
def test_wire_bytes_keep_their_stated_relation_at_world_size_one(
        backend, layout, refine):
    """Each pass row's ``wire_bytes`` is its ``comm_bytes`` plus the
    port's stated excess; hybrid rounds ship exactly 4 * touched_cap B more
    a rank, a delta round exactly its price."""
    from repro_torch import ShardGroup, distributed_louvain, sbm_graph
    g, _ = sbm_graph(8, 16, 0.4, 0.01, seed=2, device="cpu")
    _, _, rows = distributed_louvain(g, ShardGroup.single("cpu"),
                                     comm_backend=backend,
                                     state_layout=layout, refine=refine)
    for row in rows:
        assert row["wire_bytes"] == expected_wire_bytes(row, 1), row
    if backend == "delta" and layout == "replicated":
        assert all(r["wire_bytes"] == r["comm_bytes"] for r in rows
                   if r["comm_fallback_rounds"] == 0)
    if layout == "hybrid" and backend == "delta" and refine == "none":
        row = rows[0]
        hyb = tarch.hybrid_touched_cap(row["n_pad"])
        assert (row["wire_bytes"] - row["comm_bytes"]
                == 4 * hyb * row["comm_rounds"]
                + 4 * (row["n_pad"] + 1) * row["comm_fallback_rounds"])
