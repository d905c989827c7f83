"""The batch apply of the PyTorch port against the JAX package, on the CPU.

The plain version of K4 (``resolve_groups_ref``) is held against the TPU
kernel in Pallas interpret mode (``resolve_groups_pallas``) over the first
total + 1 records, with small blocks so the carry crosses tiles, groups
longer than a tile (one over many of the CUDA kernel's 4096-slot tiles),
lists with no dead slot and float weights; the Pallas
tail past total + 1 must hold no keep and no change.  The port's
``apply_edge_batch`` (``"sort"`` and ``"kernel"``, the latter through the
plain version of K4 on the CPU) is held against the JAX ``apply_edge_batch``
(``"xla"`` and ``"pallas"``) on every graph array, the touched mask,
``n_valid`` and ``e_valid``.  Weights are selected, never summed, so every
comparison is exact, float weights included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.delta import (_apply_edge_batch as j_apply_core,
                              apply_edge_batch as japply,
                              make_edge_batch as jbatch,
                              sort_reduce_apply_slots as jsort_reduce)
from repro.core.graph import build_csr as jbuild_csr
from repro.kernels.batch_apply import resolve_groups_pallas

from repro_torch.core.delta import (apply_edge_batch, make_edge_batch,
                                    sort_reduce_apply_slots,
                                    sorted_batch_slots)
from repro_torch.interop import edge_batch_from_numpy, graph_from_numpy
from repro_torch.kernels.batch_apply.resolve import (resolve_groups,
                                                     resolve_groups_ref)

SENT = 40
BACKENDS = [("sort", "xla"), ("kernel", "pallas")]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# K4's plain version against the Pallas kernel.
# ---------------------------------------------------------------------------

def sorted_slot_list(seed: int, n_groups: int, dead: int, long_group: int,
                     integer_w: bool):
    """A (src, dst)-sorted slot list as the apply builds it: per group an
    optional existing slot, then its batch slots; ``long_group`` batch slots
    on one key; ``dead`` trailing (SENT, SENT) slots."""
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.choice(SENT * SENT, n_groups, replace=False))
    src, dst, w, b = [], [], [], []
    for i, key in enumerate(keys):
        n_exist = int(rng.random() < 0.7)
        n_batch = long_group if i == n_groups // 2 else int(rng.integers(0, 3))
        n_batch = max(n_batch, 1 - n_exist)
        for j in range(n_exist + n_batch):
            src.append(key // SENT)
            dst.append(key % SENT)
            b.append(j >= n_exist)
            if rng.random() < 0.25:
                w.append(0.0)                       # a delete
            elif integer_w:
                w.append(float(rng.integers(1, 4)))
            else:
                w.append(float(rng.choice([0.25, 3.0, rng.random() + 0.1])))
    src += [SENT] * dead
    dst += [SENT] * dead
    w += [0.0] * dead
    b += list(rng.random(dead) < 0.5)
    return (np.array(src, np.int32), np.array(dst, np.int32),
            np.array(w, np.float32), np.array(b, bool))


@pytest.mark.parametrize("case", [
    dict(n_groups=300, dead=40, long_group=0, block=128, integer_w=True),
    dict(n_groups=200, dead=0, long_group=0, block=128, integer_w=False),
    dict(n_groups=60, dead=3, long_group=300, block=128, integer_w=False),
    dict(n_groups=500, dead=200, long_group=5, block=512, integer_w=False),
    dict(n_groups=1, dead=0, long_group=0, block=128, integer_w=True),
    dict(n_groups=0, dead=130, long_group=0, block=128, integer_w=True),
    dict(n_groups=400, dead=50, long_group=5 * 4096 + 3, block=512,
         integer_w=False),
    dict(n_groups=3, dead=0, long_group=3 * 4096 + 1, block=4096,
         integer_w=True),
], ids=["multi-tile", "no-dead-slots", "group-longer-than-a-tile",
        "default-block", "one-group", "all-dead",
        "group-spans-kernel-tiles", "group-spans-kernel-tiles-big-blocks"])
def test_resolve_ref_equals_pallas_interpret(case):
    block = case.pop("block")
    src, dst, w, b = sorted_slot_list(7 + block, **case)
    total = len(src)
    want = resolve_groups_pallas(jnp.asarray(src), jnp.asarray(dst),
                                 jnp.asarray(w), jnp.asarray(b), sent=SENT,
                                 block=block, interpret=True)
    want = [np.asarray(x) for x in want]
    t = [torch.from_numpy(x) for x in (src, dst, w, b)]
    got = resolve_groups_ref(*t, sent=SENT)
    names = ["keep", "pos", "src", "dst", "w", "changed"]
    for name, a, x in zip(names, got, want):
        assert a.shape == (total + 1,), name
        np.testing.assert_array_equal(a.numpy(), x[: total + 1],
                                      err_msg=name)
    np.testing.assert_array_equal(got[4].numpy().view(np.int32),
                                  want[4][: total + 1].view(np.int32))
    # The Pallas padding past total + 1 finalises nothing.
    assert not want[0][total + 1:].any() and not want[5][total + 1:].any()
    # On CPU tensors the wrapper is the plain version and counts nothing.
    before = resolve_groups.launches
    for a, x in zip(resolve_groups(*t, sent=SENT), got):
        assert torch.equal(a, x)
    assert resolve_groups.launches == before


# ---------------------------------------------------------------------------
# apply_edge_batch against the JAX package.
# ---------------------------------------------------------------------------

def random_graph(rng, n=32, e_und=80, e_slack=64, self_loops=True):
    us = rng.integers(0, n, e_und)
    ud = rng.integers(0, n, e_und)
    if not self_loops:
        ud = np.where(us == ud, (ud + 1) % n, ud)
    w = rng.uniform(0.25, 4.0, e_und).astype(np.float32)
    off = us != ud
    src = np.concatenate([us, ud[off]])
    dst = np.concatenate([ud, us[off]])
    ww = np.concatenate([w, w[off]])
    jg = jbuild_csr(src, dst, ww, n, n_cap=n + 8, e_cap=len(src) + e_slack)
    return jg, to_port(jg)


def to_port(jg):
    return graph_from_numpy(np.asarray(jg.indptr), np.asarray(jg.indices),
                            np.asarray(jg.weights), np.asarray(jg.src),
                            int(jg.n_valid), int(jg.e_valid), device="cpu")


def both_batches(src, dst, w, n_cap, b_cap):
    jb = jbatch(src, dst, w, n_cap, b_cap=b_cap)
    tb = make_edge_batch(src, dst, w, n_cap, b_cap=b_cap, device="cpu")
    return jb, tb


def assert_same_graph(tg, jg):
    for name in ("indptr", "indices", "weights", "src"):
        a = getattr(tg, name).numpy()
        b = np.asarray(getattr(jg, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32),
                                      err_msg=name)
    assert tg.n_valid == int(jg.n_valid)
    assert tg.e_valid == int(jg.e_valid)


def random_batch(rng, n_cap, bs, b_cap, n_hi=None):
    n_hi = n_hi or n_cap
    bsrc = rng.integers(0, n_hi, bs)
    bdst = rng.integers(0, n_hi, bs)
    bw = np.where(rng.random(bs) < 0.3, 0.0,
                  rng.uniform(0.25, 4.0, bs)).astype(np.float32)
    return bsrc, bdst, bw


def test_make_edge_batch_matches_reference():
    jb, tb = both_batches([1, 2, 3], [4, 5, 3], [1.0, 0.0, 2.5], 9, 6)
    for name in ("src", "dst", "weight"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)))
    assert tb.b_valid == int(jb.b_valid) and tb.b_cap == jb.b_cap
    eb = edge_batch_from_numpy(jb.src, jb.dst, jb.weight, jb.b_valid,
                               device="cpu")
    assert torch.equal(eb.src, tb.src) and eb.b_valid == tb.b_valid
    with pytest.raises(ValueError, match="below batch size"):
        make_edge_batch([1, 2], [3, 4], [1.0, 1.0], 9, b_cap=1, device="cpu")


@pytest.mark.parametrize("backends", BACKENDS, ids=["sort", "kernel"])
@pytest.mark.parametrize("seed", range(6))
def test_random_stream_equals_reference(seed, backends):
    """Insert, delete and reweight batches (endpoints past n_valid too)."""
    tb_name, jb_name = backends
    rng = np.random.default_rng(seed)
    jg, tg = random_graph(rng, self_loops=bool(seed % 2))
    for _ in range(3):
        e = int(jg.e_valid)
        bs = int(rng.integers(1, 12))
        bsrc, bdst, bw = random_batch(rng, jg.n_cap, bs, 16,
                                      n_hi=jg.n_cap + 1)
        # Reweight and delete existing edges as well.
        pick = rng.integers(0, e, 3)
        bsrc = np.concatenate([bsrc, np.asarray(jg.src)[pick]])
        bdst = np.concatenate([bdst, np.asarray(jg.indices)[pick]])
        bw = np.concatenate([bw, np.float32([0.0, 3.0, 0.25])])
        jb, tb = both_batches(bsrc, bdst, bw, jg.n_cap, 16)
        jg2, jt, je = j_apply_core(jg, jb, backend=jb_name)
        tg2, tt = apply_edge_batch(tg, tb, backend=tb_name)
        assert_same_graph(tg2, jg2)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        jg, tg = jg2, tg2


@pytest.mark.parametrize("backend", ["sort", "kernel"])
def test_reverse_duplicate_batch_stays_symmetric(backend):
    """[(1, 2, 3), (2, 1, 5)]: the later entry wins in BOTH directions."""
    rng = np.random.default_rng(0)
    jg, tg = random_graph(rng, n=8, e_und=6)
    jb, tb = both_batches([1, 2], [2, 1], [3.0, 5.0], jg.n_cap, 4)
    jg2, jt = japply(jg, jb)
    tg2, tt = apply_edge_batch(tg, tb, backend=backend)
    assert_same_graph(tg2, jg2)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    e = tg2.e_valid
    s, d, w = tg2.src[:e], tg2.indices[:e], tg2.weights[:e]
    assert float(w[(s == 1) & (d == 2)]) == 5.0
    assert float(w[(s == 2) & (d == 1)]) == 5.0


def reference_layout_slots(n_cap, entries):
    """The reference's unified slot list for an empty graph: every forward
    batch slot, then every reverse one (rank 1 + i % b_cap)."""
    u = np.array([e[0] for e in entries], np.int32)
    v = np.array([e[1] for e in entries], np.int32)
    w = np.array([e[2] for e in entries], np.float32)
    b = len(entries)
    src = np.concatenate([u, v])
    dst = np.concatenate([v, u])
    rank = 1 + np.arange(2 * b, dtype=np.int32) % b
    return src, dst, np.concatenate([w, w]), rank, np.ones(2 * b, bool)


@pytest.mark.parametrize("backend", ["sort", "kernel"])
def test_sort_reduce_on_the_reference_layout(backend):
    """Ranks out of list order (the reference's forward-then-reverse layout)
    take the two-sort path and resolve as the reference does.  A stable
    sort of that layout on the key alone would resolve (2, 1) to the
    EARLIER weight and keep (3, 0) after its deletion — the asymmetry the
    port's interleaved layout avoids."""
    entries = [(1, 2, 3.0), (2, 1, 5.0), (0, 3, 1.0), (3, 0, 0.0)]
    src, dst, w, rank, isb = reference_layout_slots(8, entries)
    want = jsort_reduce(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w),
                        jnp.asarray(rank), jnp.asarray(isb), 8, 8, "xla")
    t = [torch.from_numpy(x) for x in (src, dst, w, rank, isb)]
    got = sort_reduce_apply_slots(*t, 8, 8, backend)
    for a, x in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(x))
    assert int(got[3]) == int(want[3]) == 2
    key = src.astype(np.int64) * 9 + dst
    order = np.argsort(key, kind="stable")
    last_wins = dict(zip(zip(src[order], dst[order]), w[order]))
    assert {k: v for k, v in last_wins.items() if v > 0} == {
        (1, 2): 5.0, (2, 1): 3.0, (3, 0): 1.0}


@pytest.mark.parametrize("backends", BACKENDS, ids=["sort", "kernel"])
def test_self_loops_deletes_and_reweights(backends):
    tb_name, jb_name = backends
    rng = np.random.default_rng(7)
    jg, tg = random_graph(rng, n=16, e_und=30, self_loops=True)
    e = int(jg.e_valid)
    src = np.asarray(jg.src)[:e]
    dst = np.asarray(jg.indices)[:e]
    bsrc = np.concatenate([src[:3], src[3:6], [1, 2], [5, 5]])
    bdst = np.concatenate([dst[:3], dst[3:6], [9, 10], [5, 5]])
    bw = np.concatenate([np.zeros(3), [9.0, 8.0, 7.0], [1.5, 2.5],
                         [3.0, 0.25]]).astype(np.float32)
    jb, tb = both_batches(bsrc, bdst, bw, jg.n_cap, 12)
    jg2, jt, _ = j_apply_core(jg, jb, backend=jb_name)
    tg2, tt = apply_edge_batch(tg, tb, backend=tb_name)
    assert_same_graph(tg2, jg2)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert not tt[tg2.n_cap]


@pytest.mark.parametrize("backend", ["sort", "kernel"])
def test_overflow_raises_and_grow_rebuckets(backend):
    rng = np.random.default_rng(3)
    jg, tg = random_graph(rng, n=24, e_und=30, e_slack=2)
    bsrc, bdst, _ = random_batch(rng, 24, 20, 24)
    bdst = np.where(bsrc == bdst, (bdst + 1) % 24, bdst)
    bw = np.ones(20, np.float32)
    jb, tb = both_batches(bsrc, bdst, bw, jg.n_cap, 24)
    with pytest.raises(ValueError, match="overflows capacity"):
        japply(jg, jb)
    with pytest.raises(ValueError, match="overflows capacity"):
        apply_edge_batch(tg, tb, backend=backend)
    jg2, jt = japply(jg, jb, grow=True)
    tg2, tt = apply_edge_batch(tg, tb, grow=True, backend=backend)
    assert tg2.e_cap == jg2.e_cap > tg.e_cap
    assert tg2.n_cap == tg.n_cap
    assert_same_graph(tg2, jg2)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_sorted_batch_slots_feed_the_resolve():
    """``sorted_batch_slots`` is the list K4 resolves (a one-stream
    fleet's, dead slots at its flat sentinel n_cap + 1): its records
    compact into the same graph the apply returns."""
    rng = np.random.default_rng(5)
    _, tg = random_graph(rng)
    bsrc, bdst, bw = random_batch(rng, tg.n_cap, 10, 16)
    tb = make_edge_batch(bsrc, bdst, bw, tg.n_cap, b_cap=16, device="cpu")
    s_src, s_dst, s_w, s_batch = sorted_batch_slots(tg, tb)
    assert s_src.shape == (tg.e_cap + 32,)
    keep, pos, f_src, f_dst, f_w, _ = resolve_groups_ref(
        s_src, s_dst, s_w, s_batch, sent=tg.n_cap + 1)
    g2, _ = apply_edge_batch(tg, tb, backend="sort")
    e = g2.e_valid
    assert int(keep.sum()) == e
    assert torch.equal(pos[keep], torch.arange(e, dtype=torch.int32))
    assert torch.equal(f_src[keep], g2.src[:e])
    assert torch.equal(f_dst[keep], g2.indices[:e])
    assert torch.equal(f_w[keep], g2.weights[:e])
