"""Plain versions of the ELL scan kernels K1 (fused) and K2 (scan only) of
the PyTorch port against the TPU kernels run in Pallas interpret mode
(``louvain_fused_pallas`` / ``louvain_scan_pallas``), on the CPU.

Two levels.  The tile functions (``louvain_scan_ref`` /
``louvain_fused_ref``) take pre-gathered (R, D) tiles made from a seed with
numpy: widths 16, 64 and 256, gate fractions 1, 2 and 4, pad rows (vertex
id = sentinel, all slots dead), dead slots, all-dead rows and singleton
ties.  The row-level plain versions (``louvain_scan_rows_ref`` /
``louvain_fused_rows_ref``), which the kernels on the card must equal, take
a degree bucket's rows and the CSR; they must equal the JAX package's
composition ``to_ell_blocks`` + ``prepare_*_inputs`` + Pallas kernel on the
real buckets of the golden corpora and of small R-MAT graphs with self
loops, for every width, gate fraction 1, 2 and 4 and two rounds.

On integer-valued weights every output is exact.  On random float weights the reference's pairwise sums
associate differently, so ``best_dq`` agrees to 1e-6 relative to the
tile's largest |dQ| (a row's dQ is a difference of terms of that size), and
``best_c``/``do_move`` agree wherever the best community's dQ leads the
next community's by more than 1e-5 (and, for ``do_move``, |dQ| > 1e-5).
The kernels themselves run only on the card (``tests/test_torch_gpu.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden import capture_engine_golden as capture

from repro.core.graph import build_csr as jbuild_csr, to_ell_blocks as jell
from repro.data import rmat_graph as jrmat
from repro.kernels.louvain_scan import ops as jops
from repro.kernels.louvain_scan.fused import louvain_fused_pallas
from repro.kernels.louvain_scan.louvain_scan import louvain_scan_pallas

from repro_torch.core.graph import build_csr, ell_bucket_rows, to_ell_blocks
from repro_torch.interop import graph_from_numpy
from repro_torch.kernels.louvain_scan import louvain_scan as k2, ops, ref
from repro_torch.kernels.louvain_scan.fused import louvain_fused_ref

SENTINEL = 1 << 20
R = 32          # 4 grid steps of 8 rows in interpret mode


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def make_tiles(seed: int, d: int, integer_w: bool):
    rng = np.random.default_rng(seed)
    n_ids = max(4, d // 8)
    c = rng.integers(0, n_ids, (R, d)).astype(np.int32)
    dead = rng.random((R, d)) < 0.3
    dead[3] = True                  # an all-dead row that is not padding
    dead[-4:] = True                # pad rows
    c[dead] = -1
    if integer_w:
        w = rng.integers(1, 3, (R, d)).astype(np.float32)
    else:
        w = (rng.random((R, d)) + 0.05).astype(np.float32)
    w[dead] = 0.0
    # Few distinct Sigma values and mostly singleton sizes: exact dQ ties
    # between communities and the singleton-swap guard both occur.
    sig_tab = rng.integers(1, 4, n_ids).astype(np.float32) * 4
    size_tab = np.where(rng.random(n_ids) < 0.7, 1, 2).astype(np.int32)
    # Row 4 ties communities 0 and 1 exactly: equal weight, equal Sigma.
    sig_tab[1] = sig_tab[0]
    c[4] = -1
    c[4, :8] = [0, 1] * 4
    w[4] = np.where(c[4] >= 0, 1.0, 0.0)
    live = c >= 0
    sig = np.where(live, sig_tab[np.maximum(c, 0)], 0).astype(np.float32)
    size = np.where(live, size_tab[np.maximum(c, 0)], 0).astype(np.int32)
    c_own = rng.integers(0, n_ids, (R, 1)).astype(np.int32)
    c_own[4] = 2
    k_i = rng.integers(1, 6, (R, 1)).astype(np.float32)
    sig_own = (sig_tab[c_own[:, 0]][:, None] + k_i).astype(np.float32)
    size_own = size_tab[c_own[:, 0]][:, None].astype(np.int32)
    rows = rng.integers(-2 ** 31, 2 ** 31 - 1, (R, 1)).astype(np.int32)
    rows[:4, 0] = [0, 2 ** 31 - 1, -2 ** 31, 7]
    rows[-4:] = SENTINEL
    front = rng.integers(0, 2, (R, 1)).astype(np.int32)
    front[:6] = 1
    front[-4:] = 0
    m = np.float32(rng.integers(40, 90))
    return dict(c=c, w=w, sig=sig, size=size, k_i=k_i, c_own=c_own,
                sig_own=sig_own, size_own=size_own, rows=rows, front=front,
                m=m, round_ix=int(rng.integers(0, 1 << 30)))


def _scan_args(t, lib):
    conv = jnp.asarray if lib == "jax" else torch.from_numpy
    return [conv(t[k]) for k in ("c", "w", "sig", "k_i", "c_own", "sig_own")]


def _fused_args(t, lib):
    conv = jnp.asarray if lib == "jax" else torch.from_numpy
    return [conv(t[k]) for k in ("c", "w", "sig", "size", "k_i", "c_own",
                                 "sig_own", "size_own", "rows", "front")]


def _lead(t):
    """Per row: the best community's float64 dQ lead over the next
    community, and the best dQ itself (rows without a candidate: inf, 0)."""
    c, w = t["c"], t["w"].astype(np.float64)
    m = float(t["m"])
    lead = np.full(len(c), np.inf)
    best = np.zeros(len(c))
    for r in range(len(c)):
        own = t["c_own"][r, 0]
        k_own = w[r][c[r] == own].sum()
        per = {}
        for j in np.flatnonzero((c[r] >= 0) & (c[r] != own)):
            k_to = w[r][c[r] == c[r, j]].sum()
            ki = float(t["k_i"][r, 0])
            per[c[r, j]] = ((k_to - k_own) / m - ki * (
                ki + float(t["sig"][r, j]) - float(t["sig_own"][r, 0]))
                / (2 * m * m))
        if per:
            vals = sorted(per.values(), reverse=True)
            best[r] = vals[0]
            lead[r] = vals[0] - vals[1] if len(vals) > 1 else np.inf
    return lead, best


@pytest.mark.parametrize("integer_w", [True, False])
@pytest.mark.parametrize("gate_fraction", [1, 2, 4])
@pytest.mark.parametrize("d", [16, 64, 256])
def test_plain_kernels_match_pallas_interpret(d, gate_fraction, integer_w):
    t = make_tiles(d * 10 + gate_fraction, d, integer_w)
    m_j, m_t = jnp.float32(t["m"]), torch.tensor(t["m"])

    jc, jdq = louvain_scan_pallas(*_scan_args(t, "jax"), m_j, block_rows=8,
                                  interpret=True)
    tc, tdq = ref.louvain_scan_ref(*_scan_args(t, "torch"), m_t)
    fj = louvain_fused_pallas(*_fused_args(t, "jax"), m_j,
                              jnp.int32(t["round_ix"]),
                              gate_fraction=gate_fraction, sentinel=SENTINEL,
                              block_rows=8, interpret=True)
    ft = louvain_fused_ref(*_fused_args(t, "torch"), m_t, t["round_ix"],
                           gate_fraction=gate_fraction, sentinel=SENTINEL)
    jc, jdq = np.asarray(jc)[:, 0], np.asarray(jdq)[:, 0]
    fj = [np.asarray(x)[:, 0] for x in fj]
    ft = [x.numpy() for x in ft]
    # The tiles exercise what they claim to.
    assert (jc == -1).sum() >= 5 and fj[2].any()

    lead, best = _lead(t)
    if integer_w:
        assert (lead == 0).any()        # exact dQ ties between communities
        np.testing.assert_array_equal(tc.numpy(), jc)
        np.testing.assert_array_equal(tdq.numpy(), jdq)
        for a, b in zip(ft, fj):
            np.testing.assert_array_equal(a, b)
        return
    scale = np.abs(jdq[np.isfinite(jdq)]).max()
    np.testing.assert_allclose(tdq.numpy(), jdq, rtol=1e-6, atol=1e-6 * scale)
    np.testing.assert_allclose(ft[1], fj[1], rtol=1e-6, atol=1e-6 * scale)
    clear = lead > 1e-5
    np.testing.assert_array_equal(tc.numpy()[clear], jc[clear])
    np.testing.assert_array_equal(ft[0][clear], fj[0][clear])
    decided = clear & (np.abs(best) > 1e-5)
    np.testing.assert_array_equal(ft[2][decided], fj[2][decided])


WIDTHS = (16, 64, 256)


def _rmat_with_loops(scale, seed, float_w):
    """A JAX R-MAT graph rebuilt with self loops on a fifth of its vertices
    and random integer (or float) weights."""
    rng = np.random.default_rng(seed)
    g = jrmat(scale, 8, seed=seed)
    e = int(g.e_valid)
    src, dst = np.asarray(g.src)[:e], np.asarray(g.indices)[:e]
    und = src < dst
    u, v = src[und], dst[und]
    n = int(g.n_valid)
    loops = rng.choice(n, n // 5, replace=False)
    u, v = np.concatenate([u, loops]), np.concatenate([v, loops])
    w = (rng.random(len(u)) + 0.05 if float_w
         else rng.integers(1, 4, len(u))).astype(np.float32)
    return jbuild_csr(u, v, w, n, symmetrize=True)


def _port(jg):
    return graph_from_numpy(np.asarray(jg.indptr), np.asarray(jg.indices),
                            np.asarray(jg.weights), np.asarray(jg.src),
                            int(jg.n_valid), int(jg.e_valid), device="cpu")


@pytest.fixture(scope="module")
def row_corpora():
    graphs = dict(capture.corpora())
    graphs["rmat_loops"] = _rmat_with_loops(9, 3, float_w=False)
    graphs["rmat_float"] = _rmat_with_loops(9, 4, float_w=True)
    return graphs


def _row_state(seed, jg):
    """A mid-sweep state as numpy arrays: half of the vertices still
    singletons (equal-degree singleton neighbours tie exactly), the others
    in communities drawn from n/3 ids; Sigma and sizes consistent with
    them, a random frontier."""
    rng = np.random.default_rng(seed)
    n, n_cap = int(jg.n_valid), jg.n_cap
    comm = np.arange(n_cap + 1, dtype=np.int32)
    joined = rng.random(n) < 0.5
    comm[:n][joined] = rng.integers(0, max(n // 3, 1), int(joined.sum()))
    k = np.array(jg.vertex_weights())
    sigma = np.bincount(comm, weights=k, minlength=n_cap + 1)
    sizes = np.bincount(comm[:n], minlength=n_cap + 1)
    front = rng.random(n_cap + 1) < 0.7
    front[n:] = False
    return dict(comm=comm, sigma=sigma.astype(np.float32), k=k,
                sizes=sizes.astype(np.int32), front=front)


@pytest.mark.parametrize("gate_fraction", [1, 2, 4])
@pytest.mark.parametrize("name", ["lesmis", "sbm", "ring_of_cliques", "gnp",
                                  "rmat_loops", "rmat_float"])
def test_row_plain_versions_match_jax_composition(row_corpora, name,
                                                  gate_fraction):
    """On every bucket of the real graph, the row-level plain K1/K2 equal
    ``to_ell_blocks`` + ``prepare_*_inputs`` + the Pallas kernel."""
    jg = row_corpora[name]
    tg = _port(jg)
    n_cap = tg.n_cap
    st = _row_state(gate_fraction, jg)
    t = {key: torch.from_numpy(x) for key, x in st.items()}
    j = {key: jnp.asarray(x) for key, x in st.items()}
    m = np.float32(np.asarray(jg.weights).sum() * 0.5)
    m_j, m_t = jnp.float32(m), torch.tensor(m)
    csr = (tg.indptr, tg.indices, tg.weights)
    jblocks, _ = jell(jg, WIDTHS)
    trows, _ = ell_bucket_rows(tg, WIDTHS)
    exact = name != "rmat_float"
    for width, jb, rows in zip(WIDTHS, jblocks, trows):
        r = rows.numel()
        jins = jops.prepare_ell_inputs(jb, j["comm"], j["sigma"], j["k"],
                                       n_cap)
        jc, jdq = louvain_scan_pallas(*jins, m_j, block_rows=r,
                                      interpret=True)
        tc, tdq = ops.louvain_scan_rows_ref(rows, *csr, t["comm"],
                                            t["sigma"], t["k"], m_t,
                                            width=width)
        jfins = jops.prepare_fused_inputs(jb, j["comm"], j["sigma"],
                                          j["sizes"], j["k"], j["front"],
                                          n_cap)
        tile = {key: np.asarray(x) for key, x in zip(
            ("c", "w", "sig", "k_i", "c_own", "sig_own"), jins)}
        tile["m"] = m
        lead, best = _lead(tile)
        clear = lead > 1e-5
        jc, jdq = np.asarray(jc)[:, 0], np.asarray(jdq)[:, 0]
        for round_ix in (0, 7):
            fj = louvain_fused_pallas(*jfins, m_j, jnp.int32(round_ix),
                                      gate_fraction=gate_fraction,
                                      sentinel=n_cap, block_rows=r,
                                      interpret=True)
            ft = ops.louvain_fused_rows_ref(
                rows, *csr, t["comm"], t["sigma"], t["sizes"], t["k"],
                t["front"], m_t, round_ix, width=width,
                gate_fraction=gate_fraction, sentinel=n_cap)
            fj = [np.asarray(x)[:, 0] for x in fj]
            ft = [x.numpy() for x in ft]
            if exact:
                for a, b in zip(ft, fj):
                    np.testing.assert_array_equal(a, b)
                continue
            fin = np.isfinite(jdq)
            scale = np.abs(jdq[fin]).max() if fin.any() else 0.0
            np.testing.assert_allclose(ft[1], fj[1], rtol=1e-6,
                                       atol=1e-6 * scale)
            np.testing.assert_array_equal(ft[0][clear], fj[0][clear])
            decided = clear & (np.abs(best) > 1e-5)
            np.testing.assert_array_equal(ft[2][decided], fj[2][decided])
        if exact:
            np.testing.assert_array_equal(tc.numpy(), jc)
            np.testing.assert_array_equal(tdq.numpy(), jdq)
        else:
            fin = np.isfinite(jdq)
            scale = np.abs(jdq[fin]).max() if fin.any() else 0.0
            np.testing.assert_allclose(tdq.numpy(), jdq, rtol=1e-6,
                                       atol=1e-6 * scale)
            np.testing.assert_array_equal(tc.numpy()[clear], jc[clear])


def test_row_corpora_reach_every_bucket_and_row_case(row_corpora):
    """The R-MAT graphs fill all three buckets and hold self-loop slots, and
    the integer-weighted one has exact dQ ties between communities."""
    for name in ("rmat_loops", "rmat_float"):
        tg = _port(row_corpora[name])
        rows, _ = ell_bucket_rows(tg, WIDTHS)
        assert min(int((r < tg.n_cap).sum()) for r in rows) > 0, name
        e = tg.e_valid
        assert bool((tg.src[:e] == tg.indices[:e]).any()), name
    jg = row_corpora["rmat_loops"]
    m = np.float32(np.asarray(jg.weights).sum() * 0.5)
    jblocks, _ = jell(jg, WIDTHS)
    for seed in (1, 2, 4):          # the states of the gate fractions
        st = {key: jnp.asarray(x) for key, x in _row_state(seed, jg).items()}
        ties = 0
        for jb in jblocks:
            tile = dict(zip(("c", "w", "sig", "k_i", "c_own", "sig_own"),
                            map(np.asarray, jops.prepare_ell_inputs(
                                jb, st["comm"], st["sigma"], st["k"],
                                jg.n_cap))), m=m)
            ties += int((_lead(tile)[0] == 0).sum())
        assert ties > 0, seed


def test_wrappers_on_cpu_take_the_plain_version_and_count_nothing():
    jg = _rmat_with_loops(7, 5, float_w=False)
    tg = _port(jg)
    st = {key: torch.from_numpy(x) for key, x in _row_state(5, jg).items()}
    m = tg.total_weight()
    csr = (tg.indptr, tg.indices, tg.weights)
    before = (ops.louvain_scan.launches, ops.louvain_fused.launches)
    rows_all, _ = ell_bucket_rows(tg, WIDTHS)
    for width, rows in zip(WIDTHS, rows_all):
        got = ops.louvain_scan(rows, *csr, st["comm"], st["sigma"], st["k"],
                               m, width=width)
        want = ops.louvain_scan_rows_ref(rows, *csr, st["comm"], st["sigma"],
                                         st["k"], m, width=width)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        args = (rows, *csr, st["comm"], st["sigma"], st["sizes"], st["k"],
                st["front"], m, 3)
        fgot = ops.louvain_fused(*args, width=width, gate_fraction=2,
                                 sentinel=tg.n_cap)
        fwant = ops.louvain_fused_rows_ref(*args, width=width,
                                           gate_fraction=2,
                                           sentinel=tg.n_cap)
        assert all(torch.equal(a, b) for a, b in zip(fgot, fwant))
    assert (ops.louvain_scan.launches, ops.louvain_fused.launches) == before


def test_row_plain_versions_reject_a_row_above_the_width():
    jg = _rmat_with_loops(7, 5, float_w=False)
    tg = _port(jg)
    st = {key: torch.from_numpy(x) for key, x in _row_state(5, jg).items()}
    rows, _ = ell_bucket_rows(tg, WIDTHS)
    with pytest.raises(ValueError, match="width 16"):
        ops.louvain_scan(rows[1], tg.indptr, tg.indices, tg.weights,
                         st["comm"], st["sigma"], st["k"],
                         tg.total_weight(), width=16)


def test_prepare_inputs_match_reference_gathers():
    """The per-slot gathers of both kernels equal the reference's on a
    graph with self loops and a mid-sweep (non-singleton) state."""
    rng = np.random.default_rng(8)
    src = rng.integers(0, 40, 200)
    dst = rng.integers(0, 40, 200)
    dst[:5] = src[:5]                                  # self loops
    w = rng.integers(1, 4, 200).astype(np.float32)
    jg = jbuild_csr(src, dst, w, 40, n_cap=48, symmetrize=True)
    tg = build_csr(src, dst, w, 40, n_cap=48, symmetrize=True, device="cpu")
    n_cap = tg.n_cap
    comm = np.full(n_cap + 1, n_cap, np.int32)
    comm[:40] = rng.integers(0, 40, 40)
    sigma = rng.integers(0, 30, n_cap + 1).astype(np.float32)
    sizes = rng.integers(0, 4, n_cap + 1).astype(np.int32)
    k = rng.integers(1, 9, n_cap + 1).astype(np.float32)
    front = rng.random(n_cap + 1) < 0.6
    jblocks, _ = jell(jg, (4, 8, 16))
    tblocks, _ = to_ell_blocks(tg, (4, 8, 16))
    for jb, tb in zip(jblocks, tblocks):
        jins = jops.prepare_fused_inputs(
            jb, jnp.asarray(comm), jnp.asarray(sigma), jnp.asarray(sizes),
            jnp.asarray(k), jnp.asarray(front), n_cap)
        tins = ops.prepare_fused_inputs(
            tb, torch.from_numpy(comm), torch.from_numpy(sigma),
            torch.from_numpy(sizes), torch.from_numpy(k),
            torch.from_numpy(front), n_cap)
        assert len(jins) == len(tins)
        for a, b in zip(jins, tins):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        jscan = jops.prepare_ell_inputs(jb, jnp.asarray(comm),
                                        jnp.asarray(sigma), jnp.asarray(k),
                                        n_cap)
        tscan = ops.prepare_ell_inputs(tb, torch.from_numpy(comm),
                                       torch.from_numpy(sigma),
                                       torch.from_numpy(k), n_cap)
        for a, b in zip(jscan, tscan):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("width,rows", [(16, 256), (64, 8), (256, 8),
                                        (512, 8), (1024, 4)])
def test_block_rows_for_width_fit_shared_memory(width, rows):
    assert ops.block_rows_for_width(width) == rows
    assert (k2.warps_for_width(width) * k2.sort_capacity(width) * 12
            <= 48 * 1024)


@pytest.mark.parametrize("width", [1025, 2048, 2049, 4096, 8192, 16384])
def test_block_rows_for_wide_widths_take_one_row_per_block(width):
    """Above 1024 one row takes a whole block, whose sort buffer (12 B per
    slot of the next power of two) fits the 227 KB a Hopper block may opt
    in to."""
    assert ops.block_rows_for_width(width) == 1
    assert k2.warps_for_width(width) * 32 == k2.CTA_THREADS
    cap = k2.sort_capacity(width)
    assert cap >= width and cap & (cap - 1) == 0 and cap < 2 * width
    assert cap * 12 <= 227 * 1024


def test_block_rows_for_width_rejects_too_wide_rows():
    """No width is too wide: above ``SMEM_MAX_WIDTH`` one row still takes a
    block, its sort buffer in a global scratch of at most
    ``SCRATCH_BYTES``; only widths below 1 are refused."""
    for width in (k2.SMEM_MAX_WIDTH + 1, 1 << 15, 1 << 20):
        assert ops.block_rows_for_width(width) == 1
        cap, blocks = k2.scratch_layout(width, 100000, 1 << 22)
        assert cap == k2.sort_capacity(width) and cap >= width
        assert 1 <= blocks and blocks * cap * 12 <= k2.SCRATCH_BYTES
    assert k2.scratch_layout(1 << 20, 3, 40000) == (1 << 16, 3)
    assert k2.scratch_layout(k2.SMEM_MAX_WIDTH, 10, 1 << 22) == (0, 0)
    with pytest.raises(k2.ELLWidthError):
        ops.block_rows_for_width(0)
    with pytest.raises(ValueError):
        ops.block_rows_for_width(-5)
