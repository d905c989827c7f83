"""Aggregation of the PyTorch port against the JAX package, on the CPU.

The plain version of K3 (``coarsen_groups_ref``) is held against the TPU
kernel in Pallas interpret mode (``coarsen_groups_pallas``) over the first
total + 1 records: several tiles (more than 512 slots, and 128-slot
blocks), groups that span tiles, and all-padding input, and on one group
over many of the CUDA kernel's 4096-slot tiles.  The port's
``aggregate_graph`` (sort branch and kernel branch) is held against the JAX
``aggregate_graph`` (sort and pallas backends) and the NumPy oracle
``tests/_oracle._aggregate``.  Exact on integer weights; on float weights
float32-close (rtol 1e-5: group sums of up to a few hundred terms taken in
another association; for groups over many tiles, |g_w - plain| <= m * 2^-23
* sum |w| over the m slots summed).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _k3_bounds import k3_tolerances
from _oracle import aggregate_oracle

from repro.core.aggregate import (aggregate_graph as jaggregate,
                                  renumber_communities as jrenumber)
from repro.core.graph import build_csr as jbuild_csr
from repro.kernels.aggregate import coarsen_groups_pallas

from repro_torch.core.aggregate import aggregate_graph, renumber_communities
from repro_torch.core.graph import build_csr
from repro_torch.kernels.aggregate.coarsen import (coarsen_groups,
                                                   coarsen_groups_ref)

SENT = 50


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def sorted_slots(seed: int, total: int, n_keys: int, pad: int,
                 integer_w: bool, long_group: int = 0):
    """A (ci, cj)-sorted slot list over ids < SENT with ``pad`` trailing
    sentinel slots; ``long_group`` repeats one key that many times so the
    group spans tiles."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, n_keys, total - pad - long_group)
    keys = np.sort(np.concatenate([keys, np.full(long_group, n_keys // 2)]))
    ci = np.concatenate([keys // SENT, np.full(pad, SENT)]).astype(np.int32)
    cj = np.concatenate([keys % SENT, np.full(pad, SENT)]).astype(np.int32)
    if integer_w:
        w = rng.integers(1, 5, total).astype(np.float32)
    else:
        w = (rng.random(total) + 0.1).astype(np.float32)
    return ci, cj, w


@pytest.mark.parametrize("case", [
    dict(total=1500, n_keys=SENT * SENT, pad=100, long_group=0, block=512),
    dict(total=1500, n_keys=60, pad=7, long_group=700, block=512),
    dict(total=900, n_keys=200, pad=1, long_group=300, block=128),
    dict(total=600, n_keys=1, pad=600, long_group=0, block=512),
    dict(total=0, n_keys=1, pad=0, long_group=0, block=128),
], ids=["many-groups", "group-spans-tiles", "small-blocks", "all-padding",
        "empty"])
@pytest.mark.parametrize("integer_w", [True, False])
def test_plain_k3_matches_pallas_interpret(case, integer_w):
    ci, cj, w = sorted_slots(7, case["total"], case["n_keys"], case["pad"],
                             integer_w, case["long_group"])
    want = coarsen_groups_pallas(jnp.asarray(ci), jnp.asarray(cj),
                                 jnp.asarray(w), sent=SENT,
                                 block=case["block"], interpret=True)
    got = coarsen_groups(torch.from_numpy(ci), torch.from_numpy(cj),
                         torch.from_numpy(w), sent=SENT)
    n = case["total"] + 1
    names = ("emit", "pos", "g_src", "g_dst", "g_w")
    for name, a, b in zip(names, got, want):
        assert a.shape == (n,)
        b = np.asarray(b)[:n]
        if name == "g_w" and not integer_w:
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


#: Slots per tile of the one-pass CUDA kernel (``csrc/segscan.cuh``).
TILE = 4096


@pytest.mark.parametrize("case", [
    dict(total=25000, n_keys=60, pad=7, long_group=5 * TILE + 3, block=512),
    dict(total=25000, n_keys=SENT * SENT, pad=300, long_group=5 * TILE + 3,
         block=4096),
    dict(total=3 * TILE + 1, n_keys=1, pad=0, long_group=3 * TILE + 1,
         block=4096),
], ids=["group-spans-kernel-tiles", "group-spans-kernel-tiles-big-blocks",
        "one-group"])
@pytest.mark.parametrize("integer_w", [True, False])
def test_plain_k3_matches_pallas_interpret_across_kernel_tiles(case,
                                                               integer_w):
    """One group over many of the CUDA kernel's 4096-slot tiles: keys and
    positions exact, sums exact on integer weights and on float weights
    within the stated and the tight tolerance (``_k3_bounds``)."""
    ci, cj, w = sorted_slots(11, case["total"], case["n_keys"], case["pad"],
                             integer_w, case["long_group"])
    want = coarsen_groups_pallas(jnp.asarray(ci), jnp.asarray(cj),
                                 jnp.asarray(w), sent=SENT,
                                 block=case["block"], interpret=True)
    got = coarsen_groups_ref(torch.from_numpy(ci), torch.from_numpy(cj),
                             torch.from_numpy(w), sent=SENT)
    n = case["total"] + 1
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b)[:n])
    gw = np.asarray(want[4])[:n].astype(np.float64)
    if integer_w:
        np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4])[:n])
    else:
        err = np.abs(got[4].numpy().astype(np.float64) - gw)
        stated, tight = k3_tolerances(ci, cj, w)
        assert (err <= stated).all() and (err <= tight).all()
    assert int(got[0].sum()) == len(np.unique(ci.astype(np.int64) * SENT
                                              + cj)) - (case["pad"] > 0)


def test_k3_wrapper_on_cpu_is_the_plain_version():
    ci, cj, w = sorted_slots(3, 700, 300, 20, True, 100)
    args = [torch.from_numpy(x) for x in (ci, cj, w)]
    before = coarsen_groups.launches
    got = coarsen_groups(*args, sent=SENT)
    want = coarsen_groups_ref(*args, sent=SENT)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert coarsen_groups.launches == before


def _graphs(seed: int, integer_w: bool):
    rng = np.random.default_rng(seed)
    n, e0 = 40, 160
    src = rng.integers(0, n, e0)
    dst = rng.integers(0, n, e0)
    w = (rng.integers(1, 5, e0).astype(np.float32) if integer_w
         else (rng.random(e0) + 0.1).astype(np.float32))
    kw = dict(n_cap=48, e_cap=400, symmetrize=True)
    jg = jbuild_csr(src, dst, w, n, **kw)
    tg = build_csr(src, dst, w, n, device="cpu", **kw)
    comm = np.full(tg.n_cap + 1, tg.n_cap, np.int32)
    comm[:n] = rng.integers(0, 7, n) * 5        # sparse ids -> renumbered
    return jg, tg, comm


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_renumber_matches_reference(seed):
    jg, tg, comm = _graphs(seed, True)
    jc, jn = jrenumber(jnp.asarray(comm), jg.n_valid, jg.n_cap)
    tc, tn = renumber_communities(torch.from_numpy(comm), tg.n_valid)
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    assert int(jn) == tn


@pytest.mark.parametrize("integer_w", [True, False])
@pytest.mark.parametrize("backend,jax_backend", [("sort", "sort"),
                                                 ("kernel", "pallas")])
@pytest.mark.parametrize("seed", [0, 4])
def test_aggregate_matches_reference_and_oracle(seed, backend, jax_backend,
                                                integer_w):
    jg, tg, comm = _graphs(seed, integer_w)
    jc, jn = jrenumber(jnp.asarray(comm), jg.n_valid, jg.n_cap)
    tc, tn = renumber_communities(torch.from_numpy(comm), tg.n_valid)
    jcoarse = jaggregate(jg, jc, jn, backend=jax_backend)
    tcoarse = aggregate_graph(tg, tc, tn, backend=backend)
    assert (tcoarse.n_valid, tcoarse.e_valid) == (int(jcoarse.n_valid),
                                                  int(jcoarse.e_valid))
    for f in ("indptr", "indices", "src"):
        np.testing.assert_array_equal(np.asarray(getattr(jcoarse, f)),
                                      getattr(tcoarse, f).numpy(), err_msg=f)
    if integer_w:
        np.testing.assert_array_equal(np.asarray(jcoarse.weights),
                                      tcoarse.weights.numpy())
    else:
        np.testing.assert_allclose(tcoarse.weights.numpy(),
                                   np.asarray(jcoarse.weights), rtol=1e-5)

    e = tg.e_valid
    cdense = tc.numpy()
    o_src, o_dst, o_w = aggregate_oracle(
        tg.src.numpy()[:e], tg.indices.numpy()[:e], tg.weights.numpy()[:e],
        cdense, tn)
    ce = tcoarse.e_valid
    np.testing.assert_array_equal(tcoarse.src.numpy()[:ce], o_src)
    np.testing.assert_array_equal(tcoarse.indices.numpy()[:ce], o_dst)
    np.testing.assert_allclose(tcoarse.weights.numpy()[:ce], o_w,
                               rtol=0 if integer_w else 1e-5)
    # Padding past the live prefix keeps the slot contract.
    assert (tcoarse.src.numpy()[ce:] == tg.n_cap).all()
    assert (tcoarse.weights.numpy()[ce:] == 0).all()


def test_unknown_backend_raises():
    _, tg, comm = _graphs(0, True)
    tc, tn = renumber_communities(torch.from_numpy(comm), tg.n_valid)
    with pytest.raises(ValueError):
        aggregate_graph(tg, tc, tn, backend="pallas")
