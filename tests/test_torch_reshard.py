"""Skew-aware re-sharding in the port (``reshard="auto"`` on more than one
rank): the numpy policy of ``repro_torch.configs.louvain_arch``, the
relabel and host re-bucket of ``repro_torch.core.distributed``, and the
live-mask forms of the warm start and the refinement seed, each against
the JAX package's on the same inputs; then ONE spawned run of 4 gloo CPU
ranks on the reference's skew-owned clique corpus
(``tests/test_reshard.py``), where the re-shard must fire, lower the load
and the coarse tier, be priced, and keep the quality of
``reshard="none"``.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:         # optional dev dep — see tests/_hypothesis_fallback
    from _hypothesis_fallback import given, settings, st

from repro.configs import louvain_arch as jarch
from repro.core import distributed as jdist
from repro.core import engine as jengine
from repro.core import louvain as jlouvain

from repro.core.graph import build_csr as jbuild_csr

from repro_torch import membership_modularity
from repro_torch.configs import louvain_arch as tarch
from repro_torch.core import collectives, distributed as tdist
from repro_torch.core import engine as tengine
from repro_torch.core import louvain as tlouvain
from repro_torch.interop import graph_from_numpy

#: The hard limit of one spawned multi-rank run (seconds).
RANK_TIMEOUT = 240


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# -- the policy ----------------------------------------------------------------

def test_resolve_reshard_and_constants_equal_reference():
    assert tarch.RESHARD_MODES == jarch.RESHARD_MODES
    assert (tarch.RESHARD_IMBALANCE_THRESHOLD
            == jarch.RESHARD_IMBALANCE_THRESHOLD)
    assert tarch.RESHARD_WIDTH_SLACK == jarch.RESHARD_WIDTH_SLACK
    for mode in ("none", "auto"):
        assert tarch.resolve_reshard(mode) == jarch.resolve_reshard(mode)
    with pytest.raises(ValueError, match="reshard"):
        tarch.resolve_reshard("always")


def _counts(seed, n, hot):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 6, n).astype(np.int64)
    counts[:hot] += rng.integers(0, 400, hot)
    return counts


@settings(max_examples=40, deadline=None)
@given(st.integers(0, 10_000), st.integers(0, 200), st.integers(0, 40),
       st.integers(1, 9), st.integers(1, 64))
def test_owner_load_frac_equals_reference(seed, n, hot, n_shards, v_per):
    counts = _counts(seed, n, min(hot, n))
    assert (tarch.owner_load_frac(counts, v_per, n_shards)
            == jarch.owner_load_frac(counts, v_per, n_shards))


def _same_plan(got, want):
    assert (got is None) == (want is None)
    if got is None:
        return
    np.testing.assert_array_equal(got.bounds, want.bounds)
    assert got.bounds.dtype == want.bounds.dtype
    assert tuple(got)[1:] == tuple(want)[1:]


@settings(max_examples=60, deadline=None)
@given(st.integers(0, 10_000), st.integers(0, 300), st.integers(0, 40),
       st.integers(1, 9), st.integers(1, 128),
       st.sampled_from([None, 1.0, 1.1, 2.5]), st.sampled_from([None, 1, 2]))
def test_plan_reshard_equals_reference(seed, n, hot, n_shards, v_per,
                                       threshold, width_slack):
    counts = _counts(seed, n, min(hot, n))
    kw = dict(threshold=threshold, width_slack=width_slack)
    _same_plan(tarch.plan_reshard(counts, n_shards, v_per, **kw),
               jarch.plan_reshard(counts, n_shards, v_per, **kw))


@pytest.mark.parametrize("counts,n_shards,v_per,kw,fires", [
    (np.ones(64, np.int64), 4, 16, {}, False),         # balanced
    (np.ones(16, np.int64), 1, 16, {}, False),         # one rank
    (np.zeros(0, np.int64), 4, 4, {}, False),          # nothing live
    (np.zeros(16, np.int64), 4, 4, {}, False),         # no edges
    (np.r_[np.full(8, 200), np.ones(56)], 4, 16, {}, True),   # hot prefix
    (np.r_[np.full(16, 13), np.full(48, 10)], 4, 16, {}, False),  # mild
    (np.r_[np.full(16, 13), np.full(48, 10)], 4, 16, {"threshold": 1.1},
     True),
])
def test_plan_reshard_cases_equal_reference(counts, n_shards, v_per, kw,
                                            fires):
    got = tarch.plan_reshard(counts, n_shards, v_per, **kw)
    _same_plan(got, jarch.plan_reshard(counts, n_shards, v_per, **kw))
    assert (got is not None) == fires
    if fires:
        assert got.load_frac_after < got.load_frac_before
        for x in (got.v_per_shard, got.e_per_shard):
            assert x & (x - 1) == 0


# -- the relabel and the host re-bucket ----------------------------------------

@pytest.mark.parametrize("bounds,v_per,n_pad_new,old_cap", [
    ([0, 3, 5, 11, 12], 8, 32, 16),
    ([0, 0, 4, 4, 9], 8, 32, 9),
    ([0, 40, 41, 64, 64], 64, 256, 100),
    ([0, 7], 8, 8, 7),
])
def test_reshard_relabel_equals_reference(bounds, v_per, n_pad_new, old_cap):
    b = np.asarray(bounds, np.int64)
    got = tdist._reshard_relabel(b, v_per, n_pad_new, old_cap)
    want = jdist._reshard_relabel(b, v_per, n_pad_new, old_cap)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    live = got[:b[-1]]
    assert (np.diff(live) > 0).all()
    assert (got[b[-1]:] == n_pad_new).all()


@pytest.mark.parametrize("seed", range(5))
def test_reshard_coarse_host_equals_reference(seed):
    """A skewed coarse graph on a 4-rank layout through one plan: the same
    global arrays, spec, LUT and live mask as the reference, and the same
    live slot multiset back through the inverse relabel."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(6, 14))
    spec_old = tdist.ShardedGraphSpec(4, 4, 32, 16)
    src = np.concatenate([np.zeros(12, np.int64), rng.integers(1, n, 10)])
    dst = rng.integers(0, n, len(src))
    keep = src != dst
    src, dst = src[keep], dst[keep]
    w = (rng.random(len(src)) + 0.5).astype(np.float32)
    glob = tdist.bucket_slots_host(src, dst, w, spec_old)
    plan = tarch.plan_reshard(np.bincount(src, minlength=n), 4,
                              spec_old.v_per_shard, threshold=1.0)
    jplan = jarch.plan_reshard(np.bincount(src, minlength=n), 4,
                               spec_old.v_per_shard, threshold=1.0)
    _same_plan(plan, jplan)
    assert plan is not None
    *got, spec, lut, live = tdist._reshard_coarse_host(*glob, spec_old.sentinel,
                                                       plan)
    *want, jspec, jlut, jlive = jdist._reshard_coarse_host(
        *glob, spec_old.sentinel, jplan)
    assert tuple(spec) == tuple(jspec)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(lut, jlut)
    np.testing.assert_array_equal(live, jlive)
    s2, d2, w2 = got
    inv = np.full(spec.n_pad + 1, -1, np.int64)
    inv[lut[:n]] = np.arange(n)
    lv = s2 < spec.sentinel
    assert sorted(zip(inv[s2[lv]], inv[d2[lv]], w2[lv])) == sorted(
        zip(src, dst, w))
    for r in range(4):
        blk = s2[r * spec.e_per_shard:(r + 1) * spec.e_per_shard]
        assert (blk[blk < spec.sentinel] // spec.v_per_shard == r).all()


def test_rebucket_live_host_equals_reference():
    rng = np.random.default_rng(5)
    spec = tdist.ShardedGraphSpec(4, 8, 32, 32)
    src = rng.integers(0, 20, 60)
    dst = rng.integers(0, 20, 60)
    w = rng.random(60).astype(np.float32)
    glob = tdist.bucket_slots_host(src, dst, w, spec)
    tier = tdist.ShardedGraphSpec(4, 5, 4, 20)
    *got, gspec = tdist._rebucket_live_host(*glob, spec.sentinel, tier)
    *want, wspec = jdist._rebucket_live_host(*glob, spec.sentinel,
                                             jdist.ShardedGraphSpec(*tier))
    assert tuple(gspec) == tuple(wspec) and gspec.e_per_shard > 4
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    with pytest.raises(ValueError, match="does not fit"):
        tdist._rebucket_live_host(*glob, spec.sentinel,
                                  tdist.ShardedGraphSpec(4, 2, 64, 8))


# -- the live-mask forms ---------------------------------------------------------

def _gappy(seed, cap=40):
    """A live mask with gaps and an outer membership holding live labels,
    dead labels, negative and out-of-range ones."""
    rng = np.random.default_rng(seed)
    live = rng.random(cap + 1) < 0.6
    live[cap] = bool(seed % 2)           # the sentinel slot is never live
    outer = rng.integers(-2, cap + 3, cap + 1).astype(np.int32)
    ids = np.flatnonzero(live[:cap])
    pick = rng.random(cap + 1) < 0.5
    if ids.size:
        outer[pick] = rng.choice(ids, int(pick.sum()))
    return cap, live, outer


@pytest.mark.parametrize("seed", range(8))
def test_sanitize_outer_mask_form_equals_reference(seed):
    cap, live, outer = _gappy(seed)
    got = tengine.sanitize_outer(torch.from_numpy(outer),
                                 torch.from_numpy(live), cap)
    want = jengine.sanitize_outer(jnp.asarray(outer), jnp.asarray(live), cap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # Sanitized ids pass the eager check in both forms; the raw ones, with
    # their stale labels, fail it in both.
    tengine.assert_outer_sane(got, torch.from_numpy(live), cap)
    jengine.assert_outer_sane(np.asarray(want), live, cap)
    with pytest.raises(ValueError, match="live mask"):
        tengine.assert_outer_sane(torch.from_numpy(outer),
                                  torch.from_numpy(live), cap)
    with pytest.raises(ValueError, match="live mask"):
        jengine.assert_outer_sane(outer, live, cap)


@pytest.mark.parametrize("seed", range(6))
def test_warm_comm_sigma_mask_form_equals_reference(seed):
    cap, live, mem = _gappy(seed)
    mem = np.where(mem < 0, cap, mem).astype(np.int32)
    k = np.random.default_rng(seed).random(cap + 1).astype(np.float32)
    comm, sigma = tdist._warm_comm_sigma(torch.from_numpy(mem),
                                         torch.from_numpy(k),
                                         torch.from_numpy(live))
    jcomm, jsigma = jdist._warm_comm_sigma(jnp.asarray(mem), jnp.asarray(k),
                                           jnp.asarray(live))
    np.testing.assert_array_equal(comm.numpy(), np.asarray(jcomm))
    np.testing.assert_allclose(sigma.numpy(), np.asarray(jsigma), rtol=1e-6)


@pytest.mark.parametrize("seed", range(6))
def test_leiden_warm_membership_mask_form_equals_reference(seed):
    rng = np.random.default_rng(seed)
    cap, live, _ = _gappy(seed)
    n_agg = int(rng.integers(1, cap))
    comm_ren = np.where(live, rng.integers(0, n_agg, cap + 1),
                        cap).astype(np.int32)
    outer_ren = np.where(live, rng.integers(0, 5, cap + 1),
                         cap).astype(np.int32)
    got = tlouvain._leiden_warm_membership(
        torch.from_numpy(comm_ren), torch.from_numpy(outer_ren),
        torch.from_numpy(live), n_agg)
    want = jlouvain._leiden_warm_membership(
        jnp.asarray(comm_ren), jnp.asarray(outer_ren), jnp.asarray(live),
        n_agg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n_valid", [0, 7, 40])
def test_scalar_forms_unchanged(n_valid):
    """The live count keeps its own form beside the mask."""
    cap, _, outer = _gappy(3)
    got = tengine.sanitize_outer(torch.from_numpy(outer), n_valid, cap)
    want = jengine.sanitize_outer(jnp.asarray(outer), jnp.int32(n_valid),
                                  cap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- four gloo ranks on the skew-owned clique corpus ------------------------------

def skewed_clique_graph(n_cliques=64, hot=8, csize=5):
    """The reference's corpus (``tests/test_reshard.py``), built by the JAX
    package's ``build_csr`` as there: cliques renumber to a contiguous
    coarse-id prefix, and all-pairs links among the first ``hot`` cliques
    pile the coarse edges onto rank 0's uniform range."""
    edges = []

    def vid(c, i):
        return c * csize + i
    for c in range(n_cliques):
        for i in range(csize):
            for j in range(i + 1, csize):
                edges.append((vid(c, i), vid(c, j), 1.0))
    for a in range(hot):
        for b in range(a + 1, hot):
            edges.append((vid(a, a % csize), vid(b, b % csize), 0.25))
    for c in range(n_cliques):
        edges.append((vid(c, 0), vid((c + 1) % n_cliques, 1), 0.25))
    src = np.array([e[0] for e in edges])
    dst = np.array([e[1] for e in edges])
    w = np.array([e[2] for e in edges], np.float32)
    return jbuild_csr(src, dst, w, n_cliques * csize, symmetrize=True,
                      e_cap=2 * len(edges) + 64)


def arrays(jg) -> dict:
    return dict(indptr=np.asarray(jg.indptr), indices=np.asarray(jg.indices),
                weights=np.asarray(jg.weights), src=np.asarray(jg.src),
                n_valid=int(jg.n_valid), e_valid=int(jg.e_valid))


SKEW_RUNS = [{"reshard": "none"}, {"reshard": "auto"},
             {"reshard": "auto", "pipeline_fetch": True},
             {"reshard": "auto", "refine": "leiden"},
             {"reshard": "auto", "state_layout": "hybrid",
              "comm_backend": "delta"},
             {"reshard": "auto", "use_ladder": False}]


@pytest.fixture(scope="module")
def skew_four_ranks():
    graphs = {"skew": arrays(skewed_clique_graph())}
    g = graph_from_numpy(**graphs["skew"], device="cpu")
    out = collectives.launch(tdist.rank_runs, 4, graphs,
                             [("skew", kw) for kw in SKEW_RUNS],
                             backend="gloo", devices=["cpu"] * 4,
                             timeout=RANK_TIMEOUT)
    return g, out


def _run(skew_four_ranks, i):
    g, out = skew_four_ranks
    for r in range(1, 4):      # every rank holds the same answer
        np.testing.assert_array_equal(out[r]["results"][i][0],
                                      out[0]["results"][i][0])
    return out[0]["results"][i]


def test_four_ranks_reshard_fires_and_balances(skew_four_ranks):
    rows = [s for s in _run(skew_four_ranks, 1)[2] if s["reshard"]]
    assert len(rows) >= 1
    for r in rows:
        assert r["max_shard_load_frac_after"] < r["max_shard_load_frac_before"]
        assert r["max_shard_load_frac_before"] * 4 > 1.5
        assert r["reshard_bytes"] > 0
        assert r["comm_bytes"] >= r["reshard_bytes"]
    assert not any(s["reshard"] for s in _run(skew_four_ranks, 0)[2])


def test_four_ranks_reshard_lowers_the_coarse_tier(skew_four_ranks):
    e_auto = min(s["e_per_shard"] for s in _run(skew_four_ranks, 1)[2][1:])
    e_none = min(s["e_per_shard"] for s in _run(skew_four_ranks, 0)[2][1:])
    assert e_auto < e_none, (e_auto, e_none)


@pytest.mark.parametrize("i", range(1, len(SKEW_RUNS)),
                         ids=[str(kw) for kw in SKEW_RUNS[1:]])
def test_four_ranks_reshard_quality_parity(skew_four_ranks, i):
    """The reference's rule: Q(auto) >= Q(none) - 0.01 |Q(none)|, with the
    same number of communities; the pipelined fetch reorders host reads
    only, so against the same layout it is bit-identical."""
    g = skew_four_ranks[0]
    mem_none, n_none, _ = _run(skew_four_ranks, 0)
    mem, n, stats = _run(skew_four_ranks, i)
    q_none = membership_modularity(g, mem_none)
    assert membership_modularity(g, mem) >= q_none - 0.01 * abs(q_none)
    assert n == n_none
    assert any(s["reshard"] for s in stats)
    if SKEW_RUNS[i].get("pipeline_fetch"):
        np.testing.assert_array_equal(mem, _run(skew_four_ranks, 1)[0])


# -- four port ranks against four JAX host devices (slow) -----------------------

_JAX_SCRIPT = r"""
import os, json, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, "tests")
import numpy as np
from golden import capture_engine_golden as capture
from test_torch_reshard import SKEW_RUNS, skewed_clique_graph
from repro.compat import make_mesh
from repro.core.distributed import distributed_louvain
mesh = make_mesh((2, 2), ("data", "model"))
out = []
g = skewed_clique_graph()
for kw in SKEW_RUNS:
    mem, n, stats = distributed_louvain(g, mesh, ("data", "model"), **kw)
    out.append([np.asarray(mem).tolist(), stats])
for name, jg in capture.corpora().items():
    mem, n, stats = distributed_louvain(jg, mesh, ("data", "model"),
                                        reshard="auto")
    out.append([np.asarray(mem).tolist(), stats])
print(json.dumps(out))
"""


@pytest.mark.slow
def test_four_port_ranks_equal_four_jax_devices_with_reshard():
    from golden import capture_engine_golden as capture
    from test_torch_distributed import same_rows
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _JAX_SCRIPT], env=env,
                          capture_output=True, text=True, timeout=900,
                          cwd=root)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    graphs = {n: arrays(jg) for n, jg in capture.corpora().items()}
    graphs["skew"] = arrays(skewed_clique_graph())
    runs = ([("skew", kw) for kw in SKEW_RUNS]
            + [(n, {"reshard": "auto"}) for n in capture.corpora()])
    out = collectives.launch(tdist.rank_runs, 4, graphs, runs,
                             backend="gloo", devices=["cpu"] * 4,
                             timeout=600)
    assert any(s["reshard"] for _, s_rows in want for s in s_rows)
    for (jmem, jstats), got in zip(want, out[0]["results"]):
        np.testing.assert_array_equal(got[0], np.asarray(jmem))
        same_rows(got[2], jstats)
