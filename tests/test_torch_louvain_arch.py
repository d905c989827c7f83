"""The Louvain arch's distributed phases of the PyTorch port
(``repro_torch.configs.louvain_arch``, ``distributed.round_body``) against
the reference's ``shard_map`` bodies and against NumPy.

* On 8 gloo CPU ranks (one spawned launch), with the reference test's
  inputs (seed 0, n 64, e_l 48; ``tests/test_louvain_arch.py``; the move
  rounds take its slots bucketed by owner): the
  owner-routed all-to-all aggregation equals the gather baseline and the
  NumPy truth within 1e-4 with nothing dropped; a skewed membership makes
  the baseline's ``owned_max`` exceed ``e_l``; the delta-encoded move
  round equals ``round_body`` (membership exact, Sigma and dQ within
  1e-4, some vertex moved).
* Each body and ``round_body`` at world size 1 in process against the
  reference's under ``shard_map`` on a one-device mesh: integers exact,
  floats within 1e-5 (float32 sums in other orders).
* ``LouvainArch``'s smoke steps for the four shapes and both variants at
  world size 1 against the reference's ``ARCH.build_step`` on a (1, 1)
  mesh, same tolerances.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

from repro.compat import make_mesh as j_make_mesh
from repro.configs import louvain_arch as jla
from repro.core import distributed as jdist

from repro_torch.configs import louvain_arch as la
from repro_torch.core import collectives, distributed
from repro_torch.core.collectives import ShardGroup
from repro_torch.core.distributed import ShardedGraphSpec

CPU = "cpu"
RANKS = 8
RANK_TIMEOUT = 240.0
FLOAT_TOL = 1e-5          # float32 sums in another order, world size 1
RANKS_TOL = 1e-4          # the reference test's tolerance over 8 ranks


def reference_inputs(n_shards: int = RANKS):
    """The reference test's graph: 8 x 48 slots over 64 vertices, 12
    communities spread over the id range, a skewed membership of 8
    communities on shard 0, and the singleton start of the move round."""
    rng = np.random.default_rng(0)
    n, e_l = 64, 48
    e = RANKS * e_l
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    w = rng.random(e).astype(np.float32) + 0.1
    ids = (np.arange(12) * n) // 12
    comm_map = ids[rng.integers(0, 12, n)].astype(np.int32)
    comm = np.concatenate([comm_map, [n]]).astype(np.int32)
    comm_skew = np.concatenate(
        [rng.integers(0, 8, n).astype(np.int32), [n]]).astype(np.int32)
    k = np.zeros(n + 1, np.float32)
    np.add.at(k, src, w)
    spec = ShardedGraphSpec(n_shards, n // n_shards, e // n_shards, n)
    return {"src": src, "dst": dst, "w": w, "comm": comm,
            "comm_skew": comm_skew, "comm_map": comm_map, "k": k,
            "m": np.float32(w.sum() / 2),
            "comm0": np.concatenate([np.arange(n), [n]]).astype(np.int32),
            "sizes0": np.concatenate([np.ones(n), [0]]).astype(np.int32),
            "n": n, "e_l": e_l, "spec": spec}


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def port_phases(group: ShardGroup, inp: dict, a2a_cap: int = 8,
                move_cap_frac: int = 1) -> dict:
    """Every phase on this rank: the gather and all-to-all aggregations,
    the skewed gather, the gather round and the delta round."""
    spec = inp["spec"]
    r, e_l = group.rank, spec.e_per_shard
    t = {k: torch.from_numpy(np.asarray(inp[k])) for k in
         ("src", "dst", "w", "comm", "comm_skew", "k", "comm0", "sizes0")}
    edges = [t[k][r * e_l:(r + 1) * e_l] for k in ("src", "dst", "w")]
    m = torch.tensor(inp["m"])
    out = {"base": la.aggregate_gather_body(group, spec, *edges, t["comm"]),
           "a2a": la.aggregate_a2a_body(group, spec, a2a_cap, *edges,
                                        t["comm"]),
           "skew": la.aggregate_gather_body(group, spec, *edges,
                                            t["comm_skew"])}
    # A move round reads each vertex's slots on its owner: the same
    # slots bucketed by owner (the reference's layout puts the random
    # slots on any shard, and its scan drops the ones it does not own).
    owner = inp["src"] // spec.v_per_shard
    mspec = spec._replace(e_per_shard=int(np.bincount(
        owner, minlength=spec.n_shards).max()))
    edges = distributed.rank_slice(*distributed.bucket_slots_host(
        inp["src"], inp["dst"], inp["w"], mspec), mspec, r, CPU)
    frontier = torch.ones(spec.v_per_shard, dtype=torch.bool)
    out["round"] = distributed.round_body(group, mspec, *edges, t["comm0"],
                                          t["k"], t["k"], frontier, 0, 2, m)
    out["delta"] = la.move_round_delta(group, mspec, move_cap_frac, *edges,
                                       t["comm0"], t["k"], t["sizes0"],
                                       t["k"], m)
    return {k: tuple(_np(x) for x in v) for k, v in out.items()}


def rank_phases(group: ShardGroup, inp: dict) -> dict:
    """The rank entry of the spawned run."""
    return port_phases(group, inp)


def coarse_dict(ci, cj, cw, n):
    out = {}
    for a, b, x in zip(np.asarray(ci), np.asarray(cj), np.asarray(cw)):
        if a < n:
            out[(int(a), int(b))] = out.get((int(a), int(b)), 0.0) + float(x)
    return out


@pytest.fixture(scope="module")
def ranks():
    inp = reference_inputs()
    return inp, collectives.launch(rank_phases, RANKS, inp,
                                   devices=[CPU] * RANKS,
                                   timeout=RANK_TIMEOUT)


def test_a2a_aggregation_matches_gather_baseline(ranks):
    inp, res = ranks
    n = inp["n"]
    truth = {}
    for s_, d_, ww in zip(inp["comm_map"][inp["src"]],
                          inp["comm_map"][inp["dst"]], inp["w"]):
        truth[(int(s_), int(d_))] = truth.get((int(s_), int(d_)), 0.0) + ww
    base = [np.concatenate([r["base"][i] for r in res]) for i in range(3)]
    a2a = [np.concatenate([r["a2a"][i] for r in res]) for i in range(3)]
    d_base, d_a2a = coarse_dict(*base, n), coarse_dict(*a2a, n)
    assert set(d_base) == set(d_a2a) == set(truth)
    assert max(abs(d_base[k] - d_a2a[k]) for k in d_base) < RANKS_TOL
    assert max(abs(d_a2a[k] - truth[k]) for k in truth) < RANKS_TOL
    for r in res:
        assert int(r["base"][3]) == int(r["a2a"][3]) == len(truth)
        assert int(r["a2a"][4]) == 0
        assert int(r["base"][4]) <= inp["e_l"]
    assert len(d_base) > 10


def test_gather_baseline_overflow_detected(ranks):
    inp, res = ranks
    assert all(int(r["skew"][4]) > inp["e_l"] for r in res)


def test_delta_encoded_move_round_matches_baseline(ranks):
    inp, res = ranks
    for r in res:
        cb, sb, _, dqb = r["round"]
        cd, sd, szd, _, dqd, ovf = r["delta"]
        assert int(ovf) <= 0
        np.testing.assert_array_equal(cb, cd)
        assert np.max(np.abs(sb - sd)) < RANKS_TOL
        assert abs(float(dqb) - float(dqd)) < RANKS_TOL
        assert int(np.sum(cd[:-1] != inp["comm0"][:-1])) > 0
        # The rebuilt sizes are the new membership's.
        want = np.bincount(cd[:-1], minlength=inp["n"] + 1)
        np.testing.assert_array_equal(szd, want)
    frontiers = np.concatenate([r["delta"][3] for r in res])
    base_front = np.concatenate([r["round"][2] for r in res])
    # The gather round keeps gated-out vertices hot; the delta round's
    # frontier is the movers' neighbours, a subset of it.
    assert not np.any(frontiers & ~base_front)


# ---------------------------------------------------------------------------
# World size 1 against the reference's bodies on a one-device mesh.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def one():
    inp = reference_inputs(n_shards=1)
    return inp, port_phases(ShardGroup.single(CPU), inp)


def _jax_run(body, inp, in_specs, out_specs, args):
    mesh = j_make_mesh((1,), ("i",))
    fn = shard_map(body, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                   check_rep=False)
    with mesh:
        return [np.asarray(x) for x in jax.jit(fn)(*args)]


def _assert_same(got, want):
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=FLOAT_TOL, atol=FLOAT_TOL)
        else:
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("body", ["gather", "a2a", "skew"])
def test_aggregation_bodies_equal_the_reference(one, body):
    inp, got = one
    spec = jdist.ShardedGraphSpec(*inp["spec"])
    edge, rep = P("i"), P()
    comm = inp["comm_skew"] if body == "skew" else inp["comm"]
    fn = (functools.partial(jla._aggregate_a2a_body, ("i",), spec, 8)
          if body == "a2a" else
          functools.partial(jla._aggregate_gather_body, ("i",), spec))
    want = _jax_run(fn, inp, (edge, edge, edge, rep),
                    (edge, edge, edge, rep, rep),
                    [jnp.asarray(inp[k]) for k in ("src", "dst", "w")]
                    + [jnp.asarray(comm)])
    _assert_same(got[{"gather": "base"}.get(body, body)], want)


def test_round_body_equals_the_reference(one):
    inp, got = one
    spec = jdist.ShardedGraphSpec(*inp["spec"])
    edge, rep = P("i"), P()

    def base_round(src_l, dst_l, w_l, comm_, sigma_, k_, m_):
        frontier = jnp.ones((spec.v_per_shard,), bool)
        return jdist._round_body(("i",), spec, src_l, dst_l, w_l, comm_,
                                 sigma_, k_, frontier, jnp.int32(0), 2, m_)

    want = _jax_run(base_round, inp, (edge,) * 3 + (rep,) * 4,
                    (rep, rep, edge, rep),
                    [jnp.asarray(inp[k]) for k in
                     ("src", "dst", "w", "comm0", "k", "k", "m")])
    _assert_same(got["round"], want)


def test_delta_round_equals_the_reference(one):
    inp, got = one
    spec = jdist.ShardedGraphSpec(*inp["spec"])
    edge, rep = P("i"), P()
    want = _jax_run(functools.partial(jla._move_round_delta, ("i",), spec, 1),
                    inp, (edge,) * 3 + (rep,) * 5,
                    (rep, rep, rep, edge, rep, rep),
                    [jnp.asarray(inp[k]) for k in
                     ("src", "dst", "w", "comm0", "k", "sizes0", "k", "m")])
    _assert_same(got["delta"], want)


# ---------------------------------------------------------------------------
# The arch protocol.
# ---------------------------------------------------------------------------

def test_shapes_and_specs_equal_the_reference():
    assert la.LOUVAIN_SHAPES == jla.LOUVAIN_SHAPES
    assert la.ARCH.shapes == jla.ARCH.shapes
    assert (la.ARCH.arch_id, la.ARCH.family) == (jla.ARCH.arch_id,
                                                 jla.ARCH.family)
    for shape in la.LOUVAIN_SHAPES:
        for smoke in (False, True):
            want = jla.ARCH.input_specs(shape, smoke=smoke)
            got = la.ARCH.input_specs(shape, smoke=smoke)
            assert list(got) == list(want)
            for k, (s, dt) in got.items():
                assert s == want[k].shape
                assert str(dt).split(".")[-1] == str(want[k].dtype)
    mesh = j_make_mesh((1, 1), ("data", "model"))
    for n_shards in (1, 256):
        grid = ShardGroup.dry(0, n_shards)
        assert tuple(la.spec_for(grid, 50_636_154, 3_800_000_000)) == (
            tuple(jla._spec_for(mesh, 50_636_154, 3_800_000_000))
            if n_shards == 1 else (256, 197_798, 14_843_750,
                                   197_798 * 256))


def _smoke_batch(shape: str, variant, seed: int = 3):
    """Random smoke inputs of one phase at world size 1: a random graph,
    a random membership (singletons for a move round), K and Sigma."""
    n, e = la.LOUVAIN_SMOKE
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    w = (rng.random(e) + 0.1).astype(np.float32)
    if "move" in shape:
        comm = np.arange(n + 1, dtype=np.int32)
    else:
        comm = np.concatenate([rng.integers(0, 300, n), [n]]).astype(np.int32)
    k = np.zeros(n + 1, np.float32)
    np.add.at(k, src, w)
    sigma = np.zeros(n + 1, np.float32)
    np.add.at(sigma, comm[:n], k[:n])
    batch = {"src": src, "dst": dst, "w": w, "comm": comm, "sigma": sigma,
             "k": k, "m": np.float32(w.sum() / 2)}
    if "delta_c" in variant:
        batch["comm_sizes"] = np.bincount(comm[:n], minlength=n + 1).astype(
            np.int32)
    return batch


@pytest.mark.parametrize("shape", sorted(la.LOUVAIN_SHAPES))
@pytest.mark.parametrize("variant", [(), ("variant",)])
def test_arch_smoke_steps_equal_the_reference(shape, variant):
    phase = la.LOUVAIN_SHAPES[shape][2]
    if variant:
        variant = ("delta_c",) if phase == "move" else ("a2a",)
    batch = _smoke_batch(shape, variant)
    step = la.ARCH.build_step(shape, ShardGroup.single(CPU), smoke=True,
                              variant=variant)
    assert {k: s for k, (s, _) in step.arg_specs.items()} == {
        k: np.shape(v) for k, v in batch.items()}
    got = [_np(x) for x in step({k: torch.from_numpy(np.asarray(v))
                                 for k, v in batch.items()})]
    mesh = j_make_mesh((1, 1), ("data", "model"))
    fn, _, shardings = jla.ARCH.build_step(shape, mesh, smoke=True,
                                           variant=variant)
    with mesh:
        want = [np.asarray(x) for x in jax.jit(fn, in_shardings=shardings)(
            {k: jnp.asarray(v) for k, v in batch.items()})]
    _assert_same(got, want)
    if phase == "aggregate" and variant:
        assert int(got[4]) == 0           # nothing dropped at cap 4
