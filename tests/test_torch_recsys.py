"""The FM recommender of the PyTorch port (``repro_torch.models.recsys``,
``data/recsys.py``, ``configs/fm.py``) against the JAX package on the CPU,
at the smoke width (39 fields, embed_dim 10, ``SMOKE_VOCABS``), on the
reference's own weights (``interop.fm_params_from_numpy``).

Tolerances: the click batches are byte-equal (the same numpy draws);
logits and the loss within 1e-5 relative and gradients within 1e-5 of
their largest entry (the same float32 expressions summed in another
order: ``jnp.sum`` over 39 fields and over k is not torch's order, and
the port adds a gathered row's gradients in a pairwise tree); 25 AdamW steps
within 1e-5 of the largest parameter; retrieval top-k sets equal.  Four
gloo ranks with the table split four ways equal world size 1 within the
same 1e-5 (the partial sums cross ranks and add in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
try:
    from hypothesis import given, settings, strategies as st
except ImportError:         # optional dev dep — see tests/_hypothesis_fallback
    from _hypothesis_fallback import given, settings, st

from repro.configs import fm as jfm
from repro.data.recsys import synthetic_click_batches as jbatches
from repro.models import recsys as jrecsys
from repro.optim import AdamWConfig as JAdamWConfig, adamw_init as jinit
from repro.optim import adamw_update as jupdate

from repro_torch.configs import fm
from repro_torch.core import collectives
from repro_torch.core.collectives import ShardGroup
from repro_torch.data.recsys import synthetic_click_batches
from repro_torch.interop import adamw_state_from_numpy, fm_params_from_numpy
from repro_torch.models import recsys
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update

CPU = "cpu"
RTOL = 1e-5
RANK_TIMEOUT = 240
RANKS = 4


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    cfg = jfm.smoke_config()
    jparams = jrecsys.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, fm.smoke_config(), jparams, fm_params_from_numpy(
        np_tree(jparams), CPU)


def _batch(cfg, b, seed=0):
    return next(jbatches(cfg.vocab_sizes, batch=b, seed=seed))


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close_to_largest(got, want, tol=RTOL):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= tol * scale, (err, scale)


def test_configs_keep_the_reference_constants():
    assert fm.FM_SHAPES == jfm.FM_SHAPES
    assert fm.N_CANDIDATES == jfm.N_CANDIDATES
    assert fm.N_CANDIDATES_PAD == jfm.N_CANDIDATES_PAD == 1_000_448
    assert fm.SMOKE_VOCABS == jfm.SMOKE_VOCABS
    assert recsys.DEFAULT_VOCABS == jrecsys.DEFAULT_VOCABS
    full = fm.full_config()
    assert full.total_vocab == jfm.full_config().total_vocab == 29_333_260
    assert full.padded_vocab == 29_333_504
    np.testing.assert_array_equal(full.field_offsets,
                                  jfm.full_config().field_offsets)
    assert recsys.param_shapes(full) == jrecsys.param_shapes(
        jfm.full_config())
    for shape in fm.FM_SHAPES:
        for smoke in (True, False):
            want = jfm.fm_input_specs(jfm.full_config(), shape, smoke)
            got = fm.fm_input_specs(fm.full_config(), shape, smoke)
            assert {k: (s.shape, str(s.dtype)) for k, s in want.items()} == {
                k: (tuple(s), str(d).replace("torch.", ""))
                for k, (s, d) in got.items()}


@pytest.mark.parametrize("vocabs,b,seed", [("smoke", 64, 0), ("full", 128, 3)])
def test_click_batches_are_byte_equal_to_the_reference(vocabs, b, seed):
    vs = fm.SMOKE_VOCABS if vocabs == "smoke" else recsys.DEFAULT_VOCABS
    want = jbatches(vs, batch=b, seed=seed)
    got = synthetic_click_batches(vs, batch=b, seed=seed, device=CPU)
    for _ in range(3):
        w, g = next(want), next(got)
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == torch.int32
            assert g[k].numpy().tobytes() == w[k].tobytes(), k


def test_forward_loss_and_gradients_equal_the_reference(setup):
    jcfg, cfg, jparams, params = setup
    batch = _batch(jcfg, 256, seed=1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jlogits = jrecsys.forward(jcfg, jparams, jb["field_ids"])
    jloss, jgrads = jax.value_and_grad(
        lambda p: jrecsys.loss_fn(jcfg, p, jb))(jparams)
    tb = _t(batch)
    logits = recsys.forward(cfg, params, tb["field_ids"])
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss = recsys.loss_fn(cfg, leaves, tb)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    assert logits.dtype == torch.float32 and logits.shape == (256,)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=RTOL, atol=RTOL * float(
                                   np.abs(jlogits).max()))
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=RTOL)
    for k in ("w0", "w", "v"):
        assert grads[k].shape == tuple(np.shape(jgrads[k]))
        assert grads[k].dtype == torch.float32
        _close_to_largest(grads[k].numpy(), jgrads[k])
    # Dense gradients: rows no example touched are exact zeros in both.
    untouched = np.asarray(jgrads["w"]) == 0
    assert untouched.any()
    assert (grads["w"].numpy()[untouched] == 0).all()


def _brute_force_fm(cfg, params, field_ids):
    """O(F^2) pairwise-interaction oracle (the reference test's), in
    float64."""
    rows = np.asarray(field_ids) + cfg.field_offsets[None, :]
    v = params["v"].numpy().astype(np.float64)[rows]
    w = params["w"].numpy().astype(np.float64)[rows]
    out = float(params["w0"]) + w.sum(1)
    pair = np.zeros(len(rows))
    for i in range(v.shape[1]):
        for j in range(i + 1, v.shape[1]):
            pair += (v[:, i] * v[:, j]).sum(-1)
    return out + pair


def test_fm_matches_bruteforce(setup):
    _, cfg, _, params = setup
    rng = np.random.default_rng(0)
    ids = np.stack([rng.integers(0, v, 16) for v in cfg.vocab_sizes], 1)
    got = recsys.forward(cfg, params, torch.from_numpy(ids.astype(np.int32)))
    np.testing.assert_allclose(got.numpy(), _brute_force_fm(cfg, params, ids),
                               rtol=1e-4, atol=1e-5)


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 10_000))
def test_fm_matches_bruteforce_property(seed):
    cfg = fm.smoke_config()
    params = recsys.init_params(cfg, seed % 17, device=CPU)
    rng = np.random.default_rng(seed)
    ids = np.stack([rng.integers(0, v, 4) for v in cfg.vocab_sizes], 1)
    got = recsys.forward(cfg, params, torch.from_numpy(ids.astype(np.int32)))
    np.testing.assert_allclose(got.numpy(), _brute_force_fm(cfg, params, ids),
                               rtol=1e-3, atol=1e-4)


def test_init_params_are_seeded_normals_on_the_device():
    cfg = fm.smoke_config()
    a = recsys.init_params(cfg, 3, device=CPU)
    b = recsys.init_params(cfg, 3, device=CPU)
    c = recsys.init_params(cfg, 4, device=CPU)
    assert {k: tuple(v.shape) for k, v in a.items()} == \
        recsys.param_shapes(cfg)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["v"], c["v"])
    assert float(a["w0"]) == 0.0 and a["v"].dtype == torch.float32
    assert 0.005 < float(a["v"].std()) < 0.02


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_equals_the_reference(mode, weighted):
    """Three modes, per-sample weights, and an empty bag (bag 2): 0 under
    sum and mean, the max identity (-inf) under max, as the reference."""
    rng = np.random.default_rng(5)
    table = rng.standard_normal((10, 3)).astype(np.float32)
    ids = np.array([0, 1, 2, 5, 5, 9], np.int32)
    bags = np.array([0, 0, 1, 1, 3, 3], np.int32)
    w = (rng.random(6).astype(np.float32) + 0.5) if weighted else None
    want = jrecsys.embedding_bag(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(bags), 4, mode,
        weights=None if w is None else jnp.asarray(w))
    got = recsys.embedding_bag(
        torch.from_numpy(table), torch.from_numpy(ids),
        torch.from_numpy(bags), 4, mode,
        weights=None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    empty = got.numpy()[2]
    assert (empty == (-np.inf if mode == "max" else 0.0)).all()


def test_embedding_bag_reference_values():
    """The reference test's worked example."""
    table = torch.arange(20, dtype=torch.float32).reshape(10, 2)
    ids = torch.tensor([0, 1, 2, 5])
    bags = torch.tensor([0, 0, 1, 1])
    eb = recsys.embedding_bag
    assert eb(table, ids, bags, 2, "sum").tolist() == [[2, 4], [14, 16]]
    assert eb(table, ids, bags, 2, "mean").tolist() == [[1, 2], [7, 8]]
    assert eb(table, ids, bags, 2, "max").tolist() == [[2, 3], [10, 11]]
    ws = eb(table, ids, bags, 2, "sum",
            weights=torch.tensor([1.0, 2.0, 0.5, 0.5]))
    assert ws.tolist() == [[4, 7], [7, 8]]
    with pytest.raises(ValueError):
        eb(table, ids, bags, 2, "median")


@pytest.mark.parametrize("case", ["hot_rows", "vectors", "all_distinct",
                                  "one_run", "empty"])
def test_sorted_segment_sum_equals_the_reference(case):
    """``sorted_segment_sum`` against ``jax.ops.segment_sum`` within 1e-5 of
    the largest |sum| on Pareto-skewed ids (a run of 2^k + 1 entries takes
    every level of the tree and its gathers), and the same bits when called
    again, beside another tensor, and when the entries of other segments
    move."""
    rng = np.random.default_rng(7)
    n, segs = {"hot_rows": (3000, 50), "vectors": (2000, 40),
               "all_distinct": (257, 300), "one_run": (1025, 3),
               "empty": (0, 5)}[case]
    if case == "all_distinct":
        ids = rng.permutation(segs)[:n]
    elif case == "one_run":
        ids = np.full(n, 1)
    else:
        ids = np.minimum(rng.pareto(1.2, n).astype(np.int64), segs - 1)
    ids = ids.astype(np.int32)
    shape = (n, 3) if case == "vectors" else (n,)
    vals = rng.standard_normal(shape).astype(np.float32)
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(vals),
                                          jnp.asarray(ids), segs))
    got = recsys.sorted_segment_sum(torch.from_numpy(vals),
                                    torch.from_numpy(ids), segs)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    if n:
        _close_to_largest(got.numpy(), want)
    else:
        assert not got.any()
    again = recsys.sorted_segment_sum(torch.from_numpy(vals),
                                      torch.from_numpy(ids), segs)
    assert torch.equal(again, got)
    # Summed side by side with another tensor, through the same tree.
    other = rng.standard_normal((n, 2)).astype(np.float32)
    pair = recsys.sorted_segment_sums(
        [torch.from_numpy(vals), torch.from_numpy(other)],
        torch.from_numpy(ids), segs)
    assert torch.equal(pair[0], got)
    assert torch.equal(pair[1], recsys.sorted_segment_sum(
        torch.from_numpy(other), torch.from_numpy(ids), segs))
    # Entries of one segment keep their order; the others may move.
    order = np.argsort(ids % 2, kind="stable")
    moved = recsys.sorted_segment_sum(torch.from_numpy(vals[order]),
                                      torch.from_numpy(ids[order]), segs)
    assert torch.equal(moved, got)


def test_retrieval_scores_equal_the_reference(setup):
    jcfg, cfg, jparams, params = setup
    rng = np.random.default_rng(1)
    user = np.stack([rng.integers(0, v, 1) for v in cfg.vocab_sizes],
                    1).astype(np.int32)
    cand = rng.integers(0, cfg.total_vocab, 300).astype(np.int32)
    want = np.asarray(jrecsys.retrieval_scores(
        jcfg, jparams, jnp.asarray(user), jnp.asarray(cand)))
    got = recsys.retrieval_scores(cfg, params, torch.from_numpy(user),
                                  torch.from_numpy(cand)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())
    # Top-k sets equal; a boundary near-tie may swap only within RTOL.
    k = 20
    top_got = set(np.argsort(-got)[:k].tolist())
    top_want = set(np.argsort(-want)[:k].tolist())
    kth = np.sort(want)[-k]
    for i in top_got ^ top_want:
        assert abs(want[i] - kth) <= RTOL * np.abs(want).max()


def test_25_adamw_steps_equal_the_reference(setup):
    """The reference test's training run (lr 5e-2, 512 clicks a batch) on
    both packages from the same weights: the losses fall and the
    parameters stay within 1e-5 of the largest entry."""
    jcfg, cfg, jparams, params = setup
    jocfg = JAdamWConfig(lr=5e-2)
    ocfg = AdamWConfig(lr=5e-2)

    @jax.jit
    def jstep(p, o, batch):
        loss, g = jax.value_and_grad(
            lambda q: jrecsys.loss_fn(jcfg, q, batch))(p)
        p, o, _ = jupdate(jocfg, p, g, o)
        return p, o, loss

    jp, jo = jparams, jinit(jparams)
    tp = {k: v.clone() for k, v in params.items()}
    to = adamw_init(tp)
    jl, tl = [], []
    for b in _stream(cfg, 25):
        jp, jo, loss = jstep(jp, jo, {k: jnp.asarray(v) for k, v in b.items()})
        jl.append(float(loss))
        leaves = {k: v.requires_grad_(True) for k, v in tp.items()}
        loss = recsys.loss_fn(cfg, leaves, _t(b))
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
        tp, to, _ = adamw_update(ocfg, {k: v.detach() for k, v in
                                        leaves.items()}, grads, to)
        tl.append(float(loss))
    assert tl[-1] < tl[0] and jl[-1] < jl[0]
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    for k in ("w0", "w", "v"):
        _close_to_largest(tp[k].numpy(), jp[k])
    for k in ("w", "v"):
        _close_to_largest(to.mu[k].numpy(), jo.mu[k])
    assert int(to.step) == int(jo.step) == 25


def _stream(cfg, n, b=512, seed=0):
    it = jbatches(cfg.vocab_sizes, batch=b, seed=seed)
    return [next(it) for _ in range(n)]


def test_adamw_state_carries_across(setup):
    """Three steps in JAX, then the weights and the optimizer state carried
    across (``fm_params_from_numpy``, ``adamw_state_from_numpy("fm")``):
    three more steps in each package stay within 1e-5."""
    jcfg, cfg, jparams, _ = setup
    jocfg, ocfg = JAdamWConfig(lr=1e-2), AdamWConfig(lr=1e-2)
    grad = jax.jit(jax.value_and_grad(
        lambda p, b: jrecsys.loss_fn(jcfg, p, b)))
    jp, jo = jparams, jinit(jparams)
    batches = _stream(cfg, 6, b=128, seed=4)
    for b in batches[:3]:
        _, g = grad(jp, {k: jnp.asarray(v) for k, v in b.items()})
        jp, jo, _ = jupdate(jocfg, jp, g, jo)
    tp = fm_params_from_numpy(np_tree(jp), CPU)
    to = adamw_state_from_numpy("fm", jo.step, np_tree(jo.mu),
                                np_tree(jo.nu), CPU)
    assert int(to.step) == 3 and set(to.mu) == {"w0", "w", "v"}
    for b in batches[3:]:
        _, g = grad(jp, {k: jnp.asarray(v) for k, v in b.items()})
        jp, jo, _ = jupdate(jocfg, jp, g, jo)
        leaves = {k: v.requires_grad_(True) for k, v in tp.items()}
        loss = recsys.loss_fn(cfg, leaves, _t(b))
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
        tp, to, _ = adamw_update(ocfg, {k: v.detach()
                                        for k, v in leaves.items()},
                                 grads, to)
    for k in ("w0", "w", "v"):
        _close_to_largest(tp[k].numpy(), jp[k])


@pytest.mark.parametrize("shape", list(fm.FM_SHAPES))
def test_build_step_equals_the_plain_functions(shape):
    """``ARCH.build_step`` at world size 1 (no collective) computes the
    plain FM: the train step is ``loss_fn``'s loss and gradients and one
    ``adamw_update``; serve is ``forward``; retrieval is
    ``retrieval_scores`` (all bit for bit)."""
    arch = fm.ARCH
    cfg = arch.smoke_config()
    group = ShardGroup.single(CPU)
    model = arch.init_model(shape, seed=2, smoke=True, device=CPU)
    batch = arch.make_batch(shape, seed=3, smoke=True, device=CPU)
    specs = arch.input_specs(shape, smoke=True)
    assert {k: (tuple(v.shape), v.dtype) for k, v in batch.items()} == {
        k: (s, d) for k, (s, d) in specs.items()}
    params = {k: p.detach().clone() for k, p in model.params().items()}
    step = arch.build_step(shape, group, smoke=True)
    kind = fm.FM_SHAPES[shape][1]
    if kind == "serve":
        want = recsys.forward(cfg, params, batch["field_ids"])
        assert torch.equal(step(model, batch), want)
        assert torch.equal(model(batch["field_ids"]).detach(), want)
        return
    if kind == "retrieval":
        want = recsys.retrieval_scores(cfg, params, batch["user_fields"],
                                       batch["cand_rows"])
        assert torch.equal(step(model, batch), want)
        assert want.shape == (1024,)
        return
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss = recsys.loss_fn(cfg, leaves, batch)
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    want_p, _, _ = adamw_update(AdamWConfig(), params, grads,
                                adamw_init(params))
    got_loss, got_grads = step.loss_and_grads(model, batch)
    assert torch.equal(got_loss, loss.detach())
    assert all(torch.equal(got_grads[k], grads[k]) for k in grads)
    opt, got = step(model, adamw_init(model), batch)
    assert torch.equal(got, loss.detach()) and int(opt.step) == 1
    for k, p in model.params().items():
        assert torch.equal(p.detach(), want_p[k]), k


def test_make_batch_follows_the_seed():
    a = fm.ARCH.make_batch("serve_p99", 7, smoke=True, device=CPU)
    b = fm.ARCH.make_batch("serve_p99", 7, smoke=True, device=CPU)
    want = next(jbatches(fm.SMOKE_VOCABS, 32, 7))["field_ids"]
    assert torch.equal(a["field_ids"], b["field_ids"])
    assert a["field_ids"].numpy().tobytes() == want.tobytes()


def test_shard_holds_the_rank_rows():
    model = fm.ARCH.init_model("train_batch", seed=1, smoke=True, device=CPU)
    n = model.w.shape[0]
    parts = [model.shard(r, RANKS) for r in range(RANKS)]
    assert [p.row_lo for p in parts] == [r * n // RANKS for r in range(RANKS)]
    assert torch.equal(torch.cat([p.v.detach() for p in parts]),
                       model.v.detach())
    assert all(torch.equal(p.w0, model.w0) for p in parts)
    with pytest.raises(ValueError):
        model.shard(0, 3)


def test_param_split_equals_the_reference_and_shard_follows_it():
    """``fm_param_split`` is the reference's ``fm_param_pspecs`` (the split
    dimension is the one over the ``model`` axis), and ``FM.shard`` cuts
    each parameter by it."""
    from repro.compat import make_mesh
    from repro.sharding import rules as jrules
    from repro_torch.sharding import rules
    mesh = make_mesh((1, 1), ("data", "model"))
    want = jrules.fm_param_pspecs(mesh)
    split = rules.fm_param_split()
    assert set(split) == set(want)
    for k, p in want.items():
        axes = list(p)
        assert split[k] == (axes.index("model") if "model" in axes
                            else None), k
    model = fm.ARCH.init_model("train_batch", seed=2, smoke=True, device=CPU)
    part = model.w.shape[0] // RANKS
    for r in range(RANKS):
        sh = model.shard(r, RANKS)
        for k, p in model.params().items():
            dim = split[k]
            want_p = p if dim is None else p.narrow(dim, r * part, part)
            assert torch.equal(sh.params()[k], want_p.detach()), (r, k)


# ---------------------------------------------------------------------------
# Four gloo ranks, the table split four ways, against world size 1.
# ---------------------------------------------------------------------------

_SHAPES = ("train_batch", "serve_p99", "retrieval_cand")


def _loaded(tree):
    """A rank result with each saved ``.npy`` path read back."""
    if isinstance(tree, dict):
        return {k: _loaded(v) for k, v in tree.items()}
    return np.load(tree) if isinstance(tree, str) else tree


@pytest.fixture(scope="module")
def ranks_case(tmp_path_factory):
    """One spawned launch of 4 gloo CPU ranks (their arrays saved to
    ``.npy`` files, as the full-width run on the card does) and the same
    runs at world size 1 in process (arrays returned)."""
    arch = fm.ARCH
    model = arch.init_model("train_batch", seed=5, smoke=True, device=CPU)
    params = {k: p.detach().numpy().copy() for k, p in model.params().items()}
    runs = []
    for i, shape in enumerate(_SHAPES):
        batch = arch.make_batch(shape, seed=10 + i, smoke=True, device=CPU)
        runs.append({"shape": shape, "smoke": True, "params": params,
                     "batch": {k: v.numpy() for k, v in batch.items()},
                     "steps": 2, "lr": 1e-2})
    out_dir = str(tmp_path_factory.mktemp("fm-ranks"))
    out = collectives.launch(fm.fm_rank_runs, RANKS, runs, out_dir,
                             devices=[CPU] * RANKS, timeout=RANK_TIMEOUT)
    assert all(isinstance(o[1]["out"], str) for o in out)
    out = [[_loaded(r) for r in o] for o in out]
    world1 = fm.fm_rank_runs(ShardGroup.single(CPU), runs)
    assert isinstance(world1[1]["out"], np.ndarray)
    return runs, out, world1


@pytest.mark.parametrize("shape", _SHAPES)
def test_four_gloo_ranks_equal_world_size_one(ranks_case, shape):
    runs, out, world1 = ranks_case
    i = _SHAPES.index(shape)
    one = world1[i]
    per = [out[r][i] for r in range(RANKS)]
    if fm.FM_SHAPES[shape][1] != "train":
        got = np.concatenate([p["out"] for p in per])
        _close_to_largest(got, one["out"])
        return
    for p in per:
        assert p["loss"] == pytest.approx(one["loss"], rel=RTOL)
        assert p["losses"] == pytest.approx(one["losses"], rel=RTOL)
    for k in ("w", "v"):
        _close_to_largest(np.concatenate([p["grads"][k] for p in per]),
                          one["grads"][k])
        _close_to_largest(np.concatenate([p["params"][k] for p in per]),
                          one["params"][k])
    for p in per:
        _close_to_largest(p["grads"]["w0"], one["grads"]["w0"])
        _close_to_largest(p["params"]["w0"], one["params"]["w0"])


# ---------------------------------------------------------------------------
# One gloo rank in a process group runs the row-split step.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def one_rank_case(tmp_path_factory, ranks_case):
    """``ranks_case``'s runs through a gloo process group of one rank in
    this process (the row-split step: ids all-gathered, partials
    reduce-scattered), with the collectives it ran."""
    runs, _, world1 = ranks_case
    store = tmp_path_factory.mktemp("fm-one-rank") / "store"
    group = ShardGroup.init("gloo", 0, 1, f"file://{store}", device=CPU)
    try:
        out = fm.fm_rank_runs(group, runs)
        n_coll = group.collectives
    finally:
        group.destroy()
    return out, world1, n_coll


@pytest.mark.parametrize("shape", _SHAPES)
def test_one_rank_process_group_equals_the_plain_step(one_rank_case, shape):
    out, world1, n_coll = one_rank_case
    assert n_coll > 0
    i = _SHAPES.index(shape)
    got, one = out[i], world1[i]
    if fm.FM_SHAPES[shape][1] != "train":
        _close_to_largest(got["out"], one["out"])
        return
    assert got["loss"] == pytest.approx(one["loss"], rel=RTOL)
    assert got["losses"] == pytest.approx(one["losses"], rel=RTOL)
    for k in ("w0", "w", "v"):
        _close_to_largest(got["grads"][k], one["grads"][k])
        _close_to_largest(got["params"][k], one["params"][k])
