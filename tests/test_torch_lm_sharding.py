"""LM sharding of the PyTorch port (``sharding/rules.py``'s LM rules,
``collectives.RankGrid``, the tensor-, expert- and sequence-parallel paths
of ``models/{transformer,layers,moe,mla}.py``, ``configs/lm_common``'s
``make_sharded_ce``, ``build_lm_step`` over a grid and ``lm_rank_runs``)
against the JAX package on the CPU.

  - The split rules equal the reference's ``PartitionSpec``s leaf by leaf
    and dimension by dimension, on stand-in meshes (the rules read only
    ``shape`` and ``axis_names``).
  - One spawned launch of 4 gloo CPU ranks per grid, (2, 2) and (1, 4),
    runs the qwen2, mixtral and deepseek smoke configs (and at (1, 4) a
    2-expert mixtral, whose experts split by ``d_ff``; mixtral drops
    assignments by capacity): two AdamW steps in the dense, ``sharded_ce``
    and ``tp_only_params`` variants, prefill, and three decode steps in
    the sequence-split, ``naive_cache``, ``int8_kv`` and batch-1
    ``long_500k`` layouts.  Each is held against the one-rank step and
    against the reference's step on a 1 x 1 mesh: losses within 1e-5
    relative, first-step gradients within 1e-4 of each tensor's largest
    entry, parameters after two steps within ``ADAM_ATOL`` x lr, logits
    within 1e-4 of the largest (partials summed over ranks in another
    order).  The reference's ``tp_only_params`` and ``naive_cache`` are
    layouts of the same function, so on its 1 x 1 mesh they are held to
    its plain step.
  - Faults F2-F4: MoE routing ties, the ``sharded_ce`` loss with ignored
    labels, and decode past the cache's end.
"""

import dataclasses
import itertools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:         # optional dev dep — see tests/_hypothesis_fallback
    from _hypothesis_fallback import given, settings, st

from repro.compat import make_mesh
from repro.configs import lm_common as jlm
from repro.configs.registry import ALL_ARCHS as J_ARCHS
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.sharding import rules as jrules

from repro_torch.configs import lm_common
from repro_torch.configs.registry import get_arch
from repro_torch.core import collectives
from repro_torch.core.collectives import RankGrid, ShardGroup
from repro_torch.interop import lm_params_from_numpy, lm_tree_assemble
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.sharding import rules

CPU = "cpu"
RANKS = 4
RANK_TIMEOUT = 240
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
LOGIT_RTOL = 1e-4
#: Parameters after AdamW steps, in units of the learning rate (as in
#: ``test_torch_lm_launch.py``).
ADAM_ATOL = 0.05
LR = 1e-3
#: AdamW's eps and clip in the grid runs.  With the default eps (1e-8) a
#: gradient entry near zero (~1e-9 of 0.03, float32 noise of sums in
#: another order) sets the sign of its step; eps 1e-3 makes the step
#: Lipschitz in the gradient, so the parameters check the optimizer state
#: rather than that noise.  The clip at 0.05 is below every case's global
#: norm, so each step reads the norm summed over the ranks.
OPT = dict(lr=LR, eps=1e-3, grad_clip=0.05)
LM_IDS = ["gemma3-12b", "qwen2-1.5b", "internlm2-20b", "mixtral-8x22b",
          "deepseek-v2-236b"]
B, S, MAX_LEN, DECODE_AT = 4, 32, 64, 40


class Mesh:
    """A stand-in mesh: the split rules read only these two fields."""

    def __init__(self, shape, names=("data", "model")):
        self.shape = dict(zip(names, shape))
        self.axis_names = tuple(names)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# The split rules against the reference's PartitionSpecs
# ---------------------------------------------------------------------------

MESHES = [((1, 1), ("data", "model")), ((2, 2), ("data", "model")),
          ((1, 4), ("data", "model")), ((4, 1), ("data", "model")),
          ((2, 2, 2), ("pod", "data", "model"))]
RULE_CONFIGS = [(aid, False) for aid in LM_IDS] + [("mixtral-8x22b", True)]


def _as_split(pspec, ndim):
    entries = tuple(pspec) + (None,) * (ndim - len(tuple(pspec)))
    return tuple(rules._axes(e) for e in entries)


def _same_leaves(got, want, shapes, what):
    if isinstance(shapes, dict):
        assert set(got) == set(want) == set(shapes), what
        for k in shapes:
            _same_leaves(got[k], want[k], shapes[k], (what, k))
    elif isinstance(shapes, list):
        assert len(got) == len(want) == len(shapes), what
        for i, sh in enumerate(shapes):
            _same_leaves(got[i], want[i], sh, (what, i))
    else:
        assert got == _as_split(want, len(shapes)), (what, got, want)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m[0])))
@pytest.mark.parametrize("aid,full", RULE_CONFIGS,
                         ids=[f"{a}{'-full' if f else ''}"
                              for a, f in RULE_CONFIGS])
def test_split_rules_equal_the_reference(aid, full, mesh):
    m = Mesh(*mesh)
    jarch = J_ARCHS[aid]
    jcfg = jarch.full_config() if full else jarch.smoke_config()
    arch = get_arch(aid)
    cfg = arch.full_config() if full else arch.smoke_config()
    shapes = tf.param_shapes(cfg)
    for fsdp in (True, False):
        _same_leaves(rules.lm_param_split(cfg, m, fsdp),
                     jrules.lm_param_pspecs(jcfg, m, fsdp=fsdp), shapes,
                     ("params", fsdp))
    got = rules.lm_batch_split(m)
    want = jrules.lm_batch_pspecs(m)
    _same_leaves(got, want, {"tokens": (B, S), "labels": (B, S)}, "batch")
    for int8, seq_shard, model_seq in itertools.product(
            (False, True), (False, True), (False, True)):
        kv = "int8" if int8 else "bf16"
        c = dataclasses.replace(cfg, kv_cache_dtype=kv)
        jc = dataclasses.replace(jcfg, kv_cache_dtype=kv)
        _same_leaves(
            rules.lm_cache_split(c, m, seq_shard, model_seq),
            jrules.lm_cache_pspecs(jc, m, seq_shard=seq_shard,
                                   model_seq_shard=model_seq),
            tf.cache_shapes(c, B, MAX_LEN),
            ("cache", int8, seq_shard, model_seq))
    assert rules.dp_axes(m) == jrules.dp_axes(m)
    assert rules.shards_experts(cfg, m) == (
        cfg.moe is not None and cfg.moe.n_experts >= m.shape["model"])


@settings(deadline=None, max_examples=30)
@given(st.data())
def test_shares_reassemble_the_whole(data):
    """``share`` at every coordinate, then ``assemble``, gives the array
    back; a share is row-major over its axes, as a ``PartitionSpec``
    lists them."""
    names = data.draw(st.sampled_from([("data", "model"),
                                       ("pod", "data", "model")]))
    shape = tuple(data.draw(st.integers(1, 3)) for _ in names)
    grid = Mesh(shape, names)
    ndim = data.draw(st.integers(1, 3))
    free = list(names)
    split, dims = [], []
    for _ in range(ndim):
        k = data.draw(st.integers(0, len(free)))
        axes = tuple(data.draw(st.permutations(free))[:k]) if k else ()
        free = [a for a in free if a not in axes]
        split.append(axes or None)
        n = int(np.prod([grid.shape[a] for a in axes])) if axes else 1
        dims.append(n * data.draw(st.integers(1, 3)))
    split = tuple(split)
    x = np.arange(int(np.prod(dims))).reshape(dims)
    shares = [rules.share(x, split, grid, c) for c in rules.grid_coords(grid)]
    assert np.array_equal(rules.assemble(shares, split, grid), x)
    # Each dimension's part is indexed row-major by its axes.
    for c, part in zip(rules.grid_coords(grid), shares):
        want = x
        for dim, axes in enumerate(split):
            if axes:
                idx = 0
                for a in axes:
                    idx = idx * grid.shape[a] + c[a]
                size = part.shape[dim]
                want = np.take(want, range(idx * size, (idx + 1) * size),
                               axis=dim)
        assert np.array_equal(part, want)


# ---------------------------------------------------------------------------
# The grid
# ---------------------------------------------------------------------------

def test_a_grid_needs_the_groups_size():
    pair = ShardGroup(0, 2, torch.device(CPU), "gloo")
    with pytest.raises(ValueError, match="holds 4 ranks; the group has 2"):
        RankGrid(pair, (2, 2))
    with pytest.raises(ValueError, match="'model' axis"):
        RankGrid(pair, (2,), ("data",))
    single = RankGrid.single(CPU)
    assert single.shape == {"data": 1, "model": 1}
    for sub in (single.dp, single.model, single.everyone):
        assert (sub.rank, sub.world_size, sub.group) == (0, 1, None)


@pytest.mark.parametrize("shape,names", [
    ((1, 4), ("data", "model")), ((4, 1), ("data", "model")),
    ((1, 4, 1), ("pod", "data", "model")),
    ((4, 1, 1), ("pod", "data", "model"))])
def test_grid_coordinates_are_row_major(shape, names):
    """A grid whose one axis spans the world reuses the parent group and
    needs no new process group, so it builds without one here."""
    for r in range(RANKS):
        grid = RankGrid(ShardGroup(r, RANKS, torch.device(CPU), "gloo"),
                        shape, names)
        assert collectives.mesh_rank(
            [grid.coords[a] for a in grid.axis_names], shape) == r
        assert grid.dp_axes == rules.dp_axes(grid) == names[:-1]
        assert grid.model.world_size == shape[-1]
        assert grid.dp.world_size == RANKS // shape[-1]
        assert grid.model.rank == grid.coords["model"]
        assert grid.dp.rank == collectives.mesh_rank(
            [grid.coords[a] for a in names[:-1]], shape[:-1])
        assert grid.everyone.rank == r


# ---------------------------------------------------------------------------
# Faults F2-F4
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("after_topk", [False, True])
def test_f2_tied_router_equals_the_reference(after_topk):
    """A zero router ties every expert: both packages route each token to
    experts 0 and 1 (the lowest indices)."""
    rng = np.random.default_rng(0)
    t, d, e, f = 16, 8, 8, 12
    x = rng.standard_normal((t, d)).astype(np.float32)
    w = {"router": np.zeros((d, e), np.float32),
         "w_gate": rng.standard_normal((e, d, f)).astype(np.float32),
         "w_up": rng.standard_normal((e, d, f)).astype(np.float32),
         "w_down": rng.standard_normal((e, f, d)).astype(np.float32)}
    want = jmoe.moe_ffn(jnp.asarray(x), jmoe.MoEParams(
        **{k: jnp.asarray(v) for k, v in w.items()}), top_k=2,
        router_softmax_after_topk=after_topk)
    got = moe.moe_ffn(torch.from_numpy(x), moe.MoEParams(
        **{k: torch.from_numpy(v) for k, v in w.items()}), top_k=2,
        router_softmax_after_topk=after_topk)
    assert rel(got.numpy(), want) <= 1e-5
    assert moe._top_k(torch.zeros(3, e), 2)[1].tolist() == [[0, 1]] * 3


def _f3_batch(vocab):
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, vocab, (B, 16)).astype(np.int32)
    labels = rng.integers(0, vocab, (B, 16)).astype(np.int32)
    for row in labels:
        row[rng.choice(16, 5, replace=False)] = -1
    return {"tokens": tokens, "labels": labels}


_QWEN = {}


def _qwen():
    """qwen2's smoke configs, the reference's weights on both sides, and
    the reference's ``make_sharded_ce`` value and gradients on F3's batch
    (a 1 x 1 mesh)."""
    if not _QWEN:
        jcfg = J_ARCHS["qwen2-1.5b"].smoke_config()
        jp = jtf.init_params(jcfg, jax.random.PRNGKey(0))
        batch = _f3_batch(jcfg.vocab)
        mesh = make_mesh((1, 1), ("data", "model"))
        jloss_of = jlm.make_sharded_ce(jcfg, mesh)
        with mesh:
            jloss, jg = jax.value_and_grad(lambda p: jloss_of(p, batch))(jp)
        _QWEN.update(jcfg=jcfg, cfg=get_arch("qwen2-1.5b").smoke_config(),
                     jp=jp, pn=np_tree(jp), batch=batch, jloss=float(jloss),
                     jg=tf.flat_params(np_tree(jg)),
                     params=lm_params_from_numpy(np_tree(jp), CPU))
    return _QWEN


@pytest.fixture(scope="module")
def qwen():
    return _qwen()


F3_GRID = (2, 2)


def _f3_run():
    q = _qwen()
    return dict(cfg=q["cfg"], shape="train_4k", grid=F3_GRID,
                params=q["pn"], variant=("sharded_ce",), batches=[q["batch"]])


def test_f3_sharded_ce_equals_the_reference_at_one_rank(qwen):
    """``"sharded_ce"`` counts every position and adds ``lse`` for an
    ignored label, as the reference's ``make_sharded_ce`` does; the plain
    loss masks them."""
    batch = qwen["batch"]
    jloss, jg = qwen["jloss"], qwen["jg"]
    dense = float(jtf.loss_fn(qwen["jcfg"], qwen["jp"], batch))
    step = lm_common.build_lm_step(qwen["cfg"], "train_4k",
                                   ShardGroup.single(CPU),
                                   variant=("sharded_ce",),
                                   smoke_shapes=True)
    loss, grads = step.loss_and_grads(
        qwen["params"], {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(loss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    assert abs(float(loss) - dense) > 1e-2
    for k, g in grads.items():
        assert rel(g.numpy(), jg[k]) <= GRAD_RTOL, k
    plain = lm_common.build_lm_step(qwen["cfg"], "train_4k",
                                    ShardGroup.single(CPU),
                                    smoke_shapes=True)
    lp, _ = plain.loss_and_grads(
        qwen["params"], {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(lp) - dense) <= LOSS_RTOL * dense


def test_f4_decode_past_the_end_raises_and_writes_nothing(qwen):
    """At the last position the step equals the reference's; one past it
    the port refuses before any write (the reference clamps and overwrites
    the last position)."""
    cfg, jcfg = qwen["cfg"], qwen["jcfg"]
    n = 8
    cache = lm_common.random_cache(cfg, 2, n, 5, CPU)
    jcache = np_tree(jax.tree.map(jnp.asarray, jax.tree.map(
        lambda x: x.numpy(), cache)))
    tok = np.array([[3], [7]], np.int32)
    want, _ = jtf.decode_step(jcfg, qwen["jp"], jcache, tok, jnp.int32(n - 1))
    got, _ = tf.decode_step(cfg, qwen["params"], cache,
                            torch.from_numpy(tok), n - 1)
    assert rel(got.numpy(), want) <= LOGIT_RTOL
    before = {k: x.clone() for k, x in cache["slots"][0].items()}
    for at in (n, torch.tensor(n, dtype=torch.int32), n + 5, -1):
        with pytest.raises(ValueError, match=f"cache of {n} positions"):
            tf.decode_step(cfg, qwen["params"], cache, torch.from_numpy(tok),
                           at)
    for k, x in cache["slots"][0].items():
        assert x.numpy().tobytes() == before[k].numpy().tobytes()


def test_f4_checks_the_global_length_on_a_grid(qwen):
    """A rank's share holds 16 of 64 positions: 64 is refused, with the
    global length in the message."""
    cfg = qwen["cfg"]
    grid = RankGrid(ShardGroup(0, RANKS, torch.device(CPU), "gloo"),
                    (1, RANKS))
    full = lm_common.random_cache(cfg, 2, 64, 5, CPU)
    split = rules.lm_cache_split(cfg, grid)
    cache = {"slots": [{k: rules.share(x, split["slots"][i][k], grid)
                        for k, x in slot.items()}
                       for i, slot in enumerate(full["slots"])]}
    assert cache["slots"][0]["k"].shape[2] == 16
    params = lm_params_from_numpy(qwen["pn"], CPU, cfg=cfg, grid=grid)
    with pytest.raises(ValueError, match="position 64 of a cache of 64"):
        tf.decode_step(cfg, params, cache, torch.zeros((2, 1), dtype=torch.int32),
                       64, grid)


@pytest.mark.parametrize("shape", [(1, 1), (1, RANKS)])
def test_f4_a_grid_fails_on_a_card_position_past_the_end(qwen, monkeypatch,
                                                         shape):
    """A 0-d tensor ``cache_len`` at the global length: on the host it is
    refused with ``ValueError``; as a card tensor (not read on the host)
    the step's device assertion fails before any write, where the grid's
    write would otherwise fall on no rank and be dropped."""
    cfg = qwen["cfg"]
    grid = RankGrid(ShardGroup(0, math.prod(shape), torch.device(CPU),
                               "gloo"), shape)
    full = lm_common.random_cache(cfg, 2, 64, 5, CPU)
    split = rules.lm_cache_split(cfg, grid)
    cache = {"slots": [{k: rules.share(x, split["slots"][i][k], grid)
                        for k, x in slot.items()}
                       for i, slot in enumerate(full["slots"])]}
    before = [{k: x.clone() for k, x in slot.items()}
              for slot in cache["slots"]]
    params = lm_params_from_numpy(qwen["pn"], CPU, cfg=cfg, grid=grid)
    tok = torch.zeros((2, 1), dtype=torch.int32)
    at = torch.tensor(64, dtype=torch.int32)
    with pytest.raises(ValueError, match="position 64 of a cache of 64"):
        tf.decode_step(cfg, params, cache, tok, at, grid)
    monkeypatch.setattr(tf, "_host_int", lambda value: None)
    with pytest.raises(RuntimeError, match="single nonzero value"):
        tf.decode_step(cfg, params, cache, tok, at, grid)
    for slot, old in zip(cache["slots"], before):
        for k, x in slot.items():
            assert x.numpy().tobytes() == old[k].numpy().tobytes(), k


# ---------------------------------------------------------------------------
# Spawned grids against one rank and the reference
# ---------------------------------------------------------------------------

def _config(name):
    """(JAX config, port config) of a case."""
    aid = {"qwen": "qwen2-1.5b", "mixtral": "mixtral-8x22b",
           "deepseek": "deepseek-v2-236b", "mixtral2e": "mixtral-8x22b"}[name]
    jcfg, cfg = J_ARCHS[aid].smoke_config(), get_arch(aid).smoke_config()
    if name.startswith("mixtral"):
        # Capacity below the assignments: drops are certain in training.
        n_e = 2 if name == "mixtral2e" else jcfg.moe.n_experts
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, n_experts=n_e, capacity_factor=0.5))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=n_e, capacity_factor=0.5))
    return jcfg, cfg


TRAIN_VARIANTS = {"dense": (), "sharded_ce": ("sharded_ce",),
                  "tp_only": ("tp_only_params",)}
DECODE_LAYOUTS = {"seq": ((), "decode_32k"),
                  "naive": (("naive_cache",), "decode_32k"),
                  "int8": (("int8_kv",), "decode_32k"),
                  "long": ((), "long_500k")}
GRID_CASES = {(2, 2): ("qwen", "mixtral", "deepseek"),
              (1, 4): ("qwen", "mixtral", "deepseek", "mixtral2e")}


def _case_inputs(name):
    """The reference's weights and the case's batches, from seeds."""
    jcfg, cfg = _config(name)
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(1))
    rng = np.random.default_rng(11)
    v = cfg.vocab

    def batch():
        return {"tokens": rng.integers(0, v, (B, S)).astype(np.int32),
                "labels": rng.integers(0, v, (B, S)).astype(np.int32)}

    train = [batch(), batch()]
    ignored = [batch(), batch()]
    for b in ignored:
        b["labels"][rng.random((B, S)) < 0.3] = -1
    decode = {}
    for layout, (variant, shape) in DECODE_LAYOUTS.items():
        bs = 1 if shape == "long_500k" else B
        decode[layout] = [(rng.integers(0, v, (bs, 1)).astype(np.int32),
                           DECODE_AT + j) for j in range(3)]
    return dict(jcfg=jcfg, cfg=cfg, jp=jp, pn=np_tree(jp), train=train,
                ignored=ignored, prefill={"tokens": train[0]["tokens"]},
                decode=decode)


def _runs(inp, grid):
    runs = []
    for vname, variant in TRAIN_VARIANTS.items():
        runs.append(dict(cfg=inp["cfg"], shape="train_4k", grid=grid,
                         params=inp["pn"], variant=variant, opt=OPT,
                         batches=inp["ignored" if vname == "sharded_ce"
                                     else "train"]))
    runs.append(dict(cfg=inp["cfg"], shape="prefill_32k", grid=grid,
                     params=inp["pn"], batch=inp["prefill"]))
    for layout, (variant, shape) in DECODE_LAYOUTS.items():
        runs.append(dict(cfg=inp["cfg"], shape=shape, grid=grid,
                         params=inp["pn"], variant=variant, cache_seed=7,
                         max_len=MAX_LEN,
                         batch_size=1 if shape == "long_500k" else B,
                         steps=inp["decode"][layout]))
    return runs


def _reference(inp):
    """The reference's results on a 1 x 1 mesh: per train variant the
    first gradients, both losses and the parameters after two steps; the
    prefill's last logits; per decode layout the three steps' logits."""
    jcfg, jp = inp["jcfg"], inp["jp"]
    mesh = make_mesh((1, 1), ("data", "model"))
    out = {}
    opt = JAdamWConfig(warmup_steps=1, total_steps=2, **OPT)
    update = jax.jit(lambda p, g, o: jadamw_update(opt, p, g, o)[:2])
    for vname, variant in TRAIN_VARIANTS.items():
        if vname == "tp_only":
            out[vname] = out["dense"]
            continue
        batches = inp["ignored" if vname == "sharded_ce" else "train"]
        # The reference's train step (build_lm_step's): value_and_grad of
        # the variant's loss, then adamw_update; its first gradients kept.
        loss_of = (jlm.make_sharded_ce(jcfg, mesh) if variant
                   else lambda p, b: jtf.loss_fn(jcfg, p, b))
        grad_of = jax.jit(jax.value_and_grad(loss_of))
        p, o, losses, first = jp, jadamw_init(jp), [], None
        with mesh:
            for b in batches:
                loss, g = grad_of(p, b)
                first = g if first is None else first
                p, o = update(p, g, o)
                losses.append(float(loss))
        out[vname] = dict(grads=tf.flat_params(np_tree(first)),
                          losses=losses, params=tf.flat_params(np_tree(p)))
    out["prefill"] = np.asarray(
        jtf.forward(jcfg, jp, inp["prefill"]["tokens"])[:, -1])
    fns = {}
    for layout, (variant, shape) in DECODE_LAYOUTS.items():
        cfg = inp["cfg"]
        if "int8_kv" in variant and cfg.mla is None:
            cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
        jc = dataclasses.replace(jcfg, kv_cache_dtype=cfg.kv_cache_dtype)
        bs = 1 if shape == "long_500k" else B
        cache = jax.tree.map(
            lambda x: jnp.asarray(x.numpy()),
            lm_common.random_cache(cfg, bs, MAX_LEN, 7, CPU))
        key = jc.kv_cache_dtype
        if key not in fns:
            fns[key] = jax.jit(lambda p, c, t, n, jc=jc: jtf.decode_step(
                jc, p, c, t, n))
        logits = []
        for tok, at in inp["decode"][layout]:
            lo, cache = fns[key](jp, cache, tok, jnp.int32(at))
            logits.append(np.asarray(lo))
        out[layout] = logits
    return out


_INPUTS, _REFS = {}, {}


def _inputs(name):
    if name not in _INPUTS:
        _INPUTS[name] = _case_inputs(name)
    return _INPUTS[name]


def _ref(name):
    if name not in _REFS:
        _REFS[name] = _reference(_inputs(name))
    return _REFS[name]


_LAUNCHED = {}


def _launched(grid):
    """One spawned launch of 4 gloo ranks for every case of ``grid``, and
    the same runs on one rank: ``{case: (rank results, one-rank
    results)}``."""
    if grid not in _LAUNCHED:
        names = GRID_CASES[grid]
        runs = [r for n in names for r in _runs(_inputs(n), grid)]
        per = len(runs) // len(names)
        if grid == F3_GRID:
            runs.append(_f3_run())
        out = collectives.launch(lm_common.lm_rank_runs, RANKS, runs,
                                 devices=[CPU] * RANKS,
                                 timeout=RANK_TIMEOUT)
        one = lm_common.lm_rank_runs(
            ShardGroup.single(CPU),
            [dict(r, grid=(1, 1)) for r in runs[:per * len(names)]])
        _LAUNCHED[grid] = {
            n: ([o[i * per:(i + 1) * per] for o in out],
                one[i * per:(i + 1) * per]) for i, n in enumerate(names)}
        if grid == F3_GRID:
            _LAUNCHED[grid]["f3"] = [o[-1] for o in out]
    return _LAUNCHED[grid]


def _cases(kinds):
    return [(g, n, k) for g, names in GRID_CASES.items() for n in names
            for k in kinds]


def _id(case):
    g, n, k = case
    return f"{g[0]}x{g[1]}-{n}-{k}"


@pytest.mark.parametrize("case", _cases(TRAIN_VARIANTS), ids=_id)
def test_train_on_a_grid_equals_one_rank_and_the_reference(case):
    grid, name, vname = case
    ranks, one = _launched(grid)[name]
    i = list(TRAIN_VARIANTS).index(vname)
    ranks, one = [r[i] for r in ranks], one[i]
    want = _ref(name)[vname]
    inp = _inputs(name)
    mesh = Mesh(grid)
    split = lm_common.flat_split(inp["cfg"], mesh,
                                 "tp_only_params" not in TRAIN_VARIANTS[vname])
    assert [r["coords"] for r in ranks] == rules.grid_coords(mesh)
    for r in ranks:
        assert r["losses"] == ranks[0]["losses"]
        for j, jl in enumerate(want["losses"]):
            assert abs(r["losses"][j] - jl) <= LOSS_RTOL * abs(jl)
            assert abs(r["losses"][j] - one["losses"][j]) <= (
                LOSS_RTOL * abs(jl))
        assert abs(r["loss"] - want["losses"][0]) <= (
            LOSS_RTOL * abs(want["losses"][0]))
    norm = np.sqrt(sum(float(np.sum(np.square(g, dtype=np.float64)))
                       for g in want["grads"].values()))
    assert norm > OPT["grad_clip"], norm
    for k, g in want["grads"].items():
        got = lm_tree_assemble([r["grads"][k] for r in ranks], split[k],
                               mesh)
        assert rel(got, g) <= GRAD_RTOL, (k, rel(got, g))
        assert rel(got, one["grads"][k]) <= GRAD_RTOL, k
    for k, p in want["params"].items():
        got = lm_tree_assemble([r["params"][k] for r in ranks], split[k],
                               mesh)
        assert float(np.abs(got - p).max()) <= ADAM_ATOL * LR, k
        assert float(np.abs(got - one["params"][k]).max()) <= ADAM_ATOL * LR
    if vname == "sharded_ce":
        # The ignored labels count: the dense loss of this batch differs.
        dense = float(jtf.loss_fn(inp["jcfg"], inp["jp"], inp["ignored"][0]))
        assert abs(ranks[0]["loss"] - dense) > 1e-3


@pytest.mark.parametrize("case", _cases(["prefill"]), ids=_id)
def test_prefill_on_a_grid_equals_one_rank_and_the_reference(case):
    grid, name, _ = case
    ranks, one = _launched(grid)[name]
    i = len(TRAIN_VARIANTS)
    mesh = Mesh(grid)
    got = rules.assemble([r[i]["logits"] for r in ranks],
                         rules.lm_batch_split(mesh)["tokens"], mesh)
    assert got.shape == (B, _inputs(name)["cfg"].vocab)
    assert rel(got, _ref(name)["prefill"]) <= LOGIT_RTOL
    assert rel(got, one[i]["logits"]) <= LOGIT_RTOL


@pytest.mark.parametrize("case", _cases(DECODE_LAYOUTS), ids=_id)
def test_decode_on_a_grid_equals_one_rank_and_the_reference(case):
    """Three steps from position 40 of a 64-position cache drawn from a
    seed: every step's logits, and the cache after them against one
    rank's (int8 values within 1, the rest within 1e-5)."""
    grid, name, layout = case
    ranks, one = _launched(grid)[name]
    i = len(TRAIN_VARIANTS) + 1 + list(DECODE_LAYOUTS).index(layout)
    ranks, one = [r[i] for r in ranks], one[i]
    variant, shape = DECODE_LAYOUTS[layout]
    mesh = Mesh(grid)
    long = shape == "long_500k"
    row_split = (None, None, None) if long else (
        rules.lm_batch_split(mesh)["tokens"] + (None,))
    for j, want in enumerate(_ref(name)[layout]):
        if long:
            for r in ranks:
                assert np.array_equal(r["logits"][j], ranks[0]["logits"][j])
        got = rules.assemble([r["logits"][j] for r in ranks], row_split,
                             mesh)
        assert rel(got, want) <= LOGIT_RTOL, (j, rel(got, want))
        assert rel(got, one["logits"][j]) <= LOGIT_RTOL
    cfg = _inputs(name)["cfg"]
    csplit = lm_common.step_cache_split(cfg, shape, mesh, variant, True)
    got = lm_tree_assemble([r["cache"] for r in ranks], csplit, mesh)
    for slot, wslot in zip(got["slots"], one["cache"]["slots"]):
        for k, x in slot.items():
            if x.dtype == np.int8:
                assert int(np.abs(x.astype(int) - wslot[k]).max()) <= 1
            else:
                assert rel(x, wslot[k]) <= 1e-5, k


def test_f3_sharded_ce_on_a_grid_equals_the_reference(qwen):
    """F3's batch on the (2, 2) grid (a run of that grid's launch): value
    and gradients of the ``sharded_ce`` step against the reference's
    ``make_sharded_ce`` on a 1 x 1 mesh."""
    out = _launched(F3_GRID)["f3"]
    grid = Mesh(F3_GRID)
    split = lm_common.flat_split(qwen["cfg"], grid)
    for o in out:
        assert abs(o["loss"] - qwen["jloss"]) <= LOSS_RTOL * qwen["jloss"]
    for k, g in qwen["jg"].items():
        got = lm_tree_assemble([o["grads"][k] for o in out], split[k], grid)
        assert rel(got, g) <= GRAD_RTOL, k
