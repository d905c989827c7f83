"""The LM stack of the PyTorch port (``models/layers``, ``moe``, ``mla``,
``transformer``, ``data/tokens``, the LM converters of ``interop``) against
the JAX package on the CPU.

Both sides run the same numbers: the reference's weights (its
``init_params``) cross as numpy through ``interop.lm_params_from_numpy``,
and inputs are drawn from one ``np.random.default_rng``.  Everything is
float32 and held within 1e-5 of the largest entry of the reference's
tensor (the sums run in another order); integer results are exact:
``_quantize_kv`` on equal inputs, token batches, MoE routing.  Decode
caches hold int8 values that are rounded from float32 products computed in
another order, so a value may sit one step off where the product lies on
a rounding boundary (held: at most one step, on at most 1% of the
entries).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import (deepseek_v2_236b as jdeepseek,
                           gemma3_12b as jgemma, internlm2_20b as jinternlm,
                           mixtral_8x22b as jmixtral, qwen2_1p5b as jqwen)
from repro.data.tokens import synthetic_token_batches as jtokens
from repro.models import layers as jl, mla as jmla, moe as jmoe
from repro.models import transformer as jtf
from repro.train import checkpoint as jckpt

from repro_torch.configs.registry import get_arch
from repro_torch.data.tokens import synthetic_token_batches
from repro_torch.interop import lm_cache_from_numpy, lm_params_from_numpy
from repro_torch.models import layers, mla, moe
from repro_torch.models import transformer as tf
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               adamw_update_)
from repro_torch.train import checkpoint as ckpt

CPU = "cpu"
RTOL = 1e-5
J_MODS = [jgemma, jqwen, jinternlm, jmixtral, jdeepseek]
ARCH_IDS = [m.ARCH.arch_id for m in J_MODS]
#: Decode steps held against the reference.
DECODE_STEPS = 8


def close(got, want, rtol=RTOL, what=""):
    """max |got - want| within ``rtol`` of max |want|."""
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30) if want.size else 1.0
    err = float(np.abs(np.asarray(got, np.float32) - want).max()) \
        if want.size else 0.0
    assert err <= rtol * scale, (what, err, scale)


def t(x):
    return torch.from_numpy(np.asarray(x))


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def test_rms_norm_rope_and_swiglu_equal_the_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32) * 3
    scale = rng.standard_normal(16).astype(np.float32)
    close(layers.rms_norm(t(x), t(scale), 1e-5), jl.rms_norm(x, scale, 1e-5))
    for pos in (np.arange(7, dtype=np.int32)[None],
                rng.integers(0, 5000, (2, 7)).astype(np.int32)):
        close(layers.apply_rope(t(x), t(pos), 1_000_000.0),
              jl.apply_rope(x, pos, 1_000_000.0), what="rope")
    close(layers.rope_freqs(16, 10000.0), jl.rope_freqs(16, 10000.0))
    h = rng.standard_normal((5, 8)).astype(np.float32)
    wg, wu = (rng.standard_normal((8, 12)).astype(np.float32)
              for _ in range(2))
    wd = rng.standard_normal((12, 8)).astype(np.float32)
    close(layers.swiglu_ffn(t(h), t(wg), t(wu), t(wd)),
          jl.swiglu_ffn(h, wg, wu, wd))


def test_bf16_rms_norm_casts_before_the_scale():
    """In bf16 the normalised value is rounded to bf16 and then multiplied
    by the bf16 scale (bf16 x bf16), as the reference does."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 32)).astype(np.float32)
    s = rng.standard_normal(32).astype(np.float32)
    got = layers.rms_norm(t(x).bfloat16(), t(s).bfloat16())
    want = jl.rms_norm(jnp.asarray(x, jnp.bfloat16),
                       jnp.asarray(s, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_cross_entropy_ignores_the_ignore_id_positions():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((3, 5, 11)).astype(np.float32) * 4
    labels = rng.integers(0, 11, (3, 5)).astype(np.int32)
    labels[0, :3] = -1
    labels[2, 4] = -1
    for ignore in (-1, 7):
        got = layers.cross_entropy_loss(t(logits), t(labels), ignore)
        want = jl.cross_entropy_loss(logits, labels, ignore)
        close(got, want, what=ignore)
    all_ignored = np.full((2, 3), -1, np.int32)
    assert float(layers.cross_entropy_loss(t(logits[:2, :3]),
                                           t(all_ignored))) == 0.0


_jblockwise = jax.jit(jl.blockwise_attention, static_argnames=(
    "causal", "window", "q_offset", "q_block", "kv_block", "softmax_scale"))


@st.composite
def _attention_case(draw):
    qb = draw(st.sampled_from([2, 4, 8]))
    kvb = draw(st.sampled_from([2, 4, 8]))
    sq = qb * draw(st.integers(1, 4))
    sk = kvb * draw(st.integers(1, 4))
    q_offset = draw(st.integers(0, max(sk - sq, 0)))
    window = draw(st.one_of(st.none(), st.integers(1, sk + 2)))
    causal = draw(st.booleans())
    seed = draw(st.integers(0, 2 ** 16))
    return dict(qb=qb, kvb=kvb, sq=sq, sk=sk, q_offset=q_offset,
                window=window, causal=causal, seed=seed)


@settings(deadline=None, max_examples=30, derandomize=True)
@given(_attention_case())
def test_blockwise_attention_equals_the_reference(case):
    """Causal and windowed paths over block sizes, offsets and windows;
    GQA with 2 query heads per KV head."""
    rng = np.random.default_rng(case["seed"])
    q = rng.standard_normal((2, case["sq"], 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, case["sk"], 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, case["sk"], 2, 8)).astype(np.float32)
    kw = dict(causal=case["causal"], window=case["window"],
              q_offset=case["q_offset"], q_block=case["qb"],
              kv_block=case["kvb"])
    want = _jblockwise(q, k, v, **kw)
    got = layers.blockwise_attention(t(q), t(k), t(v), **kw)
    close(got, want, what=case)


def test_gqa_query_head_reads_kv_head_h_over_g():
    """Query head h attends with KV head h // g: zeroing KV head 1 changes
    only query heads 2 and 3 of 4."""
    rng = np.random.default_rng(3)
    q = t(rng.standard_normal((1, 8, 4, 8)).astype(np.float32))
    k = t(rng.standard_normal((1, 8, 2, 8)).astype(np.float32))
    v = t(rng.standard_normal((1, 8, 2, 8)).astype(np.float32))
    base = layers.blockwise_attention(q, k, v)
    v2 = v.clone()
    v2[:, :, 1] = 0
    out = layers.blockwise_attention(q, k, v2)
    assert torch.equal(out[:, :, :2], base[:, :, :2])
    assert not torch.equal(out[:, :, 2:], base[:, :, 2:])


@pytest.mark.parametrize("window", [None, 3, 100])
@pytest.mark.parametrize("int8", [False, True])
def test_decode_attention_equals_the_reference(window, int8):
    rng = np.random.default_rng(4)
    b, s, hkv, dh = 3, 16, 2, 8
    q = rng.standard_normal((b, 1, 4, dh)).astype(np.float32)
    if int8:
        kc = rng.integers(-127, 128, (b, s, hkv, dh)).astype(np.int8)
        vc = rng.integers(-127, 128, (b, s, hkv, dh)).astype(np.int8)
        ks = (rng.random((b, s, hkv)) * 0.05).astype(np.float32)
        vs = (rng.random((b, s, hkv)) * 0.05).astype(np.float32)
        scales = dict(k_scale=ks, v_scale=vs)
    else:
        kc = rng.standard_normal((b, s, hkv, dh)).astype(np.float32)
        vc = rng.standard_normal((b, s, hkv, dh)).astype(np.float32)
        scales = {}
    for clen in (np.int32(9), np.array([1, 16, 7], np.int32)):
        want = jl.decode_attention(q, kc, vc, clen, window=window, **scales)
        got = layers.decode_attention(
            t(q), t(kc), t(vc), t(clen), window=window,
            **{k: t(x) for k, x in scales.items()})
        close(got, want, what=(window, int8, clen))
    got_int = layers.decode_attention(t(q), t(kc), t(vc), 9, window=window,
                                      **{k: t(x) for k, x in scales.items()})
    close(got_int, jl.decode_attention(q, kc, vc, np.int32(9), window=window,
                                       **scales))


# ---------------------------------------------------------------------------
# MoE and MLA
# ---------------------------------------------------------------------------

def _moe_params(rng, d, e, f, shared):
    def w(*s):
        return (rng.standard_normal(s) / np.sqrt(s[-2])).astype(np.float32)
    p = dict(router=w(d, e), w_gate=w(e, d, f), w_up=w(e, d, f),
             w_down=w(e, f, d))
    if shared:
        p.update(shared_w_gate=w(d, 2 * f), shared_w_up=w(d, 2 * f),
                 shared_w_down=w(2 * f, d))
    return p


@pytest.mark.parametrize("after_topk,cf,shared", [
    (False, 1.25, False), (True, 1.25, False), (False, 0.3, False),
    (True, 0.3, False), (False, 0.5, True), (True, 4.0, True)])
def test_moe_ffn_and_its_gradients_equal_the_reference(after_topk, cf,
                                                       shared):
    """Both routers, with capacity drops (cf 0.3, 0.5: most assignments
    dropped at 24 tokens) and without, with and without shared experts."""
    rng = np.random.default_rng(5)
    t_, d, e, f, k = 24, 16, 6, 12, 2
    x = rng.standard_normal((t_, d)).astype(np.float32)
    p = _moe_params(rng, d, e, f, shared)
    kw = dict(top_k=k, capacity_factor=cf,
              router_softmax_after_topk=after_topk)
    cot = rng.standard_normal((t_, d)).astype(np.float32)

    @jax.jit
    def ref(x, p):
        def f(x, p):
            out = jmoe.moe_ffn(x, jmoe.MoEParams(**p), **kw)
            return jnp.sum(out * cot), out
        return jax.grad(f, argnums=(0, 1), has_aux=True)(x, p)

    jg, want = ref(x, p)
    tx = t(x).requires_grad_(True)
    tp = {n: t(v).requires_grad_(True) for n, v in p.items()}
    got = moe.moe_ffn(tx, moe.MoEParams(**tp), **kw)
    close(got, want, what="out")
    grads = torch.autograd.grad(torch.sum(got * t(cot)),
                                [tx] + list(tp.values()))
    close(grads[0], jg[0], what="dx")
    for g, n in zip(grads[1:], tp):
        close(g, jg[1][n], what=n)


def test_moe_combine_adds_in_expert_order_in_bf16():
    """bf16 tokens: each token's contributions are rounded to bf16 and added
    in ascending expert order, which is the reference's scatter-add."""
    rng = np.random.default_rng(6)
    t_, d, e, f = 32, 16, 8, 16
    x = rng.standard_normal((t_, d)).astype(np.float32)
    p = _moe_params(rng, d, e, f, False)
    bf = jnp.bfloat16
    want = jmoe.moe_ffn(jnp.asarray(x, bf),
                        jmoe.MoEParams(**{n: jnp.asarray(v, bf)
                                          for n, v in p.items()}),
                        top_k=4, capacity_factor=8.0)
    got = moe.moe_ffn(t(x).bfloat16(),
                      moe.MoEParams(**{n: t(v).bfloat16()
                                       for n, v in p.items()}),
                      top_k=4, capacity_factor=8.0)
    diff = np.abs(got.float().numpy() - np.asarray(want.astype(jnp.float32)))
    # The expert FFN's bf16 products may round differently; the combine's
    # order is what keeps the two within a couple of bf16 steps.
    assert float(diff.max()) <= 2 ** -6 * float(
        np.abs(np.asarray(want.astype(jnp.float32))).max())


def _mla_params(rng, cfg, d, h):
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    shapes = {"w_dq": (d, cfg.q_lora_rank), "q_ln": (cfg.q_lora_rank,),
              "w_uq": (cfg.q_lora_rank, h * (dn + dr)),
              "w_dkv": (d, cfg.kv_lora_rank), "kv_ln": (cfg.kv_lora_rank,),
              "w_kr": (d, dr), "w_uk": (cfg.kv_lora_rank, h * dn),
              "w_uv": (cfg.kv_lora_rank, h * dv), "w_o": (h * dv, d)}
    return {n: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
            for n, s in shapes.items()}


def test_mla_full_and_absorbed_forms_equal_the_reference():
    rng = np.random.default_rng(7)
    jcfg = jmla.MLAConfig(q_lora_rank=24, kv_lora_rank=16,
                          qk_nope_head_dim=8, qk_rope_head_dim=4,
                          v_head_dim=8)
    cfg = mla.MLAConfig(*jcfg)
    d, h, b, s = 32, 4, 2, 12
    p = _mla_params(rng, jcfg, d, h)
    tp = {n: t(v) for n, v in p.items()}
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    pos = np.arange(s, dtype=np.int32)[None]
    close(mla.mla_attention_full(tp, cfg, h, t(x), t(pos), 1e4, q_block=4,
                                 kv_block=4),
          jmla.mla_attention_full(p, jcfg, h, x, pos, 1e4, q_block=4,
                                  kv_block=4), what="full")
    for got, want in zip(mla.mla_qkv(tp, cfg, h, t(x), t(pos), 1e4),
                         jmla.mla_qkv(p, jcfg, h, x, pos, 1e4)):
        close(got, want, what="qkv")
    c_cache = rng.standard_normal((b, s, 16)).astype(np.float32)
    kr_cache = rng.standard_normal((b, s, 4)).astype(np.float32)
    x1 = x[:, :1]
    p1 = np.full((b, 1), 5, np.int32)
    close(mla.mla_decode(tp, cfg, h, t(x1), t(p1), t(c_cache), t(kr_cache),
                         6, 1e4),
          jmla.mla_decode(p, jcfg, h, x1, p1, c_cache, kr_cache, 6, 1e4),
          what="absorbed")


def test_mla_init_shapes_and_device():
    cfg = mla.MLAConfig(q_lora_rank=24, kv_lora_rank=16, qk_nope_head_dim=8,
                        qk_rope_head_dim=4, v_head_dim=8)
    want = jax.eval_shape(lambda: jmla.mla_init(jax.random.PRNGKey(0),
                                                jmla.MLAConfig(*cfg), 32, 4))
    got = mla.mla_init(cfg, 32, 4, seed=0, device=CPU)
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: v.shape for k, v in want.items()}
    assert torch.equal(got["q_ln"], torch.ones(24))


# ---------------------------------------------------------------------------
# The five architectures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lm_setups():
    """Per architecture: the two configs, the reference's weights as numpy
    and as the port's tensors, a batch, and the reference's logits, loss
    and gradients (one jit each)."""
    out = {}
    rng = np.random.default_rng(8)
    for mod in J_MODS:
        aid = mod.ARCH.arch_id
        jcfg = mod.ARCH.smoke_config()
        cfg = get_arch(aid).smoke_config()
        jp = jtf.init_params(jcfg, jax.random.PRNGKey(0))
        tokens = rng.integers(0, jcfg.vocab, (2, 24)).astype(np.int32)
        labels = rng.integers(0, jcfg.vocab, (2, 24)).astype(np.int32)
        labels[1, :5] = -1
        batch = {"tokens": tokens, "labels": labels}

        @jax.jit
        def ref(p, batch=batch, jcfg=jcfg):
            logits = jtf.forward(jcfg, p, batch["tokens"])
            loss, g = jax.value_and_grad(
                lambda q: jtf.loss_fn(jcfg, q, batch))(p)
            return logits, loss, g

        logits, loss, grads = ref(jp)
        out[aid] = dict(jcfg=jcfg, cfg=cfg, jp=jp,
                        params=lm_params_from_numpy(numpy_tree(jp), CPU),
                        batch=batch, logits=np.asarray(logits),
                        loss=float(loss),
                        grads=tf.flat_params(numpy_tree(grads)))
    return out


def test_configs_equal_the_reference():
    for mod in J_MODS:
        arch = get_arch(mod.ARCH.arch_id)
        for smoke in (False, True):
            want = dataclasses.asdict(mod.ARCH.config(smoke))
            got = dataclasses.asdict(arch.config(smoke))
            assert got == want, mod.ARCH.arch_id
        assert arch.shapes == mod.ARCH.shapes
        assert arch.skip_notes == mod.ARCH.skip_notes
        assert arch.family == "lm"
        cut = arch.config(n_repeats=1)
        assert cut.n_layers == len(cut.layer_windows)


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_forward_loss_and_every_gradient_equal_the_reference(arch_id,
                                                             lm_setups):
    s = lm_setups[arch_id]
    cfg = s["cfg"]
    batch = {k: t(v) for k, v in s["batch"].items()}
    close(tf.forward(cfg, s["params"], batch["tokens"]), s["logits"],
          what="logits")
    leaves = {k: x.detach().requires_grad_(True)
              for k, x in tf.flat_params(s["params"]).items()}
    loss = tf.loss_fn(cfg, tf.nest_params(leaves), batch)
    close(loss, s["loss"], what="loss")
    grads = torch.autograd.grad(loss, list(leaves.values()))
    assert set(leaves) == set(s["grads"])
    for k, g in zip(leaves, grads):
        close(g, s["grads"][k], what=k)


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_remat_changes_no_value(arch_id, lm_setups):
    """``remat=True`` checkpoints each layer; the loss and the gradients
    are the same bits as without it."""
    s = lm_setups[arch_id]
    batch = {k: t(v) for k, v in s["batch"].items()}
    res = []
    for remat in (False, True):
        cfg = dataclasses.replace(s["cfg"], remat=remat)
        leaves = {k: x.detach().requires_grad_(True)
                  for k, x in tf.flat_params(s["params"]).items()}
        loss = tf.loss_fn(cfg, tf.nest_params(leaves), batch)
        res.append([loss.detach()] + list(torch.autograd.grad(
            loss, list(leaves.values()))))
    assert all(torch.equal(a, b) for a, b in zip(*res))


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_decode_steps_and_caches_equal_the_reference(arch_id, kv_dtype,
                                                     lm_setups):
    """8 decode steps from an empty cache: each step's logits and the cache
    after the last (the int8 values within one step, see the module
    docstring)."""
    s = lm_setups[arch_id]
    jcfg = dataclasses.replace(s["jcfg"], kv_cache_dtype=kv_dtype)
    cfg = dataclasses.replace(s["cfg"], kv_cache_dtype=kv_dtype)
    b, max_len = 2, 12
    toks = s["batch"]["tokens"][:, :DECODE_STEPS]
    jstep = jax.jit(functools.partial(jtf.decode_step, jcfg))
    jcache = jtf.init_cache(jcfg, b, max_len)
    cache = tf.init_cache(cfg, b, max_len, CPU)
    for i in range(DECODE_STEPS):
        want, jcache = jstep(s["jp"], jcache, toks[:, i:i + 1], jnp.int32(i))
        cache_len = i if i % 2 else torch.tensor(i, dtype=torch.int32)
        got, cache = tf.decode_step(cfg, s["params"], cache,
                                    t(toks[:, i:i + 1]), cache_len)
        close(got, want, what=(arch_id, i))
    want_cache = lm_cache_from_numpy(numpy_tree(jcache), CPU)
    for slot, wslot in zip(cache["slots"], want_cache["slots"]):
        assert set(slot) == set(wslot)
        for name, x in slot.items():
            w = wslot[name]
            assert x.dtype == w.dtype and x.shape == w.shape, name
            if x.dtype == torch.int8:
                off = (x.int() - w.int()).abs()
                assert int(off.max()) <= 1, name
                assert float((off > 0).float().mean()) <= 0.01, name
            else:
                close(x, w.numpy(), what=name)


def test_quantize_kv_equals_the_reference_exactly():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((3, 1, 4, 16)).astype(np.float32)
    x[0, 0, 0] = 0.0                       # the 1e-8 floor
    x[1, 0, 1, :3] = [2.54, -1.27, 0.635]  # values on the half steps
    x[1, 0, 1, 3:] = 0.0
    q, sc = tf._quantize_kv(t(x))
    jq, jsc = jtf._quantize_kv(x)
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(jsc))


def test_param_counts_of_the_full_configs_equal_the_reference():
    for mod in J_MODS:
        want = mod.ARCH.full_config()
        got = get_arch(mod.ARCH.arch_id).full_config()
        assert got.param_count() == want.param_count()
        assert got.active_param_count() == want.active_param_count()
        assert got.activation_dtype == torch.bfloat16
    assert get_arch("qwen2-1.5b").full_config().param_count() == 1_543_569_408


def test_param_tree_shapes_and_init_rules():
    for mod in J_MODS:
        cfg = get_arch(mod.ARCH.arch_id).smoke_config()
        jshapes = jtf.param_shapes(mod.ARCH.smoke_config())
        assert tf.param_shapes(cfg) == jshapes
        p = tf.init_params(cfg, seed=3, device=CPU)
        flat = tf.flat_params(p)
        assert list(flat) == list(tf.flat_params(jshapes))
        for k, x in flat.items():
            name = k.rsplit(".", 1)[-1]
            if "ln" in name:
                assert torch.equal(x, torch.ones_like(x)), k
            elif name.startswith("b"):
                assert not x.any(), k
        again = tf.flat_params(tf.init_params(cfg, seed=3, device=CPU))
        assert all(torch.equal(flat[k], again[k]) for k in flat)
        assert tf.nest_params(flat).keys() == p.keys()


def test_synthetic_token_batches_are_byte_identical():
    for seed, structured in ((0, True), (5, False)):
        want = jtokens(512, 4, 33, seed=seed, structured=structured)
        got = synthetic_token_batches(512, 4, 33, seed=seed,
                                      structured=structured, device=CPU)
        for _ in range(3):
            w, g = next(want), next(got)
            for k in ("tokens", "labels"):
                assert w[k].dtype == np.int32 and g[k].dtype == torch.int32
                assert g[k].numpy().tobytes() == w[k].tobytes()


def test_lm_checkpoints_cross_restore(tmp_path, lm_setups):
    """A checkpoint of the reference's LM parameters restores into the
    port's tree and one written by the port into the reference's, leaf for
    leaf."""
    s = lm_setups["deepseek-v2-236b"]
    jckpt.save_checkpoint(str(tmp_path / "jax"), 3, {"params": s["jp"]})
    like = {"params": tf.init_params(s["cfg"], device=CPU)}
    back = ckpt.restore_checkpoint(str(tmp_path / "jax"), 3, like)
    want = tf.flat_params(numpy_tree(s["jp"]))
    for k, x in tf.flat_params(back["params"]).items():
        assert isinstance(x, torch.Tensor)
        np.testing.assert_array_equal(x.numpy(), want[k])
    ckpt.save_checkpoint(str(tmp_path / "port"), 4,
                         {"params": s["params"]})
    jback = jckpt.restore_checkpoint(str(tmp_path / "port"), 4,
                                     {"params": s["jp"]})
    for k, x in tf.flat_params(numpy_tree(jback["params"])).items():
        np.testing.assert_array_equal(
            x, tf.flat_params(s["params"])[k].numpy())


def test_in_place_adamw_equals_adamw_update_bit_for_bit(monkeypatch):
    """``adamw_update_`` (chunked, in place) and ``adamw_update`` give the
    same bits, bf16 parameters included; a small chunk makes every tensor
    span several chunks."""
    from repro_torch.optim import adamw as adamw_mod
    monkeypatch.setattr(adamw_mod, "CHUNK", 7)
    rng = np.random.default_rng(10)
    params = {"a": t(rng.standard_normal((5, 6)).astype(np.float32)),
              "b": t(rng.standard_normal(13).astype(np.float32)).bfloat16()}
    cfg = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    st_out, st_in = adamw_init(params), adamw_init(params)
    p_in = {k: v.clone() for k, v in params.items()}
    p_out = params
    for step in range(3):
        grads = {k: t(rng.standard_normal(v.shape).astype(np.float32)
                      * 10).to(v.dtype) for k, v in params.items()}
        p_out, st_out, m_out = adamw_update(cfg, p_out, grads, st_out)
        st_in, m_in = adamw_update_(cfg, p_in, grads, st_in)
        assert int(st_in.step) == int(st_out.step) == step + 1
        for k in params:
            assert torch.equal(p_in[k], p_out[k]), (step, k)
            assert torch.equal(st_in.mu[k], st_out.mu[k])
            assert torch.equal(st_in.nu[k], st_out.nu[k])
        assert torch.equal(m_in["grad_norm"], m_out["grad_norm"])


#: bf16 against the reference's bf16: the dense models' logits within
#: BF16_RTOL of the largest (activations rounded to bf16 after sums in
#: another order; measured ~1.1e-2), and the next-token argmax on at least
#: BF16_AGREE of the positions for every model (an MoE router may pick
#: another expert for a token whose top scores sit within a bf16 step).
BF16_RTOL = 3e-2
BF16_AGREE = 0.9


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_bf16_models_track_the_reference(arch_id):
    """The smoke LM in bf16 with ``remat``: forward against the reference's
    bf16 forward, a finite loss and finite gradients in bf16, and 4 decode
    steps with the bf16 and the int8 cache, finite and in the reference's
    cache types."""
    mod = J_MODS[ARCH_IDS.index(arch_id)]
    jcfg = dataclasses.replace(mod.ARCH.smoke_config(), dtype="bfloat16",
                               remat=True)
    cfg = dataclasses.replace(get_arch(arch_id).smoke_config(),
                              dtype="bfloat16", remat=True)
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    params = lm_params_from_numpy(
        jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)), jp), CPU,
        torch.bfloat16)
    assert all(x.dtype == torch.bfloat16
               for x in tf.flat_params(params).values())
    toks = np.random.default_rng(11).integers(0, cfg.vocab, (2, 16)).astype(
        np.int32)
    want = np.asarray(jax.jit(functools.partial(jtf.forward, jcfg))(jp, toks))
    got = tf.forward(cfg, params, t(toks))
    assert got.dtype == torch.float32
    agree = float((got.argmax(-1).numpy() == want.argmax(-1)).mean())
    assert agree >= BF16_AGREE, agree
    if cfg.moe is None:
        close(got, want, rtol=BF16_RTOL)
    leaves = {k: x.detach().requires_grad_(True)
              for k, x in tf.flat_params(params).items()}
    loss = tf.loss_fn(cfg, tf.nest_params(leaves),
                      {"tokens": t(toks), "labels": t(toks)})
    grads = torch.autograd.grad(loss, list(leaves.values()))
    assert bool(torch.isfinite(loss))
    assert all(g.dtype == torch.bfloat16 and bool(torch.isfinite(g).all())
               for g in grads)
    for kv in ("bf16", "int8"):
        c = dataclasses.replace(cfg, kv_cache_dtype=kv)
        cache = tf.init_cache(c, 2, 8, CPU)
        jshapes = jtf.cache_specs(dataclasses.replace(jcfg, kv_cache_dtype=kv),
                                  2, 8)
        for slot, jslot in zip(cache["slots"], jshapes["slots"]):
            assert {k: (tuple(x.shape), str(x.dtype).split(".")[-1])
                    for k, x in slot.items()} == {
                k: (s.shape, str(s.dtype)) for k, s in jslot.items()}
        for i in range(4):
            logits, cache = tf.decode_step(c, params, cache,
                                           t(toks[:, i:i + 1]), i)
            assert bool(torch.isfinite(logits).all())
