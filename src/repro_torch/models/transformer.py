"""Configurable decoder-only LM of the PyTorch port
(``repro.models.transformer``), covering the five LM architectures:
gemma3-12b (5:1 local:global GQA), qwen2-1.5b (GQA + QKV bias),
internlm2-20b (GQA), mixtral-8x22b (GQA + SWA + 8-expert top-2 MoE),
deepseek-v2-236b (MLA + 160-expert top-6 + 2 shared MoE).

A config declares a layer pattern (gemma3: 5 sliding + 1 global) and the
stack is that pattern repeated ``n_repeats`` times; the stack runs
repeat-major (for each repeat, each slot of the pattern).  The parameter
tree is the reference's: ``{"embed", "final_ln", "layers": [one dict per
pattern slot, each tensor stacked along a leading n_repeats dimension],
"lm_head"?}``, so checkpoints of an LM cross-restore between the packages.

Entry points:
  init_params(cfg, seed, device)      weights drawn from a torch.Generator.
  forward(cfg, params, tokens)        logits.
  loss_fn(cfg, params, batch)         the mean token CE.
  init_cache / decode_step            single-token serving against a KV
                                      cache written in place.

``flat_params`` names the tree's tensors ``embed``, ``final_ln``,
``layers.<slot>.<name>`` and ``lm_head``, the keys ``optim.adamw`` and
``train.loop`` take.

``forward``, ``loss_fn`` and ``decode_step`` take an optional
``collectives.RankGrid``.  Without one they run on one rank.  With one,
``params`` holds the rank's shares (``sharding.lm_param_split``), the
tokens are the rank's rows of the batch and a cache is the rank's share
(``sharding.lm_cache_split``):
  - FSDP shares are all-gathered over the dp axes per layer when used,
    inside the layer's checkpoint (the backward reduce-scatters their
    gradients);
  - Megatron tensor parallelism over ``model``: ``TensorParallel.copy``
    before each column-parallel product, ``.sum`` after each row-parallel
    one, so the norms, the router and MLA's down-projections (replicated
    over ``model``) get their whole gradient on every model rank;
  - the embedding is a masked gather of the rank's vocabulary rows summed
    over ``model``; the loss is the vocab-parallel cross-entropy
    (``vocab_parallel_ce``), which never holds the (B, S, V) logits;
  - attention splits its heads over ``model``; where the KV heads do not
    divide the axis, each rank gathers the KV columns its query heads read;
  - decode splits the cache's sequence (flash decoding): each rank attends
    its slice for every head, the ``(m, l, o)`` partials are merged across
    the ranks in order, and only the rank that holds position
    ``cache_len`` writes it.  The baseline layout (heads or ``d_head`` over
    ``model``) gathers the cache over ``model`` every layer.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.compat import is_dry
from repro_torch.core.collectives import SumFromRanks, all_gather_dim
from repro_torch.core.graph import resolve_device
from repro_torch.models import mla as mla_mod
from repro_torch.models.layers import (TensorParallel, acc_dtype, apply_rope,
                                       blockwise_attention,
                                       cross_entropy_loss, decode_attention,
                                       decode_attention_partial,
                                       merge_partials, rms_norm, swiglu_ffn)
from repro_torch.models.moe import MoEParams, moe_ffn
from repro_torch.models.recsys import gather_rows
from repro_torch.sharding.rules import (lm_cache_split, lm_param_split, share,
                                        split_parts)

#: ``TransformerConfig.dtype`` names (the reference's, plus float64 for the
#: card's float64 checks).
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float64": torch.float64}


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    d_ff_shared: int = 0
    capacity_factor: float = 1.25
    softmax_after_topk: bool = False  # Mixtral-style router


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The reference's config.  ``remat``: each decoder layer runs under
    ``torch.utils.checkpoint`` while grad is enabled (one ``(B, S, d)``
    input saved a layer).  ``scan_layers`` is kept for the reference's
    dry-run variants and changes nothing here: the port always runs the
    repeats in a Python loop.  ``kv_cache_dtype="int8"``: the GQA cache
    holds int8 values with a float32 absmax scale per (position, head);
    MLA latent caches stay in the activation type."""

    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    # Layer pattern: a window size per slot, None = full attention.
    layer_windows: Tuple[Optional[int], ...] = (None,)
    moe: Optional[MoESpec] = None
    mla: Optional[mla_mod.MLAConfig] = None
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    remat: bool = True
    kv_cache_dtype: str = "bf16"
    scan_layers: bool = True

    @property
    def n_repeats(self) -> int:
        if self.n_layers % len(self.layer_windows):
            raise ValueError(f"{self.n_layers} layers are not a whole number "
                             f"of {len(self.layer_windows)}-slot patterns")
        return self.n_layers // len(self.layer_windows)

    @property
    def activation_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    def _attn_params(self) -> int:
        d = self.d_model
        if self.mla is not None:
            m = self.mla
            return (d * m.q_lora_rank
                    + m.q_lora_rank * self.n_heads
                    * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                    + d * m.kv_lora_rank + d * m.qk_rope_head_dim
                    + m.kv_lora_rank * self.n_heads
                    * (m.qk_nope_head_dim + m.v_head_dim)
                    + self.n_heads * m.v_head_dim * d)
        return (d * self.n_heads * self.d_head
                + 2 * d * self.n_kv_heads * self.d_head
                + self.n_heads * self.d_head * d)

    def param_count(self) -> int:
        """Parameter count without biases and norm scales (the reference's
        MODEL_FLOPS accounting)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        if self.moe is not None:
            ffn = (d * self.moe.n_experts
                   + 3 * d * self.moe.d_ff_expert * self.moe.n_experts
                   + 3 * d * self.moe.d_ff_shared
                   * (1 if self.moe.n_shared else 0))
        else:
            ffn = 3 * d * f
        emb = v * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * (self._attn_params() + ffn) + emb

    def active_param_count(self) -> int:
        """Per-token parameters: MoE counts only the routed top-k and the
        shared experts."""
        if self.moe is None:
            return self.param_count()
        d, v = self.d_model, self.vocab
        ffn = (3 * d * self.moe.d_ff_expert * self.moe.top_k
               + 3 * d * self.moe.d_ff_shared
               * (1 if self.moe.n_shared else 0)
               + d * self.moe.n_experts)
        emb = v * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * (self._attn_params() + ffn) + emb


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _layer_param_shapes(cfg: TransformerConfig) -> dict:
    d, h, hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    shapes = {"ln1": (d,), "ln2": (d,)}
    if cfg.mla is not None:
        m = cfg.mla
        shapes.update({
            "w_dq": (d, m.q_lora_rank), "q_ln": (m.q_lora_rank,),
            "w_uq": (m.q_lora_rank,
                     h * (m.qk_nope_head_dim + m.qk_rope_head_dim)),
            "w_dkv": (d, m.kv_lora_rank), "kv_ln": (m.kv_lora_rank,),
            "w_kr": (d, m.qk_rope_head_dim),
            "w_uk": (m.kv_lora_rank, h * m.qk_nope_head_dim),
            "w_uv": (m.kv_lora_rank, h * m.v_head_dim),
            "w_o": (h * m.v_head_dim, d),
        })
    else:
        shapes.update({
            "wq": (d, h * dh), "wk": (d, hk * dh), "wv": (d, hk * dh),
            "wo": (h * dh, d),
        })
        if cfg.qkv_bias:
            shapes.update({"bq": (h * dh,), "bk": (hk * dh,),
                           "bv": (hk * dh,)})
    if cfg.moe is not None:
        mo = cfg.moe
        shapes.update({
            "router": (d, mo.n_experts),
            "w_gate_e": (mo.n_experts, d, mo.d_ff_expert),
            "w_up_e": (mo.n_experts, d, mo.d_ff_expert),
            "w_down_e": (mo.n_experts, mo.d_ff_expert, d),
        })
        if mo.n_shared:
            shapes.update({
                "w_gate_s": (d, mo.d_ff_shared), "w_up_s": (d, mo.d_ff_shared),
                "w_down_s": (mo.d_ff_shared, d),
            })
    else:
        shapes.update({"w_gate": (d, cfg.d_ff), "w_up": (d, cfg.d_ff),
                       "w_down": (cfg.d_ff, d)})
    return shapes


def param_shapes(cfg: TransformerConfig) -> dict:
    per_layer = _layer_param_shapes(cfg)
    out = {
        "embed": (cfg.vocab, cfg.d_model),
        "final_ln": (cfg.d_model,),
        "layers": [{k: (cfg.n_repeats,) + v for k, v in per_layer.items()}
                   for _ in cfg.layer_windows],
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = (cfg.d_model, cfg.vocab)
    return out


def flat_params(tree: dict) -> Dict[str, torch.Tensor]:
    """The tree's leaves keyed ``embed``, ``final_ln``,
    ``layers.<slot>.<name>`` and ``lm_head``, in ``jax.tree.flatten``'s
    order (sorted keys; fewer than ten slots)."""
    out = {}
    for key in sorted(tree):
        if key == "layers":
            for i, slot in enumerate(tree["layers"]):
                for name in sorted(slot):
                    out[f"layers.{i}.{name}"] = slot[name]
        else:
            out[key] = tree[key]
    return out


def nest_params(flat: Dict[str, torch.Tensor]) -> dict:
    """The inverse of ``flat_params``."""
    out: dict = {}
    slots: Dict[int, dict] = {}
    for key, x in flat.items():
        if key.startswith("layers."):
            _, i, name = key.split(".")
            slots.setdefault(int(i), {})[name] = x
        else:
            out[key] = x
    out["layers"] = [slots[i] for i in range(len(slots))]
    return out


def init_params(cfg: TransformerConfig, seed: int = 0,
                device="cuda") -> dict:
    """The reference's initialiser on ``device`` (the card unless the caller
    asks for the CPU): norm scales ones, biases zeros, every other tensor
    float32 normal / sqrt(fan_in) (``shape[-2]``, the embedding's vocab
    included) cast to the activation type.  The draws come from a
    ``torch.Generator`` seeded with ``seed``, one per tensor in
    ``flat_params`` order; they are not JAX's (parity tests carry the
    reference's weights across, ``interop.lm_params_from_numpy``)."""
    return nest_params(dict(init_leaves(cfg, seed, device)))


def init_leaves(cfg: TransformerConfig, seed: int = 0, device="cuda"):
    """``init_params``'s tensors one at a time, ``(key, tensor)`` in
    ``flat_params`` order, so a rank can cut each into its share before the
    next is drawn."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = cfg.activation_dtype
    for key, shape in flat_params(param_shapes(cfg)).items():
        name = key.rsplit(".", 1)[-1]
        if "ln" in name:
            yield key, torch.ones(shape, dtype=dt, device=dev)
        elif name.startswith("b"):
            yield key, torch.zeros(shape, dtype=dt, device=dev)
        else:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            x = torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=dev)
            yield key, x.div_(math.sqrt(fan_in)).to(dt)
            del x


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _gather_dp(x: torch.Tensor, split, grid) -> torch.Tensor:
    """A parameter share with its FSDP dimensions all-gathered over the dp
    axes (``split`` without the repeat dimension); the other dimensions
    stay the rank's."""
    dp = tuple(a for a in grid.axis_names if a != "model")
    for dim, axes in enumerate(split):
        if axes is None or axes == ("model",):
            continue
        if axes != dp:
            raise ValueError(f"a parameter split over {axes}; the LM rules "
                             f"split over 'model' or over {dp}")
        x = all_gather_dim(x, dim, grid.dp)
    return x


def _layer_splits(cfg: TransformerConfig, grid, fsdp: bool):
    """Each pattern slot's ``{name: split}`` without the repeat dimension."""
    split = lm_param_split(cfg, grid, fsdp)
    return split, [{k: sp[1:] for k, sp in slot.items()}
                   for slot in split["layers"]]


def _kv_for_heads(cfg: TransformerConfig, k, v, tp: TensorParallel):
    """The rank's K/V projections (B, S, cols) -> the columns of the KV
    heads that its query heads read, and their count.  Where the KV heads
    divide the model axis a rank's columns are exactly those heads; else
    the columns are gathered over ``model`` first."""
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    g, h_loc = h // hk, tp.local_heads(h)
    lo = tp.rank * h_loc // g
    hi = ((tp.rank + 1) * h_loc - 1) // g + 1
    if (h_loc % g if h_loc >= g else g % h_loc):
        raise ValueError(f"{h_loc} query heads a rank do not read whole "
                         f"groups of {g} per KV head")
    if hk % tp.size == 0:
        return k, v, hk // tp.size
    k = tp.gather(k, -1)[..., lo * dh:hi * dh]
    v = tp.gather(v, -1)[..., lo * dh:hi * dh]
    return k, v, hi - lo


def _attention_block(cfg: TransformerConfig, p: dict, x: torch.Tensor,
                     positions, window: Optional[int],
                     tp: Optional[TensorParallel] = None) -> torch.Tensor:
    b, s, _ = x.shape
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    if cfg.mla is not None:
        return mla_mod.mla_attention_full(p, cfg.mla, h, x, positions,
                                          cfg.rope_theta, tp=tp)
    if tp is not None and h % tp.size:
        return _attention_all_heads(cfg, p, x, positions, window, tp)
    if tp is not None:
        h = tp.local_heads(h)
        x = tp.copy(x)
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if tp is not None:
        k, v, hk = _kv_for_heads(cfg, k, v, tp)
    q = apply_rope(q.reshape(b, s, h, dh), positions, cfg.rope_theta)
    k = apply_rope(k.reshape(b, s, hk, dh), positions, cfg.rope_theta)
    v = v.reshape(b, s, hk, dh)
    out = blockwise_attention(q, k, v, causal=True, window=window)
    out = out.reshape(b, s, h * dh) @ p["wo"]
    return out if tp is None else tp.sum(out)


def _attention_all_heads(cfg: TransformerConfig, p: dict, x: torch.Tensor,
                         positions, window: Optional[int],
                         tp: TensorParallel) -> torch.Tensor:
    """The attention block over a grid whose model axis does not divide
    the query heads (qwen2-1.5b's 12 over 16): the rank's columns of the
    query, key and value projections are gathered over ``model``, every
    rank attends every head, and the rank's rows of ``wo`` read its
    columns of the heads' outputs (what the reference's column split of
    ``wq`` and row split of ``wo`` leave to the compiler)."""
    b, s, _ = x.shape
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    x = tp.copy(x)
    q, k, v = (x @ p[w] + p[bias] if cfg.qkv_bias else x @ p[w]
               for w, bias in (("wq", "bq"), ("wk", "bk"), ("wv", "bv")))
    q, k, v = (tp.gather(t, -1) for t in (q, k, v))
    q = apply_rope(q.reshape(b, s, h, dh), positions, cfg.rope_theta)
    k = apply_rope(k.reshape(b, s, hk, dh), positions, cfg.rope_theta)
    out = blockwise_attention(q, k, v.reshape(b, s, hk, dh), causal=True,
                              window=window).reshape(b, s, h * dh)
    cols = p["wo"].shape[0]
    return tp.sum(out[..., tp.rank * cols:(tp.rank + 1) * cols] @ p["wo"])


def _ffn_block(cfg: TransformerConfig, p: dict, x: torch.Tensor,
               tp: Optional[TensorParallel] = None):
    b, s, d = x.shape
    if cfg.moe is None:
        if tp is None:
            return swiglu_ffn(x, p["w_gate"], p["w_up"], p["w_down"])
        return tp.sum(swiglu_ffn(tp.copy(x), p["w_gate"], p["w_up"],
                                 p["w_down"]))
    mp = MoEParams(router=p["router"], w_gate=p["w_gate_e"],
                   w_up=p["w_up_e"], w_down=p["w_down_e"],
                   shared_w_gate=p.get("w_gate_s"),
                   shared_w_up=p.get("w_up_s"),
                   shared_w_down=p.get("w_down_s"))
    out = moe_ffn(x.reshape(b * s, d), mp, top_k=cfg.moe.top_k,
                  capacity_factor=cfg.moe.capacity_factor,
                  router_softmax_after_topk=cfg.moe.softmax_after_topk,
                  tp=tp)
    return out.reshape(b, s, d)


def _decoder_layer(cfg: TransformerConfig, window, p, x, positions,
                   tp: Optional[TensorParallel] = None, split=None):
    """One layer; over a grid ``p`` holds the rank's shares, gathered here
    (inside the checkpoint, so the recompute gathers again)."""
    if tp is not None:
        p = {k: _gather_dp(t, split[k], tp.grid) for k, t in p.items()}
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + _attention_block(cfg, p, h, positions, window, tp)
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + _ffn_block(cfg, p, h, tp)


def _embed(cfg: TransformerConfig, params: dict, tokens: torch.Tensor,
           tp: Optional[TensorParallel] = None, split=None):
    """The token rows (a sorted, fixed-order segment sum in the backward),
    scaled by sqrt(d_model) in the activation type.  Over a grid each
    model rank gathers the tokens of its vocabulary rows, zeros the others,
    and the rows are summed over ``model``."""
    dt = cfg.activation_dtype
    if tp is None:
        x = gather_rows(params["embed"], tokens).to(dt)
    else:
        emb = _gather_dp(params["embed"], split["embed"], tp.grid)
        v_l = emb.shape[0]
        local = tokens.long() - tp.rank * v_l
        inside = (local >= 0) & (local < v_l)
        rows = gather_rows(emb, torch.clamp(local, 0, v_l - 1))
        rows = torch.where(inside[..., None], rows,
                           torch.zeros((), dtype=rows.dtype,
                                       device=rows.device))
        x = tp.sum(rows).to(dt)
    return x * torch.tensor(math.sqrt(cfg.d_model), dtype=dt,
                            device=x.device)


def _head(cfg: TransformerConfig, params: dict,
          tp: Optional[TensorParallel] = None, split=None):
    """The LM head (d, V), or over a grid the rank's (d, V / model)."""
    if tp is None:
        return params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    if cfg.tie_embeddings:
        return _gather_dp(params["embed"], split["embed"], tp.grid).T
    return _gather_dp(params["lm_head"], split["lm_head"], tp.grid)


def _logits(cfg: TransformerConfig, params: dict, x: torch.Tensor,
            tp: Optional[TensorParallel] = None, split=None):
    """The LM head: a product in the activation type, then float32.  Over a
    grid each model rank multiplies its vocabulary columns and the logits
    are gathered over ``model``."""
    if tp is None:
        return (x @ _head(cfg, params).to(x.dtype)).to(acc_dtype(x.dtype))
    head = _head(cfg, params, tp, split)
    local = (tp.copy(x) @ head.to(x.dtype)).to(acc_dtype(x.dtype))
    return all_gather_dim(local, -1, tp.model, backward="own")


def _run_layers(cfg: TransformerConfig, params: dict, x, positions, tp,
                slot_splits):
    remat = cfg.remat and torch.is_grad_enabled()
    for r in range(cfg.n_repeats):
        for slot, window in enumerate(cfg.layer_windows):
            p = {k: t[r] for k, t in params["layers"][slot].items()}
            split = None if tp is None else slot_splits[slot]
            if remat:
                x = checkpoint(_decoder_layer, cfg, window, p, x, positions,
                               tp, split, use_reentrant=False)
            else:
                x = _decoder_layer(cfg, window, p, x, positions, tp, split)
    return x


def forward(cfg: TransformerConfig, params: dict, tokens: torch.Tensor,
            return_hidden: bool = False, grid=None,
            fsdp: bool = True) -> torch.Tensor:
    """tokens (B, S) -> float32 logits (B, S, V); ``return_hidden`` stops
    before the LM head.  Over ``grid`` (a ``RankGrid``), ``params`` are the
    rank's shares (``fsdp=False``: the ``tp_only_params`` layout), tokens
    its rows, and the logits its rows' (every vocabulary column)."""
    b, s = tokens.shape
    tp = split = slot_splits = None
    if grid is not None:
        tp = TensorParallel(grid)
        split, slot_splits = _layer_splits(cfg, grid, fsdp)
    x = _embed(cfg, params, tokens, tp, split)
    positions = torch.arange(s, device=x.device)[None, :]
    x = _run_layers(cfg, params, x, positions, tp, slot_splits)
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    if return_hidden:
        return x
    return _logits(cfg, params, x, tp, split)


def vocab_parallel_ce(cfg: TransformerConfig, params: dict, x: torch.Tensor,
                      labels: torch.Tensor, grid, fsdp: bool = True,
                      count_ignored: bool = False,
                      ignore_id: int = -1) -> torch.Tensor:
    """The token cross-entropy of the hidden states ``x`` (the rank's rows,
    ``forward(..., return_hidden=True, grid=grid)``) over the rank's
    vocabulary shard: the head product in the activation type, then
    float32; the global max from the gathered per-shard maxima (no
    gradient), the sum of exponentials summed over ``model``, and the
    label's logit from the shard that holds it.  The (B, S, V) logits are
    never formed.

    ``count_ignored=False``: the plain loss, the mean over the labels that
    are not ``ignore_id`` of every rank.  ``count_ignored=True``: the
    reference's ``make_sharded_ce``, ``sum(lse - ll)`` over every position
    of every rank divided by their count, so an ignored label adds its
    ``lse`` (no shard holds it, so its ``ll`` is 0)."""
    tp = TensorParallel(grid)
    split = _layer_splits(cfg, grid, fsdp)[0]
    head = _head(cfg, params, tp, split)
    logits = (tp.copy(x) @ head.to(x.dtype)).to(acc_dtype(x.dtype))
    v_l = logits.shape[-1]
    shard_max = torch.amax(logits.detach(), dim=-1)
    gmax = torch.amax(tp.model.all_gather(shard_max, tiled=False), dim=0)
    # The shard's sum of exp(logits - gmax), through the shard's own
    # logsumexp so that autograd keeps no (B, S, V / model) exponentials.
    sumexp = torch.exp(torch.logsumexp(logits, dim=-1) - gmax)
    lse = gmax + torch.log(tp.sum(sumexp))
    col = labels.long() - tp.rank * v_l
    inside = (col >= 0) & (col < v_l)
    ll_local = torch.gather(logits, -1,
                            torch.clamp(col, 0, v_l - 1)[..., None])[..., 0]
    ll = tp.sum(torch.where(inside, ll_local,
                            torch.zeros((), dtype=ll_local.dtype,
                                        device=ll_local.device)))
    if count_ignored:
        nll = lse - ll
        count = torch.tensor(float(labels.numel() * tp.token_ranks),
                             dtype=nll.dtype, device=nll.device)
    else:
        mask = labels != ignore_id
        nll = (lse - ll) * mask
        count = torch.clamp(tp.dp.psum(torch.sum(mask)), min=1)
    return SumFromRanks.apply(torch.sum(nll), tp.dp) / count


def loss_fn(cfg: TransformerConfig, params: dict, batch: dict, grid=None,
            fsdp: bool = True):
    """The mean token CE, ignoring label -1.  Over ``grid``: the global
    masked mean of the ranks' rows (``vocab_parallel_ce``)."""
    if grid is None:
        return cross_entropy_loss(forward(cfg, params, batch["tokens"]),
                                  batch["labels"])
    x = forward(cfg, params, batch["tokens"], return_hidden=True, grid=grid,
                fsdp=fsdp)
    return vocab_parallel_ce(cfg, params, x, batch["labels"], grid, fsdp)


# ---------------------------------------------------------------------------
# Serving: KV cache and single-token decode
# ---------------------------------------------------------------------------

def cache_shapes(cfg: TransformerConfig, batch: int, max_len: int) -> dict:
    r = cfg.n_repeats
    if cfg.mla is not None:
        m = cfg.mla
        per = {"c_kv": (r, batch, max_len, m.kv_lora_rank),
               "k_rope": (r, batch, max_len, m.qk_rope_head_dim)}
    elif cfg.kv_cache_dtype == "int8":
        per = {"k_q": (r, batch, max_len, cfg.n_kv_heads, cfg.d_head),
               "v_q": (r, batch, max_len, cfg.n_kv_heads, cfg.d_head),
               "k_s": (r, batch, max_len, cfg.n_kv_heads),
               "v_s": (r, batch, max_len, cfg.n_kv_heads)}
    else:
        per = {"k": (r, batch, max_len, cfg.n_kv_heads, cfg.d_head),
               "v": (r, batch, max_len, cfg.n_kv_heads, cfg.d_head)}
    return {"slots": [dict(per) for _ in cfg.layer_windows]}


def cache_leaf_dtype(name: str, activation_dtype: torch.dtype):
    """The type of a cache leaf: int8 values, float32 scales, the rest in
    the activation type."""
    if name in ("k_q", "v_q"):
        return torch.int8
    if name in ("k_s", "v_s"):
        return torch.float32
    return activation_dtype


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               device="cuda") -> dict:
    """A zero cache on ``device`` (the card unless the caller asks for the
    CPU)."""
    dev = resolve_device(device)
    return {"slots": [{name: torch.zeros(
                           shape, dtype=cache_leaf_dtype(
                               name, cfg.activation_dtype), device=dev)
                       for name, shape in slot.items()}
                      for slot in cache_shapes(cfg, batch, max_len)["slots"]]}


def _quantize_kv(x: torch.Tensor):
    """(B, 1, H, Dh) -> (int8 values, float32 absmax scale per (b, 1, h)):
    round half to even, clipped to +-127, the scale floored at 1e-8."""
    xf = x.to(torch.float32)
    scale = torch.clamp(torch.amax(torch.abs(xf), dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _write(buf: torch.Tensor, at: torch.Tensor, val: torch.Tensor) -> None:
    """``buf[:, at] = val`` in place (``buf`` (B, S, ...), ``val`` (B, 1,
    ...)), cast to the buffer's type."""
    buf.index_copy_(1, at, val.to(buf.dtype))


def _decode_layer(cfg, window, p, x, pos, cache_slot, cache_len):
    """x: (B, 1, d); cache_slot: this layer's (B, S, ...) cache tensors,
    written at ``cache_len`` in place; attention then reads ``cache_len +
    1`` positions."""
    b = x.shape[0]
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    at = cache_len.reshape(1).long()
    hcur = rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.mla is not None:
        m = cfg.mla
        _, _, c_kv, k_rope = mla_mod.mla_qkv(p, m, h, hcur, pos,
                                             cfg.rope_theta)
        _write(cache_slot["c_kv"], at, c_kv)
        _write(cache_slot["k_rope"], at, k_rope[:, :, 0])
        x = x + mla_mod.mla_decode(p, m, h, hcur, pos, cache_slot["c_kv"],
                                   cache_slot["k_rope"], cache_len + 1,
                                   cfg.rope_theta)
    else:
        q = hcur @ p["wq"]
        kx = hcur @ p["wk"]
        vx = hcur @ p["wv"]
        if cfg.qkv_bias:
            q, kx, vx = q + p["bq"], kx + p["bk"], vx + p["bv"]
        q = apply_rope(q.reshape(b, 1, h, dh), pos, cfg.rope_theta)
        kx = apply_rope(kx.reshape(b, 1, hk, dh), pos, cfg.rope_theta)
        vx = vx.reshape(b, 1, hk, dh)
        if cfg.kv_cache_dtype == "int8":
            kq, ks = _quantize_kv(kx)
            vq, vs = _quantize_kv(vx)
            for name, val in (("k_q", kq), ("v_q", vq), ("k_s", ks),
                              ("v_s", vs)):
                _write(cache_slot[name], at, val)
            attn = decode_attention(
                q, cache_slot["k_q"], cache_slot["v_q"], cache_len + 1,
                window=window, k_scale=cache_slot["k_s"],
                v_scale=cache_slot["v_s"])
        else:
            _write(cache_slot["k"], at, kx)
            _write(cache_slot["v"], at, vx)
            attn = decode_attention(q, cache_slot["k"], cache_slot["v"],
                                    cache_len + 1, window=window)
        x = x + attn.reshape(b, 1, h * dh) @ p["wo"]
    hcur = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + _ffn_block(cfg, p, hcur)


class _CacheShare:
    """How one rank holds a decode cache over a grid: the split of each
    leaf (without the repeat dimension), the group over which the sequence
    is split (``None``: every rank holds all of it) and the global position
    of the rank's first one."""

    def __init__(self, cfg, grid, seq_shard: bool, model_seq_shard: bool,
                 local_len: int):
        slot = lm_cache_split(cfg, grid, seq_shard,
                              model_seq_shard)["slots"][0]
        self.split = {k: sp[1:] for k, sp in slot.items()}
        self.grid = grid
        s_ax = next(iter(self.split.values()))[1]
        self.seq = None if s_ax is None else grid.sub(s_ax)
        self.start = 0 if self.seq is None else self.seq.rank * local_len
        parts = split_parts(next(iter(self.split.values())), grid)[1]
        self.max_len = local_len * parts

    def write(self, buf: torch.Tensor, val: torch.Tensor,
              cache_len: torch.Tensor, name: str) -> None:
        """Write ``val`` (B, 1, full heads and dims) at global position
        ``cache_len`` into the rank's share ``buf``, if the rank holds that
        position: the rank's heads or ``d_head`` columns of ``val``, and an
        unchanged write elsewhere (no host read of ``cache_len``)."""
        split = self.split[name]
        val = share(val, (None, None) + tuple(split[2:]), self.grid)
        s_l = buf.shape[1]
        rel = cache_len.reshape(1).long() - self.start
        at = torch.clamp(rel, 0, s_l - 1)
        mine = (rel >= 0) & (rel < s_l)
        val = torch.where(mine.reshape((1,) * val.dim()),
                          val.to(buf.dtype), buf.index_select(1, at))
        buf.index_copy_(1, at, val)

    def read(self, buf: torch.Tensor, name: str) -> torch.Tensor:
        """The rank's slice of the sequence with every head and ``d_head``
        column: a share split over ``model`` on heads or ``d_head`` (the
        baseline layout) is gathered over ``model``."""
        for dim, axes in enumerate(self.split[name]):
            if dim >= 2 and axes is not None:
                buf = all_gather_dim(buf, dim, self.grid.model)
        return buf

    def merge(self, part, dtype):
        """The attention output from this rank's ``(m, l, o)`` partial and
        those of the other ranks of the sequence's group, merged in rank
        order."""
        if self.seq is None:
            return merge_partials([part], dtype)
        every = [self.seq.all_gather(t, tiled=False) for t in part]
        return merge_partials([tuple(t[r] for t in every)
                               for r in range(self.seq.world_size)], dtype)


def _decode_layer_grid(cfg, window, p, x, pos, cache_slot, cache_len,
                       tp: TensorParallel, cs: _CacheShare):
    """``_decode_layer`` on a grid: ``p`` the rank's (FSDP-gathered)
    shares, ``cache_slot`` its cache share.  The query, key and value of
    the new token are gathered over ``model`` (every head), the rank
    attends its slice of the sequence for every head, the partials are
    merged, and the rank's heads go through its rows of ``wo``."""
    b = x.shape[0]
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    hcur = rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.mla is not None:
        m = cfg.mla
        _, _, c_kv, k_rope = mla_mod.mla_qkv(p, m, tp.local_heads(h), hcur,
                                             pos,
                                             cfg.rope_theta)
        cs.write(cache_slot["c_kv"], c_kv, cache_len, "c_kv")
        cs.write(cache_slot["k_rope"], k_rope[:, :, 0], cache_len, "k_rope")
        x = x + mla_mod.mla_decode(p, m, h, hcur, pos, cache_slot["c_kv"],
                                   cache_slot["k_rope"], cache_len + 1,
                                   cfg.rope_theta, tp=tp, cache=cs)
    else:
        q = hcur @ p["wq"]
        kx = hcur @ p["wk"]
        vx = hcur @ p["wv"]
        if cfg.qkv_bias:
            q, kx, vx = q + p["bq"], kx + p["bk"], vx + p["bv"]
        q, kx, vx = (tp.gather(t, -1) for t in (q, kx, vx))
        q = apply_rope(q.reshape(b, 1, h, dh), pos, cfg.rope_theta)
        kx = apply_rope(kx.reshape(b, 1, hk, dh), pos, cfg.rope_theta)
        vx = vx.reshape(b, 1, hk, dh)
        if cfg.kv_cache_dtype == "int8":
            kq, ks = _quantize_kv(kx)
            vq, vs = _quantize_kv(vx)
            for name, val in (("k_q", kq), ("v_q", vq), ("k_s", ks),
                              ("v_s", vs)):
                cs.write(cache_slot[name], val, cache_len, name)
            names = ("k_q", "v_q", "k_s", "v_s")
        else:
            cs.write(cache_slot["k"], kx, cache_len, "k")
            cs.write(cache_slot["v"], vx, cache_len, "v")
            names = ("k", "v")
        read = [cs.read(cache_slot[n], n) for n in names]
        scales = (dict(k_scale=read[2], v_scale=read[3]) if len(read) == 4
                  else {})
        part = decode_attention_partial(q, read[0], read[1], cache_len + 1,
                                        start=cs.start, window=window,
                                        **scales)
        # The rank's rows of wo read its columns of the heads' outputs
        # (its heads where they divide the model axis).
        cols = p["wo"].shape[0]
        attn = cs.merge(part, q.dtype).reshape(b, 1, h * dh)
        x = x + tp.sum(attn[..., tp.rank * cols:(tp.rank + 1) * cols]
                       @ p["wo"])
    hcur = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + _ffn_block(cfg, p, hcur, tp)


def _host_int(value):
    """``value`` as a Python int where it is one on the host (an int or a
    CPU tensor), else ``None`` (reading a card tensor would sync; a dry
    run's tensor holds no value)."""
    if isinstance(value, torch.Tensor):
        return (int(value) if value.device.type == "cpu"
                and not is_dry(value) else None)
    return int(value)


def decode_step(cfg: TransformerConfig, params: dict, cache: dict,
                tokens: torch.Tensor, cache_len, grid=None, *,
                fsdp: bool = True, seq_shard: bool = False,
                model_seq_shard: bool = True):
    """One decode step.  tokens (B, 1) integers; ``cache_len`` a Python int
    or a 0-d integer tensor (the position written).  The cache is written
    in place (what the reference's donation buys).  Returns ``(logits (B,
    1, V) float32, cache)``.

    The cache holds ``max_len`` positions, so ``cache_len`` must lie in
    ``[0, max_len)``: a value on the host outside it raises ``ValueError``
    before anything is written (the reference's write clamps to the last
    position instead).  A value on the card is not read: out of range, it
    fails the device's index check (on a grid, ``torch._assert_async``).

    Over ``grid``: ``params`` and ``cache`` are the rank's shares
    (``fsdp`` as in ``forward``; ``seq_shard`` and ``model_seq_shard`` as
    in ``sharding.lm_cache_split``), ``tokens`` the rank's rows (every
    row under ``seq_shard``, batch 1), and ``max_len`` the global length
    of the cache."""
    b = tokens.shape[0]
    dev = tokens.device
    first = next(iter(cache["slots"][0].values()))
    cs = None
    if grid is not None:
        cs = _CacheShare(cfg, grid, seq_shard, model_seq_shard,
                         first.shape[2])
    max_len = first.shape[2] if cs is None else cs.max_len
    at_host = _host_int(cache_len)
    if at_host is not None and not 0 <= at_host < max_len:
        raise ValueError(f"decode at position {at_host} of a cache of "
                         f"{max_len} positions")
    tp = split = slot_splits = None
    if grid is not None:
        tp = TensorParallel(grid, tokens_split=not seq_shard)
        split, slot_splits = _layer_splits(cfg, grid, fsdp)
    x = _embed(cfg, params, tokens, tp, split)
    cache_len = torch.as_tensor(cache_len, dtype=torch.int32,
                                device=dev).reshape(())
    if cs is not None and at_host is None:
        # A grid's write past the end would land on no rank: fail on the
        # card, as the one-rank write's index check does.
        torch._assert_async((cache_len >= 0) & (cache_len < max_len))
    pos = cache_len + torch.zeros((b, 1), dtype=torch.int32, device=dev)
    for r in range(cfg.n_repeats):
        for slot, window in enumerate(cfg.layer_windows):
            p = {k: t[r] for k, t in params["layers"][slot].items()}
            c = {k: t[r] for k, t in cache["slots"][slot].items()}
            if tp is None:
                x = _decode_layer(cfg, window, p, x, pos, c, cache_len)
            else:
                p = {k: _gather_dp(t, slot_splits[slot][k], grid)
                     for k, t in p.items()}
                x = _decode_layer_grid(cfg, window, p, x, pos, c, cache_len,
                                       tp, cs)
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    return _logits(cfg, params, x, tp, split), cache
