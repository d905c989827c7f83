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
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.graph import resolve_device
from repro_torch.models import mla as mla_mod
from repro_torch.models.layers import (acc_dtype, apply_rope,
                                       blockwise_attention,
                                       cross_entropy_loss, decode_attention,
                                       rms_norm, swiglu_ffn)
from repro_torch.models.moe import MoEParams, moe_ffn
from repro_torch.models.recsys import gather_rows

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
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = cfg.activation_dtype
    flat = {}
    for key, shape in flat_params(param_shapes(cfg)).items():
        name = key.rsplit(".", 1)[-1]
        if "ln" in name:
            flat[key] = torch.ones(shape, dtype=dt, device=dev)
        elif name.startswith("b"):
            flat[key] = torch.zeros(shape, dtype=dt, device=dev)
        else:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            x = torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=dev)
            flat[key] = x.div_(math.sqrt(fan_in)).to(dt)
            del x
    return nest_params(flat)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _attention_block(cfg: TransformerConfig, p: dict, x: torch.Tensor,
                     positions, window: Optional[int]) -> torch.Tensor:
    b, s, _ = x.shape
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    if cfg.mla is not None:
        return mla_mod.mla_attention_full(p, cfg.mla, h, x, positions,
                                          cfg.rope_theta)
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = apply_rope(q.reshape(b, s, h, dh), positions, cfg.rope_theta)
    k = apply_rope(k.reshape(b, s, hk, dh), positions, cfg.rope_theta)
    v = v.reshape(b, s, hk, dh)
    out = blockwise_attention(q, k, v, causal=True, window=window)
    return out.reshape(b, s, h * dh) @ p["wo"]


def _ffn_block(cfg: TransformerConfig, p: dict, x: torch.Tensor):
    b, s, d = x.shape
    if cfg.moe is None:
        return swiglu_ffn(x, p["w_gate"], p["w_up"], p["w_down"])
    mp = MoEParams(router=p["router"], w_gate=p["w_gate_e"],
                   w_up=p["w_up_e"], w_down=p["w_down_e"],
                   shared_w_gate=p.get("w_gate_s"),
                   shared_w_up=p.get("w_up_s"),
                   shared_w_down=p.get("w_down_s"))
    out = moe_ffn(x.reshape(b * s, d), mp, top_k=cfg.moe.top_k,
                  capacity_factor=cfg.moe.capacity_factor,
                  router_softmax_after_topk=cfg.moe.softmax_after_topk)
    return out.reshape(b, s, d)


def _decoder_layer(cfg: TransformerConfig, window, p, x, positions):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + _attention_block(cfg, p, h, positions, window)
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + _ffn_block(cfg, p, h)


def _embed(cfg: TransformerConfig, params: dict, tokens: torch.Tensor):
    """The token rows (a sorted, fixed-order segment sum in the backward),
    scaled by sqrt(d_model) in the activation type."""
    dt = cfg.activation_dtype
    x = gather_rows(params["embed"], tokens).to(dt)
    return x * torch.tensor(math.sqrt(cfg.d_model), dtype=dt,
                            device=x.device)


def _logits(cfg: TransformerConfig, params: dict, x: torch.Tensor):
    """The LM head: a product in the activation type, then float32."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (x @ head.to(x.dtype)).to(acc_dtype(x.dtype))


def forward(cfg: TransformerConfig, params: dict, tokens: torch.Tensor,
            return_hidden: bool = False) -> torch.Tensor:
    """tokens (B, S) -> float32 logits (B, S, V); ``return_hidden`` stops
    before the LM head."""
    b, s = tokens.shape
    x = _embed(cfg, params, tokens)
    positions = torch.arange(s, device=x.device)[None, :]
    remat = cfg.remat and torch.is_grad_enabled()
    for r in range(cfg.n_repeats):
        for slot, window in enumerate(cfg.layer_windows):
            p = {k: t[r] for k, t in params["layers"][slot].items()}
            if remat:
                x = checkpoint(_decoder_layer, cfg, window, p, x, positions,
                               use_reentrant=False)
            else:
                x = _decoder_layer(cfg, window, p, x, positions)
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    if return_hidden:
        return x
    return _logits(cfg, params, x)


def loss_fn(cfg: TransformerConfig, params: dict, batch: dict):
    return cross_entropy_loss(forward(cfg, params, batch["tokens"]),
                              batch["labels"])


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


def decode_step(cfg: TransformerConfig, params: dict, cache: dict,
                tokens: torch.Tensor, cache_len):
    """One decode step.  tokens (B, 1) integers; ``cache_len`` a Python int
    or a 0-d integer tensor (the position written).  The cache is written
    in place (what the reference's donation buys).  Returns ``(logits (B,
    1, V) float32, cache)``."""
    b = tokens.shape[0]
    dev = tokens.device
    x = _embed(cfg, params, tokens)
    cache_len = torch.as_tensor(cache_len, dtype=torch.int32,
                                device=dev).reshape(())
    pos = cache_len + torch.zeros((b, 1), dtype=torch.int32, device=dev)
    for r in range(cfg.n_repeats):
        for slot, window in enumerate(cfg.layer_windows):
            p = {k: t[r] for k, t in params["layers"][slot].items()}
            c = {k: t[r] for k, t in cache["slots"][slot].items()}
            x = _decode_layer(cfg, window, p, x, pos, c, cache_len)
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    return _logits(cfg, params, x), cache
