"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434) of the
PyTorch port (``repro.models.mla``).

Train and prefill up-project the latent ``c_kv`` to per-head K/V and run
the shared blockwise attention.  Decode uses the *absorbed* form: W_UK
folds into the query and W_UV into the output, so a token costs O(S *
kv_lora) and the cache holds only ``kv_lora + rope_dim`` values a
position (576 for V2).  Decode has no window.

Over a grid of ranks (``tp``, a ``layers.TensorParallel``) the
down-projections ``w_dq``, ``w_dkv``, ``w_kr`` and their norms are whole on
every model rank, the up-projections are split by head and ``w_o`` is
row-parallel.  Decode gathers the absorbed queries of every head and
attends the rank's slice of the latent cache.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core.graph import resolve_device
from repro_torch.models.layers import (NEG, acc_dtype, apply_rope,
                                       blockwise_attention, rms_norm)


class MLAConfig(NamedTuple):
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


def mla_qkv(p, cfg: MLAConfig, n_heads: int, x, positions, rope_theta,
            tp=None):
    """Project to (q_nope, q_rope, c_kv, k_rope).  x: (B, S, d); k_rope:
    (B, S, 1, rope_dim).  Over a grid ``n_heads`` is the rank's and its
    ``w_uq`` columns read ``tp.copy`` of the latent query."""
    b, s, _ = x.shape
    h, dn, dr = n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim

    cq = rms_norm(x @ p["w_dq"], p["q_ln"])                    # (B, S, q_lora)
    if tp is not None:
        cq = tp.copy(cq)
    q = (cq @ p["w_uq"]).reshape(b, s, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, rope_theta)

    c_kv = rms_norm(x @ p["w_dkv"], p["kv_ln"])               # (B, S, kv_lora)
    k_rope = apply_rope((x @ p["w_kr"])[:, :, None, :], positions, rope_theta)
    return q_nope, q_rope, c_kv, k_rope


def mla_attention_full(p, cfg: MLAConfig, n_heads: int, x, positions,
                       rope_theta: float, *, q_block: int = 512,
                       kv_block: int = 512, tp=None) -> torch.Tensor:
    """Train/prefill MLA: per-head K/V materialised from the latent.  Over
    a grid the rank runs its heads and the output is summed over
    ``model``."""
    b, s, _ = x.shape
    h = n_heads if tp is None else tp.local_heads(n_heads)
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q_nope, q_rope, c_kv, k_rope = mla_qkv(p, cfg, h, x, positions,
                                           rope_theta, tp)
    if tp is not None:
        c_kv, k_rope = tp.copy(c_kv), tp.copy(k_rope)

    k_nope = (c_kv @ p["w_uk"]).reshape(b, s, h, dn)
    v = (c_kv @ p["w_uv"]).reshape(b, s, h, dv)
    k = torch.cat([k_nope, k_rope.expand(b, s, h, dr)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    scale = 1.0 / math.sqrt(dn + dr)
    out = blockwise_attention(q, k, v, causal=True, q_block=q_block,
                              kv_block=kv_block, softmax_scale=scale)
    out = out.reshape(b, s, h * dv) @ p["w_o"]
    return out if tp is None else tp.sum(out)


def mla_decode(p, cfg: MLAConfig, n_heads: int, x, position,
               c_cache, kr_cache, cache_len, rope_theta: float, *, tp=None,
               cache=None):
    """Absorbed-latent decode.  x: (B, 1, d); caches (B, S, kv_lora) and
    (B, S, rope_dim), read in float32 and masked past ``cache_len``.

    score_h(t) = (W_UK_h^T q_nope_h) . c_t + q_rope_h . k_rope_t
    out_h      = W_UV_h^T (sum_t p_t c_t)

    Over a grid (``tp`` and the cache's layout ``cache``, a
    ``transformer._CacheShare``) the caches are the rank's slice of the
    sequence: every head's absorbed query is gathered over ``model``, the
    slice's ``(m, l, sum_t p_t c_t)`` partials are merged across the
    sequence's ranks, and the rank's heads go through its ``w_uv`` and
    ``w_o`` rows."""
    if tp is not None:
        return _mla_decode_grid(p, cfg, n_heads, x, position, c_cache,
                                kr_cache, cache_len, rope_theta, tp, cache)
    b = x.shape[0]
    h, dn, dr, dv = (n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                     cfg.v_head_dim)
    r = cfg.kv_lora_rank
    acc = acc_dtype(x.dtype)
    q_nope, q_rope, _, _ = mla_qkv(p, cfg, h, x, position, rope_theta)

    w_uk = p["w_uk"].reshape(r, h, dn)
    q_eff = torch.einsum("bohd,rhd->bhr", q_nope.to(acc), w_uk.to(acc))
    c = c_cache.to(acc)
    s_lat = torch.einsum("bhr,bsr->bhs", q_eff, c)
    s_rope = torch.einsum("bohd,bsd->bhs", q_rope.to(acc), kr_cache.to(acc))
    logits = (s_lat + s_rope) / math.sqrt(dn + dr)
    pos = torch.arange(c_cache.shape[1], device=x.device)
    mask = pos[None, None, :] < torch.as_tensor(
        cache_len, device=x.device).reshape(-1, 1, 1)
    logits = torch.where(mask, logits, torch.full((), NEG, dtype=acc,
                                                  device=x.device))
    probs = torch.softmax(logits, dim=-1)
    ctx = torch.einsum("bhs,bsr->bhr", probs, c)
    w_uv = p["w_uv"].reshape(r, h, dv)
    out = torch.einsum("bhr,rhd->bhd", ctx, w_uv.to(acc))
    return (out.reshape(b, 1, h * dv) @ p["w_o"].to(acc)).to(x.dtype)


def _mla_decode_grid(p, cfg: MLAConfig, n_heads: int, x, position,
                     c_cache, kr_cache, cache_len, rope_theta, tp, cache):
    b = x.shape[0]
    h = tp.local_heads(n_heads)
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank
    acc = acc_dtype(x.dtype)
    q_nope, q_rope, _, _ = mla_qkv(p, cfg, h, x, position, rope_theta)
    w_uk = p["w_uk"].reshape(r, h, dn)
    q_eff = tp.gather(torch.einsum("bohd,rhd->bhr", q_nope.to(acc),
                                   w_uk.to(acc)), 1)            # (B, H, r)
    q_rope = tp.gather(q_rope, 2)                               # (B, 1, H, dr)
    c = c_cache.to(acc)
    s_lat = torch.einsum("bhr,bsr->bhs", q_eff, c)
    s_rope = torch.einsum("bohd,bsd->bhs", q_rope.to(acc), kr_cache.to(acc))
    logits = (s_lat + s_rope) / math.sqrt(dn + dr)
    pos = torch.arange(c_cache.shape[1], device=x.device) + cache.start
    mask = pos[None, None, :] < torch.as_tensor(
        cache_len, device=x.device).reshape(-1, 1, 1)
    logits = torch.where(mask, logits, torch.full((), NEG, dtype=acc,
                                                  device=x.device))
    m = torch.amax(logits, dim=-1, keepdim=True)                # (B, H, 1)
    probs = torch.exp(logits - m)
    l = torch.sum(probs, dim=-1, keepdim=True)
    ctx = torch.einsum("bhs,bsr->bhr", probs, c)
    # As merge_partials' (B, Hkv, G, 1, 1) statistics and (B, 1, Hkv, G, D)
    # values, one query head a group.
    part = (m[:, :, None, :, None], l[:, :, None, :, None],
            ctx[:, None, :, None, :])
    ctx = cache.merge(part, acc)[:, 0, tp.rank * h:(tp.rank + 1) * h]
    w_uv = p["w_uv"].reshape(r, h, dv)
    out = torch.einsum("bhr,rhd->bhd", ctx, w_uv.to(acc))
    out = out.reshape(b, 1, h * dv) @ p["w_o"].to(acc)
    return tp.sum(out).to(x.dtype)


def mla_init(cfg: MLAConfig, d_model: int, n_heads: int, seed: int = 0,
             dtype=torch.float32, device="cuda") -> dict:
    """One layer's MLA weights on ``device`` (the card unless the caller
    asks for the CPU), normal / sqrt(fan_in) from a ``torch.Generator``
    seeded with ``seed`` (not JAX's draws), the norm scales ones."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    h, dn, dr, dv = (n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                     cfg.v_head_dim)

    def init(*s):
        return (torch.randn(s, generator=gen, dtype=dtype, device=dev)
                / math.sqrt(max(s[0], 1)))

    return {
        "w_dq": init(d_model, cfg.q_lora_rank),
        "q_ln": torch.ones(cfg.q_lora_rank, dtype=dtype, device=dev),
        "w_uq": init(cfg.q_lora_rank, h * (dn + dr)),
        "w_dkv": init(d_model, cfg.kv_lora_rank),
        "kv_ln": torch.ones(cfg.kv_lora_rank, dtype=dtype, device=dev),
        "w_kr": init(d_model, dr),
        "w_uk": init(cfg.kv_lora_rank, h * dn),
        "w_uv": init(cfg.kv_lora_rank, h * dv),
        "w_o": init(h * dv, d_model),
    }
