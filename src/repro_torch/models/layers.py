"""Transformer building blocks of the PyTorch port (``repro.models.layers``):
functions on tensors, in the reference's arithmetic.

Attention is blockwise (online softmax over KV blocks, FlashAttention-style
in plain PyTorch ops, no library attention kernel):

  - full-causal layers cut the queries into at most 8 blocks, each visiting
    exactly the KV blocks at or below its diagonal;
  - sliding-window layers visit a fixed span of KV blocks around the
    diagonal (O(S * W) work);
  - GQA never repeats KV heads: query head ``h`` reads KV head ``h // g``
    through the grouped view ``(B, S, Hkv, g, Dh)``.

Matrix products inside attention read their inputs in the activation type
and accumulate in float32: each tile's inputs are widened to float32 (a
bfloat16 value is exact in float32) before the product, as the
reference's ``preferred_element_type=float32``.  Softmax statistics, the
running ``(m, l, o)`` merge, RoPE and the cross-entropy are float32.  A
float64 model (the card's checks) keeps float64 throughout: every
"float32" above is ``promote_types(dtype, float32)``.

``TensorParallel`` is a rank's view of a ``collectives.RankGrid`` for the
LM's tensor-parallel blocks, and ``decode_attention_partial`` /
``merge_partials`` split single-token attention over slices of the cache
held by different ranks (flash decoding).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.collectives import (CopyToRanks, SumFromRanks,
                                         all_gather_dim)

F32 = torch.float32
#: The reference's mask value and softmax-denominator floor.
NEG = -1e30
L_FLOOR = 1e-30


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The accumulation type of ``dtype``: float32, float64 kept."""
    return torch.promote_types(dtype, F32)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """Normalise in float32, cast to ``x``'s type, then scale (in bf16 the
    product is bf16 x bf16)."""
    xf = x.to(acc_dtype(x.dtype))
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def rope_freqs(d_head: int, theta: float = 10000.0, dtype=F32,
               device=None) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=dtype, device=device) / d_head
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, Dh); positions: (B, S), (1, S) or (S,) integers.  The
    two halves of ``Dh`` rotate as a pair (not interleaved pairs), in
    float32, and the result is cast back."""
    acc = acc_dtype(x.dtype)
    freqs = rope_freqs(x.shape[-1], theta, acc, x.device)
    angles = positions[..., :, None].to(acc) * freqs        # (..., S, Dh/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(acc), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _tile(q5, k_blk, v_blk, bias, scale):
    """One attention tile.  q5: (B, Qb, Hkv, G, Dh); k/v: (B, Kb, Hkv, Dh);
    bias: (Qb, Kb), 0 where a key is visible and -1e30 where masked.

    Returns running-softmax pieces (m, l, o) with m, l: (B, Hkv, G, Qb, 1)
    and o: (B, Qb, Hkv, G, Dv), in the accumulation type."""
    acc = bias.dtype
    s = torch.einsum("bqhgd,bkhd->bhgqk", q5.to(acc), k_blk.to(acc))
    s = s * scale + bias
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v_blk.dtype).to(acc),
                     v_blk.to(acc))
    return m, l, o


def _tr(t: torch.Tensor) -> torch.Tensor:
    """(B, H, G, Q, 1) -> (B, Q, H, G, 1), to scale o."""
    return t.permute(0, 3, 1, 2, 4)


def _merge(carry, m_i, l_i, o_i):
    m_run, l_run, o_run = carry
    m_new = torch.maximum(m_run, m_i)
    alpha = torch.exp(m_run - m_new)
    beta = torch.exp(m_i - m_new)
    l_new = l_run * alpha + l_i * beta
    o_new = o_run * _tr(alpha) + o_i * _tr(beta)
    return m_new, l_new, o_new


def _mask_bias(mask: torch.Tensor, acc: torch.dtype) -> torch.Tensor:
    return torch.where(mask, torch.zeros((), dtype=acc, device=mask.device),
                       torch.full((), NEG, dtype=acc, device=mask.device))


def blockwise_attention(
    q: torch.Tensor,               # (B, Sq, Hq, Dh)
    k: torch.Tensor,               # (B, Sk, Hkv, Dh)
    v: torch.Tensor,               # (B, Sk, Hkv, Dv)
    *,
    causal: bool = True,
    window: Optional[int] = None,  # sliding-window size (None = full)
    q_offset: int = 0,             # absolute position of q[0]
    q_block: int = 512,
    kv_block: int = 512,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    b, sq, hq, dh = q.shape
    _, sk, hkv, _ = k.shape
    dv = v.shape[-1]
    g = hq // hkv
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(dh)
    acc = acc_dtype(q.dtype)
    dev = q.device

    q_block = min(q_block, sq)
    kv_block = min(kv_block, sk)
    windowed = window is not None and window < sk
    if not windowed:
        # At most 8 query blocks on the causal-exact path (the reference
        # unrolls them; the bound also sets the summation order).
        q_block = max(q_block, -(-sq // 8))
    if sq % q_block or sk % kv_block:
        raise ValueError(f"blocks must divide the sequences: sq {sq}, "
                         f"q_block {q_block}, sk {sk}, kv_block {kv_block}")
    nq, nk = sq // q_block, sk // kv_block
    q5 = q.reshape(b, sq, hkv, g, dh)
    ar_q = torch.arange(q_block, device=dev)
    ar_k = torch.arange(kv_block, device=dev)

    def carry0():
        return (torch.full((b, hkv, g, q_block, 1), NEG, dtype=acc,
                           device=dev),
                torch.zeros((b, hkv, g, q_block, 1), dtype=acc, device=dev),
                torch.zeros((b, q_block, hkv, g, dv), dtype=acc, device=dev))

    def finish(carry):
        _, l_f, o_f = carry
        return o_f / torch.clamp(_tr(l_f), min=L_FLOOR)

    def run_block(qi: int, kv_blocks, in_window):
        q_i = q5[:, qi * q_block:(qi + 1) * q_block]
        q_pos = q_offset + qi * q_block + ar_q
        carry = carry0()
        for kb in kv_blocks:
            lo = kb * kv_block
            kv_pos = lo + ar_k
            mask = in_window(q_pos[:, None], kv_pos[None, :])
            if causal:
                mask = mask & (q_pos[:, None] >= kv_pos[None, :])
            carry = _merge(carry, *_tile(
                q_i, k[:, lo:lo + kv_block], v[:, lo:lo + kv_block],
                _mask_bias(mask, acc), scale))
        return finish(carry)

    parts = []
    if windowed:
        span = min(nk, -(-(window + q_block) // kv_block) + 1)
        for qi in range(nq):
            lo_pos = max(q_offset + qi * q_block - window + 1, 0)
            kv_lo = min(max(lo_pos // kv_block, 0), nk - span)
            parts.append(run_block(
                qi, range(kv_lo, kv_lo + span),
                lambda qp, kp: qp - kp < window))
    else:
        for qi in range(nq):
            hi = nk if not causal else min(
                nk, -(-(q_offset + (qi + 1) * q_block) // kv_block))
            parts.append(run_block(
                qi, range(hi),
                lambda qp, kp: torch.ones(
                    (qp.shape[0], kp.shape[1]), dtype=torch.bool,
                    device=dev)))
    out = torch.cat(parts, dim=1) if nq > 1 else parts[0]
    return out.reshape(b, sq, hq, dv).to(q.dtype)


def decode_attention(
    q: torch.Tensor,              # (B, 1, Hq, Dh)
    k_cache: torch.Tensor,        # (B, S, Hkv, Dh): activation type or int8
    v_cache: torch.Tensor,        # (B, S, Hkv, Dh)
    cache_len,                    # (B,), 0-d tensor or int: valid prefix
    *,
    window: Optional[int] = None,
    softmax_scale: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,   # (B, S, Hkv) int8 scales
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Single-token attention against a padded KV cache, O(S) per token.
    With ``k_scale`` / ``v_scale`` the caches hold int8 values; each
    position's scale folds into the logits and into the probabilities.
    The whole cache is read in float32 and masked past ``cache_len``."""
    b, s, hkv, dh = k_cache.shape
    hq = q.shape[2]
    g = hq // hkv
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(dh)
    acc = acc_dtype(q.dtype)
    qf = q[:, 0].to(acc).reshape(b, hkv, g, dh)
    logits = torch.einsum("bhgd,bshd->bhgs", qf, k_cache.to(acc))
    if k_scale is not None:
        logits = logits * k_scale.permute(0, 2, 1)[:, :, None, :]
    logits = logits * scale
    pos = torch.arange(s, device=q.device)[None, None, None, :]
    clen = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1, 1, 1)
    mask = pos < clen
    if window is not None and window < s:
        mask = mask & (pos >= clen - window)
    logits = torch.where(mask, logits, torch.full((), NEG, dtype=acc,
                                                  device=q.device))
    p = torch.softmax(logits, dim=-1)
    if v_scale is not None:
        p = p * v_scale.permute(0, 2, 1)[:, :, None, :]
    out = torch.einsum("bhgs,bshd->bhgd", p, v_cache.to(acc))
    return out.reshape(b, 1, hq, dh).to(q.dtype)


def decode_attention_partial(
    q: torch.Tensor,              # (B, 1, Hq, Dh)
    k_cache: torch.Tensor,        # (B, S, Hkv, Dh): a slice of the cache
    v_cache: torch.Tensor,
    cache_len,                    # 0-d tensor or int: the global prefix
    *,
    start=0,                      # global position of the slice's first
    window: Optional[int] = None,
    softmax_scale: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
):
    """``decode_attention`` over one slice of the cache, unnormalised: the
    running-softmax pieces ``(m, l, o)`` with m, l: (B, Hkv, G, 1, 1) and
    o: (B, 1, Hkv, G, Dh) in the accumulation type, which ``_merge``
    combines across slices.  A slice with no visible position has m =
    -1e30 and weighs nothing in the merge."""
    b, s, hkv, dh = k_cache.shape
    hq = q.shape[2]
    g = hq // hkv
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(dh)
    acc = acc_dtype(q.dtype)
    qf = q[:, 0].to(acc).reshape(b, hkv, g, dh)
    logits = torch.einsum("bhgd,bshd->bhgs", qf, k_cache.to(acc))
    if k_scale is not None:
        logits = logits * k_scale.permute(0, 2, 1)[:, :, None, :]
    logits = logits * scale
    pos = (torch.arange(s, device=q.device) + start)[None, None, None, :]
    clen = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1, 1, 1)
    mask = pos < clen
    if window is not None:
        mask = mask & (pos >= clen - window)
    logits = torch.where(mask, logits, torch.full((), NEG, dtype=acc,
                                                  device=q.device))
    m = torch.amax(logits, dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    if v_scale is not None:
        p = p * v_scale.permute(0, 2, 1)[:, :, None, :]
    o = torch.einsum("bhgs,bshd->bhgd", p, v_cache.to(acc))
    return m[..., None], l[..., None], o[:, None]


def merge_partials(parts, dtype: torch.dtype) -> torch.Tensor:
    """The attention output (B, 1, Hq, Dh) in ``dtype`` from the ``(m, l,
    o)`` partials of every slice, merged in order by ``_merge``."""
    carry = parts[0]
    for part in parts[1:]:
        carry = _merge(carry, *part)
    _, l_f, o_f = carry
    out = o_f / torch.clamp(_tr(l_f), min=L_FLOOR)
    b, _, hkv, g, dv = out.shape
    return out.reshape(b, 1, hkv * g, dv).to(dtype)


class TensorParallel:
    """A rank's view of a ``collectives.RankGrid`` for the LM's blocks:
    ``rank`` of ``size`` on the ``model`` axis, ``copy`` (Megatron's ``f``:
    before a column-parallel product) and ``sum`` (``g``: after a
    row-parallel product) over ``model``, ``gather`` over ``model`` along a
    dimension.  ``tokens_split``: the rank's tokens are its dp rows of the
    global batch (else every dp rank holds the same tokens, as at decode
    batch 1), which the MoE's capacity counts."""

    def __init__(self, grid, tokens_split: bool = True):
        self.grid = grid
        self.model = grid.model
        self.dp = grid.dp
        self.rank = grid.coords["model"]
        self.size = grid.shape["model"]
        self.tokens_split = tokens_split
        self.token_ranks = self.dp.world_size if tokens_split else 1

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return CopyToRanks.apply(x, self.model)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return SumFromRanks.apply(x, self.model)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return all_gather_dim(x, dim, self.model)

    def expert_offsets(self, flat_e: torch.Tensor,
                       n_experts: int) -> torch.Tensor:
        """(E,) the assignments to each expert on the lower dp ranks: the
        global token-major order puts them first."""
        counts = torch.zeros(n_experts, dtype=torch.int64,
                             device=flat_e.device).index_add_(
            0, flat_e.long(), torch.ones_like(flat_e, dtype=torch.int64))
        if not self.tokens_split or self.dp.world_size == 1:
            return torch.zeros_like(counts)
        every = self.dp.all_gather(counts, tiled=False)
        return torch.sum(every[:self.dp.rank], dim=0)

    def local_heads(self, n_heads: int) -> int:
        if n_heads % self.size:
            raise ValueError(f"{n_heads} heads do not split over a model "
                             f"axis of {self.size}")
        return n_heads // self.size


def swiglu_ffn(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
               w_down: torch.Tensor) -> torch.Tensor:
    h = torch.nn.functional.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_id: int = -1) -> torch.Tensor:
    """Mean token CE in float32, ignoring ``ignore_id`` positions."""
    logits = logits.to(acc_dtype(logits.dtype))
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1,
                      torch.clamp(labels, min=0).long()[..., None])[..., 0]
    mask = labels != ignore_id
    nll = (lse - ll) * mask
    return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1)
