"""Mixture-of-Experts FFN with capacity-based sort dispatch
(``repro.models.moe``).

Assignments are sorted by expert id (stably), ranked within their expert,
dropped beyond ``capacity``, and the tokens are gathered into a dense (E,
capacity, d) buffer for a batched expert matmul.  Shared experts
(DeepSeek) are plain SwiGLU FFNs added to the routed output.

No step adds floats through atomics, so a step gives the same bits on
every run:
  - the dispatch gathers tokens with ``recsys.gather_rows``, whose backward
    is a sorted, fixed-order segment sum (a token is gathered ``top_k``
    times);
  - the combine adds each token's ``top_k`` contributions in ascending
    expert order, one after another, into a tensor of the expert outputs'
    type, which is the order the reference's sorted scatter-add takes.

The top-k is a stable descending sort, so equal router scores go to the
lowest expert index first, as ``lax.top_k`` breaks ties.

Over a grid of ranks (``tp``, a ``layers.TensorParallel``) every model rank
holds the same tokens and computes the same routing.  Under expert
parallelism (``n_experts`` at least the model axis) each rank runs its
``E / model`` experts on full weights; otherwise every rank runs every
expert on its slice of ``d_ff``.  Either way a rank adds its tokens'
contributions in ascending expert order and the partials are summed over
``model`` in rank order.  Capacity drops are decided on the global token
set: a token's rank within its expert counts the assignments of the lower
dp ranks first, which is the reference's token-major order over the
global batch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.models.layers import acc_dtype, swiglu_ffn
from repro_torch.models.recsys import gather_rows


class MoEParams(NamedTuple):
    router: torch.Tensor            # (d, E)
    w_gate: torch.Tensor            # (E, d, f)
    w_up: torch.Tensor              # (E, d, f)
    w_down: torch.Tensor            # (E, f, d)
    shared_w_gate: Optional[torch.Tensor] = None   # (d, f_shared)
    shared_w_up: Optional[torch.Tensor] = None
    shared_w_down: Optional[torch.Tensor] = None


def _top_k(scores: torch.Tensor, k: int):
    """The ``k`` largest scores of each row and their indices, ties to the
    lowest index (``lax.top_k``'s order)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def moe_ffn(
    x: torch.Tensor,                # (T, d): flattened tokens
    p: MoEParams,
    *,
    top_k: int,
    capacity_factor: float = 1.25,
    router_softmax_after_topk: bool = False,
    tp=None,
) -> torch.Tensor:
    """Top-k routed expert FFN; returns (T, d).  ``tp`` runs it over a grid
    of ranks (the module docstring): ``p``'s expert and shared weights are
    then the rank's (FSDP-gathered) shares and the router is whole."""
    t, d = x.shape
    e = p.router.shape[1]
    acc = acc_dtype(x.dtype)
    dev = x.device
    logits = x.to(acc) @ p.router.to(acc)                      # (T, E)
    if router_softmax_after_topk:
        # Mixtral: softmax over the selected top-k logits only.
        top_logits, top_idx = _top_k(logits, top_k)
        top_w = torch.softmax(top_logits, dim=-1)
    else:
        probs = torch.softmax(logits, dim=-1)
        top_w, top_idx = _top_k(probs, top_k)
        top_w = top_w / torch.clamp(torch.sum(top_w, -1, keepdim=True),
                                    min=1e-9)

    t_global = t if tp is None else t * tp.token_ranks
    capacity = max(int(capacity_factor * t_global * top_k / e), 4)
    # The experts this rank runs: [e_lo, e_lo + e_loc).
    e_loc = p.w_gate.shape[0]
    e_lo = 0 if tp is None or e_loc == e else tp.rank * e_loc
    n_slots = e_loc * capacity

    # Flatten (token, slot) assignments (token-major) and rank them within
    # each expert.
    flat_e = top_idx.reshape(-1)
    flat_tok = torch.arange(t, device=dev).repeat_interleave(top_k)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    ranks = (torch.arange(t * top_k, device=dev)
             - torch.searchsorted(sorted_e, sorted_e, side="left"))
    if tp is not None:
        ranks = ranks + tp.expert_offsets(flat_e, e)[sorted_e]
        x = tp.copy(x)
        top_w = tp.copy(top_w)
    local = (sorted_e >= e_lo) & (sorted_e < e_lo + e_loc)
    keep = (ranks < capacity) & local
    slot = torch.where(keep, (sorted_e - e_lo) * capacity + ranks,
                       torch.full_like(ranks, n_slots))

    # The dispatch buffer gathers its tokens: each kept slot names its
    # token, every dropped (or another rank's) assignment writes the one
    # dummy row.
    src_tok = flat_tok[order]
    slot_tok = torch.zeros(n_slots + 1, dtype=torch.long,
                           device=dev).index_copy_(0, slot, src_tok)
    filled = torch.zeros(n_slots + 1, dtype=torch.bool,
                         device=dev).index_fill_(0, slot, True)
    buf = torch.where(filled[:n_slots, None],
                      gather_rows(x, slot_tok[:n_slots]),
                      torch.zeros((), dtype=x.dtype, device=dev))
    buf = buf.reshape(e_loc, capacity, d)

    # Batched expert FFN: (E, cap, d) x (E, d, f) -> (E, cap, d).
    h = torch.nn.functional.silu(torch.einsum("ecd,edf->ecf", buf, p.w_gate))
    h = h * torch.einsum("ecd,edf->ecf", buf, p.w_up)
    out_buf = torch.einsum("ecf,efd->ecd", h, p.w_down).reshape(n_slots, d)

    # Combine, weighted by the router: each assignment's contribution in
    # the output's type, back in token-major order, then each token's
    # top_k contributions added in ascending expert order.
    gathered = torch.where(
        keep[:, None], out_buf[torch.clamp(slot, max=n_slots - 1)],
        torch.zeros((), dtype=out_buf.dtype, device=dev))
    contrib = (gathered * top_w.reshape(-1)[order][:, None]).to(out_buf.dtype)
    by_token = torch.empty_like(contrib).index_copy(0, order, contrib)
    by_token = by_token.reshape(t, top_k, d)
    by_expert = torch.argsort(top_idx, dim=-1)                 # (T, k)
    by_token = torch.gather(by_token, 1,
                            by_expert[:, :, None].expand(t, top_k, d))
    out = by_token[:, 0]
    for j in range(1, top_k):
        out = out + by_token[:, j]

    if p.shared_w_gate is not None:
        out = out + swiglu_ffn(x, p.shared_w_gate, p.shared_w_up,
                               p.shared_w_down)
    if tp is not None:
        out = tp.sum(out)
    return out.to(x.dtype)
