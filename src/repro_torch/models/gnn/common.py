"""Shared GNN infrastructure of the PyTorch port
(``repro.models.gnn.common``): message passing on padded edge lists by
gathers and scatter-adds.

Edge lists are padded to a fixed capacity with ``src = dst = N_pad`` (a
sentinel).  Two differences from JAX are handled here:

  * JAX clamps an out-of-range gather, so ``x[N_pad]`` reads row
    ``N_pad - 1``; PyTorch raises.  Gathers clamp ``src`` to ``N_pad - 1``
    (``clamp_src``), which gives the reference's values; padding edges add
    into the sentinel segment ``N_pad``, which is dropped (``[:n_pad]``),
    and GAT masks them to ``-inf``.
  * ``jax.ops.segment_max`` gives ``-inf`` for an empty segment;
    ``segment_softmax`` starts its ``scatter_reduce`` from ``-inf`` to
    match, and maps it to 0 as the reference does.

Float sums here are float32 ``index_add_``: on the card its atomics add in
no fixed order, so results are float32-close to the reference, not
bit-equal.  Weights keep the reference's layout: an ``MLP`` computes
``x @ w + b`` with ``w`` shaped ``(in, out)``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

#: Edges per block of ``gather_scatter_sum``: bounds its (block, d)
#: message buffer (6.7 GB at d = 100 in float32).
EDGE_CHUNK = 1 << 24


class GraphBatch(NamedTuple):
    """Padded graph (or batch of merged graphs).

    node_feat : (N_pad, d_feat) float — input features.
    edge_src  : (E_pad,) int — source node per directed edge (pad = N_pad).
    edge_dst  : (E_pad,) int — destination node (pad = N_pad).
    n_nodes   : int — valid node count.
    labels    : (N_pad,) int or (G,) — targets (node class / graph target).
    graph_id  : (N_pad,) int — graph of each node (merged small graphs).
    n_graphs  : int.
    positions : (N_pad, 3) float or None — 3D coordinates.
    t_kj/t_ji : (T,) int or None — DimeNet's triplets (edge kj feeds edge
                ji; pad = E_pad); the reference passes them beside the
                graph.
    """

    node_feat: torch.Tensor
    edge_src: torch.Tensor
    edge_dst: torch.Tensor
    n_nodes: int
    labels: torch.Tensor
    graph_id: torch.Tensor
    n_graphs: int
    positions: Optional[torch.Tensor] = None
    t_kj: Optional[torch.Tensor] = None
    t_ji: Optional[torch.Tensor] = None


class LocalNodes:
    """The node exchange of a graph held whole by one rank: every method is
    the identity.  A model layer calls ``gather`` on its owned rows to get
    every row, ``scatter`` on every row's partial sums to get its owned
    rows' sums, and ``all_sum`` / ``all_max`` to complete per-node
    reductions over edges held by several ranks
    (``configs.gnn_common.ShardedNodes`` splits the nodes over ranks)."""

    def gather(self, x):
        return x

    def scatter(self, x):
        return x

    def all_sum(self, x):
        return x

    def all_max(self, x):
        return x


LOCAL = LocalNodes()


def clamp_src(edge_src: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Gather indices clamped into ``[0, n_rows)``: JAX's out-of-range
    gather."""
    return edge_src.clamp(max=n_rows - 1)


def segment_sum(values: torch.Tensor, segments: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum`` in the values' type (differentiable)."""
    out = values.new_zeros((num_segments,) + values.shape[1:])
    return out.index_add(0, segments, values)


class _GatherScatterSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, src, dst, num_segments, out_dtype):
        out = torch.zeros((num_segments,) + x.shape[1:], dtype=out_dtype,
                          device=x.device)
        for a in range(0, src.numel(), EDGE_CHUNK):
            msgs = x.index_select(0, src[a:a + EDGE_CHUNK])
            out.index_add_(0, dst[a:a + EDGE_CHUNK], msgs.to(out_dtype))
        ctx.save_for_backward(src, dst)
        ctx.x_rows, ctx.x_dtype = x.shape[0], x.dtype
        return out

    @staticmethod
    def backward(ctx, grad):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None, None
        src, dst = ctx.saved_tensors
        gx = grad.new_zeros((ctx.x_rows,) + grad.shape[1:])
        for a in range(0, src.numel(), EDGE_CHUNK):
            gx.index_add_(0, src[a:a + EDGE_CHUNK],
                          grad.index_select(0, dst[a:a + EDGE_CHUNK]))
        return gx.to(ctx.x_dtype), None, None, None, None


def gather_scatter_sum(x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                       num_segments: int,
                       out_dtype: Optional[torch.dtype] = None
                       ) -> torch.Tensor:
    """``segment_sum(x[src].astype(out_dtype), dst, num_segments)``, the
    messages gathered and added ``EDGE_CHUNK`` edges at a time, so that no
    (E, d) buffer is held (the same sums; the backward adds ``grad[dst]``
    into ``x``'s rows the same way, in ``out_dtype``, and skips it when
    ``x`` needs no gradient).  ``src`` must be in range (``clamp_src``)."""
    return _GatherScatterSum.apply(x, src, dst, num_segments,
                                   out_dtype or x.dtype)


def segment_softmax(logits: torch.Tensor, segments: torch.Tensor,
                    num_segments: int, nodes=LOCAL) -> torch.Tensor:
    """Softmax over groups (e.g. the incoming edges of each node); with
    ``nodes`` the groups' maxima and sums are completed over the ranks'
    edges.  The shift by the segment maximum carries no gradient (the
    softmax does not depend on it)."""
    idx = segments.to(torch.int64).view((-1,) + (1,) * (logits.dim() - 1))
    idx = idx.expand_as(logits)
    mx = logits.new_full((num_segments,) + logits.shape[1:], -math.inf)
    mx = mx.scatter_reduce(0, idx, logits.detach(), "amax",
                           include_self=True)
    mx = nodes.all_max(mx)
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    ex = torch.exp(logits - mx[segments])
    den = nodes.all_sum(segment_sum(ex, segments, num_segments))
    return ex / torch.clamp(den[segments], min=1e-16)


def scatter_mean(values: torch.Tensor, segments: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    s = segment_sum(values, segments, num_segments)
    c = segment_sum(torch.ones(segments.shape, dtype=values.dtype,
                               device=values.device), segments, num_segments)
    c = torch.clamp(c, min=1.0)
    return s / (c[:, None] if values.dim() > 1 else c)


class MLP(nn.Module):
    """The reference's ``mlp`` / ``mlp_init``: ``x @ w + b`` per layer with
    ``w`` shaped ``(in, out)``, an activation between layers; ``w`` drawn
    from a standard normal over ``sqrt(in)``, ``b`` zero."""

    def __init__(self, dims: Sequence[int],
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.w = nn.ParameterList(
            nn.Parameter((torch.randn(dims[i], dims[i + 1],
                                      generator=generator)
                          / math.sqrt(dims[i])).to(dtype))
            for i in range(len(dims) - 1))
        self.b = nn.ParameterList(
            nn.Parameter(torch.zeros(dims[i + 1], dtype=dtype))
            for i in range(len(dims) - 1))

    def forward(self, x: torch.Tensor, act=F.relu) -> torch.Tensor:
        for i, (w, b) in enumerate(zip(self.w, self.b)):
            x = x @ w + b
            if i + 1 < len(self.w):
                x = act(x)
        return x


def node_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-row cross-entropy, in float32 or wider."""
    if logits.dtype not in (torch.float32, torch.float64):
        logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, 1,
                      torch.clamp(labels, min=0).to(torch.int64)[:, None])
    return lse - ll[:, 0]


def node_ce_loss(logits: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """Masked mean cross-entropy."""
    nll = node_nll(logits, labels) * mask
    return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)
