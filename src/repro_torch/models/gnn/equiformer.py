"""EquiformerV2-style equivariant graph attention via eSCN SO(2)
convolutions (arXiv:2306.12059, eSCN trick from arXiv:2302.03655), the
PyTorch port of ``repro.models.gnn.equiformer``.

Node features are real-SH irreps x: (N, (l_max+1)^2, C).  Per edge,
features rotate into the edge-aligned frame (Wigner-D, edge -> +z), where
the full O(l^6) Clebsch-Gordan tensor product collapses to SO(2)-blockwise
linear maps over the m index; truncating to |m| <= m_max (= 2) gives the
eSCN O(l^3) cost.  Attention weights come from the rotation-invariant m = 0
block, messages rotate back and scatter-sum to destinations.  The
reference's simplifications stand: an equivariant gate nonlinearity in
place of the S2 grid activation, value/key projections fused into the
SO(2) convolution.

One layer (``EquiformerLayer.forward``) serves the single-device model,
the all-gather layout over ranks and the halo step
(``core/gnn_halo.equiformer_halo_loss_shard``): the caller hands it the
edge frame (``edge_frame``: Wigner blocks, optionally row-sliced to the
|m| <= m_max rows the SO(2) convolution reads, and the distance RBF) and
a function giving each edge's source and destination rows.  The gate and
the attention weights scale the messages as one product, and sums are
float32 scatter-adds, so results are float32-close to the reference, not
bit-equal.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.graph import resolve_device
from repro_torch.models.gnn.common import (LOCAL, MLP, GraphBatch,
                                           clamp_src, node_ce_loss,
                                           segment_softmax, segment_sum)
from repro_torch.models.gnn.wigner import (block_diag_apply, rotation_to_z,
                                           wigner_d_stack)


@dataclasses.dataclass(frozen=True)
class EquiformerConfig:
    name: str = "equiformer-v2"
    n_layers: int = 12
    d_hidden: int = 128        # sphere channels C
    l_max: int = 6
    m_max: int = 2
    n_heads: int = 8
    n_radial: int = 8          # RBF size for distance embedding
    cutoff: float = 5.0
    d_feat: int = 16
    out_dim: int = 1
    node_level: bool = False   # node classification head instead of energy

    @property
    def n_coef(self) -> int:
        return (self.l_max + 1) ** 2


def _m_indices(l_max: int, m: int) -> tuple:
    """Flat irrep indices of the (+m, -m) coefficients for all l >= m."""
    pos = [l * l + l + m for l in range(m, l_max + 1)]
    neg = [l * l + l - m for l in range(m, l_max + 1)]
    return np.asarray(pos), np.asarray(neg)


def truncated_rows(l_max: int, m_max: int) -> np.ndarray:
    """The flat coefficients with |m| <= m_max, in order: the rows the
    SO(2) convolution reads and writes (the halo step's ``sel``)."""
    sel = []
    for l in range(l_max + 1):
        lo = 0 if l <= m_max else l - m_max
        hi = 2 * l + 1 if l <= m_max else l + m_max + 1
        sel.extend(range(l * l + lo, l * l + hi))
    return np.asarray(sel)


@functools.lru_cache(maxsize=None)
def _coef_tables(l_max: int, m_max: int, truncated: bool,
                 device: torch.device):
    """Index tensors on ``device``: each flat coefficient's l, and the SO(2)
    convolution's rows in the edge-frame row space (all coefficients, or
    the |m| <= m_max ones): the m = 0 rows, then (+m, -m) for m = 1..m_max,
    and all of them in output order."""
    n_coef = (l_max + 1) ** 2
    rows = truncated_rows(l_max, m_max) if truncated else np.arange(n_coef)
    row_of = {int(f): r for r, f in enumerate(rows)}
    groups = [[row_of[l * l + l] for l in range(l_max + 1)]]
    for m in range(1, m_max + 1):
        for side in _m_indices(l_max, m):
            groups.append([row_of[int(i)] for i in side])
    l_of = np.repeat(np.arange(l_max + 1), 2 * np.arange(l_max + 1) + 1)

    def put(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    return (put(l_of), [put(gr) for gr in groups],
            put(np.concatenate(groups)))


def _irrep_norm(x: torch.Tensor, scale: torch.Tensor,
                l_max: int) -> torch.Tensor:
    """Equivariant RMS norm: per-l, per-channel scaling (each l block over
    its root mean square, the sum over its rows averaged over channels)."""
    l_of = _coef_tables(l_max, 0, False, x.device)[0]
    onehot = F.one_hot(l_of, l_max + 1).to(x.dtype)          # (n_coef, L)
    per_l = torch.einsum("nkc,kl->nl", x * x, onehot) / x.shape[-1]
    rms = torch.sqrt(per_l + 1e-8)                           # (N, L)
    return x / rms[:, l_of, None] * scale[l_of]


def _so2_conv(cfg: EquiformerConfig, lp: "EquiformerLayer",
              feat: torch.Tensor, truncated: bool = False):
    """eSCN SO(2) convolution in the edge frame.

    feat: (E, rows, 2C) — rotated src||dst features over all n_coef
    coefficients, or with ``truncated`` over the |m| <= m_max rows only
    (the reference's ``_so2_conv_truncated``, which equals the full
    convolution on those rows).  Returns (E, rows, C) with |m| > m_max
    coefficients zeroed (the eSCN truncation) and the m = 0 output flat.
    The weights take ``feat``'s type (bf16 edges keep bf16 here)."""
    e, rows, c2 = feat.shape
    c = c2 // 2
    lm, dt = cfg.l_max, feat.dtype
    _, groups, order = _coef_tables(lm, cfg.m_max, truncated, feat.device)

    def take(idx):
        return feat.index_select(1, idx).reshape(e, -1)

    # m = 0: plain linear over (l, channel).
    y0 = take(groups[0]) @ lp.w_m0.to(dt)
    ys = [y0.view(e, lm + 1, c)]
    # m >= 1: SO(2)-equivariant pair mixing.
    for m in range(1, cfg.m_max + 1):
        xp, xn = take(groups[2 * m - 1]), take(groups[2 * m])
        w1 = getattr(lp, f"w1_m{m}").to(dt)
        w2 = getattr(lp, f"w2_m{m}").to(dt)
        ys.append((xp @ w1 - xn @ w2).view(e, lm + 1 - m, c))
        ys.append((xp @ w2 + xn @ w1).view(e, lm + 1 - m, c))
    out = feat.new_zeros((e, rows, c)).index_copy(1, order,
                                                   torch.cat(ys, 1))
    return out, y0                                         # messages, m0 flat


class EdgeFrame(NamedTuple):
    """Per-edge geometry: the Wigner blocks (row-sliced to |m| <= m_max
    when ``truncated``, in the edge type) and the distance RBF."""
    ds: List[torch.Tensor]
    truncated: bool
    rbf: torch.Tensor


def edge_frame(cfg: EquiformerConfig, vec: torch.Tensor,
               m_truncate: bool = False,
               edge_dtype: Optional[torch.dtype] = None) -> EdgeFrame:
    """The frame of edges with vectors ``vec`` (E, 3) = dst - src: unit
    vectors rotated to +z, their Wigner blocks up to l_max, and the RBF of
    the distance over ``linspace(0, cutoff, n_radial)``."""
    dist = torch.linalg.norm(vec + 1e-12, dim=-1)
    nvec = vec / torch.clamp(dist[:, None], min=1e-8)
    ds = wigner_d_stack(rotation_to_z(nvec), cfg.l_max)
    if m_truncate:
        # Rows with |m| <= m_max are the only coefficients _so2_conv reads;
        # the blocks are sliced to those rows (and transpose-applied on the
        # way back) — the eSCN O(L^3) trick.
        mm = cfg.m_max
        ds = [d if l <= mm else d[:, l - mm:l + mm + 1]
              for l, d in enumerate(ds)]
    if edge_dtype is not None:
        ds = [d.to(edge_dtype) for d in ds]
    n_rbf = cfg.n_radial
    # float64 linspace rounded once: jnp.linspace's float32 values.
    mu = torch.linspace(0.0, cfg.cutoff, n_rbf, dtype=torch.float64,
                        device=vec.device).to(dist.dtype)
    rbf = torch.exp(-((dist[:, None] - mu) ** 2) * (n_rbf / cfg.cutoff))
    return EdgeFrame(ds, m_truncate, rbf)


def _leaky_relu(x: torch.Tensor, slope: float) -> torch.Tensor:
    """``jax.nn.leaky_relu``: its derivative at exactly 0 is 1 (torch's
    is ``slope``), which counts where a dead hidden layer and a zero bias
    give logits of exactly 0."""
    return torch.where(x >= 0, x, slope * x)


def _normal(gen, *shape, fan):
    return nn.Parameter(torch.randn(*shape, generator=gen) / math.sqrt(fan))


class EquiformerLayer(nn.Module):
    """One layer's parameters under the reference's names and ``(in, out)``
    layout: ``w_m0``, ``w1_m{m}`` / ``w2_m{m}``, ``rbf_mlp``,
    ``attn_mlp``, ``ffn_gate``, ``ffn_l.{l}``, ``ln_scale``, ``out_proj``."""

    def __init__(self, cfg: EquiformerConfig, gen):
        super().__init__()
        c, lm, mm = cfg.d_hidden, cfg.l_max, cfg.m_max
        l0 = lm + 1
        self.cfg = cfg
        # SO(2) conv, m = 0 (real): mixes (l, channel) jointly; input is
        # src||dst concatenated -> 2C channels.
        self.w_m0 = _normal(gen, l0 * 2 * c, l0 * c, fan=l0 * 2 * c)
        self.rbf_mlp = MLP([cfg.n_radial, c, c], gen)
        self.attn_mlp = MLP([l0 * c, c, cfg.n_heads], gen)
        self.ffn_gate = MLP([c, c, lm * c], gen)
        self.ffn_l = nn.ParameterList(_normal(gen, c, c, fan=c)
                                      for _ in range(lm + 1))
        self.ln_scale = nn.Parameter(torch.ones(lm + 1, c))
        self.out_proj = _normal(gen, c, c, fan=c)
        for m in range(1, mm + 1):
            lmc, lout = (lm + 1 - m) * 2 * c, (lm + 1 - m) * c
            setattr(self, f"w1_m{m}", _normal(gen, lmc, lout, fan=lmc))
            setattr(self, f"w2_m{m}", _normal(gen, lmc, lout, fan=lmc))

    def forward(self, x: torch.Tensor, frame: EdgeFrame, pair: Callable,
                dst: torch.Tensor, n_seg: int, live_e: torch.Tensor,
                nodes=LOCAL) -> torch.Tensor:
        """x (N, n_coef, C) -> x after attention and the gated FFN.
        ``pair(h)`` gives each edge's (source, destination) rows of the
        normed state, in the edge type; ``dst`` the destination segment of
        each edge among ``n_seg`` (the last is the padding edges'); with
        ``nodes`` the softmax and the sums are completed over ranks and the
        owned rows' sums kept."""
        cfg = self.cfg
        lm, heads = cfg.l_max, cfg.n_heads
        h = _irrep_norm(x, self.ln_scale, lm)
        # Rotate src/dst into the edge frame (channels concatenated).
        feat = block_diag_apply(frame.ds, torch.cat(pair(h), dim=-1))
        msg, m0 = _so2_conv(cfg, self, feat, frame.truncated)

        # Distance modulation and head attention from the invariant part,
        # applied as one per-edge, per-channel scale.
        gate = self.rbf_mlp(frame.rbf)                            # (E, C)
        logits = _leaky_relu(self.attn_mlp(m0.to(x.dtype)), 0.2)
        logits = torch.where(live_e[:, None], logits, -math.inf)
        alpha = segment_softmax(logits, dst, n_seg, nodes)       # (E, H)
        e, rows, c = msg.shape
        scale = (gate.view(e, heads, c // heads)
                 * alpha[:, :, None]).reshape(e, 1, c)
        msg = msg * scale.to(msg.dtype)

        # Rotate back and aggregate (float sums in the node state's type).
        msg = block_diag_apply(frame.ds, msg, transpose=True)
        msg = torch.where(live_e[:, None, None], msg, 0.0)
        agg = segment_sum(msg.to(x.dtype), dst, n_seg)[:n_seg - 1]
        x = x + nodes.scatter(agg) @ self.out_proj

        # Equivariant gated FFN: each l block times ffn_l[l]; l = 0 through
        # silu, l >= 1 gated by sigmoid(ffn_gate(scalar)).
        h = _irrep_norm(x, self.ln_scale, lm)
        l_of = _coef_tables(lm, 0, False, x.device)[0]
        y = torch.einsum("nkc,kcd->nkd", h,
                         torch.stack(list(self.ffn_l))[l_of])
        gates = torch.sigmoid(self.ffn_gate(h[:, 0])).view(-1, lm, c)
        ffn = torch.cat([F.silu(y[:, :1]), y[:, 1:] * gates[:, l_of[1:] - 1]],
                        dim=1)
        return x + ffn


class Equiformer(nn.Module):
    """Parameters ``embed.{w,b}.{j}``, ``layers.{i}.*`` (``EquiformerLayer``)
    and ``head.{w,b}.{j}``, drawn from ``torch.Generator().manual_seed(seed)``
    on the host and moved to ``device`` (the card unless the caller asks
    for the CPU)."""

    def __init__(self, cfg: EquiformerConfig, seed: int = 0, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        gen = torch.Generator().manual_seed(seed)
        self.embed = MLP([cfg.d_feat, cfg.d_hidden], gen)
        self.layers = nn.ModuleList(EquiformerLayer(cfg, gen)
                                    for _ in range(cfg.n_layers))
        self.head = MLP([cfg.d_hidden, cfg.d_hidden, cfg.out_dim], gen)
        self.to(dev)

    def init_irreps(self, node_feat: torch.Tensor) -> torch.Tensor:
        """(N, n_coef, C): the scalar (l = 0) channel from the input
        features, zeros elsewhere."""
        x0 = self.embed(node_feat)[:, None]
        return torch.cat([x0, x0.new_zeros((x0.shape[0], self.cfg.n_coef - 1,
                                            x0.shape[2]))], dim=1)

    def forward(self, g: GraphBatch, nodes=LOCAL) -> torch.Tensor:
        """Node logits (N_pad, out_dim) with ``node_level``, else graph
        outputs (G, out_dim) over ``graph_id.shape[0]`` segments (rows past
        ``n_graphs`` are the head of zeros).  With ``nodes`` splitting the
        graph's nodes over ranks (node level only) each layer gathers every
        row and keeps the owned rows' sums; edge ids are global."""
        cfg = self.cfg
        pos = nodes.gather(g.positions)
        n_all = pos.shape[0]
        s = clamp_src(g.edge_src, n_all)
        t = clamp_src(g.edge_dst, n_all)
        live_e = g.edge_src < n_all
        frame = edge_frame(cfg, pos[t] - pos[s])

        def pair(h):
            h_all = nodes.gather(h)
            return h_all.index_select(0, s), h_all.index_select(0, t)

        x = self.init_irreps(g.node_feat)
        for layer in self.layers:
            x = layer(x, frame, pair, g.edge_dst, n_all + 1, live_e, nodes)
        scalar = x[:, 0]
        if cfg.node_level:
            return self.head(scalar)                       # (N, out_dim)
        g_out = segment_sum(scalar, g.graph_id, int(g.graph_id.shape[0]))
        return self.head(g_out)                            # (G, out_dim)

    def loss(self, g: GraphBatch) -> torch.Tensor:
        """The reference's ``loss_fn``: masked node cross-entropy, or the
        masked mean squared error of the graph outputs."""
        pred = self(g)
        rows = torch.arange(pred.shape[0], device=pred.device)
        if self.cfg.node_level:
            return node_ce_loss(pred, g.labels,
                                (rows < g.n_nodes).to(pred.dtype))
        gmask = (rows < g.n_graphs).to(pred.dtype)
        target = g.labels[: pred.shape[0]].to(pred.dtype)[:, None]
        err = torch.square(pred - target).mean(-1) * gmask
        return torch.sum(err) / torch.clamp(torch.sum(gmask), min=1.0)
