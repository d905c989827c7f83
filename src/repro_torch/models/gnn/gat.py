"""GAT (arXiv:1710.10903) of the PyTorch port (``repro.models.gnn.gat``):
SDDMM edge scores -> segment softmax -> weighted scatter.  gat-cora config:
2 layers, 8 hidden per head, 8 heads."""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.graph import resolve_device
from repro_torch.models.gnn.common import (LOCAL, GraphBatch, clamp_src,
                                           node_ce_loss, segment_softmax)


@dataclasses.dataclass(frozen=True)
class GATConfig:
    name: str = "gat-cora"
    n_layers: int = 2
    d_hidden: int = 8          # per head
    n_heads: int = 8
    d_feat: int = 1433
    n_classes: int = 7
    negative_slope: float = 0.2


class GATLayer(nn.Module):
    """``w`` (d_in, heads, d_out), ``a_src`` / ``a_dst`` (heads, d_out)."""

    def __init__(self, d_in: int, heads: int, d_out: int, generator):
        super().__init__()

        def normal(*shape, fan):
            return nn.Parameter(torch.randn(*shape, generator=generator)
                                / math.sqrt(fan))

        self.w = normal(d_in, heads, d_out, fan=d_in)
        self.a_src = normal(heads, d_out, fan=d_out)
        self.a_dst = normal(heads, d_out, fan=d_out)


class GAT(nn.Module):
    """Parameters ``layers.{i}.{w,a_src,a_dst}``, drawn from
    ``torch.Generator().manual_seed(seed)`` on the host and moved to
    ``device`` (the card unless the caller asks for the CPU)."""

    def __init__(self, cfg: GATConfig, seed: int = 0, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        gen = torch.Generator().manual_seed(seed)
        layers, d_in = [], cfg.d_feat
        for i in range(cfg.n_layers):
            last = i == cfg.n_layers - 1
            d_out = cfg.n_classes if last else cfg.d_hidden
            heads = 1 if last else cfg.n_heads
            layers.append(GATLayer(d_in, heads, d_out, gen))
            d_in = heads * d_out
        self.layers = nn.ModuleList(layers)
        self.to(dev)

    def forward(self, g: GraphBatch, nodes=LOCAL) -> torch.Tensor:
        """Logits (N_pad, n_classes): of the owned rows when ``nodes``
        splits the graph's nodes over ranks (each layer gathers every row,
        completes the softmax over the ranks' edges and scatters back the
        owned rows' sums; edge ids are global)."""
        dst = g.edge_dst
        x = g.node_feat
        for i, lp in enumerate(self.layers):
            last = i == self.cfg.n_layers - 1
            x_all = nodes.gather(x)
            n_all = x_all.shape[0]
            src, dst_c = clamp_src(g.edge_src, n_all), clamp_src(dst, n_all)
            h = torch.einsum("nd,dho->nho", x_all, lp.w)       # (N, H, O)
            s_src = torch.einsum("nho,ho->nh", h, lp.a_src)    # (N, H)
            s_dst = torch.einsum("nho,ho->nh", h, lp.a_dst)
            e = s_src[src] + s_dst[dst_c]                      # (E, H) SDDMM
            e = F.leaky_relu(e, self.cfg.negative_slope)
            # Mask padding edges out of the softmax.
            e = torch.where((dst < n_all)[:, None], e, -math.inf)
            alpha = segment_softmax(e, dst, n_all + 1, nodes)  # (E, H)
            msg = h[src] * alpha[:, :, None]
            out = nodes.scatter(h.new_zeros((n_all + 1,) + h.shape[1:])
                                .index_add(0, dst, msg)[:n_all])
            x = (out if last else F.elu(out)).reshape(out.shape[0], -1)
        return x  # (N, n_classes)

    def loss(self, g: GraphBatch) -> torch.Tensor:
        logits = self(g)
        rows = torch.arange(logits.shape[0], device=logits.device)
        return node_ce_loss(logits, g.labels,
                            (rows < g.n_nodes).to(logits.dtype))
