"""DimeNet (arXiv:2003.03123) of the PyTorch port
(``repro.models.gnn.dimenet``): directional message passing with
spherical Bessel / spherical-harmonic bases and triplet (k->j->i)
interactions.

Config (assigned): 6 blocks, d=128, n_bilinear=8, n_spherical=7, n_radial=6.

Bases:
  RBF(d)    = sqrt(2/c) * sin(n pi d / c) / d                       n=1..6
  SBF(d,a)  = j_l(z_{l,n} d / c) * Y_l^0(a)        l=0..6, n=1..6
with j_l the spherical Bessel functions (closed forms, Taylor series near
0) and z_{l,n} their roots (scipy, once per size).

Triplets: for every directed edge (j -> i), every incoming edge (k -> j),
k != i, contributes a message weighted by the angle between the two edge
vectors.  ``build_triplets_host`` builds the index lists on the host,
vectorised, in the reference's order and padding.  The bilinear
interaction ``einsum("tb,bdo,td->to")`` runs as the edges' ``(d, b·o)``
product gathered per triplet and contracted with the triplet's ``b``
weights, so no (T, d, d) tensor is formed.  Sums are float32 scatter-adds:
results are float32-close to the reference, not bit-equal.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.core.graph import resolve_device
from repro_torch.models.gnn.common import (MLP, GraphBatch, clamp_src,
                                           segment_sum)


# --- spherical Bessel j_l, closed forms up to l = 6 -------------------------

def _sph_jl(l: int, x: torch.Tensor) -> torch.Tensor:
    """Numerically-safe j_l(x): closed forms for x >~ 0.5, Taylor series
    below (the closed forms carry 1/x^(l+1) terms that explode near 0)."""
    # The closed forms cancel catastrophically below x ~ l (terms of size
    # (2l-1)!!/x^(l+1) summing to O(x^l)); switch to the Taylor series there.
    thresh = max(0.5, 0.55 * l + 0.5)
    small = x < thresh
    xs = torch.where(small, thresh + 1.0, x)   # safe arg for the closed form
    s, c = torch.sin(xs), torch.cos(xs)
    inv = 1.0 / xs
    if l == 0:
        big = s * inv
    elif l == 1:
        big = s * inv**2 - c * inv
    elif l == 2:
        big = (3 * inv**3 - inv) * s - 3 * inv**2 * c
    elif l == 3:
        big = (15 * inv**4 - 6 * inv**2) * s - (15 * inv**3 - inv) * c
    elif l == 4:
        big = (105 * inv**5 - 45 * inv**3 + inv) * s \
            - (105 * inv**4 - 10 * inv**2) * c
    elif l == 5:
        big = (945 * inv**6 - 420 * inv**4 + 15 * inv**2) * s \
            - (945 * inv**5 - 105 * inv**3 + inv) * c
    elif l == 6:
        big = (10395 * inv**7 - 4725 * inv**5 + 210 * inv**3 - inv) * s \
            - (10395 * inv**6 - 1260 * inv**4 + 21 * inv**2) * c
    else:
        raise ValueError(l)
    # Small-x series: x^l/(2l+1)!! * sum_k (-x^2/2)^k / (k! (2l+3)(2l+5)...).
    dfact = float(np.prod(np.arange(2 * l + 1, 0, -2))) if l > 0 else 1.0
    x2 = x * x
    term = torch.ones_like(x)
    series = torch.ones_like(x)
    for k in range(1, 6):
        term = term * (-x2 / 2.0) / (k * (2 * l + 2 * k + 1))
        series = series + term
    series = x**l / dfact * series
    return torch.where(small, series, big)


@functools.lru_cache(maxsize=None)
def _bessel_zeros(n_l: int, n_n: int) -> np.ndarray:
    """Roots z_{l,n} of j_l, shape (n_l, n_n) — scipy once, host-side."""
    from scipy import optimize, special
    zeros = np.zeros((n_l, n_n))
    for l in range(n_l):
        def f(x, l=l):
            return special.spherical_jn(l, x)
        found, x = [], l + 1e-3  # j_l's first zero is > l
        step = 0.1
        while len(found) < n_n:
            if f(x) * f(x + step) < 0:
                found.append(optimize.brentq(f, x, x + step))
            x += step
        zeros[l] = found
    return zeros


def _legendre_y_l0(l: int, cos_t: torch.Tensor) -> torch.Tensor:
    """Y_l^0 up to normalization constant sqrt((2l+1)/4pi) * P_l(cos t)."""
    p = [torch.ones_like(cos_t), cos_t]
    for ll in range(2, l + 1):
        p.append(((2 * ll - 1) * cos_t * p[-1] - (ll - 1) * p[-2]) / ll)
    return math.sqrt((2 * l + 1) / (4 * math.pi)) * p[l]


@dataclasses.dataclass(frozen=True)
class DimeNetConfig:
    name: str = "dimenet"
    n_blocks: int = 6
    d_hidden: int = 128
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    cutoff: float = 5.0
    d_feat: int = 16           # input node feature dim (atom embedding stub)
    out_dim: int = 1           # graph-level regression target


#: Edges of ``build_triplets_host``'s candidate wedges per numpy pass.
TRIPLET_CHUNK = 1 << 22


def build_triplets_host(edge_src: np.ndarray, edge_dst: np.ndarray,
                        n_edges: int, cap: int) -> Tuple[np.ndarray,
                                                         np.ndarray]:
    """(t_kj, t_ji) edge-index pairs: edge kj feeds edge ji when dst(kj) ==
    src(ji) and src(kj) != dst(ji).  Padded to ``cap`` with n_edges.

    The reference's lists, vectorised: ji ascending, and for each ji its
    kj in ascending edge order; the first ``cap`` kept.  Edges are taken
    in passes of candidate wedges, stopping once ``cap`` are found."""
    src = np.asarray(edge_src)[:n_edges].astype(np.int64)
    dst = np.asarray(edge_dst)[:n_edges].astype(np.int64)
    by_dst = np.argsort(dst, kind="stable")          # edges into each node
    keys = dst[by_dst]
    lo = np.searchsorted(keys, src, side="left")     # edges into src(ji)
    cnt = np.searchsorted(keys, src, side="right") - lo
    ends = np.cumsum(cnt)
    kj_out, ji_out, found, e0 = [], [], 0, 0
    while e0 < n_edges and found < cap:
        base = ends[e0 - 1] if e0 else 0
        e1 = max(int(np.searchsorted(ends, base + TRIPLET_CHUNK,
                                     side="right")), e0 + 1)
        e1 = min(e1, n_edges)
        c = cnt[e0:e1]
        ji = np.repeat(np.arange(e0, e1), c)
        start = np.repeat(np.cumsum(c) - c, c)
        kj = by_dst[np.repeat(lo[e0:e1], c) + np.arange(ji.size) - start]
        keep = src[kj] != dst[ji]
        kj_out.append(kj[keep])
        ji_out.append(ji[keep])
        found += int(keep.sum())
        e0 = e1
    t_kj = np.concatenate(kj_out or [np.zeros(0, np.int64)])[:cap]
    t_ji = np.concatenate(ji_out or [np.zeros(0, np.int64)])[:cap]
    pad = cap - t_kj.size
    return (np.concatenate([t_kj, np.full(pad, n_edges)]).astype(np.int32),
            np.concatenate([t_ji, np.full(pad, n_edges)]).astype(np.int32))


def rbf_basis(d: torch.Tensor, n_radial: int, cutoff: float) -> torch.Tensor:
    n = torch.arange(1, n_radial + 1, dtype=d.dtype, device=d.device)
    d = torch.clamp(d, min=1e-8)[:, None]
    env = torch.where(d < cutoff, 1.0, 0.0).to(d.dtype)
    return env * math.sqrt(2.0 / cutoff) * torch.sin(n * math.pi * d
                                                     / cutoff) / d


def sbf_basis(d: torch.Tensor, cos_angle: torch.Tensor, n_spherical: int,
              n_radial: int, cutoff: float) -> torch.Tensor:
    """(T, n_spherical * n_radial) spherical basis over triplets (columns
    l-major, n-minor), each l's radial part over all n at once."""
    zeros = torch.as_tensor(_bessel_zeros(n_spherical, n_radial),
                            device=d.device).to(d.dtype)     # (L, N)
    d = torch.clamp(d, min=1e-8)
    parts = []
    for l in range(n_spherical):
        ang = _legendre_y_l0(l, cos_angle)                   # (T,)
        rad = _sph_jl(l, zeros[l] * d[:, None] / cutoff)     # (T, N)
        parts.append(rad * ang[:, None])
    env = torch.where(d < cutoff, 1.0, 0.0).to(d.dtype)
    return torch.cat(parts, dim=-1) * env[:, None]


def _normal(gen, *shape, scale):
    return nn.Parameter(torch.randn(*shape, generator=gen) * scale)


class DimeNetBlock(nn.Module):
    """``w_sbf`` (n_sbf, nb), ``w_bil`` (nb, d, d), ``mlp_kj`` / ``mlp_ji``
    ([d, d]) and ``mlp_out`` ([d, d, d])."""

    def __init__(self, cfg: DimeNetConfig, gen):
        super().__init__()
        d, nb = cfg.d_hidden, cfg.n_bilinear
        n_sbf = cfg.n_spherical * cfg.n_radial
        self.w_sbf = _normal(gen, n_sbf, nb, scale=1 / math.sqrt(n_sbf))
        self.w_bil = _normal(gen, nb, d, d, scale=2.0 / d)
        self.mlp_kj = MLP([d, d], gen)
        self.mlp_ji = MLP([d, d], gen)
        self.mlp_out = MLP([d, d, d], gen)


class DimeNet(nn.Module):
    """Parameters ``embed.{w,b}.0``, ``rbf_w``, ``blocks.{i}.*``
    (``DimeNetBlock``) and ``out.{w,b}.{j}``, drawn from
    ``torch.Generator().manual_seed(seed)`` on the host and moved to
    ``device`` (the card unless the caller asks for the CPU)."""

    def __init__(self, cfg: DimeNetConfig, seed: int = 0, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        gen = torch.Generator().manual_seed(seed)
        d = cfg.d_hidden
        self.embed = MLP([2 * cfg.d_feat + cfg.n_radial, d], gen)
        self.rbf_w = _normal(gen, cfg.n_radial, d,
                             scale=1 / math.sqrt(cfg.n_radial))
        self.blocks = nn.ModuleList(DimeNetBlock(cfg, gen)
                                    for _ in range(cfg.n_blocks))
        self.out = MLP([d, d, cfg.out_dim], gen)
        self.to(dev)

    def forward(self, g: GraphBatch, t_kj: torch.Tensor,
                t_ji: torch.Tensor) -> torch.Tensor:
        """Graph-level prediction (G_pad, out_dim) over
        ``graph_id.shape[0]`` segments.  Requires ``g.positions``."""
        cfg = self.cfg
        n_pad = g.node_feat.shape[0]
        e_pad = g.edge_src.shape[0]
        pos = g.positions
        # Edge geometry (padding edges point sentinel->sentinel; clamp).
        s = clamp_src(g.edge_src, n_pad)
        t = clamp_src(g.edge_dst, n_pad)
        vec = pos[t] - pos[s]
        dist = torch.linalg.norm(vec + 1e-12, dim=-1)
        rbf = rbf_basis(dist, cfg.n_radial, cfg.cutoff)     # (E, n_radial)

        live_e = (g.edge_src < n_pad)[:, None].to(pos.dtype)
        x_e = self.embed(torch.cat([g.node_feat[s], g.node_feat[t], rbf],
                                   dim=-1))
        x_e = x_e * live_e                                  # (E, d)

        # Triplet geometry: angle between edge ji and edge kj at node j.
        kj = clamp_src(t_kj, e_pad)
        ji = clamp_src(t_ji, e_pad)
        v1 = -vec[kj]                                       # j -> k
        v2 = vec[ji]                                        # j -> i
        cos_a = torch.sum(v1 * v2, -1) / torch.clamp(
            torch.linalg.norm(v1, dim=-1) * torch.linalg.norm(v2, dim=-1),
            min=1e-8)
        sbf = sbf_basis(dist[kj], torch.clamp(cos_a, -1.0, 1.0),
                        cfg.n_spherical, cfg.n_radial, cfg.cutoff)
        live_t = (t_kj < e_pad)[:, None].to(pos.dtype)
        seg_t = torch.clamp(t_ji, max=e_pad).to(torch.int64)

        rbf_proj = rbf @ self.rbf_w                          # (E, d)
        d, nb = cfg.d_hidden, cfg.n_bilinear
        for bp in self.blocks:
            m_kj = bp.mlp_kj(x_e)                            # (E, d)
            sbf_p = (sbf @ bp.w_sbf) * live_t                # (T, nb)
            # Bilinear directional interaction (DimeNet eq. 9): each edge's
            # (b, o) products, gathered per triplet, weighted by sbf_p.
            w = bp.w_bil.permute(1, 0, 2).reshape(d, nb * d)
            per_b = (m_kj @ w).view(-1, nb, d).index_select(0, kj)
            tri = torch.einsum("tb,tbo->to", sbf_p, per_b)
            agg = segment_sum(tri, seg_t, e_pad + 1)[:e_pad]
            x_e = x_e + bp.mlp_out(bp.mlp_ji(x_e) * rbf_proj + agg)
            x_e = x_e * live_e

        # Per-node then per-graph readout.
        node_out = segment_sum(x_e, torch.clamp(g.edge_dst, max=n_pad).to(
            torch.int64), n_pad + 1)[:n_pad]
        g_out = segment_sum(node_out, g.graph_id, int(g.graph_id.shape[0]))
        return self.out(g_out)

    def loss(self, g: GraphBatch, t_kj: torch.Tensor,
             t_ji: torch.Tensor) -> torch.Tensor:
        """The reference's ``loss_fn``: masked mean squared error of the
        graph outputs."""
        pred = self(g, t_kj, t_ji)                          # (G_pad, out)
        rows = torch.arange(pred.shape[0], device=pred.device)
        gmask = (rows < g.n_graphs).to(pred.dtype)
        target = g.labels[: pred.shape[0]].to(pred.dtype)[:, None]
        err = torch.square(pred - target).mean(-1) * gmask
        return torch.sum(err) / torch.clamp(torch.sum(gmask), min=1.0)
