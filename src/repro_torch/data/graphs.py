"""Synthetic graph generators of the PyTorch port (``repro.data.graphs``):
R-MAT (web-like power-law) and SBM (planted communities), the held-out
SBM edge stream of the streaming goldens and the held-out SBM streams of
the multi-stream tests.

The random draws are the reference's own ``np.random.default_rng`` calls in
the same order, so a seed gives byte-identical edges; the CSR is then built
on ``device``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.core.graph import CSRGraph, build_csr, resolve_device


def rmat_graph(scale: int, edge_factor: int = 8, a: float = 0.57,
               b: float = 0.19, c: float = 0.19, seed: int = 0,
               n_cap: int | None = None, e_cap: int | None = None,
               device="cuda") -> CSRGraph:
    """R-MAT generator (Graph500-style): 2^scale vertices, power-law
    degrees, symmetrized and deduplicated, unit weights."""
    dev = resolve_device(device)
    n = 1 << scale
    m = n * edge_factor
    rng = np.random.default_rng(seed)
    src = np.zeros(m, np.int64)
    dst = np.zeros(m, np.int64)
    for bit in range(scale):
        r = rng.random(m)
        go_right = (r > a + b) & (r <= a + b + c)
        go_down = r > a + b + c
        pick_b = (r > a) & (r <= a + b)
        src += ((go_right | go_down).astype(np.int64)) << bit
        dst += ((pick_b | go_down).astype(np.int64)) << bit
    keep = src != dst
    src, dst = src[keep], dst[keep]
    w = np.ones(len(src), np.float32)
    return build_csr(src, dst, w, n, symmetrize=True, dedup=True,
                     n_cap=n_cap, e_cap=e_cap, device=dev)


def sbm_graph(n_communities: int, size: int, p_in: float, p_out: float,
              seed: int = 0, device="cuda") -> Tuple[CSRGraph, np.ndarray]:
    """Stochastic block model; returns (graph, true_membership)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n = n_communities * size
    labels = np.repeat(np.arange(n_communities), size)
    src_l, dst_l = [], []
    for cix in range(n_communities):
        base = cix * size
        tri = rng.random((size, size)) < p_in
        iu = np.triu_indices(size, 1)
        sel = tri[iu]
        src_l.append(base + iu[0][sel])
        dst_l.append(base + iu[1][sel])
    n_cross = rng.binomial(n * (n - 1) // 2, p_out)
    cs = rng.integers(0, n, n_cross)
    cd = rng.integers(0, n, n_cross)
    off = (labels[cs] != labels[cd]) & (cs != cd)
    src_l.append(cs[off])
    dst_l.append(cd[off])
    src = np.concatenate(src_l)
    dst = np.concatenate(dst_l)
    w = np.ones(len(src), np.float32)
    return build_csr(src, dst, w, n, symmetrize=True, dedup=True,
                     device=dev), labels


def sbm_edge_stream(device="cuda"):
    """The held-out SBM edge stream of the reference's streaming goldens
    (``dynamic__sbm_stream``): ``sbm_graph(8, 16, 0.4, 0.01, seed=2)`` with
    40 of its undirected edges held out (``default_rng(0)``) and streamed
    back as 8 insert batches of capacity 8.  Returns (initial graph,
    batches); the initial graph has ``e_cap`` = the full graph's + 8."""
    from repro_torch.core.delta import make_edge_batch
    dev = resolve_device(device)
    full, _ = sbm_graph(8, 16, 0.4, 0.01, seed=2, device=dev)
    e = full.e_valid
    src = full.src[:e].cpu().numpy()
    dst = full.indices[:e].cpu().numpy()
    w = full.weights[:e].cpu().numpy()
    und = src < dst
    us, ud, uw = src[und], dst[und], w[und]
    rng = np.random.default_rng(0)
    hold = rng.choice(len(us), 40, replace=False)
    keep = np.ones(len(us), bool)
    keep[hold] = False
    init = build_csr(np.concatenate([us[keep], ud[keep]]),
                     np.concatenate([ud[keep], us[keep]]),
                     np.concatenate([uw[keep], uw[keep]]), full.n_valid,
                     e_cap=e + 8, device=dev)
    batches = [make_edge_batch(us[hold[i::8]], ud[hold[i::8]],
                               uw[hold[i::8]], init.n_cap, b_cap=8,
                               device=dev)
               for i in range(8)]
    return init, batches


def sbm_holdout_stream(seed: int, *, n_communities: int = 8, size: int = 16,
                       p_in: float = 0.4, p_out: float = 0.01,
                       n_cap: int | None = None, e_cap: int | None = None,
                       n_hold: int = 32, n_steps: int = 4, b_cap: int = 8,
                       device="cuda"):
    """One streaming scenario of the multi-stream tests: an SBM (graph seed
    ``seed``) with ``n_hold`` undirected edges held out (``default_rng(
    seed)``) and fed back as ``n_steps`` batches, striding round-robin over
    the holdout.  Returns (initial graph, batches, full graph) on
    ``device``, the reference's inputs byte for byte.  (``sbm_edge_stream``
    is another stream: graph seed 2, holdout seed 0, 40 edges.)"""
    from repro_torch.core.delta import make_edge_batch
    dev = resolve_device(device)
    full, _ = sbm_graph(n_communities, size, p_in, p_out, seed=seed,
                        device=dev)
    e = full.e_valid
    src = full.src[:e].cpu().numpy()
    dst = full.indices[:e].cpu().numpy()
    w = full.weights[:e].cpu().numpy()
    und = src < dst
    us, ud, uw = src[und], dst[und], w[und]
    rng = np.random.default_rng(seed)
    hold = rng.choice(len(us), n_hold, replace=False)
    keep = np.ones(len(us), bool)
    keep[hold] = False
    init = build_csr(np.concatenate([us[keep], ud[keep]]),
                     np.concatenate([ud[keep], us[keep]]),
                     np.concatenate([uw[keep], uw[keep]]), full.n_valid,
                     n_cap=n_cap, e_cap=e_cap if e_cap is not None else e + 8,
                     device=dev)
    batches = [make_edge_batch(us[hold[i::n_steps]], ud[hold[i::n_steps]],
                               uw[hold[i::n_steps]], init.n_cap, b_cap=b_cap,
                               device=dev)
               for i in range(n_steps)]
    return init, batches, full
