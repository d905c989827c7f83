#!/usr/bin/env python3
"""Louvain's quality on chip_smoke's planted-class graph, by size, in both
packages on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tests/products_scale_witness.py

Phase 10 of ``chip_smoke.py`` draws a graph at ogbn-products' sizes
(``products_graph``: 47 planted classes, 0.8 of the pairs inside a class,
about 25.3 slots a vertex) and packs the port's Louvain communities onto
devices.  At that size the port finds fewer, mixed communities than the
planted classes.  This script draws the same kind of graph from seed 0 (the
CPU's random stream, so not the card's graph) at SIZES vertices with the
pairs scaled to keep the degree, runs the JAX package's ``louvain`` and the
port's on one CSR, and prints one JSON line per size: each package's
community count, size range and Q (its own float32 Q and a float64 Q from
the slots), the planted classes' Q, and whether the two memberships are
equal.  If both packages lose Q against the planted classes alike as the
graph grows, the loss is Louvain's on this graph, not the port's.  About
13 minutes on a CPU, most of it the JAX package at 500,000 vertices.
``tests/test_torch_partition.py`` runs ``witness`` at 20,000 vertices.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: Vertex counts: the largest graphs the JAX package runs on a CPU in
#: minutes (phase 10's is 2,449,029).
SIZES = (100_000, 200_000, 500_000)
SEED = 0


def modularity_f64(src, dst, w, membership) -> float:
    """Q (Eq. 1) in float64 from the valid slots (numpy only)."""
    mem = np.asarray(membership, np.int64)
    w = w.astype(np.float64)
    two_m = w.sum()
    inside = w[mem[src] == mem[dst]].sum()
    tot = np.bincount(mem[src], weights=w, minlength=int(mem.max()) + 1)
    return float(inside / two_m - ((tot / two_m) ** 2).sum())


def summary(membership, q32, q64, seconds) -> dict:
    sizes = np.bincount(np.unique(membership, return_inverse=True)[1])
    return {"communities": int(len(sizes)), "size_min": int(sizes.min()),
            "size_median": int(np.median(sizes)),
            "size_max": int(sizes.max()), "q": q32, "q_f64": q64,
            "seconds": seconds}


def witness(n: int, seed: int = SEED) -> dict:
    """Both packages' Louvain on phase 10's generator at ``n`` vertices."""
    import torch
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import chip_smoke
    from repro.core.graph import build_csr as jbuild_csr
    from repro.core.louvain import louvain as jlouvain
    from repro.core.louvain import membership_modularity as jmodularity
    from repro_torch import louvain, membership_modularity
    from repro_torch.interop import graph_from_numpy

    n_pairs = round(n * chip_smoke.PRODUCTS_PAIRS / chip_smoke.PRODUCTS_NODES)
    cls, u, v = chip_smoke.products_graph(torch, torch.device("cpu"), n,
                                          n_pairs, seed)
    jg = jbuild_csr(u.numpy(), v.numpy(), np.ones(n_pairs, np.float32), n,
                    symmetrize=True)
    e = int(jg.e_valid)
    src = np.asarray(jg.src)[:e]
    dst = np.asarray(jg.indices)[:e]
    w = np.asarray(jg.weights)[:e]
    tg = graph_from_numpy(np.asarray(jg.indptr), np.asarray(jg.indices),
                          np.asarray(jg.weights), np.asarray(jg.src), n, e,
                          device="cpu")
    t = time.perf_counter()
    jres = jlouvain(jg)
    j_s = time.perf_counter() - t
    t = time.perf_counter()
    tres = louvain(tg)
    t_s = time.perf_counter() - t
    return {"nodes": n, "pairs": n_pairs, "slots": e, "seed": seed,
            "planted_q_f64": modularity_f64(src, dst, w, cls.numpy()),
            "jax": summary(jres.membership,
                           float(jmodularity(jg, jres.membership)),
                           modularity_f64(src, dst, w, jres.membership), j_s),
            "port": summary(tres.membership,
                            membership_modularity(tg, tres.membership),
                            modularity_f64(src, dst, w, tres.membership),
                            t_s),
            "memberships_equal": bool(np.array_equal(jres.membership,
                                                     tres.membership))}


def main() -> int:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    for n in SIZES:
        print(json.dumps(witness(n)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
