"""Inputs with ELL rows wider than 1024 slots, shared by the port's CPU and
card tests.  Imports numpy only, so the card tests can use it on a machine
without JAX."""

from __future__ import annotations

import numpy as np


def wide_csr_arrays(rng, n, degs, integer_w):
    """A random CSR of ``n`` vertices for K1/K2's one-row-per-block layout,
    as numpy arrays: vertices 8 .. 8 + len(degs) - 1 have the degrees
    ``degs``, the others 0 .. 16; vertex 0 (only self loops) and vertex 1
    (only neighbours of one community, one run of degs[0] slots) have
    degree degs[0], vertex 2 an exact dQ tie between two communities over
    degs[1] slots.  Returns ((indptr, cols, w), state, deg, m) with
    ``n_cap = n + 8``, ``state`` the dict of comm, sigma, sizes, k and
    front, and ``m`` a float."""
    n_cap = n + 8
    n_ids = max(8, n // 6)
    deg = rng.integers(0, 17, n)
    deg[8:8 + len(degs)] = degs
    deg[0] = deg[1] = degs[0]
    deg[2] = degs[1] - degs[1] % 2
    comm = np.arange(n_cap + 1, dtype=np.int32)
    comm[:n] = rng.integers(0, n_ids, n)
    indptr = np.zeros(n_cap + 1, np.int64)
    indptr[1:n + 1] = np.cumsum(deg)
    indptr[n + 1:] = indptr[n]
    cols = rng.integers(0, n, int(indptr[n])).astype(np.int32)
    cols[rng.random(len(cols)) < 0.01] = n_cap
    cols[indptr[0]:indptr[1]] = 0
    members = np.flatnonzero(comm[:n] == comm[5])
    cols[indptr[1]:indptr[2]] = rng.choice(members, deg[1])
    a, b = (10 + np.flatnonzero(comm[10:n] == c)[0] for c in np.unique(
        comm[10:n])[:2])
    half = deg[2] // 2
    cols[indptr[2]:indptr[2] + half] = a
    cols[indptr[2] + half:indptr[3]] = b
    comm[2] = n_ids
    if integer_w:
        w = rng.integers(1, 4, len(cols)).astype(np.float32)
    else:
        w = (rng.random(len(cols)) + 0.05).astype(np.float32)
    w[indptr[2]:indptr[3]] = 1.0
    sigma = (rng.integers(1, 4, n_cap + 1) * 4).astype(np.float32)
    sigma[comm[b]] = sigma[comm[a]]
    sizes = np.where(rng.random(n_cap + 1) < 0.7, 1, 2).astype(np.int32)
    k = rng.integers(1, 6, n_cap + 1).astype(np.float32)
    front = rng.random(n_cap + 1) < 0.9
    state = dict(comm=comm, sigma=sigma, sizes=sizes, k=k, front=front)
    m = float(rng.integers(4000, 90000))
    return (indptr.astype(np.int32), cols, w), state, deg, m


def hub_graph_slots():
    """13 blocks over 1,300 vertices plus vertex 0 linked to 1,100 others:
    one row of degree 1,100, above every width but the 2048 one.  Returns
    (src, dst, w, n) for ``build_csr(..., symmetrize=True)``."""
    rng = np.random.default_rng(5)
    n = 1300
    blocks = rng.integers(0, 13, n)
    s = rng.integers(0, n, 9000)
    d = rng.integers(0, n, 9000)
    keep = (blocks[s] == blocks[d]) | (rng.random(9000) < 0.05)
    hub = rng.choice(np.arange(1, n), 1100, replace=False)
    s = np.concatenate([s[keep], np.zeros(1100, np.int64)])
    d = np.concatenate([d[keep], hub])
    return s, d, np.ones(len(s), np.float32), n


def star_graph_slots(leaves: int = 17000):
    """An sbm block of 8 communities of 24 vertices, whose vertex 0 is also
    the hub of a star of ``leaves`` leaves: one row of degree above 16,384
    when ``leaves`` is.  Returns (src, dst, w, n) for ``build_csr(...,
    symmetrize=True)``."""
    rng = np.random.default_rng(9)
    n_sbm = 8 * 24
    blocks = np.arange(n_sbm) // 24
    s = rng.integers(0, n_sbm, 3000)
    d = rng.integers(0, n_sbm, 3000)
    keep = (blocks[s] == blocks[d]) | (rng.random(3000) < 0.02)
    leaf = np.arange(n_sbm, n_sbm + leaves)
    s = np.concatenate([s[keep], np.zeros(leaves, np.int64)])
    d = np.concatenate([d[keep], leaf])
    return s, d, np.ones(len(s), np.float32), n_sbm + leaves
