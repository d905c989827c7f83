"""GVE-Louvain written out plainly in PyTorch, on one graph, from its
semantics: the paper's Algorithms 1-3 with the options of its §4.1 as the
configuration states them (threshold scaling, iteration cap, aggregation
tolerance, vertex pruning) and the bulk-synchronous move rule of the
parallel version that the program implements.

A move round, from one snapshot of (C, Sigma):
  * every frontier vertex i scores each neighbouring community c != C[i]
    by Eq. 2 in float32,
        dQ = (K_ic - K_id) / m - K_i (K_i + Sigma_c - Sigma_d) / (2 m m),
    with K_ic the summed weight of i's slots into c (self loops excluded,
    sums taken in float64 and rounded once), and picks the largest dQ,
    ties to the smallest community id;
  * i moves if dQ > 0, unless i and its target are both singletons and
    the target id is larger (the singleton-swap guard), and only if the
    round's Weyl gate selects i: with h the int32 wraparound of
    i * 2654435761 + round * 40503, the gate is |h >> 13| % g == 0 for g
    rounds a sweep;
  * all moves apply at once; Sigma takes the moved weights; with pruning
    the next frontier is the movers' neighbours plus the frontier
    vertices the gate held back.
A sweep is g rounds; the phase sweeps until the sweep's float32 dQ sum is
at most the float32 tolerance or the iteration cap.  A pass renumbers the
communities densely in ascending id order and aggregates (weights summed
in float64, rounded once); the loop stops when a phase took one sweep or
the communities shrank the vertex count by less than the aggregation
tolerance.  The membership is the last level's, so labels are compared
exactly, not only the partition.

``dq_dtype`` lets a control run score Eq. 2 in a lower precision.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

#: Knuth's multiplicative constant 2654435761 as an int32.
GATE_MUL = -1640531535
#: The gate's odd per-round increment.
GATE_INC = 40503


@dataclasses.dataclass
class Graph:
    """Live directed slots: an undirected edge {i, j}, i != j, is the two
    slots (i, j) and (j, i); a self loop is one slot."""

    n: int
    src: torch.Tensor   # int32
    dst: torch.Tensor   # int32
    w: torch.Tensor     # float32


@dataclasses.dataclass
class Params:
    """The configuration's Louvain parameters (paper §4.1)."""

    max_passes: int
    max_iterations: int
    initial_tolerance: float
    tolerance_drop: float
    aggregation_tolerance: float
    use_pruning: bool
    gate_fraction: int

    @classmethod
    def of(cls, louvain: dict) -> "Params":
        return cls(**{f.name: louvain[f.name]
                      for f in dataclasses.fields(cls)})


def sum64(values: torch.Tensor, index: torch.Tensor, size: int):
    """Float32 sums of ``values`` by ``index``, taken in float64 and
    rounded once."""
    out = torch.zeros(size, dtype=torch.float64, device=values.device)
    out.index_add_(0, index.to(torch.int64), values.to(torch.float64))
    return out.to(torch.float32)


def vertex_weights(g: Graph) -> torch.Tensor:
    """(n + 1,) K_i with a trailing 0."""
    return sum64(g.w, g.src, g.n + 1)


def total_weight(g: Graph) -> torch.Tensor:
    """0-d float32 m = sum(w) / 2."""
    return torch.sum(g.w, dtype=torch.float64).to(torch.float32) * 0.5


def delta_q(kic, kid, ki, sc, sd, m, dtype=torch.float32):
    """Eq. 2 per slot; ``m`` 0-d, read per slot."""
    m = m.expand(kic.shape[0])
    if dtype != torch.float32:
        kic, kid, ki, sc, sd, m = (x.to(dtype)
                                   for x in (kic, kid, ki, sc, sd, m))
    m_safe = torch.where(m > 0, m, 1.0)
    dq = ((kic - kid) / m_safe
          - ki * (ki + sc - sd) / (2.0 * m_safe * m_safe))
    return torch.where(m > 0, dq, 0.0).to(torch.float32)


def best_moves(g: Graph, comm, sigma, k, frontier, m, dq_dtype):
    """(best community, best dQ) of every vertex ((n + 1,) each; no
    candidate: (n, -inf)).  Only frontier rows are scanned: a row's answer
    depends on its own slots alone."""
    n = g.n
    sel = frontier[g.src] & (g.src != g.dst)
    s, d, w = g.src[sel], g.dst[sel], g.w[sel]
    cs, cd = comm[s], comm[d]
    own = cd == cs
    k_own = sum64(w[own], s[own], n + 1)
    key = s.to(torch.int64) * (n + 1) + cd.to(torch.int64)
    key, order = torch.sort(key)
    s, c, w = s[order], cd[order], w[order]
    first = torch.ones_like(key, dtype=torch.bool)
    first[1:] = key[1:] != key[:-1]
    gid = torch.cumsum(first, 0) - 1
    kic = sum64(w, gid, max(int(key.shape[0]), 1))[gid]
    c_own = comm[s]
    dq = delta_q(kic, k_own[s], k[s], sigma[c], sigma[c_own], m, dq_dtype)
    valid = (c != c_own) & (c != n)
    dq = torch.where(valid, dq, float("-inf"))
    seg = s.to(torch.int64)
    best_dq = torch.full((n + 1,), float("-inf"), dtype=torch.float32,
                         device=dq.device)
    best_dq.scatter_reduce_(0, seg, dq, "amax", include_self=True)
    best_dq = torch.where(torch.isfinite(best_dq), best_dq, float("-inf"))
    is_best = (dq == best_dq[seg]) & valid
    best_c = torch.full((n + 1,), n, dtype=torch.int32, device=dq.device)
    best_c.scatter_reduce_(0, seg, torch.where(is_best, c, n), "amin",
                           include_self=True)
    return best_c, best_dq


def round_gate(ids: torch.Tensor, round_ix: int, fraction: int):
    x = (ids.to(torch.int64) * GATE_MUL + round_ix * GATE_INC) & 0xFFFFFFFF
    h = torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)
    return torch.abs(h >> 13) % fraction == 0


def move_phase(g: Graph, comm, sigma, frontier0, tolerance: float,
               p: Params, dq_dtype=torch.float32):
    """One local-moving phase; returns (comm, sweeps)."""
    n, dev = g.n, g.src.device
    ids = torch.arange(n + 1, dtype=torch.int32, device=dev)
    valid = ids < n
    k = vertex_weights(g)
    m = total_weight(g)
    tol = np.float32(tolerance)
    frontier = frontier0
    iters, sweeps, dq_sweep = 0, 0, np.float32(np.inf)
    while iters < p.max_iterations and dq_sweep > tol:
        acc = torch.zeros((), dtype=torch.float32, device=dev)
        for r in range(p.gate_fraction):
            front = frontier if p.use_pruning else frontier0
            sizes = torch.bincount(comm[:n].to(torch.int64),
                                   minlength=n + 1).to(torch.int32)
            best_c, best_dq = best_moves(g, comm, sigma, k, front, m,
                                         dq_dtype)
            target = torch.clamp(best_c, max=n)
            blocked = ((sizes[comm] == 1) & (sizes[target] == 1)
                       & (best_c > comm))
            move = ((best_dq > 0.0) & (best_c != comm) & (best_c < n)
                    & front & ~blocked & valid)
            gate = None
            if p.gate_fraction > 1:
                gate = round_gate(ids, sweeps * p.gate_fraction + r,
                                  p.gate_fraction)
                move = move & gate
            acc = acc + torch.sum(torch.where(move, best_dq, 0.0)[:n],
                                  dtype=torch.float64).to(torch.float32)
            moved_k = torch.where(move, k, 0.0)
            add = sum64(moved_k, torch.where(move, best_c, n), n + 1)
            sub = sum64(moved_k, torch.where(move, comm, n), n + 1)
            sigma = sigma + add - sub
            comm = torch.where(move, best_c, comm)
            mark = torch.zeros(n + 1, dtype=torch.bool, device=dev)
            mark[g.dst[move[g.src]].to(torch.int64)] = True
            frontier = mark & valid
            if gate is not None:
                frontier = frontier | (front & ~gate)
        iters += 1
        sweeps += 1
        dq_sweep = np.float32(acc.item())
    return comm, iters


def renumber(comm: torch.Tensor, n: int):
    """Dense ids in ascending order of the community ids: ((n,) ids,
    count)."""
    present = torch.zeros(n + 1, dtype=torch.int32, device=comm.device)
    present[comm[:n].to(torch.int64)] = 1
    new_id = torch.cumsum(present, 0, dtype=torch.int32) - present
    return new_id[comm[:n].to(torch.int64)], int(present.sum())


def aggregate(g: Graph, comm_ren: torch.Tensor, n_comms: int) -> Graph:
    ci = comm_ren[g.src.to(torch.int64)].to(torch.int64)
    cj = comm_ren[g.dst.to(torch.int64)].to(torch.int64)
    key, inv = torch.unique(ci * n_comms + cj, return_inverse=True)
    w = sum64(g.w, inv, int(key.shape[0]))
    return Graph(n_comms, (key // n_comms).to(torch.int32),
                 (key % n_comms).to(torch.int32), w)


def louvain(g: Graph, p: Params, *, prev: Optional[torch.Tensor] = None,
            frontier: Optional[torch.Tensor] = None,
            dq_dtype=torch.float32) -> torch.Tensor:
    """The (n,) int32 membership of the original vertices.  ``prev`` (n,)
    warm-starts the first pass (Sigma recomputed from ``g``; a label that
    is not a vertex id gives the vertex its own singleton); ``frontier``
    ((n + 1,) bool) restricts its seed frontier (delta screening)."""
    n0, dev = g.n, g.src.device
    ids0 = torch.arange(n0 + 1, dtype=torch.int32, device=dev)
    global_comm = ids0[:n0]
    tol = float(p.initial_tolerance)
    level = global_comm
    for pss in range(p.max_passes):
        n = g.n
        ids = torch.arange(n + 1, dtype=torch.int32, device=dev)
        valid = ids < n
        if pss == 0 and prev is not None:
            lab = torch.cat([prev.to(device=dev, dtype=torch.int32),
                             torch.full((1,), n, dtype=torch.int32,
                                        device=dev)])
            comm0 = torch.where(valid, torch.where(lab < n, lab, ids), n)
            sigma0 = sum64(vertex_weights(g)[:n], comm0[:n], n + 1)
            front0 = valid if frontier is None else frontier & valid
        else:
            comm0, sigma0 = ids, vertex_weights(g)
            front0 = (valid if frontier is None or pss > 0
                      else frontier & valid)
        comm, iters = move_phase(g, comm0, sigma0, front0, tol, p, dq_dtype)
        comm_ren, n_comms = renumber(comm, n)
        level = comm_ren[global_comm.to(torch.int64)]
        global_comm = level
        converged = iters <= 1
        low_shrink = n_comms / max(n, 1) > p.aggregation_tolerance
        if converged or low_shrink:
            break
        if pss < p.max_passes - 1:
            g = aggregate(g, comm_ren, n_comms)
        tol = tol / p.tolerance_drop
    return level


def modularity64(g: Graph, membership: torch.Tensor) -> float:
    """Q (Eq. 1) of an (n,) membership, in float64."""
    c = membership.to(device=g.src.device, dtype=torch.int64)
    w = g.w.to(torch.float64)
    two_m = w.sum()
    if float(two_m) <= 0:
        return 0.0
    internal = torch.where(c[g.src.to(torch.int64)]
                           == c[g.dst.to(torch.int64)], w, 0.0).sum()
    k = torch.zeros(g.n, dtype=torch.float64, device=w.device)
    k.index_add_(0, g.src.to(torch.int64), w)
    sig = torch.zeros(int(c.max()) + 1, dtype=torch.float64, device=w.device)
    sig.index_add_(0, c, k)
    return float(internal / two_m - torch.sum((sig / two_m) ** 2))
