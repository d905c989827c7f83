"""Synthetic graph generators of the PyTorch port (``repro.data.graphs``):
R-MAT (web-like power-law) and SBM (planted communities), the held-out
SBM edge stream of the streaming goldens and the held-out SBM streams of
the multi-stream tests, LFR (community benchmark) and Holme-Kim
powerlaw-cluster (social-like).

R-MAT, SBM and the streams draw the reference's own
``np.random.default_rng`` calls in the same order, so a seed gives
byte-identical edges.  The reference's LFR and powerlaw-cluster wrap
networkx, whose random draws NumPy cannot reproduce: ``lfr_graph`` and
``powerlaw_cluster`` here are NumPy generators of the same models and
parameters, not byte-identical to networkx's graphs for a seed.  Every
generator draws on the host and builds the CSR on ``device``.
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


def _simple_graph(u: np.ndarray, v: np.ndarray, n: int, dev) -> CSRGraph:
    """The unit-weight CSR of the simple undirected graph on the pairs
    (u, v): self-loops removed, parallel pairs merged (as a networkx
    ``Graph`` holds them)."""
    u = np.asarray(u, np.int64)
    v = np.asarray(v, np.int64)
    keep = u != v
    lo, hi = np.minimum(u, v)[keep], np.maximum(u, v)[keep]
    key = np.unique(lo * n + hi)
    lo, hi = key // n, key % n
    return build_csr(lo, hi, np.ones(len(lo), np.float32), n,
                     symmetrize=True, device=dev)


def _holme_kim_pairs(n: int, m: int, p: float, seed: int):
    """Holme and Kim's growth (networkx's ``powerlaw_cluster_graph``):
    each new vertex draws m distinct preferential targets (uniform over
    the list of every edge end so far, the first m vertices once each),
    links to the first, and for each further link takes, with probability
    p, a uniform neighbour of the last preferential target that it is not
    yet linked to (a triangle), else the next preferential target; a
    target it already links to adds no edge.  The targets are taken in
    the order drawn (networkx pops them from a set, in hash order, which
    favours the oldest vertices and gives a higher clustering).  The
    uniforms come from ``default_rng(seed)`` in bulk (the loop is the hot
    path)."""
    rng = np.random.default_rng(seed)
    chunk = 1 << 16
    buf, pos = rng.random(chunk).tolist(), 0
    repeated = list(range(m))
    nbrs = [[] for _ in range(n)]
    us, vs = [], []
    for source in range(m, n):
        fill = len(repeated)
        targets, chosen = [], set()
        while len(targets) < m:
            if pos == chunk:
                buf, pos = rng.random(chunk).tolist(), 0
            x = repeated[int(buf[pos] * fill)]
            pos += 1
            if x not in chosen:
                chosen.add(x)
                targets.append(x)
        mine = nbrs[source]
        linked = set()
        target = None
        for count in range(m):
            t = None
            if count:
                if pos == chunk:
                    buf, pos = rng.random(chunk).tolist(), 0
                pos += 1
                if buf[pos - 1] < p:
                    cand = nbrs[target]
                    # A uniform eligible neighbour: a few rejection draws,
                    # then the eligible list.
                    for _ in range(4):
                        if pos == chunk:
                            buf, pos = rng.random(chunk).tolist(), 0
                        y = cand[int(buf[pos] * len(cand))]
                        pos += 1
                        if y != source and y not in linked:
                            t = y
                            break
                    else:
                        ok = [y for y in cand
                              if y != source and y not in linked]
                        if ok:
                            if pos == chunk:
                                buf, pos = rng.random(chunk).tolist(), 0
                            t = ok[int(buf[pos] * len(ok))]
                            pos += 1
            if t is None:
                target = t = targets.pop()
            repeated.append(t)
            if t not in linked:
                linked.add(t)
                mine.append(t)
                nbrs[t].append(source)
                us.append(source)
                vs.append(t)
        repeated.extend([source] * m)
    return np.asarray(us, np.int64), np.asarray(vs, np.int64)


def powerlaw_cluster(n: int, m: int = 10, p: float = 0.3, seed: int = 7,
                     device="cuda") -> CSRGraph:
    """Holme-Kim powerlaw-cluster graph of ``n`` vertices: preferential
    attachment with m links a new vertex and triangle closure with
    probability ``p``; unit weights, no self-loops.  The same model as the
    reference's networkx ``powerlaw_cluster_graph``, drawn with NumPy: not
    the same edges for a seed.  The reference returns the networkx graph
    beside the CSR; this returns the CSR alone."""
    dev = resolve_device(device)
    if m < 1 or m >= n:
        raise ValueError(f"need 1 <= m < n; got m={m}, n={n}")
    if not 0 <= p <= 1:
        raise ValueError(f"p must be in [0, 1]; got {p}")
    us, vs = _holme_kim_pairs(n, m, p, seed)
    return _simple_graph(us, vs, n, dev)


#: The reference's LFR parameters (``repro.data.graphs.lfr_graph``).
LFR_TAU1, LFR_TAU2, LFR_MU = 3.0, 1.5, 0.1
LFR_AVG_DEGREE, LFR_MIN_COMMUNITY = 10, 20
#: Re-pairing rounds for stubs whose pairs are self-loops, repeats or (for
#: the external stubs) inside one community; what is left is dropped.
_LFR_REWIRE_ROUNDS = 50


def _powerlaw_table(gamma: float, lo: int, hi: int):
    """Values lo..hi of the bounded discrete power law x^-gamma and its
    cumulative distribution."""
    x = np.arange(lo, hi + 1, dtype=np.float64)
    cdf = np.cumsum(x ** -gamma)
    return x.astype(np.int64), cdf / cdf[-1]


def _powerlaw_draw(rng, table, size):
    x, cdf = table
    return x[np.minimum(np.searchsorted(cdf, rng.random(size)), len(x) - 1)]


def _lfr_min_degree(gamma: float, avg: float, max_degree: int) -> int:
    """The minimum degree whose bounded power law on [min, max_degree]
    has the mean closest to ``avg``."""
    x = np.arange(1, max_degree + 1, dtype=np.float64)
    s0 = np.cumsum((x ** -gamma)[::-1])[::-1]
    s1 = np.cumsum((x ** (1 - gamma))[::-1])[::-1]
    return int(np.argmin(np.abs(s1 / s0 - avg))) + 1


def _lfr_sizes(rng, table, n: int, max_iters: int) -> np.ndarray:
    """Community sizes drawn until they reach n, kept when they sum to n
    exactly (networkx's rule), 256 tries at a time."""
    per = n // int(table[0][0]) + 1
    for _ in range(max_iters):
        cum = np.cumsum(_powerlaw_draw(rng, table, (256, per)), axis=1)
        end = (cum < n).sum(axis=1)
        hit = np.nonzero(cum[np.arange(256), end] == n)[0]
        if len(hit):
            row = cum[hit[0], :end[hit[0]] + 1]
            return np.diff(row, prepend=0)
    raise RuntimeError("LFR: no community sizes summing to n")


def _lfr_assign(rng, sizes: np.ndarray, s_in: np.ndarray, order):
    """Each vertex, in decreasing internal degree, takes a uniform free
    place in a community larger than its internal degree.  Returns the
    community of each vertex, or None if a vertex finds no place."""
    by_size = np.argsort(-sizes, kind="stable")
    slot_comm = np.repeat(by_size, sizes[by_size]).tolist()
    # Places in communities of more than s_in[v] vertices: a prefix of the
    # places in decreasing community size.
    desc = sizes[by_size]
    n_big = np.searchsorted(-desc, -s_in, side="left")
    eligible = np.concatenate([[0], np.cumsum(desc)])[n_big].tolist()
    comm = np.empty(len(s_in), np.int64)
    pool, next_slot = [], 0
    for v, u in zip(order.tolist(), rng.random(len(order)).tolist()):
        while next_slot < eligible[v]:
            pool.append(next_slot)
            next_slot += 1
        if not pool:
            return None
        j = int(u * len(pool))
        comm[v] = slot_comm[pool[j]]
        pool[j] = pool[-1]
        pool.pop()
    return comm


def _pair_stubs(rng, stubs: np.ndarray, group: np.ndarray, cross_only):
    """Pair stubs at random within each ``group`` (every group's count
    even); a pair that is a self-loop, repeats a pair, or (``cross_only``)
    joins one community is re-paired among the bad ones, for a bounded
    number of rounds.  Returns the good pairs (u, v)."""
    good_u, good_v = [np.zeros(0, np.int64)], [np.zeros(0, np.int64)]
    keys = np.zeros(1, np.int64) - 1        # the good pairs' keys, sorted
    for _ in range(_LFR_REWIRE_ROUNDS):
        if not len(stubs):
            break
        order = np.lexsort((rng.random(len(stubs)), group))
        s, g = stubs[order], group[order]
        u, v = s[0::2], s[1::2]
        key = np.minimum(u, v) * (1 << 32) + np.maximum(u, v)
        first = np.zeros(len(u), bool)
        first[np.unique(key, return_index=True)[1]] = True
        seen = keys[np.searchsorted(keys, key, side="right") - 1] == key
        bad = (u == v) | ~first | seen
        if cross_only is not None:
            bad |= cross_only[u] == cross_only[v]
        ok = ~bad
        keys = np.sort(np.concatenate([keys, key[ok]]), kind="stable")
        good_u.append(u[ok])
        good_v.append(v[ok])
        stubs = np.concatenate([u[bad], v[bad]])
        group = np.concatenate([g[0::2][bad], g[1::2][bad]])
    return np.concatenate(good_u), np.concatenate(good_v)


def _one_per_group(rng, members: np.ndarray, group: np.ndarray):
    """One uniform member of each group present."""
    order = np.lexsort((rng.random(len(members)), group))
    g = group[order]
    first = np.ones(len(g), bool)
    first[1:] = g[1:] != g[:-1]
    return members[order][first]


def _lfr_edges(rng, n: int, deg, s_in, comm):
    """The internal and external pairs of an LFR graph: each vertex's
    round(0.9 deg) internal stubs paired within its community, the rest
    across communities (one stub moves from internal to external in each
    community with an odd internal count, and one external stub is dropped
    if their count is odd)."""
    s_in = s_in.copy()
    out = deg - s_in
    odd = np.bincount(comm, weights=s_in) % 2 == 1
    cand = np.nonzero(odd[comm] & (s_in > 0))[0]
    moved = _one_per_group(rng, cand, comm[cand])
    s_in[moved] -= 1
    out[moved] += 1
    if out.sum() % 2:
        has = np.nonzero(out > 0)[0]
        out[has[int(rng.integers(len(has)))]] -= 1
    ids = np.arange(n, dtype=np.int64)
    stubs = np.repeat(ids, s_in)
    iu, iv = _pair_stubs(rng, stubs, comm[stubs], None)
    stubs = np.repeat(ids, out)
    eu, ev = _pair_stubs(rng, stubs, np.zeros(len(stubs), np.int64), comm)
    return np.concatenate([iu, eu]), np.concatenate([iv, ev])


def lfr_graph(n: int = 1000, seed: int = 42, device="cuda"):
    """LFR benchmark graph (Lancichinetti, Fortunato and Radicchi 2008)
    with the reference's parameters: degree exponent 3, community-size
    exponent 1.5, mixing mu 0.1, average degree 10, maximum degree
    ``max(50, n // 20)``, communities of at least 20 vertices (and at most
    the largest degree); self-loops removed.  Returns ``(graph,
    communities)``: the CSR on ``device`` and the planted community of
    each vertex as an int64 array (the reference returns the networkx
    graph there).

    Drawn with NumPy, not networkx, so not the reference's edges for a
    seed: a power-law degree sequence with the mean closest to 10 and an
    even sum, community sizes summing to n, each vertex placed in a
    community larger than its internal degree round(0.9 deg), then the
    internal stubs paired at random within each community and the
    external ones across communities (a configuration model, as in the
    original LFR), with self-loops, repeats and external pairs inside one
    community re-paired and what is left dropped."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    max_degree = max(50, n // 20)
    lo = _lfr_min_degree(LFR_TAU1, LFR_AVG_DEGREE, max_degree)
    deg_table = _powerlaw_table(LFR_TAU1, lo, max_degree)
    for _ in range(500):
        deg = _powerlaw_draw(rng, deg_table, n)
        if deg.sum() % 2 == 0:
            break
    else:
        raise RuntimeError("LFR: no degree sequence with an even sum")
    s_in = np.round(deg * (1 - LFR_MU)).astype(np.int64)
    size_table = _powerlaw_table(LFR_TAU2, LFR_MIN_COMMUNITY,
                                 max(int(deg.max()), LFR_MIN_COMMUNITY))
    perm = rng.permutation(n)
    order = perm[np.argsort(-s_in[perm], kind="stable")]
    for _ in range(100):
        sizes = _lfr_sizes(rng, size_table, n, 500)
        comm = _lfr_assign(rng, sizes, s_in, order)
        if comm is not None:
            break
    else:
        raise RuntimeError("LFR: no community assignment; the degrees "
                           "outgrow the communities")
    u, v = _lfr_edges(rng, n, deg, s_in, comm)
    return _simple_graph(u, v, n, dev), comm
