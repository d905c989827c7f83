"""Aggregation phase (Algorithm 3) of the PyTorch port
(``repro.core.aggregate``): community coarsening as one sort-reduce over the
relabelled edge slots,

    (i, j, w)  ->  (C[i], C[j], w)  --stable sort--> groups --reduce--> G''

The sort is one stable ``torch.sort`` of a packed int64 key (the reference's
``lexsort((cj, ci))``).  Two backends resolve the sorted groups: ``"sort"``
(cumsum group ids, segment-sum weights, scatters) and ``"kernel"`` (the CUDA
kernel K3, or its plain version on the CPU).  Keys and positions agree
exactly; weights agree bit for bit when the sums are exact in float32.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.graph import CSRGraph, scatter_slots, segment_sum
from repro_torch.kernels.aggregate.coarsen import coarsen_groups


def renumber_communities(comm: torch.Tensor, n_valid: int,
                         n_cap: int) -> Tuple[torch.Tensor, int]:
    """Dense relabel of community ids to [0, n_comms); invalid vertex slots
    and the sentinel map to n_cap.  Returns (comm_new, n_comms)."""
    dev = comm.device
    idx = torch.arange(n_cap + 1, device=dev)
    valid = idx < n_valid
    cs = torch.where(valid, comm, n_cap)
    present = torch.zeros(n_cap + 1, dtype=torch.int32, device=dev)
    present[cs] = 1
    present[n_cap] = 0
    new_id = torch.cumsum(present, 0, dtype=torch.int32) - present
    n_comms = int(present.sum())
    new_id[n_cap] = n_cap
    return torch.where(valid, new_id[cs], n_cap), n_comms


def aggregate_graph(graph: CSRGraph, comm: torch.Tensor, n_comms: int,
                    backend: str = "sort") -> CSRGraph:
    """Algorithm 3 as sort-reduce; returns the coarse graph at equal
    capacity.  ``comm`` must be renumbered (dense ids in [0, n_comms),
    sentinel n_cap)."""
    n_cap, e_cap = graph.n_cap, graph.e_cap
    ci = comm[graph.src]           # padding slots -> sentinel
    cj = comm[graph.indices]
    key = ci.to(torch.int64) * (n_cap + 1) + cj.to(torch.int64)
    s_key, order = torch.sort(key, stable=True)
    s_ci, s_cj, s_w = ci[order], cj[order], graph.weights[order]

    if backend == "kernel":
        emit, gpos, g_src, g_dst, g_w = coarsen_groups(s_ci, s_cj, s_w,
                                                       sent=n_cap)
        # One record per live group, at the dense position the sort path
        # uses (live groups precede sentinel padding in sort order).
        pos = torch.where(emit, gpos, e_cap)
        coarse_src, coarse_dst, coarse_w = scatter_slots(
            pos, torch.where(emit, g_src, n_cap),
            torch.where(emit, g_dst, n_cap), torch.where(emit, g_w, 0.0),
            n_cap, e_cap)
    elif backend == "sort":
        new_group = torch.ones_like(s_key, dtype=torch.bool)
        new_group[1:] = s_key[1:] != s_key[:-1]
        gid = torch.cumsum(new_group, 0) - 1
        group_w = segment_sum(s_w, gid, e_cap)
        # The first slot of each live group scatters the coarse edge to
        # position gid; sentinel-src groups (padding) go to the scratch slot.
        live = new_group & (s_ci != n_cap)
        pos = torch.where(live, gid, e_cap)
        coarse_src, coarse_dst, coarse_w = scatter_slots(
            pos, s_ci, s_cj, group_w[gid], n_cap, e_cap)
    else:
        raise ValueError(f"unknown aggregation backend: {backend!r}")

    live_rows = coarse_src < n_cap
    counts = segment_sum(live_rows.to(torch.int32),
                         torch.where(live_rows, coarse_src, n_cap), n_cap + 1)
    indptr = torch.zeros(n_cap + 1, dtype=torch.int32, device=comm.device)
    indptr[1:] = torch.cumsum(counts[:n_cap], 0, dtype=torch.int32)
    return CSRGraph(indptr=indptr, indices=coarse_dst, weights=coarse_w,
                    src=coarse_src, n_valid=int(n_comms),
                    e_valid=int(live_rows.sum()))
