"""Aggregation phase (Algorithm 3) of the PyTorch port
(``repro.core.aggregate``): community coarsening as one sort-reduce over the
relabelled edge slots,

    (i, j, w)  ->  (C[i], C[j], w)  --stable sort--> groups --reduce--> G''

The sort is one stable ``torch.sort`` of a packed int64 key (the reference's
``lexsort((cj, ci))``).  Two backends resolve the sorted groups: ``"sort"``
(cumsum group ids, segment-sum weights, scatters) and ``"kernel"`` (the CUDA
kernel K3, or its plain version on the CPU).  Keys and positions agree
exactly; weights agree bit for bit when the sums are exact in float32.
A graph aggregates as a one-stream fleet (``aggregate_fleet``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.graph import (CSRGraph, FleetGraph,
                                    scatter_fleet_records, segment_sum,
                                    stack_graphs)
from repro_torch.kernels.aggregate.coarsen import coarsen_groups


def renumber_communities(comm: torch.Tensor,
                         n_valid: int) -> Tuple[torch.Tensor, int]:
    """Dense relabel of one graph's community ids to [0, n_comms); invalid
    vertex slots and the sentinel map to n_cap.  Returns (comm_new,
    n_comms): ``renumber_communities_fleet`` of a one-stream fleet."""
    comm_new, n_comms = renumber_communities_fleet(comm[None], [n_valid])
    return comm_new[0], int(n_comms[0])


def renumber_communities_fleet(comm: torch.Tensor, n_valid
                               ) -> Tuple[torch.Tensor, np.ndarray]:
    """Dense relabel of every stream's community ids at once: ``comm`` is
    (S, n_cap + 1) in stream-local ids, ``n_valid`` (S,) host ints; each
    row's ids go to [0, n_comms_s), its invalid slots and sentinel to
    n_cap.  Returns ((S, n_cap + 1) int32 dense ids, (S,) host community
    counts), one host read for the fleet."""
    S, N = comm.shape
    n_cap = N - 1
    dev = comm.device
    nv = torch.as_tensor(np.asarray(n_valid), device=dev)
    valid = torch.arange(N, device=dev)[None, :] < nv[:, None]
    cs = torch.where(valid, comm, n_cap).to(torch.int64)
    present = torch.zeros(S, N, dtype=torch.int32, device=dev)
    present.scatter_(1, cs, 1)
    present[:, n_cap] = 0
    new_id = torch.cumsum(present, 1, dtype=torch.int32) - present
    n_comms = present.sum(1).cpu().numpy()
    new_id[:, n_cap] = n_cap
    return (torch.where(valid, torch.gather(new_id, 1, cs), n_cap)
            .to(torch.int32), n_comms)


def community_vertices_csr(comm: torch.Tensor, n_valid: int, n_cap: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Opt. 7: vertices grouped by community via prefix sum + stable sort.

    Returns (offsets, vertex_list): offsets (n_cap + 1,) int32 exclusive
    scan of community sizes; vertex_list (n_cap,) int32 vertex ids grouped
    by community (invalid slots at the tail)."""
    idx = torch.arange(n_cap + 1, device=comm.device)
    valid = idx < n_valid
    cs = torch.where(valid, comm, n_cap)[:n_cap].to(torch.int64)
    counts = segment_sum(valid[:n_cap].to(torch.int32), cs, n_cap + 1)
    offsets = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    order = torch.sort(cs, stable=True).indices
    return offsets.to(torch.int32), order.to(torch.int32)


def coarsen_records(s_ci: torch.Tensor, s_cj: torch.Tensor,
                    s_w: torch.Tensor, sent: int, backend: str):
    """One record per group of (ci, cj)-sorted relabelled slots: ``(emit,
    pos, r_src, r_dst, r_w)``.  ``emit`` marks the records of live groups
    (ci != ``sent``), ``pos`` their rank among them (live groups precede
    the sentinel padding in sort order), ``r_*`` the group's key and weight
    sum.  ``"kernel"`` is K3 (its records sit one slot after each group),
    ``"sort"`` the cumsum / segment-sum chain (records on each group's
    first slot)."""
    if backend == "kernel":
        return coarsen_groups(s_ci, s_cj, s_w, sent=sent)
    if backend != "sort":
        raise ValueError(f"unknown aggregation backend: {backend!r}")
    new_group = torch.ones_like(s_ci, dtype=torch.bool)
    new_group[1:] = (s_ci[1:] != s_ci[:-1]) | (s_cj[1:] != s_cj[:-1])
    gid = torch.cumsum(new_group, 0) - 1
    group_w = segment_sum(s_w, gid, s_ci.shape[0])
    return new_group & (s_ci != sent), gid, s_ci, s_cj, group_w[gid]


def aggregate_graph(graph: CSRGraph, comm: torch.Tensor, n_comms: int,
                    backend: str = "sort") -> CSRGraph:
    """Algorithm 3 as sort-reduce; returns the coarse graph at equal
    capacity.  ``comm`` must be renumbered (dense ids in [0, n_comms),
    sentinel n_cap).  ``aggregate_fleet`` of a one-stream fleet."""
    return aggregate_fleet(stack_graphs([graph]), comm[None], [n_comms],
                           backend=backend).stream(0)


def sorted_fleet_aggregate_slots(fleet: FleetGraph, comm: torch.Tensor):
    """The fleet's relabelled slot list keyed ``(stream, ci, cj)`` in flat
    ids (``FleetGraph.flat_ids``; padding keys as the flat sentinel G and
    sorts last), put in order by ONE stable sort: ``(s_ci, s_cj, s_w)``,
    which K3 resolves with ``sent=G``.  ``comm`` is (S, n_cap + 1)
    renumbered per stream."""
    sent = fleet.sentinel
    S, e_cap = fleet.n_streams, fleet.e_cap
    # Row s of comm sits at flat offset s * (n_cap + 1): a slot's
    # stream-local id plus its row's offset reads it (int32 index).
    comm_flat = comm.reshape(-1)
    off = fleet.offsets()
    f_ci = fleet.flat_ids(torch.index_select(
        comm_flat, 0, (fleet.src + off).reshape(-1)).view(S, e_cap))
    f_cj = fleet.flat_ids(torch.index_select(
        comm_flat, 0, (fleet.indices + off).reshape(-1)).view(S, e_cap))
    f_cj = torch.where(f_ci == sent, sent, f_cj)
    key = f_ci.to(torch.int64)
    key.mul_(sent + 1).add_(f_cj)
    order = torch.sort(key, stable=True).indices
    del key
    return f_ci[order], f_cj[order], fleet.weights.reshape(-1)[order]


def aggregate_fleet(fleet: FleetGraph, comm: torch.Tensor, n_comms,
                    backend: str = "sort") -> FleetGraph:
    """Algorithm 3 for every stream at once: one relabelled slot list,
    ONE stable sort (``sorted_fleet_aggregate_slots``), one group resolve
    (K3 with ``backend="kernel"``: one launch for all S streams,
    ``sent=G``) and one scatter back into per-stream buffers at the
    fleet's capacity.  ``comm`` is (S, n_cap + 1) renumbered per stream,
    ``n_comms`` (S,) host ints.  Keys and positions equal each stream's
    aggregated alone; so do the weight sums of the sort chain, and K3's on
    integer weights (its float carry depends on where its tiles start)."""
    emit, pos, r_src, r_dst, r_w = coarsen_records(
        *sorted_fleet_aggregate_slots(fleet, comm), fleet.sentinel, backend)
    out_src, out_dst, out_w, counts, indptr = scatter_fleet_records(
        fleet, emit, pos, r_src, r_dst, r_w, fleet.e_cap)
    return FleetGraph(indptr=indptr, indices=out_dst, weights=out_w,
                      src=out_src, n_valid=np.asarray(n_comms),
                      e_valid=counts.cpu().numpy())
