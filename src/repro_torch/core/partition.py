"""Louvain-driven graph partitioning (``repro.core.partition``): the
paper's technique as a framework feature for distributed GNN training.

Communities from GVE-Louvain are packed onto devices with a greedy
bin-packing, keeping each community's vertices device-local.  Compared to
random/hashed vertex assignment this minimizes cut edges, i.e. the cross-
device gathers a full-graph GNN layer must exchange.  Also provides the
community-contiguous reordering (locality for segment ops).

Louvain and the edge cut run on the graph's device; the packing loop runs
over communities on the host with the reference's numpy calls (its
``np.argsort(-counts)`` is not stable, so a device sort would break ties
between equal-sized communities another way and pack differently).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.graph import CSRGraph
from repro_torch.core.louvain import LouvainConfig, louvain


@dataclasses.dataclass
class PartitionResult:
    assignment: np.ndarray       # (n,) device id per vertex
    order: np.ndarray            # (n,) community-contiguous permutation
    cut_edges: int
    total_edges: int
    balance: float               # max device load / mean load

    @property
    def cut_fraction(self) -> float:
        return self.cut_edges / max(self.total_edges, 1)


def edge_cut(graph: CSRGraph, assignment) -> int:
    """Live directed slots whose endpoints lie on different devices."""
    a = torch.as_tensor(np.asarray(assignment), device=graph.device)
    live = graph.src < graph.n_cap
    src = graph.src[live].to(torch.int64)
    dst = graph.indices[live].to(torch.int64)
    return int(torch.sum(a[src] != a[dst]))


def _live_slots(graph: CSRGraph) -> int:
    return int(torch.sum(graph.src < graph.n_cap))


def louvain_partition(
    graph: CSRGraph,
    n_devices: int,
    config: LouvainConfig = LouvainConfig(),
) -> PartitionResult:
    """Detect communities, then greedily pack them onto devices (LPT)."""
    res = louvain(graph, config)
    membership = res.membership

    # Community sizes -> largest-first bin packing onto devices.
    comms, counts = np.unique(membership, return_counts=True)
    order_c = np.argsort(-counts)
    loads = np.zeros(n_devices, np.int64)
    comm_dev = np.zeros(comms.max() + 1, np.int32)
    for cix in order_c:
        d = int(np.argmin(loads))
        comm_dev[comms[cix]] = d
        loads[d] += counts[cix]

    assignment = comm_dev[membership]
    order = np.argsort(assignment * (membership.max() + 1) + membership,
                       kind="stable").astype(np.int32)
    return PartitionResult(
        assignment=assignment.astype(np.int32), order=order,
        cut_edges=edge_cut(graph, assignment),
        total_edges=_live_slots(graph),
        balance=float(loads.max() / max(loads.mean(), 1e-9)))


def random_partition(graph: CSRGraph, n_devices: int,
                     seed: int = 0) -> PartitionResult:
    """Baseline: hashed assignment (what you get without the technique)."""
    n = int(graph.n_valid)
    rng = np.random.default_rng(seed)
    assignment = rng.integers(0, n_devices, n).astype(np.int32)
    loads = np.bincount(assignment, minlength=n_devices)
    return PartitionResult(
        assignment=assignment, order=np.argsort(assignment).astype(np.int32),
        cut_edges=edge_cut(graph, assignment),
        total_edges=_live_slots(graph),
        balance=float(loads.max() / max(loads.mean(), 1e-9)))
