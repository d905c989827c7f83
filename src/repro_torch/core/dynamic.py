"""Dynamic streaming Louvain of the PyTorch port (``repro.core.dynamic``):
naive-dynamic warm start + delta screening.

Serving workloads see small edge-batch deltas between queries, so
``louvain_dynamic(graph, batches, prev=...)`` applies each ``EdgeBatch``
in capacity (``core/delta.py``, the kernel K4 on the card), screens the
affected frontier (``core/engine.affected_frontier``) and resumes
``louvain()`` from the running membership:

  * **Naive-dynamic**: the move phase resumes from the previous membership;
    community weights Sigma are recomputed from the updated graph.
  * **Delta screening**: the first pass's frontier holds only the endpoints
    of changed edges (plus, by default, every member of their communities);
    with vertex pruning the frontier then grows outward from actual movers.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.delta import EdgeBatch, apply_edge_batch
from repro_torch.core.engine import affected_frontier, normalize_screening
from repro_torch.core.graph import CSRGraph
from repro_torch.core.louvain import (LouvainConfig, LouvainResult, louvain,
                                      membership_modularity, pad_membership,
                                      screened_frontier)
from repro_torch.core.spans import span

#: The frontier rule under its historical single-device name (the
#: engine's ``affected_frontier``, shared with the sharded layout).
delta_frontier = screened_frontier


@dataclasses.dataclass
class BatchUpdateStats:
    """One streamed batch: what changed and what it cost."""

    batch_size: int              # live entries in the batch
    n_touched: int               # endpoints whose incident weights changed
    frontier_size: int           # delta-screened seed frontier (|F| <= n)
    n_vertices: int              # n_valid after the update
    n_communities: int
    apply_seconds: float         # CSR edge-batch apply
    update_seconds: float        # warm-started Louvain
    modularity: Optional[float] = None
    scan_backend: Optional[str] = None   # the first pass's scanner

    @property
    def frontier_fraction(self) -> float:
        return self.frontier_size / max(self.n_vertices, 1)


@dataclasses.dataclass
class DynamicResult:
    graph: CSRGraph              # graph after all batches
    membership: np.ndarray       # (n_valid,) final community per vertex
    n_communities: int
    batch_stats: List[BatchUpdateStats]
    total_seconds: float

    @property
    def updates_per_second(self) -> float:
        edges = sum(s.batch_size for s in self.batch_stats)
        return edges / max(self.total_seconds, 1e-12)


def louvain_dynamic(
    graph: CSRGraph,
    batches: Sequence[EdgeBatch],
    prev: Optional[np.ndarray] = None,
    config: LouvainConfig = LouvainConfig(),
    *,
    screening=True,
    track_modularity: bool = False,
    grow_capacity: bool = True,
    apply_backend: str = "auto",
) -> DynamicResult:
    """Stream edge batches through warm-started, delta-screened Louvain on
    the graph's device.

    ``prev`` is the membership of ``graph`` before the stream ((n,) ints);
    if ``None``, a cold ``louvain()`` on the initial graph gives it.
    ``screening``: ``True``/``"community"`` (touched endpoints plus their
    whole communities), ``"vertex"`` (touched endpoints only), ``"auto"``
    (per batch, from the touched-set size, on the device) or ``False``
    (warm start over all vertices).  With ``grow_capacity`` a batch that
    would overflow ``e_cap`` re-buckets into doubled capacity instead of
    raising.  ``apply_backend``: ``"auto"`` (K4 on the card, the sort chain
    on the CPU), ``"kernel"`` or ``"sort"`` — equal results.

    The resident stream graph is never laddered: ``louvain`` re-buckets only
    its internal coarse graphs, so every batch applies at stream capacity.
    """
    with span("dynamic.call") as call:
        dev = graph.device
        n_cap = graph.n_cap
        screen_mode = normalize_screening(screening)
        if prev is None:
            prev = louvain(graph, config).membership
        with span("dynamic.prepare", host=True):
            membership = pad_membership(np.asarray(prev, np.int32), n_cap)
            n_comms = int(len(np.unique(membership[: graph.n_valid])))

        stats: List[BatchUpdateStats] = []
        # n_touched is a device reduction; reading it per batch would wait
        # on the device inside the stream loop, so the counts are read in
        # one transfer after the stream.
        touched_counts: List[torch.Tensor] = []
        for i, batch in enumerate(batches):
            with span("dynamic.batch", batch=i):
                # The apply reads its edge count to the host, so the device
                # is done with it when the span ends.
                with span("dynamic.apply") as apply_span:
                    graph, touched = apply_edge_batch(
                        graph, batch, grow=grow_capacity,
                        backend=apply_backend)
                with span("dynamic.update") as update_span:
                    frontier = None
                    if screen_mode is not None:
                        frontier = affected_frontier(
                            touched, torch.from_numpy(membership).to(dev),
                            graph.n_valid, screen_mode)
                    res: LouvainResult = louvain(graph, config,
                                                 init_membership=membership,
                                                 init_frontier=frontier)
                with span("dynamic.pad", host=True):
                    membership = pad_membership(res.membership, n_cap)
                    n_comms = res.n_communities
                    touched_counts.append(touched.sum())
                    first = res.passes[0] if res.passes else None
                    stats.append(BatchUpdateStats(
                        batch_size=batch.b_valid,
                        n_touched=-1,  # filled from touched_counts below
                        frontier_size=first.frontier_size if first else 0,
                        n_vertices=graph.n_valid,
                        n_communities=n_comms,
                        apply_seconds=apply_span.seconds,
                        update_seconds=update_span.seconds,
                        modularity=(membership_modularity(graph,
                                                          res.membership)
                                    if track_modularity else None),
                        scan_backend=first.scan_backend if first else None))
        with span("dynamic.finish", host=True):
            if touched_counts:
                for s, cnt in zip(stats,
                                  torch.stack(touched_counts).tolist()):
                    s.n_touched = int(cnt)
            n = graph.n_valid
            membership = membership[:n].copy()
    return DynamicResult(graph=graph, membership=membership,
                         n_communities=n_comms, batch_stats=stats,
                         total_seconds=call.seconds)
