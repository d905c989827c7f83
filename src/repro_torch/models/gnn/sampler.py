"""Fanout neighbor sampler (GraphSAGE-style) for minibatch GNN training.

Host-side numpy, a copy of ``repro.models.gnn.sampler`` that gives the
same blocks byte for byte from the same generator state: samples a k-hop
block from a CSR graph with per-hop fanouts (the ``minibatch_lg`` shape
uses fanout 15-10 over 1024 seeds).  Returns a padded subgraph in
GraphBatch layout with static shapes: layer h edges connect hop-(h+1)
sources to hop-h destinations (all re-indexed into the block's local node
space).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class SampledBlock:
    node_ids: np.ndarray      # (N_block,) global ids of all block nodes
    edge_src: np.ndarray      # (E_pad,) local ids
    edge_dst: np.ndarray      # (E_pad,) local ids
    n_nodes: int
    n_seeds: int              # first n_seeds nodes are the seed targets


def block_capacity(n_seeds: int, fanouts: Sequence[int]) -> Tuple[int, int]:
    """Static (node, edge) capacity of a sampled block."""
    n_cap, e_cap, frontier = n_seeds, 0, n_seeds
    for f in fanouts:
        e_cap += frontier * f
        frontier = frontier * f
        n_cap += frontier
    return n_cap, e_cap


def sample_block(
    indptr: np.ndarray,
    indices: np.ndarray,
    seeds: np.ndarray,
    fanouts: Sequence[int],
    rng: np.random.Generator,
) -> SampledBlock:
    """Uniform fanout sampling.  Capacity-padded; duplicate block nodes are
    deduplicated (memory layout stays static via padding)."""
    n_cap, e_cap = block_capacity(len(seeds), fanouts)
    nodes = list(seeds)
    local = {int(v): i for i, v in enumerate(seeds)}
    src_l, dst_l = [], []
    frontier = list(seeds)
    for f in fanouts:
        nxt = []
        for v in frontier:
            lo, hi = indptr[v], indptr[v + 1]
            deg = hi - lo
            if deg == 0:
                continue
            take = min(f, deg)
            picks = indices[lo + rng.choice(deg, size=take, replace=False)]
            for u in picks:
                u = int(u)
                if u not in local:
                    local[u] = len(nodes)
                    nodes.append(u)
                # message u -> v
                src_l.append(local[u])
                dst_l.append(local[v])
                nxt.append(u)
        frontier = nxt

    n_block = len(nodes)
    e_block = len(src_l)
    node_ids = np.full(n_cap, -1, np.int64)
    node_ids[:n_block] = nodes
    es = np.full(e_cap, n_cap, np.int32)
    ed = np.full(e_cap, n_cap, np.int32)
    es[:e_block] = src_l
    ed[:e_block] = dst_l
    return SampledBlock(node_ids=node_ids, edge_src=es, edge_dst=ed,
                        n_nodes=n_block, n_seeds=len(seeds))
