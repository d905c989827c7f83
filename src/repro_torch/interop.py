"""Carry state across from the JAX package as plain Python and numpy
values, so that both packages compute on the same inputs (the parity tests
use these).  Nothing here imports JAX: callers hand over numpy arrays and
``dataclasses.asdict`` dictionaries."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.delta import EdgeBatch
from repro_torch.core.distributed import ShardedGraphSpec, rank_slice
from repro_torch.core.graph import CSRGraph, resolve_device
from repro_torch.core.louvain import LouvainConfig


def graph_from_numpy(indptr, indices, weights, src, n_valid, e_valid,
                     device="cuda") -> CSRGraph:
    """A ``CSRGraph`` from the JAX ``CSRGraph``'s buffers as numpy arrays
    (same capacities, same slot contract)."""
    dev = resolve_device(device)

    def put(x, dtype):
        return torch.from_numpy(np.array(x, dtype=dtype)).to(dev)

    return CSRGraph(indptr=put(indptr, np.int32),
                    indices=put(indices, np.int32),
                    weights=put(weights, np.float32),
                    src=put(src, np.int32), n_valid=int(n_valid),
                    e_valid=int(e_valid))


def edge_batch_from_numpy(src, dst, weight, b_valid,
                          device="cuda") -> EdgeBatch:
    """An ``EdgeBatch`` from the JAX ``EdgeBatch``'s buffers as numpy arrays
    (same capacity, same padding)."""
    dev = resolve_device(device)

    def put(x, dtype):
        return torch.from_numpy(np.array(x, dtype=dtype)).to(dev)

    return EdgeBatch(src=put(src, np.int32), dst=put(dst, np.int32),
                     weight=put(weight, np.float32), b_valid=int(b_valid))


def config_from_dict(fields: dict) -> LouvainConfig:
    """A ``LouvainConfig`` from ``dataclasses.asdict`` of the JAX config.
    The reference's ``agg_backend="pallas"`` is the port's ``"kernel"``;
    what ``LouvainConfig`` refuses (an ELL width below 1) raises here
    too."""
    fields = dict(fields)
    if fields.get("agg_backend") == "pallas":
        fields["agg_backend"] = "kernel"
    if "ell_widths" in fields:
        fields["ell_widths"] = tuple(fields["ell_widths"])
    return LouvainConfig(**fields)


def sharded_from_numpy(src_g, dst_g, w_g, spec, rank: int, device="cuda"):
    """One rank's ``(e_per_shard,)`` device slices (src, dst, w) of the JAX
    package's partitioned edge arrays (``partition_graph_host`` /
    ``bucket_slots_host``) as numpy; ``spec`` is the reference's
    ``ShardedGraphSpec`` or its fields."""
    spec = ShardedGraphSpec(*spec)
    return rank_slice(src_g, dst_g, w_g, spec, rank, resolve_device(device))
