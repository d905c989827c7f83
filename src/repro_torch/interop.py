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


def _tree_leaves(tree, prefix=""):
    """(name, array) of a JAX GNN parameter pytree as numpy, named like the
    port module's parameters: dict keys and list indices join with dots,
    and an MLP's list of ``(w, b)`` pairs becomes ``w.{j}`` / ``b.{j}``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tree_leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)) and tree and all(
            isinstance(x, (list, tuple)) and len(x) == 2 for x in tree):
        for j, (w, b) in enumerate(tree):
            yield f"{prefix}w.{j}", w
            yield f"{prefix}b.{j}", b
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tree_leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


#: The architectures whose modules take a converted JAX parameter tree.
GNN_ARCH_IDS = ("gin-tu", "gat-cora", "equiformer-v2", "dimenet")


def gnn_params_from_numpy(arch_id: str, tree, device="cuda") -> dict:
    """The port module's state (``load_state_dict``) of ``arch_id`` from the
    JAX parameter pytree as numpy arrays (``jax.tree.map(np.asarray,
    params)``); weights keep the reference's ``(in, out)`` layout.  The
    same names key a converted gradient tree."""
    if arch_id not in GNN_ARCH_IDS:
        raise ValueError(f"no port module for {arch_id!r}; ported: "
                         f"{GNN_ARCH_IDS}")
    dev = resolve_device(device)
    return {name: torch.from_numpy(np.array(x, np.float32)).to(dev)
            for name, x in _tree_leaves(tree)}


def fm_params_from_numpy(tree, device="cuda") -> dict:
    """The FM's parameters ``{"w0", "w", "v"}`` as float32 tensors on
    ``device`` from the JAX package's FM parameter dict as numpy (the
    keys of ``repro.models.recsys.init_params``); the same names key a
    converted gradient tree."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(tree[k], np.float32)).to(dev)
            for k in ("w0", "w", "v")}


def adamw_state_from_numpy(arch_id: str, step, mu, nu, device="cuda"):
    """The port's ``AdamWState`` from the JAX ``AdamWState``'s fields as
    numpy (``mu`` / ``nu`` trees like the parameters of ``arch_id``: a GNN
    of ``GNN_ARCH_IDS`` or ``"fm"``)."""
    from repro_torch.optim import AdamWState
    dev = resolve_device(device)

    def convert(tree):
        if arch_id == "fm":
            return fm_params_from_numpy(tree, dev)
        return gnn_params_from_numpy(arch_id, tree, dev)

    return AdamWState(
        step=torch.tensor(int(step), dtype=torch.int32, device=dev),
        mu=convert(mu), nu=convert(nu))



def lm_params_from_numpy(tree, device="cuda", dtype=torch.float32, *,
                         cfg=None, grid=None, coords=None,
                         fsdp: bool = True) -> dict:
    """An LM parameter tree of the port (``models.transformer``) from the
    reference's ``{"embed", "final_ln", "layers": [{name: (n_repeats, ...)}
    ...], "lm_head"?}`` as numpy, cast to ``dtype`` (the config's
    activation type).  bfloat16 travels as float32 numpy
    (``np.asarray(x.astype(jnp.float32))``) and is cast back exactly.  The
    same call converts a gradient tree.

    With ``grid`` (a ``RankGrid`` or any object with its ``shape`` and
    ``axis_names``) it returns the share of ``cfg``'s parameters at grid
    coordinate ``coords`` (default ``grid.coords``) by
    ``sharding.lm_param_split(cfg, grid, fsdp)``."""
    from repro_torch.sharding.rules import lm_param_split, map_split, share
    dev = resolve_device(device)
    if grid is not None:
        tree = map_split(lambda x, sp: share(np.asarray(x), sp, grid, coords),
                         tree, lm_param_split(cfg, grid, fsdp))

    def put(x):
        return torch.from_numpy(np.array(x, np.float32)).to(dev, dtype)

    out = {k: put(x) for k, x in tree.items() if k != "layers"}
    out["layers"] = [{k: put(x) for k, x in slot.items()}
                     for slot in tree["layers"]]
    return out


def lm_cache_from_numpy(tree, device="cuda", dtype=torch.float32, *,
                        cfg=None, grid=None, coords=None,
                        seq_shard: bool = False,
                        model_seq_shard: bool = True) -> dict:
    """An LM cache tree ``{"slots": [{name: (n_repeats, B, S, ...)}]}`` of
    the port from the reference's as numpy: the int8 values (``k_q``,
    ``v_q``) stay int8 and their scales (``k_s``, ``v_s``) float32; ``k``,
    ``v``, ``c_kv`` and ``k_rope`` take ``dtype`` (as float32 numpy, like
    the parameters).  With ``grid``: the share at ``coords`` by
    ``sharding.lm_cache_split(cfg, grid, seq_shard, model_seq_shard)``."""
    from repro_torch.models.transformer import cache_leaf_dtype
    from repro_torch.sharding.rules import lm_cache_split, map_split, share
    dev = resolve_device(device)
    if grid is not None:
        tree = map_split(lambda x, sp: share(np.asarray(x), sp, grid, coords),
                         tree, lm_cache_split(cfg, grid, seq_shard,
                                              model_seq_shard))
    return {"slots": [
        {name: torch.from_numpy(np.array(x)).to(
            dev, cache_leaf_dtype(name, dtype)) for name, x in slot.items()}
        for slot in tree["slots"]]}


def lm_tree_assemble(shares, split_tree, grid):
    """The full LM tree (numpy) from every rank's share of it (trees of
    numpy arrays or tensors, in rank order) under ``split_tree``: the
    inverse of the sharing above, for the tests."""
    from repro_torch.sharding.rules import assemble
    if isinstance(split_tree, dict):
        return {k: lm_tree_assemble([t[k] for t in shares], split_tree[k],
                                    grid) for k in split_tree}
    if isinstance(split_tree, list):
        return [lm_tree_assemble([t[i] for t in shares], sp, grid)
                for i, sp in enumerate(split_tree)]
    return assemble(shares, split_tree, grid)
