"""Which dimension of each input is split across the ranks of a
``ShardGroup`` (``repro.sharding.rules``, the part the GNN configs use).

The reference names mesh axes in ``PartitionSpec``s; a ``ShardGroup`` is
one flat rank axis (``collectives.mesh_rank`` flattens a mesh row-major),
so a spec becomes the index of the split dimension, or ``None`` where the
value is replicated on every rank.  The reference's data-parallel axes
(``dp_axes``: every mesh axis but ``model``) are all of a group's ranks,
since the GNN configs replicate their parameters.  Splits are even, in
rank order: rank r holds rows ``[r * n / W, (r + 1) * n / W)`` of the
split dimension.

The LM rules (``dp_axes``, ``lm_param_split``, ``lm_batch_split``,
``lm_cache_split``) keep the reference's mesh axes, since the LM runs on a
``collectives.RankGrid``: each gives, for every dimension of a leaf, the
tuple of axis names that split it (major first, as a ``PartitionSpec``
lists them) or ``None``.  They read only ``grid.shape`` and
``grid.axis_names``, so a JAX ``Mesh`` or any stand-in with those fields
serves.  ``share`` cuts a full tensor into one grid coordinate's share and
``assemble`` puts the shares of every rank back together.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np


def graph_batch_split(specs: dict, *, node_sharded: bool
                      ) -> Dict[str, Optional[int]]:
    """The split dimension of each field of ``specs`` (name -> ``(shape,
    dtype)``), the reference's ``gnn_batch_pspecs``: full-graph training
    (``node_sharded``) splits nodes and edges (dim 0) over every rank,
    except a ``(1,)`` graph target, which is replicated; a leading batch of
    sampled blocks or molecules splits dim 0 over every rank."""
    if node_sharded:
        return {k: None if (k == "labels" and s == (1,)) else 0
                for k, (s, _) in specs.items()}
    return dict.fromkeys(specs, 0)


def fm_param_split() -> Dict[str, Optional[int]]:
    """The reference's ``fm_param_pspecs``: ``w0`` replicated, the rows of
    ``w`` and ``v`` split over the ranks (the reference's ``model``
    axis)."""
    return {"w0": None, "w": 0, "v": 0}


def fm_batch_split(kind: str) -> Dict[str, Optional[int]]:
    """The FM's inputs (``configs/fm.py``): a train or serve batch splits
    dim 0 over every rank (the reference's dp axes); a retrieval query is
    replicated and its candidates split over every rank."""
    if kind == "train":
        return {"field_ids": 0, "labels": 0}
    if kind == "serve":
        return {"field_ids": 0}
    if kind == "retrieval":
        return {"user_fields": None, "cand_rows": 0}
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# The LM rules (MaxText-style FSDP x TP over a ("data", "model") grid).
# ---------------------------------------------------------------------------

Split = Tuple[Optional[Tuple[str, ...]], ...]


def dp_axes(grid) -> Tuple[str, ...]:
    """The data-parallel axes: every axis but ``model``."""
    return tuple(a for a in grid.axis_names if a != "model")


def _axes(entry) -> Optional[Tuple[str, ...]]:
    """One dimension's entry as a tuple of axis names or ``None``."""
    if entry is None:
        return None
    if isinstance(entry, str):
        return (entry,)
    entry = tuple(entry)
    return entry or None


def _spec(*entries) -> Split:
    return tuple(_axes(e) for e in entries)


def _layer_split(name: str, shard_experts: bool, F) -> Split:
    """One (unstacked) layer parameter's split by name (the reference's
    ``_layer_pspec``); ``F`` is the FSDP axis group or ``None``."""
    if name in ("ln1", "ln2", "q_ln", "kv_ln"):
        return _spec(None)
    if name in ("wq", "wk", "wv"):
        return _spec(F, "model")
    if name in ("bq", "bk", "bv"):
        return _spec("model")
    if name == "wo":
        return _spec("model", F)
    if name in ("w_dq", "w_dkv", "w_kr"):
        return _spec(F, None)
    if name in ("w_uq", "w_uk", "w_uv"):
        return _spec(F, "model")
    if name == "w_o":
        return _spec("model", F)
    if name in ("w_gate", "w_up"):
        return _spec(F, "model")
    if name == "w_down":
        return _spec("model", F)
    if name == "router":
        return _spec(F, None)
    if name in ("w_gate_e", "w_up_e"):
        return (_spec("model", F, None) if shard_experts
                else _spec(None, F, "model"))
    if name == "w_down_e":
        return (_spec("model", None, F) if shard_experts
                else _spec(None, "model", F))
    if name in ("w_gate_s", "w_up_s"):
        return _spec(F, "model")
    if name == "w_down_s":
        return _spec("model", F)
    raise ValueError(f"no sharding rule for param {name!r}")


def shards_experts(cfg, grid) -> bool:
    """Expert parallelism: experts split over ``model`` when there are at
    least as many experts as model ranks (else each expert's ``d_ff``)."""
    return cfg.moe is not None and cfg.moe.n_experts >= grid.shape["model"]


def lm_param_split(cfg, grid, fsdp: bool = True) -> dict:
    """The split of every leaf of ``transformer.param_shapes(cfg)`` (the
    reference's ``lm_param_pspecs``): Megatron tensor parallelism over
    ``model`` (``wq``/``wk``/``wv``/gate/up column-parallel, ``wo``/down
    row-parallel, the embedding split by vocabulary, experts over ``model``
    under expert parallelism) and FSDP over the dp axes on every other
    large dimension.  ``fsdp=False`` (the ``tp_only_params`` variant)
    replicates over dp.  Stacked layer leaves lead with their unsplit
    repeat dimension."""
    from repro_torch.models.transformer import _layer_param_shapes
    F = dp_axes(grid) if fsdp else None
    ep = shards_experts(cfg, grid)
    layer = {name: (None,) + _layer_split(name, ep, F)
             for name in _layer_param_shapes(cfg)}
    out = {"embed": _spec("model", F), "final_ln": _spec(None),
           "layers": [dict(layer) for _ in cfg.layer_windows]}
    if not cfg.tie_embeddings:
        out["lm_head"] = _spec(F, "model")
    return out


def lm_batch_split(grid) -> dict:
    """Token batches split by rows over the dp axes (``lm_batch_pspecs``)."""
    dp = dp_axes(grid)
    return {"tokens": _spec(dp, None), "labels": _spec(dp, None)}


def lm_cache_split(cfg, grid, seq_shard: bool = False,
                   model_seq_shard: bool = True) -> dict:
    """The decode cache's split (``lm_cache_pspecs``): batch over dp and
    the cache's sequence over ``model`` (the flash-decoding layout: each
    model rank holds a slice of the history, and only the ``(m, l, o)``
    partials of attention cross ranks).  ``model_seq_shard=False`` is the
    reference's baseline: heads over ``model`` where the KV heads divide
    the axis, else ``d_head``.  ``seq_shard`` (``long_500k``, batch 1)
    splits the sequence over dp as well and replicates the batch."""
    dp = dp_axes(grid)
    if seq_shard:
        b_ax, s_ax = None, (dp + ("model",) if model_seq_shard else dp)
    elif model_seq_shard:
        b_ax, s_ax = dp, "model"
    else:
        b_ax, s_ax = dp, None
    if cfg.mla is not None:
        per = {"c_kv": _spec(None, b_ax, s_ax, None),
               "k_rope": _spec(None, b_ax, s_ax, None)}
    else:
        if model_seq_shard:
            h_ax, d_ax = None, None
        elif cfg.n_kv_heads % grid.shape["model"] == 0:
            h_ax, d_ax = "model", None
        else:
            h_ax, d_ax = None, "model"
        if cfg.kv_cache_dtype == "int8":
            per = {"k_q": _spec(None, b_ax, s_ax, h_ax, d_ax),
                   "v_q": _spec(None, b_ax, s_ax, h_ax, d_ax),
                   "k_s": _spec(None, b_ax, s_ax, h_ax),
                   "v_s": _spec(None, b_ax, s_ax, h_ax)}
        else:
            per = {"k": _spec(None, b_ax, s_ax, h_ax, d_ax),
                   "v": _spec(None, b_ax, s_ax, h_ax, d_ax)}
    return {"slots": [dict(per) for _ in cfg.layer_windows]}


def split_parts(split: Split, grid) -> Tuple[int, ...]:
    """How many shares each dimension is cut into."""
    return tuple(1 if axes is None else
                 math.prod(grid.shape[a] for a in axes) for axes in split)


def _share_index(axes, grid, coords: dict) -> int:
    idx = 0
    for a in axes:
        idx = idx * grid.shape[a] + int(coords[a])
    return idx


def share(x, split: Split, grid, coords: Optional[dict] = None):
    """The share of ``x`` (a tensor or an array) at ``coords`` (default
    ``grid.coords``): each split dimension cut into equal parts, the part
    indexed row-major by the coordinates on its axes.  A tensor's share is
    a fresh contiguous copy."""
    coords = grid.coords if coords is None else coords
    if len(split) != x.ndim:
        raise ValueError(f"a split of {len(split)} dimensions for a "
                         f"{x.ndim}-dimensional leaf")
    out = x
    for dim, (axes, n) in enumerate(zip(split, split_parts(split, grid))):
        if axes is None:
            continue
        if x.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                             f"split into {n} equal shares over {axes}")
        size = x.shape[dim] // n
        lo = _share_index(axes, grid, coords) * size
        index = [slice(None)] * x.ndim
        index[dim] = slice(lo, lo + size)
        out = out[tuple(index)]
    if hasattr(out, "contiguous"):
        return out.contiguous().clone()
    return np.ascontiguousarray(out)


def grid_coords(grid) -> list:
    """Every rank's coordinates, in rank order (row-major)."""
    return [dict(zip(grid.axis_names, pt)) for pt in itertools.product(
        *(range(grid.shape[a]) for a in grid.axis_names))]


def assemble(shares: Sequence, split: Split, grid) -> np.ndarray:
    """The full array from every rank's share (numpy or tensors, in rank
    order): the inverse of ``share``.  Ranks that hold the same part (a
    dimension replicated over an axis) must agree; the lowest rank's copy
    is kept."""
    parts = [np.asarray(s.detach().cpu().numpy()) if hasattr(s, "detach")
             else np.asarray(s) for s in shares]
    n = split_parts(split, grid)
    full = np.empty(tuple(d * k for d, k in zip(parts[0].shape, n)),
                    parts[0].dtype)
    seen = set()
    for coords, part in zip(grid_coords(grid), parts):
        key = tuple(0 if axes is None else _share_index(axes, grid, coords)
                    for axes in split)
        if key in seen:
            continue
        seen.add(key)
        full[tuple(slice(k * d, (k + 1) * d)
                   for k, d in zip(key, part.shape))] = part
    return full


def map_split(fn, tree, split_tree):
    """``fn(leaf, split)`` over an LM tree (dicts and lists) and its split
    tree."""
    if isinstance(tree, dict):
        return {k: map_split(fn, v, split_tree[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_split(fn, v, s) for v, s in zip(tree, split_tree)]
    return fn(tree, split_tree)
