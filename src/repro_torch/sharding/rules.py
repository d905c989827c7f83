"""Which dimension of each input is split across the ranks of a
``ShardGroup`` (``repro.sharding.rules``, the part the GNN configs use).

The reference names mesh axes in ``PartitionSpec``s; a ``ShardGroup`` is
one flat rank axis (``collectives.mesh_rank`` flattens a mesh row-major),
so a spec becomes the index of the split dimension, or ``None`` where the
value is replicated on every rank.  The reference's data-parallel axes
(``dp_axes``: every mesh axis but ``model``) are all of a group's ranks,
since the GNN configs replicate their parameters.  Splits are even, in
rank order: rank r holds rows ``[r * n / W, (r + 1) * n / W)`` of the
split dimension.  The LM rules come with their models.
"""

from __future__ import annotations

from typing import Dict, Optional


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
