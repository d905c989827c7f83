"""Factorization Machine (Rendle, ICDM'10) of the PyTorch port
(``repro.models.recsys``).

y(x) = w0 + sum_i w_i + 1/2 [ (sum_i v_i)^2 - sum_i v_i^2 ]   (O(n k) trick)

over 39 sparse categorical fields (Criteo-style).  The per-field tables
are one concatenated (padded_vocab, k) matrix; per-field offsets turn
field-local ids into rows.  The 39 default vocabularies sum to 29,333,260
rows, padded to 29,333,504 (the reference's docstrings say ~33M).

Every parameter is float32.  Row gathers differentiate into DENSE
gradients over the whole table, as ``jax.value_and_grad`` gives them: no
sparse gradients, so AdamW decays and moves every row on every step.  A
gather's backward sums each table row's gradients with
``sorted_segment_sums``: a stable sort and a pairwise tree in a fixed
order, with no atomics, so rows that many examples share (the click ids
are Pareto-skewed) get the same bits on every run; ``w`` and ``v`` share
one sort and one tree (``gather_shared_rows``).

``embedding_bag`` is built from ``index_select`` and segment reductions,
as the reference builds it from ``take`` and ``segment_*``:
``torch.nn.functional.embedding_bag`` differs on ``max`` and on empty bags.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.core.graph import resolve_device
from repro_torch.sharding.rules import fm_param_split

F32 = torch.float32

# A realistic Criteo-like vocabulary mix for 39 fields (29,333,260 rows).
DEFAULT_VOCABS = tuple(
    [int(v) for v in
     [10_000_000, 8_000_000, 4_000_000, 2_000_000, 1_500_000, 1_000_000,
      800_000, 600_000, 400_000, 300_000, 200_000, 150_000, 100_000,
      80_000, 60_000, 40_000, 30_000, 20_000, 15_000, 10_000,
      8_000, 6_000, 4_000, 3_000, 2_000, 1_500, 1_000, 800, 600, 400,
      300, 200, 150, 100, 80, 60, 40, 20, 10]]
)


@dataclasses.dataclass(frozen=True)
class FMConfig:
    name: str = "fm"
    n_fields: int = 39
    embed_dim: int = 10
    vocab_sizes: Tuple[int, ...] = DEFAULT_VOCABS

    @property
    def total_vocab(self) -> int:
        return int(sum(self.vocab_sizes))

    @property
    def padded_vocab(self) -> int:
        """Table rows padded to a multiple of 512, so that the row split
        divides every power-of-two rank count up to 512; rows past
        ``total_vocab`` are never indexed."""
        return -(-self.total_vocab // 512) * 512

    @property
    def field_offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.vocab_sizes)[:-1]]
                              ).astype(np.int64)


def param_shapes(cfg: FMConfig) -> dict:
    return {"w0": (), "w": (cfg.padded_vocab,),
            "v": (cfg.padded_vocab, cfg.embed_dim)}


def init_params(cfg: FMConfig, seed: int = 0,
                device="cuda") -> Dict[str, torch.Tensor]:
    """``w0`` zero, ``w`` and ``v`` normal * 0.01, drawn on ``device`` (the
    card unless the caller asks for the CPU) from a ``torch.Generator``
    seeded with ``seed``.  The draws are not JAX's: parity tests carry the
    reference's weights across (``interop.fm_params_from_numpy``)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    v_total = cfg.padded_vocab
    w = torch.randn(v_total, generator=gen, device=dev, dtype=F32) * 0.01
    v = torch.randn(v_total, cfg.embed_dim, generator=gen, device=dev,
                    dtype=F32) * 0.01
    return {"w0": torch.zeros((), dtype=F32, device=dev), "w": w, "v": v}


#: Pairwise levels run over every entry before the entries still adding
#: are gathered (``_tree_sum``).
TREE_LEVELS = 4


def _tree_sum(x: torch.Tensor, pos: torch.Tensor, length: torch.Tensor,
              max_len: int, gather: bool = True) -> torch.Tensor:
    """Adds each run of ``x`` (n, c) (entries sorted by segment; ``pos``
    is an entry's place in its run, ``length`` its run's length) into the
    run's first entry, in place, by a pairwise tree: at stride s the entry
    at a multiple of 2s takes in the one s further on.  With ``gather``,
    after ``TREE_LEVELS`` levels the entries still adding (at a multiple of
    the stride, in runs longer than it) are gathered once and the tree ends
    over them."""
    step = 1
    while step < max_len:
        if gather and step == 2 ** TREE_LEVELS:
            live = torch.nonzero((pos % step == 0)
                                 & (length > step)).squeeze(1)
            return x.index_copy_(0, live, _tree_sum(
                x[live], pos[live] // step, -(-length[live] // step),
                -(-max_len // step), gather=False))
        mask = (pos % (2 * step) == 0) & (pos + step < length)
        x[:-step] += torch.where(mask[:-step, None], x[step:], 0)
        step *= 2
    return x


def sorted_segment_sums(values: Sequence[torch.Tensor],
                        segments: torch.Tensor,
                        num_segments: int) -> List[torch.Tensor]:
    """``jax.ops.segment_sum`` of each of ``values`` ((L, ...) tensors of one
    type) over the same ``segments`` (L,), in a fixed order: a stable sort
    brings each segment's entries together in their input order, one
    pairwise tree (``_tree_sum``) adds the runs of all of ``values`` side by
    side, and each run's total is written to its own row.  No atomics: the
    same inputs give the same bits on every run and every device."""
    seg = segments.reshape(-1).long()
    n = seg.numel()
    outs = [torch.zeros((num_segments, *v.shape[1:]), dtype=v.dtype,
                        device=v.device) for v in values]
    if n == 0:
        return outs
    order = torch.argsort(seg, stable=True)
    s = seg[order]
    head = torch.ones(n, dtype=torch.bool, device=seg.device)
    head[1:] = s[1:] != s[:-1]
    heads = torch.nonzero(head).squeeze(1)           # each run's first entry
    counts = torch.diff(heads, append=heads.new_tensor([n]))
    run = torch.cumsum(head, 0) - 1                  # each entry's run
    pos = torch.arange(n, device=seg.device) - heads[run]
    flat = [v.reshape(n, -1) for v in values]
    x = _tree_sum(torch.cat(flat, 1).index_select(0, order), pos,
                  counts[run], int(counts.max()))
    rows, tot = s[heads], x[heads]
    col = 0
    for out, f in zip(outs, flat):
        w = f.shape[1]
        out.index_copy_(0, rows, tot[:, col:col + w].reshape(
            -1, *out.shape[1:]))
        col += w
    return outs


def sorted_segment_sum(values: torch.Tensor, segments: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """``sorted_segment_sums`` of one tensor."""
    return sorted_segment_sums([values], segments, num_segments)[0]


class _GatherRows(torch.autograd.Function):
    """``t[rows]`` for each of ``tables`` (the same number of rows);
    backward: each table's dense gradient, every table's contributions
    added by one ``sorted_segment_sums``."""

    @staticmethod
    def forward(ctx, rows, *tables):
        ctx.save_for_backward(rows)
        ctx.n_rows = tables[0].shape[0]
        flat = rows.reshape(-1)
        return tuple(t.index_select(0, flat).view(*rows.shape, *t.shape[1:])
                     for t in tables)

    @staticmethod
    def backward(ctx, *grads):
        (rows,) = ctx.saved_tensors
        return (None, *sorted_segment_sums(
            [g.reshape(rows.numel(), *g.shape[rows.dim():]) for g in grads],
            rows, ctx.n_rows))


def gather_shared_rows(tables: Sequence[torch.Tensor],
                       rows: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """``t[rows]`` for each of ``tables`` (rows of any shape, int32 or
    int64), differentiable into dense gradients of the tables' shapes
    (one sort and one tree for all of them)."""
    return _GatherRows.apply(rows.long(), *tables)


def gather_rows(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``table[rows]`` (rows of any shape, int32 or int64), differentiable
    into a dense gradient of ``table``'s shape."""
    return gather_shared_rows((table,), rows)[0]


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  bag_ids: torch.Tensor, n_bags: int, mode: str = "sum",
                  weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``torch.nn.EmbeddingBag`` as the reference builds it: a ragged gather
    and a segment reduction.  table (V, k); ids (L,) row ids; bag_ids (L,)
    the bag of each id.  An empty bag is 0 under ``sum`` and ``mean`` and
    the identity of max (``-inf``) under ``max``."""
    rows = gather_rows(table, ids)
    if weights is not None:
        rows = rows * weights[:, None]
    seg = bag_ids.long()
    if mode == "sum":
        return sorted_segment_sum(rows, seg, n_bags)
    if mode == "mean":
        s = sorted_segment_sum(rows, seg, n_bags)
        c = sorted_segment_sum(torch.ones(ids.shape, dtype=F32,
                                          device=ids.device), seg, n_bags)
        return s / torch.clamp(c, min=1.0)[:, None]
    if mode == "max":
        init = torch.full((n_bags, *rows.shape[1:]), float("-inf"),
                          dtype=rows.dtype, device=rows.device)
        return init.scatter_reduce(0, seg[:, None].expand_as(rows), rows,
                                   "amax", include_self=True)
    raise ValueError(mode)


def field_rows(cfg: FMConfig, field_ids: torch.Tensor) -> torch.Tensor:
    """(B, F) per-field ids -> (B, F) global rows via field offsets."""
    offs = torch.as_tensor(cfg.field_offsets, dtype=torch.int32,
                           device=field_ids.device)
    return field_ids.to(torch.int32) + offs[None, :]


def fm_partials(params: dict, rows: torch.Tensor,
                owned: Optional[torch.Tensor] = None):
    """The per-example sums of the FM over the rows (B, F) of the table in
    ``params``: ``(sum_f w, sum_f v, sum_f v*v)`` of shapes (B,), (B, k),
    (B, k).  ``owned`` (B, F) bool keeps only the rows this table holds
    (``rows`` then index its local rows); the sums are linear in the rows,
    so partial sums over a row split add up to the whole."""
    v, w = gather_shared_rows((params["v"], params["w"]), rows)
    if owned is not None:
        keep = owned.to(v.dtype)
        v = v * keep[..., None]
        w = w * keep
    return torch.sum(w, dim=1), torch.sum(v, dim=1), torch.sum(v * v, dim=1)


def _at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 as the reference returns it, float64 kept (the checks on
    the card run a float64 copy of the model)."""
    return x.to(torch.promote_types(x.dtype, F32))


def fm_logits(w0: torch.Tensor, sum_w: torch.Tensor, sum_v: torch.Tensor,
              sum_sq: torch.Tensor) -> torch.Tensor:
    """Logits from the per-example sums: the sum-square trick."""
    lin = w0 + sum_w
    pair = 0.5 * torch.sum(sum_v * sum_v - sum_sq, dim=1)
    return _at_least_f32(lin + pair)


def forward(cfg: FMConfig, params: dict,
            field_ids: torch.Tensor) -> torch.Tensor:
    """field_ids (B, F) int32 -> logits (B,)."""
    return fm_logits(params["w0"],
                     *fm_partials(params, field_rows(cfg, field_ids)))


def bce_terms(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-example binary cross-entropy on logits, in the stable form."""
    y = labels.to(F32)
    return (torch.clamp(logits, min=0) - logits * y
            + torch.log1p(torch.exp(-torch.abs(logits))))


def loss_fn(cfg: FMConfig, params: dict, batch: dict) -> torch.Tensor:
    """Binary cross-entropy on click labels (mean over the batch)."""
    logits = forward(cfg, params, batch["field_ids"])
    return torch.mean(bce_terms(logits, batch["labels"]))


def retrieval_scores(cfg: FMConfig, params: dict, user_fields: torch.Tensor,
                     cand_rows: torch.Tensor) -> torch.Tensor:
    """Score ONE user (1, F) against N candidate rows (N,) in one mat-vec:
    the FM restricted to user-item cross terms, s(u, c) = <sum_f v_f(u),
    v_c> + w_c (user-internal terms are constant over candidates)."""
    rows = field_rows(cfg, user_fields)                # (1, F)
    v_u = torch.sum(gather_rows(params["v"], rows[0]), dim=0)   # (k,)
    v_c = gather_rows(params["v"], cand_rows)          # (N, k)
    w_c = gather_rows(params["w"], cand_rows)          # (N,)
    return _at_least_f32(v_c @ v_u + w_c)


class FM(nn.Module):
    """The FM's parameters ``w0``, ``w`` and ``v`` on ``device`` (the card
    unless the caller asks for the CPU): ``init_params``, or a copy of
    ``params`` (tensors or numpy).  A module may hold a row range of the
    table: ``row_lo`` is its first global row (``shard``)."""

    def __init__(self, cfg: FMConfig, seed: int = 0, device="cuda",
                 params: Optional[dict] = None, row_lo: int = 0):
        super().__init__()
        self.cfg = cfg
        self.row_lo = row_lo
        if params is None:
            params = init_params(cfg, seed, device)
        else:
            dev = resolve_device(device)
            params = {k: torch.as_tensor(params[k]).to(dev, F32, copy=True)
                      for k in ("w0", "w", "v")}
        self.w0 = nn.Parameter(params["w0"])
        self.w = nn.Parameter(params["w"])
        self.v = nn.Parameter(params["v"])

    def params(self) -> Dict[str, torch.Tensor]:
        return {"w0": self.w0, "w": self.w, "v": self.v}

    def shard(self, rank: int, world_size: int) -> "FM":
        """A module holding rank ``rank``'s share of each parameter under
        ``sharding.rules.fm_param_split``: the table's rows (an even split
        in rank order) and ``w0`` whole."""
        n = self.w.shape[0]
        if n % world_size:
            raise ValueError(f"{n} table rows do not split over "
                             f"{world_size} ranks")
        part = n // world_size
        lo = rank * part
        split = fm_param_split()
        params = {k: p.detach() if split[k] is None
                  else p.detach().narrow(split[k], lo, part)
                  for k, p in self.params().items()}
        return FM(self.cfg, device=self.w.device, params=params,
                  row_lo=self.row_lo + lo)

    def forward(self, field_ids: torch.Tensor) -> torch.Tensor:
        return forward(self.cfg, self.params(), field_ids)
