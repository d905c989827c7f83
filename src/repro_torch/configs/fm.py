"""fm [recsys]: factorization machine, 39 sparse fields, embed_dim=10,
pairwise interactions via the O(nk) sum-square trick.  [ICDM'10 (Rendle)]
(``repro.configs.fm``)

Shapes: train_batch (B=65,536 training), serve_p99 (B=512 online),
serve_bulk (B=262,144 offline scoring), retrieval_cand (1 query vs 10^6
candidates, single batched mat-vec).

Over the ranks of a ``ShardGroup`` (``sharding.rules.fm_param_split`` /
``fm_batch_split``): the table's 29,333,504 padded rows (29,333,260 used)
x 10 are split evenly by rows in rank order, ``w0`` is replicated, and a
batch splits its examples over every rank.  A rank's partial sums of the
FM (``sum w``, ``sum v``, ``sum v*v``) are linear in its rows, so each rank
all-gathers the batch's ``field_ids`` (B x 39 int32), sums the rows it
owns for every example, and reduce-scatters the (B, 2k + 1) partials back
to the examples' owners, where the pairwise term is formed; the backward
is the adjoint collective.  Retrieval sums the user's vector over ranks,
scores the all-gathered candidates whose rows a rank owns, and
reduce-scatters the scores to each rank's candidate slice.  A
``ShardGroup.single`` runs no collective: each step is the plain FM.  A
process group of any size, one rank included, runs the row-split step.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.gnn_common import shard_batch
from repro_torch.core.collectives import RankGrid, ReduceScatter, ShardGroup
from repro_torch.core.graph import resolve_device
from repro_torch.data.recsys import synthetic_click_batches
from repro_torch.models import recsys
from repro_torch.optim import AdamWConfig, adamw_apply, adamw_init
from repro_torch.sharding.rules import fm_batch_split

I32, F32 = torch.int32, torch.float32

# (batch, kind); retrieval_cand carries n_candidates.
FM_SHAPES: Dict[str, Tuple[int, str]] = {
    "train_batch": (65536, "train"),
    "serve_p99": (512, "serve"),
    "serve_bulk": (262144, "serve"),
    "retrieval_cand": (1, "retrieval"),
}
N_CANDIDATES = 1_000_000
# Candidate array padded to divide every rank count up to 512 (valid
# prefix = 1M).
N_CANDIDATES_PAD = -(-N_CANDIDATES // 512) * 512

SMOKE_VOCABS = tuple([64, 48, 32, 24, 16, 12, 8, 8] + [4] * 31)  # 39 fields


def full_config() -> recsys.FMConfig:
    return recsys.FMConfig(name="fm", n_fields=39, embed_dim=10)


def smoke_config() -> recsys.FMConfig:
    return recsys.FMConfig(name="fm-smoke", n_fields=39, embed_dim=10,
                           vocab_sizes=SMOKE_VOCABS)


def fm_input_specs(cfg: recsys.FMConfig, shape: str,
                   smoke: bool = False) -> dict:
    """``{field: (shape, dtype)}`` of one batch of ``shape``."""
    batch, kind = FM_SHAPES[shape]
    if smoke:
        batch = min(batch, 32)
    if kind == "train":
        return {"field_ids": ((batch, cfg.n_fields), I32),
                "labels": ((batch,), I32)}
    if kind == "serve":
        return {"field_ids": ((batch, cfg.n_fields), I32)}
    n_cand = 1024 if smoke else N_CANDIDATES_PAD
    return {"user_fields": ((1, cfg.n_fields), I32),
            "cand_rows": ((n_cand,), I32)}


def _owned(model: recsys.FM, rows: torch.Tensor):
    """(local rows, owned mask) of global ``rows`` in ``model``'s range."""
    local = rows - model.row_lo
    owned = (local >= 0) & (local < model.w.shape[0])
    return torch.where(owned, local, torch.zeros_like(local)), owned


def sharded_sums(cfg: recsys.FMConfig, model: recsys.FM,
                 field_ids: torch.Tensor, group: ShardGroup):
    """``fm_partials`` of this rank's examples ``field_ids`` (B/W, F) over
    the whole table split across the ranks of ``group``: every rank's
    partials over the rows it owns, reduce-scattered to the examples'
    owners (added in rank order)."""
    rows = recsys.field_rows(cfg, group.all_gather(field_ids))
    local, owned = _owned(model, rows)
    sw, sv, ssq = recsys.fm_partials(model.params(), local, owned)
    mine = ReduceScatter.apply(torch.cat([sw[:, None], sv, ssq], 1), group)
    k = cfg.embed_dim
    return mine[:, 0], mine[:, 1:1 + k], mine[:, 1 + k:]


def _plain(group: ShardGroup) -> bool:
    """Whether ``group`` has no process group (``ShardGroup.single``): the
    plain FM, with no collective."""
    return group.group is None and group.backend != "dry"


def _logits(cfg, model, field_ids, group):
    if _plain(group):
        return recsys.forward(cfg, model.params(), field_ids)
    return recsys.fm_logits(model.w0,
                            *sharded_sums(cfg, model, field_ids, group))


@dataclasses.dataclass
class FMTrainStep:
    """``step(model, opt_state, batch) -> (opt_state, loss)``: the BCE of
    the global ``batch`` (each rank takes its examples), dense gradients,
    and the port's AdamW written into ``model`` (the rank's rows of the
    table) in place."""

    cfg: recsys.FMConfig
    group: ShardGroup
    opt_cfg: AdamWConfig = AdamWConfig()

    def loss_and_grads(self, model: recsys.FM, batch: dict):
        """The loss of ``batch`` and the gradients of ``model``'s
        parameters (``w0``'s summed over ranks; ``w`` and ``v`` of the
        rank's rows, complete), without an update."""
        g = self.group
        local = shard_batch({k: batch[k] for k in ("field_ids", "labels")},
                            fm_batch_split("train"), g)
        params = [model.w0, model.w, model.v]
        if _plain(g):
            loss = recsys.loss_fn(self.cfg, model.params(), local)
            grads = torch.autograd.grad(loss, params)
            return loss.detach(), dict(zip(("w0", "w", "v"), grads))
        logits = _logits(self.cfg, model, local["field_ids"], g)
        n = batch["labels"].shape[0]
        share = torch.sum(recsys.bce_terms(logits, local["labels"])) / n
        g_w0, g_w, g_v = torch.autograd.grad(share, params)
        tot = g.psum(torch.stack([share.detach(), g_w0]))
        return tot[0], {"w0": tot[1], "w": g_w, "v": g_v}

    def grad_norm(self, grads: dict):
        """The global norm of the gradients over every rank's rows (``None``
        without a process group: AdamW takes the norm of ``grads``)."""
        if _plain(self.group):
            return None
        sq = self.group.psum(torch.stack([torch.sum(torch.square(grads[k]))
                                          for k in ("w", "v")]))
        return torch.sqrt(torch.square(grads["w0"]) + sq[0] + sq[1])

    def __call__(self, model: recsys.FM, opt_state, batch: dict):
        loss, grads = self.loss_and_grads(model, batch)
        opt_state, _ = adamw_apply(self.opt_cfg, model, grads, opt_state,
                                   self.grad_norm(grads))
        return opt_state, loss


@dataclasses.dataclass
class FMServeStep:
    """``step(model, batch)``: the logits of the rank's examples."""

    cfg: recsys.FMConfig
    group: ShardGroup

    @torch.no_grad()
    def __call__(self, model: recsys.FM, batch: dict) -> torch.Tensor:
        local = shard_batch({"field_ids": batch["field_ids"]},
                            fm_batch_split("serve"), self.group)
        return _logits(self.cfg, model, local["field_ids"], self.group)


@dataclasses.dataclass
class FMRetrievalStep:
    """``step(model, batch)``: the scores of the rank's candidate slice
    against the one user of ``batch``."""

    cfg: recsys.FMConfig
    group: ShardGroup

    @torch.no_grad()
    def __call__(self, model: recsys.FM, batch: dict) -> torch.Tensor:
        g = self.group
        local = shard_batch(batch, fm_batch_split("retrieval"), g)
        if _plain(g):
            return recsys.retrieval_scores(self.cfg, model.params(),
                                           local["user_fields"],
                                           local["cand_rows"])
        rows, owned = _owned(model,
                             recsys.field_rows(self.cfg,
                                               local["user_fields"])[0])
        v = model.v
        v_u = g.psum(torch.sum(v[rows] * owned[:, None].to(v.dtype), 0))
        cand, c_owned = _owned(model, g.all_gather(local["cand_rows"]))
        part = torch.where(c_owned, v[cand] @ v_u + model.w[cand],
                           torch.zeros((), dtype=v.dtype, device=v.device))
        return ReduceScatter.apply(part, g)


def build_fm_step(cfg: recsys.FMConfig, shape: str, group: ShardGroup,
                  opt_cfg: AdamWConfig = AdamWConfig()):
    """The train step (loss, dense gradients, AdamW), the serve step
    (logits) or the retrieval step of ``shape`` over the ranks of
    ``group``."""
    kind = FM_SHAPES[shape][1]
    if kind == "train":
        return FMTrainStep(cfg, group, opt_cfg)
    if kind == "serve":
        return FMServeStep(cfg, group)
    return FMRetrievalStep(cfg, group)


@dataclasses.dataclass(frozen=True)
class FMArch:
    arch_id: str = "fm"
    family: str = "recsys"
    shapes: Tuple[str, ...] = tuple(FM_SHAPES)
    skip_notes: Dict[str, str] = dataclasses.field(default_factory=dict)

    def full_config(self) -> recsys.FMConfig:
        return full_config()

    def smoke_config(self) -> recsys.FMConfig:
        return smoke_config()

    def config(self, smoke: bool) -> recsys.FMConfig:
        return smoke_config() if smoke else full_config()

    def input_specs(self, shape: str, smoke: bool = False) -> dict:
        return fm_input_specs(self.config(smoke), shape, smoke=smoke)

    def build_step(self, shape: str, group, smoke: bool = False,
                   opt_cfg: AdamWConfig = AdamWConfig()):
        """The step over ``group``, a ``ShardGroup`` or a ``RankGrid``
        (the table's rows and the batch split over all its ranks)."""
        if isinstance(group, RankGrid):
            group = group.everyone
        return build_fm_step(self.config(smoke), shape, group, opt_cfg)

    def init_model(self, shape: str, seed: int = 0, smoke: bool = False,
                   device="cuda") -> recsys.FM:
        """The whole table (every shape shares it); ``model.shard(rank,
        world_size)`` gives a rank's rows."""
        return recsys.FM(self.config(smoke), seed, device)

    def make_batch(self, shape: str, seed: int, smoke: bool = False,
                   device="cuda") -> dict:
        """A concrete batch matching ``input_specs``: a train or serve
        batch is the first of ``synthetic_click_batches(seed)``; a
        retrieval batch draws the user's ids per field and the candidate
        rows from ``np.random.default_rng(seed)``."""
        dev = resolve_device(device)
        cfg = self.config(smoke)
        specs = self.input_specs(shape, smoke)
        if "user_fields" not in specs:
            b = next(synthetic_click_batches(
                cfg.vocab_sizes, specs["field_ids"][0][0], seed, dev))
            return {k: b[k] for k in specs}
        rng = np.random.default_rng(seed)
        user = np.array([[rng.integers(0, v) for v in cfg.vocab_sizes]],
                        np.int32)
        cand = rng.integers(0, cfg.total_vocab,
                            specs["cand_rows"][0]).astype(np.int32)
        return {"user_fields": torch.from_numpy(user).to(dev),
                "cand_rows": torch.from_numpy(cand).to(dev)}


ARCH = FMArch()


def fm_rank_runs(group: ShardGroup, runs: list,
                 out_dir: Optional[str] = None) -> list:
    """One rank of a spawned FM run (``collectives.launch``), for each dict
    of ``runs``: ``shape``, ``smoke``, ``params`` (the whole table as numpy;
    without it, ``init_model(seed)``'s on the rank's device, the same on
    every rank), ``batch`` (numpy; without it, ``make_batch(shape,
    seed)``), and for a train shape ``steps`` AdamW steps (``lr``).  Each
    result holds the rank's share, as numpy: the loss and gradients of the
    first step and the parameters after the steps (train), the logits of
    its examples (serve) or the scores of its candidates (retrieval); and
    the run's host seconds (``seconds``, ending in a sync on a card) and
    wall-clock end (``finished``, ``time.time()``).  With ``out_dir`` each
    array is saved there as ``.npy`` and the result holds its path: a
    full-width table's share is too large to pass back through the
    launcher's queue in good time."""
    dev = group.device
    out = []

    def keep(i: int, name: str, x: torch.Tensor):
        a = x.detach().cpu().numpy()
        if out_dir is None:
            return a
        path = os.path.join(out_dir, f"rank{group.rank}_run{i}_{name}.npy")
        np.save(path, a)
        return path

    for i, run in enumerate(runs):
        t0 = time.perf_counter()
        shape, smoke, seed = run["shape"], run.get("smoke", False), \
            run.get("seed", 0)
        cfg = ARCH.config(smoke)
        full = (recsys.FM(cfg, device=dev, params=run["params"])
                if "params" in run else ARCH.init_model(shape, seed, smoke,
                                                        dev))
        model = full.shard(group.rank, group.world_size)
        del full
        batch = ({k: torch.from_numpy(v).to(dev)
                  for k, v in run["batch"].items()} if "batch" in run
                 else ARCH.make_batch(shape, seed, smoke, dev))
        step = ARCH.build_step(shape, group, smoke, opt_cfg=AdamWConfig(
            lr=run.get("lr", 1e-2), warmup_steps=0,
            total_steps=max(run.get("steps", 1), 1)))
        if FM_SHAPES[shape][1] != "train":
            out.append({"out": keep(i, "out", step(model, batch)),
                        "seconds": time.perf_counter() - t0,
                        "finished": time.time()})
            continue
        loss, grads = step.loss_and_grads(model, batch)
        res = {"loss": float(loss),
               "grads": {k: keep(i, f"grad_{k}", x)
                         for k, x in grads.items()}}
        del grads
        opt = adamw_init(model)
        losses = []
        for _ in range(run.get("steps", 0)):
            opt, lo = step(model, opt, batch)
            losses.append(float(lo))
        res["losses"] = losses
        res["params"] = {k: keep(i, f"param_{k}", p)
                         for k, p in model.params().items()}
        res.update(seconds=time.perf_counter() - t0, finished=time.time())
        out.append(res)
    return out
