"""Shared plumbing for the five LM architectures of the PyTorch port
(``repro.configs.lm_common``): shapes, input specs, and the train, prefill
and decode steps over a (data, model) grid of ranks.

``build_lm_step`` takes a ``collectives.RankGrid`` or a ``ShardGroup`` of
one rank.  A ``ShardGroup`` runs the model without a grid (the faster
path on one card, ``PERF.md``); a ``RankGrid``, of any size, runs the
grid path, where each rank holds its shares of the parameters
(``sharding.lm_param_split``: FSDP over the dp axes, Megatron tensor and
expert parallelism over ``model``), its AdamW moments split alike, and in
decode its share of the cache (``sharding.lm_cache_split``).  A step takes
the global batch and cuts the rank's rows (``sharding.lm_batch_split``);
a decode batch of one row is every rank's.  The reference's variants:
  - ``"int8_kv"`` stores the GQA cache as int8 with per-(position, head)
    scales;
  - ``"naive_cache"``: the baseline cache layout (heads or ``d_head`` over
    ``model``, gathered every layer) in place of the sequence split;
  - ``"tp_only_params"``: parameters replicated over dp (no FSDP);
  - ``"sharded_ce"``: the reference's ``make_sharded_ce`` loss, whose
    ignored labels count (``transformer.vocab_parallel_ce``);
  - ``"no_donate"``: the port's decode writes the cache in place, which is
    what the reference's donation buys, so there is nothing to turn off.
``lm_rank_runs`` is the rank entry of ``collectives.launch``.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.collectives import RankGrid, ShardGroup
from repro_torch.models import transformer as tf
from repro_torch.optim import (AdamWConfig, AdamWState, adamw_init,
                               adamw_update_)
from repro_torch.sharding.rules import (lm_batch_split, lm_cache_split,
                                        lm_param_split, share)

I32, F32 = torch.int32, torch.float32

# (seq_len, global_batch, kind)
LM_SHAPES: Dict[str, Tuple[int, int, str]] = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}


def _shape_dims(shape: str, smoke: bool):
    """(seq, batch, kind); smoke shrinks to CPU-executable sizes."""
    seq, batch, kind = LM_SHAPES[shape]
    if smoke:
        seq, batch = min(seq, 128), min(batch, 4)
    return seq, batch, kind


def lm_input_specs(cfg: tf.TransformerConfig, shape: str,
                   smoke: bool = False) -> dict:
    """``{field: (shape, dtype)}`` of one batch of ``shape``; a decode batch
    is one new token against a ``seq``-long cache."""
    seq, batch, kind = _shape_dims(shape, smoke)
    tok = ((batch, seq), I32)
    if kind == "train":
        return {"tokens": tok, "labels": tok}
    if kind == "prefill":
        return {"tokens": tok}
    return {"tokens": ((batch, 1), I32), "cache_len": ((), I32)}


def opt_specs(param_shapes_tree: dict) -> AdamWState:
    """The AdamW state's ``(shape, dtype)``s for a parameter shape tree
    (``transformer.param_shapes``): float32 moments keyed like
    ``transformer.flat_params``."""
    flat = tf.flat_params(param_shapes_tree)
    return AdamWState(step=((), I32),
                      mu={k: (s, F32) for k, s in flat.items()},
                      nu={k: (s, F32) for k, s in flat.items()})


def step_grid(grid: Union[RankGrid, ShardGroup],
              sharded_ce: bool = False) -> Optional[RankGrid]:
    """The grid a step runs over: ``grid`` itself, or for a ``ShardGroup``
    of one rank ``None`` (the model without a grid), except that the
    reference's sharded CE is the vocab-parallel loss of a 1 x 1 grid.  A
    larger group needs its grid's shape."""
    if isinstance(grid, RankGrid):
        return grid
    if grid.world_size > 1:
        raise ValueError(
            f"a group of {grid.world_size} ranks needs a RankGrid over "
            f"('data', 'model') that says how the ranks are laid out")
    return RankGrid(grid, (1, 1)) if sharded_ce else None


def flat_split(cfg: tf.TransformerConfig, grid, fsdp: bool = True) -> dict:
    """``lm_param_split`` keyed like ``transformer.flat_params``."""
    return tf.flat_params(lm_param_split(cfg, grid, fsdp))


def local_batch(batch: dict, grid: Optional[RankGrid],
                replicated: bool = False):
    """The rank's rows of a global token batch (``lm_batch_split``); every
    row where ``replicated`` or without a grid."""
    if grid is None:
        return batch
    split = lm_batch_split(grid)
    return {k: (v if replicated or k not in split or not torch.is_tensor(v)
                or v.dim() != 2 else share(v, split[k], grid))
            for k, v in batch.items()}


def make_sharded_ce(cfg: tf.TransformerConfig, grid: RankGrid,
                    fsdp: bool = True) -> Callable:
    """The reference's vocab-sharded cross-entropy: ``loss(params,
    batch)`` over the rank's shares and its rows of the batch.  The head
    product and the softmax statistics run per vocabulary shard, and the
    result is ``sum(lse - ll)`` over every position of every rank divided
    by their count, an ignored label included
    (``transformer.vocab_parallel_ce``)."""

    def loss(params, batch):
        x = tf.forward(cfg, params, batch["tokens"], return_hidden=True,
                       grid=grid, fsdp=fsdp)
        return tf.vocab_parallel_ce(cfg, params, x, batch["labels"], grid,
                                    fsdp, count_ignored=True)

    return loss


def _dp_replicated(split, grid: RankGrid) -> bool:
    dp = set(grid.dp_axes)
    return not any(axes and dp & set(axes) for axes in split)


def _counted_here(split, grid: RankGrid) -> bool:
    """Whether this rank holds the copy of a leaf's share that the global
    norm counts: coordinate 0 on every axis that does not split it."""
    used = {a for axes in split if axes for a in axes}
    return all(grid.coords[a] == 0 for a in grid.axis_names if a not in used)


@dataclasses.dataclass
class LMTrainStep:
    """``step(params, opt_state, batch) -> (params, opt_state, loss)``: the
    mean token CE, its gradients, and AdamW written into ``params`` (the
    parameter tree) and the moments in place, a chunk at a time
    (``adamw_update_``).  ``opt_state`` is ``adamw_init(
    transformer.flat_params(params))``.

    Without ``grid`` the step runs ``transformer.loss_fn`` on one rank.
    Over ``grid`` ``params`` are the rank's shares, the batch is global
    (the step takes its rows), the gradients are the rank's shares (a leaf
    replicated over dp has its gradient summed over dp), and the clip
    reads the global norm with a replicated share counted once."""

    cfg: tf.TransformerConfig
    opt_cfg: AdamWConfig = AdamWConfig()
    grid: Optional[RankGrid] = None
    fsdp: bool = True
    sharded_ce: bool = False

    def __post_init__(self):
        if self.sharded_ce and self.grid is None:
            raise ValueError("the sharded CE is a grid's loss: give a "
                             "RankGrid (1 x 1 on one rank)")

    def loss_and_grads(self, params: dict, batch: dict):
        """The loss of ``batch`` and the gradients keyed like
        ``transformer.flat_params``, without an update."""
        leaves = {k: x.detach().requires_grad_(True)
                  for k, x in tf.flat_params(params).items()}
        tree = tf.nest_params(leaves)
        if self.grid is None:
            loss = tf.loss_fn(self.cfg, tree, batch)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            return loss.detach(), dict(zip(leaves, grads))
        grid = self.grid
        local = local_batch(batch, grid)
        if self.sharded_ce:
            loss = make_sharded_ce(self.cfg, grid, self.fsdp)(tree, local)
        else:
            loss = tf.loss_fn(self.cfg, tree, local, grid, self.fsdp)
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
        split = flat_split(self.cfg, grid, self.fsdp)
        for k in grads:
            if _dp_replicated(split[k], grid):
                grads[k] = grid.dp.psum(grads[k])
        return loss.detach(), grads

    def grad_norm(self, grads: dict):
        """The global norm over every rank's shares (``None`` without a
        grid: AdamW takes the norm of ``grads``)."""
        if self.grid is None:
            return None
        split = flat_split(self.cfg, self.grid, self.fsdp)
        dev = next(iter(grads.values())).device
        sq = torch.zeros((), dtype=torch.float64, device=dev)
        for k, g in grads.items():
            if _counted_here(split[k], self.grid):
                sq = sq + torch.sum(torch.square(g.to(torch.float32)))
        return torch.sqrt(self.grid.everyone.psum(sq)).to(torch.float32)

    @torch.no_grad()
    def loss(self, params: dict, batch: dict) -> torch.Tensor:
        """The loss of ``batch`` alone (no gradient)."""
        if self.grid is None:
            return tf.loss_fn(self.cfg, params, batch)
        local = local_batch(batch, self.grid)
        if self.sharded_ce:
            return make_sharded_ce(self.cfg, self.grid, self.fsdp)(params,
                                                                   local)
        return tf.loss_fn(self.cfg, params, local, self.grid, self.fsdp)

    def __call__(self, params: dict, opt_state: AdamWState, batch: dict):
        loss, grads = self.loss_and_grads(params, batch)
        opt_state, _ = adamw_update_(self.opt_cfg, tf.flat_params(params),
                                     grads, opt_state, self.grad_norm(grads))
        return params, opt_state, loss


def build_lm_step(cfg: tf.TransformerConfig, shape: str,
                  grid: Union[RankGrid, ShardGroup],
                  opt_cfg: AdamWConfig = AdamWConfig(),
                  variant: Tuple[str, ...] = (),
                  smoke_shapes: bool = False) -> Callable:
    """The step of ``shape``'s kind on this rank of ``grid`` (a
    ``RankGrid``, or a ``ShardGroup`` of one rank: ``step_grid``):
      - train: an ``LMTrainStep``;
      - prefill: ``step(params, batch)`` -> the last position's float32
        logits (B / dp, V) of the rank's rows;
      - decode: ``step(params, cache, batch)`` -> ``(logits (B / dp, 1,
        V), cache)``, the rank's share of the cache written at
        ``batch["cache_len"]`` in place.  At batch 1 (``long_500k``) the
        cache's sequence is split over every rank and the token is every
        rank's.
    ``variant`` as in the module docstring."""
    if "int8_kv" in variant and cfg.mla is None:
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    fsdp = "tp_only_params" not in variant
    _, batch_size, kind = _shape_dims(shape, smoke_shapes)
    grid = step_grid(grid, kind == "train" and "sharded_ce" in variant)
    if kind == "train":
        return LMTrainStep(cfg, opt_cfg, grid, fsdp,
                           sharded_ce="sharded_ce" in variant)

    if kind == "prefill":
        @torch.no_grad()
        def prefill_step(params, batch):
            tokens = local_batch(batch, grid)["tokens"]
            return tf.forward(cfg, params, tokens, grid=grid,
                              fsdp=fsdp)[:, -1]
        return prefill_step

    seq_shard = batch_size == 1
    model_seq_shard = "naive_cache" not in variant

    @torch.no_grad()
    def decode_step(params, cache, batch):
        tokens = local_batch(batch, grid, replicated=seq_shard)["tokens"]
        return tf.decode_step(cfg, params, cache, tokens,
                              batch["cache_len"], grid, fsdp=fsdp,
                              seq_shard=seq_shard,
                              model_seq_shard=model_seq_shard)
    decode_step.cfg = cfg
    decode_step.seq_shard = seq_shard
    decode_step.model_seq_shard = model_seq_shard
    return decode_step


def step_cache_split(cfg: tf.TransformerConfig, shape: str, grid,
                     variant: Tuple[str, ...] = (),
                     smoke_shapes: bool = False) -> dict:
    """The cache split that ``build_lm_step``'s decode step of ``shape``
    and ``variant`` reads."""
    if "int8_kv" in variant and cfg.mla is None:
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    batch = _shape_dims(shape, smoke_shapes)[1]
    return lm_cache_split(cfg, grid, seq_shard=batch == 1,
                          model_seq_shard="naive_cache" not in variant)


@dataclasses.dataclass(frozen=True)
class LMArch:
    arch_id: str
    full_config: Callable[[], tf.TransformerConfig]
    smoke_config: Callable[[], tf.TransformerConfig]
    shapes: Tuple[str, ...]
    skip_notes: Dict[str, str] = dataclasses.field(default_factory=dict)
    family: str = "lm"

    def input_specs(self, shape: str, smoke: bool = False) -> dict:
        return lm_input_specs(self.config(smoke), shape, smoke=smoke)

    def config(self, smoke: bool = False,
               n_repeats: int | None = None) -> tf.TransformerConfig:
        """The smoke or full config, cut to ``n_repeats`` pattern repeats
        where given."""
        cfg = self.smoke_config() if smoke else self.full_config()
        if n_repeats is None:
            return cfg
        return dataclasses.replace(
            cfg, n_layers=len(cfg.layer_windows) * n_repeats)

    def build_step(self, shape: str, group: Union[RankGrid, ShardGroup],
                   smoke: bool = False, variant: Tuple[str, ...] = (),
                   opt_cfg: AdamWConfig = AdamWConfig()):
        return build_lm_step(self.config(smoke), shape, group,
                             opt_cfg=opt_cfg, variant=variant,
                             smoke_shapes=smoke)


# ---------------------------------------------------------------------------
# Shares of weights and caches, and the rank entry of a spawned run.
# ---------------------------------------------------------------------------

def init_param_shares(cfg: tf.TransformerConfig, grid: RankGrid,
                      seed: int = 0, device="cuda",
                      fsdp: bool = True) -> dict:
    """The rank's shares of ``transformer.init_params(cfg, seed)``: each
    tensor drawn whole, in order, and cut before the next, so the rank
    never holds the whole model and every rank's shares come from the same
    draws."""
    split = flat_split(cfg, grid, fsdp)
    return tf.nest_params({k: share(x, split[k], grid)
                           for k, x in tf.init_leaves(cfg, seed, device)})


def random_cache(cfg: tf.TransformerConfig, batch: int, max_len: int,
                 seed: int, device="cuda", grid: Optional[RankGrid] = None,
                 split: Optional[dict] = None) -> dict:
    """A decode cache whose every position is drawn from ``seed`` (normal
    keys and values, or int8 values in [-127, 127] with scales in [0,
    0.05)), leaf by leaf in order; with ``grid``, the rank's share by
    ``split`` (an ``lm_cache_split``) of each leaf, cut as it is drawn."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    slots = []
    for i, slot in enumerate(tf.cache_shapes(cfg, batch, max_len)["slots"]):
        out = {}
        for name, shape in slot.items():
            x = torch.empty(shape, dtype=tf.cache_leaf_dtype(
                name, cfg.activation_dtype), device=dev)
            if x.dtype == torch.int8:
                x.random_(-127, 128, generator=gen)
            elif name in ("k_s", "v_s"):
                x.uniform_(0.0, 0.05, generator=gen)
            else:
                x.normal_(generator=gen)
            out[name] = (x if grid is None
                         else share(x, split["slots"][i][name], grid))
            del x
        slots.append(out)
    return {"slots": slots}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def lm_rank_runs(group: ShardGroup, runs: list,
                 out_dir: Optional[str] = None) -> list:
    """One rank of a spawned LM run (``collectives.launch``), for each dict
    of ``runs``:
      - ``cfg`` (a ``TransformerConfig``), ``shape`` (an ``LM_SHAPES``
        key), ``grid`` (its shape; default ``(1, world)``), ``axes``
        (default ``("data", "model")``), ``variant``, ``smoke_shapes``;
      - ``params``: the whole parameter tree as numpy (the reference's
        layout), or else ``seed``: ``init_params``' draws;
      - train: ``batches`` (global numpy batches) and ``opt`` (AdamW
        settings; warmup 1 and lr 1e-3 unless given): the loss and
        gradients of the first batch, then one AdamW step a batch and the
        parameters after them (``adam=False``: no step; ``keep_grads`` /
        ``keep_params=False``: not returned; without ``keep_grads`` the
        steps alone run, and with neither the loss alone);
      - prefill: ``batch``: the last logits of the rank's rows;
      - decode: ``cache`` (the whole cache as numpy) or ``cache_seed``
        with ``max_len`` and ``batch_size`` (``random_cache``), and
        ``steps``: a list of ``(tokens, cache_len)``; the logits of each
        step and the cache's share after them (not with
        ``keep_cache=False``).
    Every result holds the rank's share, as numpy (with ``out_dir``, each
    array saved there as ``.npy`` and the result holds its path), the
    rank's grid coordinates (``coords``), the host seconds of each step
    (``step_seconds``, each ending in a sync on a card) and of the whole
    run (``seconds``, set-up and hand-back included; ``started`` and
    ``finished`` are its wall-clock ends, ``time.time()``), the peak device
    memory (``peak_bytes``, 0 on the CPU) and the run's part of the grid's
    collective counters (``stats``).  Runs of one grid layout share its
    process groups."""
    from repro_torch.interop import lm_cache_from_numpy, lm_params_from_numpy
    dev = group.device
    out = []

    def keep(i: int, name: str, x: torch.Tensor):
        a = x.detach().float().cpu().numpy() if x.dtype == torch.bfloat16 \
            else x.detach().cpu().numpy()
        if out_dir is None:
            return a
        path = os.path.join(out_dir, f"rank{group.rank}_run{i}_{name}.npy")
        np.save(path, a)
        return path

    def keep_tree(i: int, name: str, tree):
        if isinstance(tree, dict):
            return {k: keep_tree(i, f"{name}.{k}", v)
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [keep_tree(i, f"{name}.{j}", v)
                    for j, v in enumerate(tree)]
        return keep(i, name, tree)

    def timed(fn):
        _sync(dev)
        t = time.perf_counter()
        res = fn()
        _sync(dev)
        return res, time.perf_counter() - t

    def put(batch):
        return {k: (torch.as_tensor(np.asarray(v)).to(dev)
                    if k != "cache_len" else v) for k, v in batch.items()}

    grids = {}
    for i, run in enumerate(runs):
        t_run, started = time.perf_counter(), time.time()
        cfg, shape = run["cfg"], run["shape"]
        # One grid (and its process groups) for every run of its layout.
        layout = (tuple(run.get("grid", (1, group.world_size))),
                  tuple(run.get("axes", ("data", "model"))))
        if layout not in grids:
            grids[layout] = RankGrid(group, *layout)
        grid = grids[layout]
        stats0 = grid.stats()
        variant = tuple(run.get("variant", ()))
        fsdp = "tp_only_params" not in variant
        smoke_shapes = run.get("smoke_shapes", True)
        kind = LM_SHAPES[shape][2]
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        params = (lm_params_from_numpy(run["params"], dev,
                                       cfg.activation_dtype, cfg=cfg,
                                       grid=grid, fsdp=fsdp)
                  if "params" in run else
                  init_param_shares(cfg, grid, run.get("seed", 0), dev, fsdp))
        opt_cfg = dict(lr=1e-3, warmup_steps=1,
                       total_steps=max(len(run.get("batches", ())), 1))
        opt_cfg.update(run.get("opt", {}))
        step = build_lm_step(cfg, shape, grid, opt_cfg=AdamWConfig(**opt_cfg),
                             variant=variant, smoke_shapes=smoke_shapes)
        res, secs = {}, []
        if kind == "train":
            batches = [put(b) for b in run["batches"]]
            if run.get("keep_grads", True):
                (loss, grads), s = timed(
                    lambda: step.loss_and_grads(params, batches[0]))
                res["grads"] = keep_tree(i, "grad", grads)
                del grads
            elif not run.get("adam", True):
                loss, s = timed(lambda: step.loss(params, batches[0]))
            if run.get("keep_grads", True) or not run.get("adam", True):
                secs.append(s)
                res["loss"] = float(loss)
            losses = []
            if run.get("adam", True):
                opt = adamw_init(tf.flat_params(params))
                for b in batches:
                    (params, opt, loss), s = timed(
                        lambda: step(params, opt, b))
                    secs.append(s)
                    losses.append(float(loss))
                del opt
                if run.get("keep_params", True):
                    res["params"] = keep_tree(i, "param",
                                              tf.flat_params(params))
            res["losses"] = losses
        elif kind == "prefill":
            logits, s = timed(lambda: step(params, put(run["batch"])))
            secs.append(s)
            res["logits"] = keep(i, "logits", logits)
        else:
            if "cache" in run:
                cache = lm_cache_from_numpy(
                    run["cache"], dev, cfg.activation_dtype,
                    cfg=step.cfg, grid=grid, seq_shard=step.seq_shard,
                    model_seq_shard=step.model_seq_shard)
            else:
                cache = random_cache(
                    step.cfg, run["batch_size"], run["max_len"],
                    run["cache_seed"], dev, grid, step_cache_split(
                        cfg, shape, grid, variant, smoke_shapes))
            logits = []
            for tokens, at in run["steps"]:
                (lo, _), s = timed(lambda: step(params, cache, put(
                    {"tokens": tokens, "cache_len": at})))
                secs.append(s)
                logits.append(keep(i, f"logits{len(logits)}", lo))
            res["logits"] = logits
            if run.get("keep_cache", True):
                res["cache"] = keep_tree(i, "cache", cache)
            del cache
        res["coords"] = dict(grid.coords)
        res["step_seconds"] = secs
        res["seconds"] = time.perf_counter() - t_run
        res["started"], res["finished"] = started, time.time()
        res["peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                             if dev.type == "cuda" else 0)
        res["stats"] = {
            k: ({kind: n - stats0[k][kind] for kind, n in v.items()}
                if isinstance(v, dict) else v - stats0[k])
            for k, v in grid.stats().items()}
        out.append(res)
        del params, step
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out
