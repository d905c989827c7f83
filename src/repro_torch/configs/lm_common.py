"""Shared plumbing for the five LM architectures of the PyTorch port
(``repro.configs.lm_common``): shapes, input specs, and the train, prefill
and decode steps.

The port runs an LM on one rank.  Its layouts over the ranks of a
``ShardGroup`` (the reference's FSDP x TP parameter rules, the
sequence-sharded caches and the vocab-sharded cross-entropy) are ROADMAP
item 13b, and a group of more than one rank is refused.  On one rank the
reference's layout variants change nothing, exactly as on its one-device
mesh:
  - ``"int8_kv"`` stores the GQA cache as int8 with per-(position, head)
    scales (as in the reference);
  - ``"naive_cache"`` and ``"tp_only_params"`` are layouts;
  - ``"no_donate"``: the port's decode writes the cache in place, which is
    what the reference's donation buys, so there is nothing to turn off;
  - ``"sharded_ce"`` is the plain loss (one vocab shard holds every
    logit).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch

from repro_torch.core.collectives import ShardGroup
from repro_torch.models import transformer as tf
from repro_torch.optim import AdamWConfig, AdamWState, adamw_update_

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


def _one_rank(group: ShardGroup) -> None:
    if group.world_size > 1:
        raise ValueError(
            f"the LM steps run on one rank; a group of {group.world_size} "
            "ranks needs the LM layouts of ROADMAP Queue 1, item 13b (LM "
            "sharding)")


@dataclasses.dataclass
class LMTrainStep:
    """``step(params, opt_state, batch) -> (params, opt_state, loss)``: the
    mean token CE, its gradients, and AdamW written into ``params`` (the
    parameter tree) and the moments in place, a chunk at a time
    (``adamw_update_``).  ``opt_state`` is ``adamw_init(
    transformer.flat_params(params))``."""

    cfg: tf.TransformerConfig
    opt_cfg: AdamWConfig = AdamWConfig()

    def loss_and_grads(self, params: dict, batch: dict):
        """The loss of ``batch`` and the gradients keyed like
        ``transformer.flat_params``, without an update."""
        leaves = {k: x.detach().requires_grad_(True)
                  for k, x in tf.flat_params(params).items()}
        loss = tf.loss_fn(self.cfg, tf.nest_params(leaves), batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), dict(zip(leaves, grads))

    def __call__(self, params: dict, opt_state: AdamWState, batch: dict):
        loss, grads = self.loss_and_grads(params, batch)
        opt_state, _ = adamw_update_(self.opt_cfg, tf.flat_params(params),
                                     grads, opt_state)
        return params, opt_state, loss


def build_lm_step(cfg: tf.TransformerConfig, shape: str, group: ShardGroup,
                  opt_cfg: AdamWConfig = AdamWConfig(),
                  variant: Tuple[str, ...] = (),
                  smoke_shapes: bool = False) -> Callable:
    """The step of ``shape``'s kind on the one rank of ``group``:
      - train: an ``LMTrainStep``;
      - prefill: ``step(params, batch)`` -> the last position's float32
        logits (B, V);
      - decode: ``step(params, cache, batch)`` -> ``(logits (B, 1, V),
        cache)``, the cache written at ``batch["cache_len"]`` in place.
    ``variant`` as in the module docstring."""
    _one_rank(group)
    if "int8_kv" in variant and cfg.mla is None:
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    kind = _shape_dims(shape, smoke_shapes)[2]
    if kind == "train":
        return LMTrainStep(cfg, opt_cfg)

    if kind == "prefill":
        @torch.no_grad()
        def prefill_step(params, batch):
            return tf.forward(cfg, params, batch["tokens"])[:, -1]
        return prefill_step

    @torch.no_grad()
    def decode_step(params, cache, batch):
        return tf.decode_step(cfg, params, cache, batch["tokens"],
                              batch["cache_len"])
    return decode_step


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

    def build_step(self, shape: str, group: ShardGroup, smoke: bool = False,
                   variant: Tuple[str, ...] = (),
                   opt_cfg: AdamWConfig = AdamWConfig()):
        return build_lm_step(self.config(smoke), shape, group,
                             opt_cfg=opt_cfg, variant=variant,
                             smoke_shapes=smoke)
