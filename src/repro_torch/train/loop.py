"""Fault-tolerant training loop with checkpoint/restart, straggler
detection and elastic-rescale hooks (``repro.train.loop``).

  - **checkpoint/restart**: resumes from the newest valid checkpoint (see
    ``checkpoint.py`` for atomicity and integrity); parameters, optimizer
    state and the data stream's position are restored, so a preempted run
    continues exactly;
  - **straggler mitigation**: per-step wall times feed an EWMA; steps
    slower than ``straggler_factor`` x the EWMA are counted and passed to
    ``on_straggler`` (a deployment's scheduler attaches there);
  - **elastic rescale hook**: ``ElasticController.desired_devices()`` is
    polled every ``elastic_poll_steps``; when it differs from the devices
    of the loop's type, the loop checkpoints and records the event for the
    launcher (single-host runs never take this branch);
  - **gradient compression** (``optim/compression.py``) with error
    feedback between the gradients and the optimizer.

Parameters are a dict of tensors on one device, where the loop runs.  The
step runs eagerly: ``torch.autograd.grad`` of ``loss_fn(params, batch)``
over the dict's leaves, the compression, then the port's ``adamw_update``.
The loss comes to the host every step.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterator, Optional

import torch

from repro_torch.core.graph import resolve_device
from repro_torch.optim import (AdamWConfig, CompressionConfig, adamw_init,
                               adamw_update, compress_grads, compression_init)
from repro_torch.train import checkpoint as ckpt


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 200
    log_every: int = 20
    ckpt_every: int = 100
    ckpt_dir: Optional[str] = None
    keep_n: int = 3
    straggler_factor: float = 3.0
    elastic_poll_steps: int = 50


def device_count(device) -> int:
    """Devices of ``device``'s type on this host: the cards for CUDA, one
    CPU."""
    dev = torch.device(device)
    return torch.cuda.device_count() if dev.type == "cuda" else 1


class ElasticController:
    """Polled by the loop; override ``desired_devices`` for real
    elasticity.  By default it wants the devices of ``device``'s type on
    this host (the card unless the caller asks for the CPU)."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)

    def desired_devices(self) -> int:
        return device_count(self.device)


def _default_step(loss_fn, opt_cfg, comp_cfg):
    def step_fn(params, opt_state, residual, batch):
        leaves = {k: p.detach().requires_grad_(True)
                  for k, p in params.items()}
        loss = loss_fn(leaves, batch)
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
        if residual is not None:
            grads, residual = compress_grads(comp_cfg, grads, residual)
        params, opt_state, metrics = adamw_update(opt_cfg, params, grads,
                                                  opt_state)
        return params, opt_state, residual, loss.detach(), metrics
    return step_fn


def train(
    loss_fn: Callable,                       # (params, batch) -> scalar loss
    params: Dict[str, torch.Tensor],
    batches: Iterator[dict],
    opt_cfg: AdamWConfig,
    loop_cfg: TrainLoopConfig,
    *,
    comp_cfg: CompressionConfig = CompressionConfig(),
    elastic: Optional[ElasticController] = None,
    on_straggler: Optional[Callable[[int, float], None]] = None,
    make_step: Optional[Callable] = None,    # custom step factory
):
    """Returns ``(params, metrics)``, ``metrics`` holding ``history`` and
    ``n_stragglers``.  Resumes from ``loop_cfg.ckpt_dir``.  ``make_step(
    loss_fn, opt_cfg, comp_cfg)`` returns ``step(params, opt_state,
    residual, batch) -> (params, opt_state, residual, loss, metrics)``."""
    dev = next(iter(params.values())).device
    opt_state = adamw_init(params)
    residual = compression_init(params) if comp_cfg.scheme != "none" else None
    start_step = 0

    if loop_cfg.ckpt_dir:
        latest = ckpt.latest_step(loop_cfg.ckpt_dir)
        if latest is not None:
            state = ckpt.restore_checkpoint(
                loop_cfg.ckpt_dir, latest,
                {"params": params, "opt": opt_state, "step": 0})
            params, opt_state = state["params"], state["opt"]
            start_step = int(state["step"])

    step_fn = (make_step or _default_step)(loss_fn, opt_cfg, comp_cfg)

    history = []
    ewma = None
    n_stragglers = 0
    # Fast-forward the data stream on resume (deterministic iterators).
    for _ in range(start_step):
        next(batches)

    for step in range(start_step, loop_cfg.total_steps):
        batch = next(batches)
        t0 = time.perf_counter()
        params, opt_state, residual, loss, metrics = step_fn(
            params, opt_state, residual, batch)
        loss = float(loss)
        dt = time.perf_counter() - t0

        if ewma is None:
            ewma = dt
        elif dt > loop_cfg.straggler_factor * ewma and step > start_step + 3:
            n_stragglers += 1
            if on_straggler:
                on_straggler(step, dt)
        else:
            ewma = 0.9 * ewma + 0.1 * dt

        if step % loop_cfg.log_every == 0 or step == loop_cfg.total_steps - 1:
            history.append({"step": step, "loss": loss, "sec": dt,
                            **{k: float(v) for k, v in metrics.items()}})

        if loop_cfg.ckpt_dir and (step + 1) % loop_cfg.ckpt_every == 0:
            ckpt.save_checkpoint(
                loop_cfg.ckpt_dir, step + 1,
                {"params": params, "opt": opt_state, "step": step + 1},
                keep_n=loop_cfg.keep_n)

        if (elastic is not None
                and (step + 1) % loop_cfg.elastic_poll_steps == 0):
            want = elastic.desired_devices()
            if want != device_count(dev) and loop_cfg.ckpt_dir:
                # Checkpoint and signal the launcher to re-shard at the new
                # scale; single-host runs never take this branch.
                ckpt.save_checkpoint(
                    loop_cfg.ckpt_dir, step + 1,
                    {"params": params, "opt": opt_state, "step": step + 1},
                    keep_n=loop_cfg.keep_n)
                history.append({"step": step, "event": "elastic_rescale",
                                "devices": want})

    return params, {"history": history, "n_stragglers": n_stragglers}
