"""AdamW with decoupled weight decay, global-norm clipping and a linear
warmup + cosine decay schedule (``repro.optim.adamw``), over a dict of
tensors or a module's parameters.

``torch.optim.AdamW`` has neither the clip nor the schedule, so the step is
written out: every value is computed in float32 in the reference's order,
and the optimizer state (``step``, ``mu``, ``nu``) stays float32 whatever
the parameters' type.  Decay is decoupled, ``lr * (step_v + wd * p)``, on
every parameter, biases and GIN's ``eps`` included.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, NamedTuple, Optional, Union

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor                 # 0-d int32
    mu: Dict[str, torch.Tensor]        # float32, keyed like the parameters
    nu: Dict[str, torch.Tensor]


Params = Union[torch.nn.Module, Mapping[str, torch.Tensor]]


def _named(params: Params) -> Dict[str, torch.Tensor]:
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def adamw_init(params: Params) -> AdamWState:
    named = _named(params)
    dev = next(iter(named.values())).device
    zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in named.items()}
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=zeros, nu={k: z.clone() for k, z in zeros.items()})


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    s = step.to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in float32; ``tensors``
    is a dict (its values in order) or a sequence."""
    values = tensors.values() if isinstance(tensors, Mapping) else tensors
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in values))


def adamw_update(cfg: AdamWConfig, params: Params, grads, state: AdamWState,
                 grad_norm: Optional[torch.Tensor] = None):
    """One step.  ``grads`` is keyed like the parameters.  Returns
    ``(new_params, new_state, metrics)``: new tensors in the parameters'
    types (the inputs are not written), the new state, and ``grad_norm``
    and ``lr`` as 0-d float32 tensors.  ``grad_norm`` is the global norm
    that the clip reads, by default ``global_norm(grads)``; a rank that
    holds a share of split parameters passes the norm over all ranks."""
    named = _named(params)
    gnorm = (global_norm([grads[k] for k in named]) if grad_norm is None
             else grad_norm)
    scale = _clip_scale(cfg, gnorm)
    step, lr, bc1, bc2 = _step_scalars(cfg, state)
    new_p, new_mu, new_nu = {}, {}, {}
    for k, p in named.items():
        new_p[k], new_mu[k], new_nu[k] = _leaf_update(
            cfg, p.detach(), grads[k], state.mu[k], state.nu[k], scale, lr,
            bc1, bc2)
    return new_p, AdamWState(step, new_mu, new_nu), {"grad_norm": gnorm,
                                                     "lr": lr}


def _clip_scale(cfg: AdamWConfig, gnorm: torch.Tensor) -> torch.Tensor:
    return torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)


def _step_scalars(cfg: AdamWConfig, state: AdamWState):
    """(step, lr, bias corrections 1 and 2) of the step after ``state``,
    as 0-d tensors."""
    step = state.step + 1
    lr = _schedule(cfg, step)
    sf = step.to(torch.float32)
    one = torch.ones((), dtype=torch.float32, device=sf.device)
    bc1 = 1 - torch.pow(one * cfg.beta1, sf)
    bc2 = 1 - torch.pow(one * cfg.beta2, sf)
    return step, lr, bc1, bc2


def _leaf_update(cfg: AdamWConfig, p, g, mu, nu, scale, lr, bc1, bc2):
    """One tensor's (or one chunk's) step, elementwise in float32: the new
    parameter in ``p``'s type and the new moments."""
    b1, b2 = cfg.beta1, cfg.beta2
    g = g.to(torch.float32) * scale
    mu = b1 * mu + (1 - b1) * g
    nu = b2 * nu + (1 - b2) * g * g
    step_v = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
    pf = p.to(torch.float32)
    return (pf - lr * (step_v + cfg.weight_decay * pf)).to(p.dtype), mu, nu


#: Elements a chunk of ``adamw_update_``: its float32 temporaries stay near
#: 256 MB each whatever the tensor's size.
CHUNK = 1 << 26


@torch.no_grad()
def adamw_update_(cfg: AdamWConfig, params: Mapping[str, torch.Tensor],
                  grads, state: AdamWState,
                  grad_norm: Optional[torch.Tensor] = None):
    """``adamw_update`` written in place into ``params`` (a dict of
    tensors) and into ``state``'s moments, ``CHUNK`` elements at a time, so
    the step needs no second copy of the parameters or the moments.  The
    arithmetic is ``adamw_update``'s, elementwise, so the bits are its.
    Returns ``(new_state, metrics)``; the new state holds the same moment
    tensors."""
    gnorm = (global_norm([grads[k] for k in params]) if grad_norm is None
             else grad_norm)
    scale = _clip_scale(cfg, gnorm)
    step, lr, bc1, bc2 = _step_scalars(cfg, state)
    for k, p in params.items():
        # view(-1) refuses a non-contiguous tensor, whose reshape would be
        # a copy that the writes below never reach.
        flat = [p.view(-1), grads[k].reshape(-1), state.mu[k].view(-1),
                state.nu[k].view(-1)]
        for lo in range(0, p.numel(), CHUNK):
            p_c, g_c, mu_c, nu_c = (x[lo:lo + CHUNK] for x in flat)
            new = _leaf_update(cfg, p_c, g_c, mu_c, nu_c, scale, lr, bc1,
                               bc2)
            for dst, src in zip((p_c, mu_c, nu_c), new):
                dst.copy_(src)
    return AdamWState(step, state.mu, state.nu), {"grad_norm": gnorm,
                                                  "lr": lr}


def adamw_apply(cfg: AdamWConfig, module: torch.nn.Module, grads,
                state: AdamWState, grad_norm: Optional[torch.Tensor] = None):
    """``adamw_update`` written into ``module``'s parameters in place.
    Returns ``(new_state, metrics)``."""
    new_p, state, metrics = adamw_update(cfg, module, grads, state,
                                         grad_norm)
    with torch.no_grad():
        for k, p in module.named_parameters():
            p.copy_(new_p[k])
    return state, metrics
