"""Gradient compression with error feedback (``repro.optim.compression``).

Two schemes, both with EF-SGD-style residual accumulation so compression
error is fed back rather than lost (Karimireddy et al. 2019):

  - ``topk``: keep the largest-|g| fraction of each tensor
    (sparsification), modelled as a masked dense tensor;
  - ``int8``: per-tensor scale to int8 (round half to even, clip to
    +-127), dequantized after.

Applied between the gradients and the optimizer in ``train/loop.py``.
Both are exact functions of float32 inputs, so they equal the reference
bit for bit; the invariant ``sent + new_residual == grad + residual``
holds exactly.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.optim.adamw import Params, _named


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    scheme: str = "none"        # none | topk | int8
    topk_fraction: float = 0.01


def compression_init(params: Params) -> dict:
    """A float32 zero residual keyed like the parameters."""
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in _named(params).items()}


def _topk_mask(g: torch.Tensor, frac: float) -> torch.Tensor:
    k = max(int(g.numel() * frac), 1)
    thresh = torch.topk(torch.abs(g.reshape(-1)), k).values[-1]
    return (torch.abs(g) >= thresh).to(g.dtype)


def compress_grads(cfg: CompressionConfig, grads: dict, residual: dict):
    """Returns ``(sent, new_residual)``, keyed like ``grads``."""
    if cfg.scheme == "none":
        return grads, residual
    if cfg.scheme not in ("topk", "int8"):
        raise ValueError(cfg.scheme)
    sent, left = {}, {}
    for k, g in grads.items():
        g = g.to(torch.float32) + residual[k]
        if cfg.scheme == "topk":
            s = g * _topk_mask(g, cfg.topk_fraction)
        else:
            scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
            q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
            s = q.to(torch.float32) * scale
        sent[k], left[k] = s, g - s
    return sent, left
