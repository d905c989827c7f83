"""Synthetic Criteo-like click batches for the FM (``repro.data.recsys``).

The draws are the reference's own ``np.random.default_rng`` calls in the
same order, so a seed gives byte-identical batches; each batch's tensors
then go to ``device``."""

from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np
import torch

from repro_torch.core.graph import resolve_device


def _click_arrays(vocab_sizes: Sequence[int], batch: int,
                  seed: int) -> Iterator[dict]:
    rng = np.random.default_rng(seed)
    vs = np.asarray(vocab_sizes)
    # Hidden linear model over a few hash features -> learnable CTR signal.
    w_true = rng.normal(size=len(vs)) * 0.5
    while True:
        ids = (rng.pareto(1.2, size=(batch, len(vs))) * vs / 20).astype(
            np.int64)
        ids = np.minimum(ids, vs - 1).astype(np.int32)
        logit = ((ids % 7 - 3) * w_true).sum(1) * 0.3
        y = (rng.random(batch) < 1 / (1 + np.exp(-logit))).astype(np.int32)
        yield {"field_ids": ids, "labels": y}


def synthetic_click_batches(vocab_sizes: Sequence[int], batch: int,
                            seed: int = 0,
                            device="cuda") -> Iterator[dict]:
    """An endless stream of ``{"field_ids": (batch, F) int32, "labels":
    (batch,) int32}`` on ``device`` (the card unless the caller asks for
    the CPU): Pareto(1.2)-skewed ids per field and clicks from a hidden
    logistic model of the ids."""
    dev = resolve_device(device)
    return ({k: torch.from_numpy(x).to(dev) for k, x in b.items()}
            for b in _click_arrays(vocab_sizes, batch, seed))
