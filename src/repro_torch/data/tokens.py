"""Synthetic LM token batches (``repro.data.tokens``): a Zipfian unigram
distribution plus a deterministic successor rule on half the positions,
so the loss falls measurably in a short training run.

The draws are the reference's own ``np.random.default_rng`` calls in the
same order, so a seed gives byte-identical batches."""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from repro_torch.core.graph import resolve_device


def _token_arrays(vocab: int, batch: int, seq_len: int, seed: int = 0,
                 structured: bool = True) -> Iterator[dict]:
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1)
    probs = 1.0 / ranks ** 1.1
    probs /= probs.sum()
    while True:
        toks = rng.choice(vocab, size=(batch, seq_len + 1), p=probs)
        if structured:
            # tok[t+1] = (tok[t] * 7 + 3) % vocab on half the positions.
            mask = rng.random((batch, seq_len)) < 0.5
            nxt = (toks[:, :-1] * 7 + 3) % vocab
            toks[:, 1:][mask] = nxt[mask]
        yield {"tokens": toks[:, :-1].astype(np.int32),
               "labels": toks[:, 1:].astype(np.int32)}


def synthetic_token_batches(vocab: int, batch: int, seq_len: int,
                            seed: int = 0, structured: bool = True,
                            device="cuda") -> Iterator[dict]:
    """An endless stream of ``{"tokens", "labels"}``, each (batch, seq_len)
    int32 on ``device`` (the card unless the caller asks for the CPU), the
    labels the tokens shifted by one."""
    dev = resolve_device(device)
    return ({k: torch.from_numpy(x).to(dev) for k, x in b.items()}
            for b in _token_arrays(vocab, batch, seq_len, seed, structured))
