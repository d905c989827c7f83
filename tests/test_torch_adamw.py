"""The port's AdamW (``repro_torch.optim.adamw``) against the reference's
``repro.optim.adamw`` on the CPU: 8 steps on a random tree from the same
numpy draws, three of them inside the warmup and some with the gradients
clipped. ``lr`` must be equal through the warmup and within ``cfg.lr *
2^-22`` on the cosine (an ulp or two of the cosine): XLA's float32 cosine
and torch's differ by an ulp on about 5% of inputs (497 of 10,001 points of
[0, pi] with JAX 0.9.0 and torch 2.13 on the CPU), and no torch function
reproduces XLA's. ``grad_norm`` within 2 float32 ulps (relative 2^-22): both add the
same float32 squares, in another order. Parameters and moments
float32-close (rtol 1e-6, atol 1e-7: the same float32 expressions, with
lr's ulp carried along)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw

from repro_torch.optim import adamw

SHAPES = {"a": (3, 5), "bias": (5,), "eps": (), "w": (4, 2, 3)}


def _tree(rng, scale=1.0):
    return {k: np.asarray(scale * rng.standard_normal(s), np.float32)
            for k, s in SHAPES.items()}


@pytest.mark.parametrize("cfg", [
    adamw.AdamWConfig(lr=1e-2, warmup_steps=4, total_steps=10,
                      grad_clip=1.0),
    adamw.AdamWConfig(),
    adamw.AdamWConfig(lr=3e-3, weight_decay=0.0, warmup_steps=0,
                      total_steps=5, grad_clip=0.5, min_lr_ratio=0.0),
], ids=["warmup_cosine_clip", "defaults", "no_warmup_past_total"])
def test_adamw_equals_the_reference_step_for_step(cfg):
    jcfg = jadamw.AdamWConfig(**dataclasses.asdict(cfg))
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = jadamw.adamw_init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    tstate = adamw.adamw_init(tp)
    clipped = 0
    for step in range(8):
        # Alternate small and large gradients: some steps clip.
        g = _tree(rng, scale=0.05 if step % 2 else 3.0)
        jp, jstate, jm = jadamw.adamw_update(
            jcfg, jp, {k: jnp.asarray(v) for k, v in g.items()}, jstate)
        tp, tstate, tm = adamw.adamw_update(
            cfg, tp, {k: torch.from_numpy(v) for k, v in g.items()}, tstate)
        if step + 1 <= cfg.warmup_steps:
            assert float(tm["lr"]) == float(jm["lr"]), step
        else:
            assert float(tm["lr"]) == pytest.approx(
                float(jm["lr"]), rel=0, abs=cfg.lr * 2.0 ** -22), step
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=2.0 ** -22, abs=0), step
        clipped += float(jm["grad_norm"]) > cfg.grad_clip
        assert int(tstate.step) == int(jstate.step) == step + 1
        for k in SHAPES:
            for got, want in ((tp[k], jp[k]), (tstate.mu[k], jstate.mu[k]),
                              (tstate.nu[k], jstate.nu[k])):
                assert got.dtype == torch.float32
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-6, atol=1e-7, err_msg=k)
    assert 0 < clipped < 8


def test_apply_writes_a_module_in_place():
    lin = torch.nn.Linear(3, 2)
    named = {k: p.detach().clone() for k, p in lin.named_parameters()}
    grads = {k: torch.ones_like(p) for k, p in named.items()}
    cfg = adamw.AdamWConfig(lr=0.1, warmup_steps=0)
    want, _, _ = adamw.adamw_update(cfg, named, grads, adamw.adamw_init(named))
    state, metrics = adamw.adamw_apply(cfg, lin, grads, adamw.adamw_init(lin))
    for k, p in lin.named_parameters():
        assert torch.equal(p.detach(), want[k])
    assert int(state.step) == 1 and float(metrics["lr"]) == pytest.approx(0.1)
