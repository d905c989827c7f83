"""The training infrastructure of the PyTorch port (``optim/compression``,
``train/checkpoint``, ``train/loop``) against the JAX package on the CPU.

Compression is an exact function of float32 inputs, so ``compress_grads``
equals the reference bit for bit and the error-feedback invariant ``sent +
new_residual == grad + residual`` holds exactly.  Checkpoints keep the
reference's payload (``arrays.npz`` of ``leaf_<i>`` in ``jax.tree.flatten``
order, ``meta.json`` with the treedef string and sha256), so one written by
either package restores into the other.  The loop is held to the
reference's loop on the same quadratic and batches: 20 steps within 1e-5
(float32 steps in another summation order), with and without compression.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import (AdamWConfig as JAdamWConfig,
                         CompressionConfig as JCompressionConfig,
                         adamw_init as jadamw_init,
                         compress_grads as jcompress,
                         compression_init as jcompression_init)
from repro.train import checkpoint as jckpt
from repro.train.loop import TrainLoopConfig as JLoopConfig, train as jtrain

import repro_torch.train.loop as loop_mod
from repro_torch.optim import (AdamWConfig, AdamWState, CompressionConfig,
                               adamw_init, compress_grads, compression_init)
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.loop import (ElasticController, TrainLoopConfig,
                                    train)

CPU = "cpu"


def _grads(rng, scale=1.0):
    g = {"w": rng.standard_normal((8, 8)), "b": rng.standard_normal(13),
         "s": rng.standard_normal(()), "big": rng.standard_normal((64, 33))}
    g = {k: np.asarray(v * scale, np.float32) for k, v in g.items()}
    # Ties and signed zeros at the top-k threshold and the int8 rounding.
    g["w"][0, :4] = g["w"][1, :4] = 2.5
    g["b"][:3] = [0.0, -0.0, 1e-30]
    return g


@pytest.mark.parametrize("scheme,frac", [("topk", 0.25), ("topk", 0.01),
                                         ("topk", 0.5), ("int8", 0.01)])
def test_compress_grads_is_bit_equal_to_the_reference(scheme, frac):
    rng = np.random.default_rng(3)
    jcfg = JCompressionConfig(scheme=scheme, topk_fraction=frac)
    cfg = CompressionConfig(scheme=scheme, topk_fraction=frac)
    g0 = _grads(rng)
    jres = jcompression_init({k: jnp.asarray(v) for k, v in g0.items()})
    res = compression_init({k: torch.from_numpy(v) for k, v in g0.items()})
    assert all(r.dtype == torch.float32 and not r.any() for r in res.values())
    for step in range(4):
        g = g0 if step == 0 else _grads(rng, scale=10.0 ** -step)
        jsent, jres2 = jcompress(jcfg, {k: jnp.asarray(v)
                                        for k, v in g.items()}, jres)
        tg = {k: torch.from_numpy(v) for k, v in g.items()}
        sent, res2 = compress_grads(cfg, tg, res)
        for k in g:
            for got, want in ((sent[k], jsent[k]), (res2[k], jres2[k])):
                assert got.dtype == torch.float32
                assert got.numpy().tobytes() == np.asarray(want).tobytes(), \
                    (scheme, step, k)
            # The error-feedback invariant, exactly.
            assert torch.equal(sent[k] + res2[k], tg[k] + res[k])
        if scheme == "topk":
            n = g0["big"].size
            assert int((sent["big"] != 0).sum()) >= max(int(n * frac), 1)
        else:
            for k in g:
                scale = float((tg[k] + res[k]).abs().max()) / 127
                q = sent[k] / max(scale, 1e-12 / 127)
                assert float((q - q.round()).abs().max()) < 1e-3
        jres, res = jres2, res2


def test_compress_grads_none_passes_through_and_refuses_unknown():
    g = {"w": torch.ones(3)}
    r = compression_init(g)
    assert compress_grads(CompressionConfig(), g, r) == (g, r)
    with pytest.raises(ValueError):
        compress_grads(CompressionConfig(scheme="fp4"), g, r)


def _tree(lib):
    """A tree like the loop's ``{params, opt, step}`` (and a list and a
    None), with the same values in either package."""
    rng = np.random.default_rng(0)
    p = {"w0": np.float32(0.5), "w": rng.standard_normal(7).astype(np.float32),
         "v": rng.standard_normal((7, 3)).astype(np.float32)}
    if lib == "jax":
        from repro.optim.adamw import AdamWState as JState
        arr = jnp.asarray
        state = JState(jnp.asarray(3, jnp.int32),
                       {k: arr(v * 2) for k, v in p.items()},
                       {k: arr(v * 3) for k, v in p.items()})
    else:
        arr = torch.as_tensor
        state = AdamWState(torch.tensor(3, dtype=torch.int32),
                           {k: arr(v * 2) for k, v in p.items()},
                           {k: arr(v * 3) for k, v in p.items()})
    return {"params": {k: arr(v) for k, v in p.items()}, "opt": state,
            "step": 3, "extra": [arr(np.arange(4, dtype=np.int32)), None]}


def test_checkpoint_round_trip_and_treedef(tmp_path):
    tree = _tree("torch")
    d = str(tmp_path)
    ckpt.save_checkpoint(d, 3, tree)
    ckpt.save_checkpoint(d, 7, {**tree, "step": 7})
    assert ckpt.latest_step(d) == 7
    back = ckpt.restore_checkpoint(d, 7, tree)
    assert int(back["step"]) == 7
    assert isinstance(back["opt"], AdamWState)
    assert back["opt"].step.dtype == torch.int32
    for k in ("w0", "w", "v"):
        assert torch.equal(back["params"][k], tree["params"][k])
        assert torch.equal(back["opt"].nu[k], tree["opt"].nu[k])
    assert back["extra"][1] is None
    assert torch.equal(back["extra"][0], tree["extra"][0])
    # The treedef string and the leaf order are the reference's.
    meta = json.load(open(os.path.join(d, "step_0000000007", "meta.json")))
    jleaves, jdef = jax.tree.flatten(_tree("jax"))
    assert meta["treedef"] == str(jdef)
    assert meta["n_leaves"] == len(jleaves) == 12
    with pytest.raises(ValueError):
        ckpt.restore_checkpoint(d, 7, {"x": torch.zeros(2)})


def test_checkpoint_skips_a_corrupt_payload_and_keeps_n(tmp_path):
    d = str(tmp_path)
    tree = {"x": torch.ones(3)}
    for s in (1, 2, 3, 4):
        ckpt.save_checkpoint(d, s, {"x": torch.full((3,), float(s))},
                             keep_n=3)
    assert sorted(ckpt.all_steps(d)) == [2, 3, 4]
    assert not [n for n in os.listdir(d) if n.startswith("tmp.")]
    with open(os.path.join(d, "step_0000000004", "arrays.npz"), "wb") as f:
        f.write(b"garbage")
    assert ckpt.latest_step(d) == 3
    with pytest.raises(IOError):
        ckpt.restore_checkpoint(d, 4, tree)
    assert float(ckpt.restore_checkpoint(d, 3, tree)["x"][0]) == 3.0
    os.remove(os.path.join(d, "step_0000000003", "meta.json"))
    assert ckpt.latest_step(d) == 2
    assert ckpt.latest_step(os.path.join(d, "absent")) is None


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoints_restore_across_packages(tmp_path, writer):
    """A checkpoint written by one package restores into the other, leaf
    for leaf, with the same meta."""
    d = str(tmp_path)
    jt, tt = _tree("jax"), _tree("torch")
    if writer == "jax":
        jckpt.save_checkpoint(d, 5, jt)
        back = ckpt.restore_checkpoint(d, 5, tt)
        assert isinstance(back["opt"], AdamWState)
        got = [x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
               for x in ckpt._flatten(back)[0]]
    else:
        ckpt.save_checkpoint(d, 5, tt)
        assert jckpt.latest_step(d) == 5
        back = jckpt.restore_checkpoint(d, 5, jt)
        got = [np.asarray(x) for x in jax.tree.leaves(back)]
    want = [np.asarray(x) for x in jax.tree.leaves(jt)]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    meta = json.load(open(os.path.join(d, "step_0000000005", "meta.json")))
    assert meta["treedef"] == str(jax.tree.structure(jt))


def _quadratic_batches(lib):
    rng = np.random.default_rng(0)
    while True:
        x = rng.standard_normal((8, 4)).astype(np.float32)
        y = x.sum(1, keepdims=True)
        if lib == "jax":
            yield {"x": jnp.asarray(x), "y": jnp.asarray(y)}
        else:
            yield {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}


def _tloss(params, batch):
    return torch.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)


def _jloss(params, batch):
    return jnp.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)


def test_train_loop_resume_exact(tmp_path):
    """The reference's test on the port: kill the loop mid-run; resuming
    reproduces the uninterrupted run."""
    p0 = {"w": torch.zeros((4, 1))}
    ocfg = AdamWConfig(lr=1e-2)
    p_full, _ = train(_tloss, {k: v.clone() for k, v in p0.items()},
                      _quadratic_batches("torch"), ocfg,
                      TrainLoopConfig(total_steps=20, ckpt_every=100))
    d = str(tmp_path)
    train(_tloss, {k: v.clone() for k, v in p0.items()},
          _quadratic_batches("torch"), ocfg,
          TrainLoopConfig(total_steps=10, ckpt_every=10, ckpt_dir=d))
    p_res, m = train(_tloss, {k: v.clone() for k, v in p0.items()},
                     _quadratic_batches("torch"), ocfg,
                     TrainLoopConfig(total_steps=20, ckpt_every=100,
                                     ckpt_dir=d, log_every=1))
    assert torch.equal(p_res["w"], p_full["w"])
    assert m["history"][0]["step"] == 10


def test_straggler_detection():
    """The reference's test on the port: ``loop.time.perf_counter`` jumps
    every 13th call; the hook sees the slow steps."""
    def batches():
        while True:
            yield {"x": torch.ones((2, 2)), "y": torch.ones((2, 1))}

    hits = []
    calls = {"i": 0}
    real = loop_mod.time.perf_counter

    def fake():
        calls["i"] += 1
        return real() + (5.0 if calls["i"] % 13 == 0 else 0.0)

    old = loop_mod.time.perf_counter
    loop_mod.time.perf_counter = fake
    try:
        _, metrics = train(
            lambda p, b: torch.sum((b["x"] @ p["w"] - b["y"]) ** 2),
            {"w": torch.zeros((2, 1))}, batches(), AdamWConfig(lr=1e-3),
            TrainLoopConfig(total_steps=30),
            on_straggler=lambda s, dt: hits.append(s))
    finally:
        loop_mod.time.perf_counter = old
    assert metrics["n_stragglers"] >= 1
    assert hits


@pytest.mark.parametrize("scheme", ["none", "topk", "int8"])
def test_loop_equals_the_reference_loop(scheme):
    """20 steps of both loops on the same quadratic and batches, with the
    same compression: losses and parameters within 1e-5."""
    jp, jm = jtrain(_jloss, {"w": jnp.zeros((4, 1))},
                    _quadratic_batches("jax"), JAdamWConfig(lr=5e-2),
                    JLoopConfig(total_steps=20, log_every=1),
                    comp_cfg=JCompressionConfig(scheme=scheme,
                                                topk_fraction=0.5))
    tp, tm = train(_tloss, {"w": torch.zeros((4, 1))},
                   _quadratic_batches("torch"), AdamWConfig(lr=5e-2),
                   TrainLoopConfig(total_steps=20, log_every=1),
                   comp_cfg=CompressionConfig(scheme=scheme,
                                              topk_fraction=0.5))
    assert len(tm["history"]) == len(jm["history"]) == 20
    for a, b in zip(tm["history"], jm["history"]):
        assert a["step"] == b["step"]
        for k in ("loss", "grad_norm", "lr"):
            assert a[k] == pytest.approx(b[k], rel=1e-5, abs=1e-7), (k, a, b)
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                               rtol=1e-5, atol=1e-6)


def test_elastic_controller_checkpoints_when_the_device_count_changes(
        tmp_path):
    class Wants2(ElasticController):
        def desired_devices(self):
            return 2

    d = str(tmp_path)
    cfg = TrainLoopConfig(total_steps=6, ckpt_every=100, ckpt_dir=d,
                          elastic_poll_steps=3)
    _, m = train(_tloss, {"w": torch.zeros((4, 1))},
                 _quadratic_batches("torch"), AdamWConfig(lr=1e-2), cfg,
                 elastic=ElasticController(CPU))
    assert not [h for h in m["history"] if "event" in h]
    assert ckpt.latest_step(d) is None
    _, m = train(_tloss, {"w": torch.zeros((4, 1))},
                 _quadratic_batches("torch"), AdamWConfig(lr=1e-2), cfg,
                 elastic=Wants2(CPU))
    events = [h for h in m["history"] if h.get("event") == "elastic_rescale"]
    assert [e["step"] for e in events] == [2, 5]
    assert events[0]["devices"] == 2
    assert ckpt.latest_step(d) == 6


def test_loop_runs_the_fm_and_resumes_on_it(tmp_path):
    """The FM through the loop at the smoke width: resume from a checkpoint
    at step 3 ends on the uninterrupted run's parameters bit for bit."""
    from repro_torch.configs import fm
    from repro_torch.data.recsys import synthetic_click_batches
    from repro_torch.models import recsys
    cfg = fm.smoke_config()

    def loss_fn(p, b):
        return recsys.loss_fn(cfg, p, b)

    def run(total, d=None, every=100):
        return train(loss_fn, recsys.init_params(cfg, 0, device=CPU),
                     synthetic_click_batches(cfg.vocab_sizes, 64, 1, CPU),
                     AdamWConfig(lr=1e-2, warmup_steps=0),
                     TrainLoopConfig(total_steps=total, ckpt_every=every,
                                     ckpt_dir=d, keep_n=1))

    full, m_full = run(6)
    d = str(tmp_path)
    run(3, d, every=3)
    res, _ = run(6, d)
    for k in full:
        assert torch.equal(full[k], res[k]), k
    assert all(np.isfinite(h["loss"]) for h in m_full["history"])
