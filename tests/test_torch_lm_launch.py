"""The LM configs' plumbing (``configs/lm_common``, the registry) and the
training CLI (``launch/train``) of the PyTorch port against the JAX
package on the CPU.

The steps of ``build_lm_step`` (train, prefill, decode and their variants)
are held to the reference's on a one-device mesh, where its layouts are
trivial, within 1e-5 of the largest entry (float32 sums in another
order).  The CLI runs with ``--device cpu``; its Louvain run gives the
reference's community count and passes and its Q within 1e-6 (float32
sums in another order).
"""

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compat import make_mesh
from repro.configs import lm_common as jlm
from repro.configs.registry import (ALL_ARCHS as J_ARCHS,
                                    EXTRA_ARCHS as J_EXTRA,
                                    all_cells as j_all_cells,
                                    skipped_cells as j_skipped_cells)
from repro.launch.train import run_louvain as j_run_louvain
from repro.models import transformer as jtf
from repro.optim import adamw_init as jadamw_init

from repro_torch import ShardGroup
from repro_torch.configs import lm_common
from repro_torch.core.collectives import RankGrid
from repro_torch.configs.registry import (ALL_ARCHS, EXTRA_ARCHS, all_cells,
                                          get_arch, skipped_cells)
from repro_torch.interop import lm_cache_from_numpy, lm_params_from_numpy
from repro_torch.launch import train as cli
from repro_torch.models import transformer as tf
from repro_torch.optim import AdamWConfig, adamw_init

CPU = "cpu"
RTOL = 1e-5
#: Parameters after AdamW steps, in units of the learning rate.
ADAM_ATOL = 0.05
LM_IDS = ["gemma3-12b", "qwen2-1.5b", "internlm2-20b", "mixtral-8x22b",
          "deepseek-v2-236b"]
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


def close(got, want, rtol=RTOL, what=""):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    err = float(np.abs(np.asarray(got, np.float32) - want).max())
    assert err <= rtol * max(float(np.abs(want).max()), 1e-30), (what, err)


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh((1, 1), ("data", "model"))


@pytest.fixture(scope="module")
def qwen():
    """qwen2's smoke configs and the reference's weights on both sides."""
    jarch = J_ARCHS["qwen2-1.5b"]
    jp = jtf.init_params(jarch.smoke_config(), jax.random.PRNGKey(0))
    return dict(jcfg=jarch.smoke_config(),
                cfg=get_arch("qwen2-1.5b").smoke_config(), jp=jp,
                params=lm_params_from_numpy(numpy_tree(jp), CPU))


def _batch(rng, vocab, specs):
    return {k: rng.integers(0, vocab, s).astype(np.int32)
            for k, (s, _) in specs.items() if k != "cache_len"}


# ---------------------------------------------------------------------------
# Specs and the registry
# ---------------------------------------------------------------------------

def test_shapes_and_input_specs_equal_the_reference():
    assert lm_common.LM_SHAPES == jlm.LM_SHAPES
    for aid in LM_IDS:
        for shape in lm_common.LM_SHAPES:
            for smoke in (False, True):
                want = J_ARCHS[aid].input_specs(shape, smoke=smoke)
                got = get_arch(aid).input_specs(shape, smoke=smoke)
                assert {k: (tuple(v.shape), str(v.dtype))
                        for k, v in want.items()} == {
                    k: (s, str(d).replace("torch.", ""))
                    for k, (s, d) in got.items()}, (aid, shape, smoke)


def test_opt_specs_equal_the_reference():
    cfg = get_arch("mixtral-8x22b").smoke_config()
    jcfg = J_ARCHS["mixtral-8x22b"].smoke_config()
    want = jlm.opt_specs(jtf.param_specs(jcfg))
    got = lm_common.opt_specs(tf.param_shapes(cfg))
    assert got.step == ((), torch.int32)
    for ours, theirs in ((got.mu, want.mu), (got.nu, want.nu)):
        theirs = tf.flat_params(theirs)
        assert list(ours) == list(theirs)
        assert all(ours[k] == (theirs[k].shape, torch.float32)
                   and theirs[k].dtype == jnp.float32 for k in ours)


def test_registry_equals_the_reference():
    assert set(ALL_ARCHS) == set(J_ARCHS) and len(ALL_ARCHS) == 10
    assert all_cells() == j_all_cells() and len(all_cells()) == 38
    assert skipped_cells() == j_skipped_cells()
    for aid, arch in ALL_ARCHS.items():
        assert arch.family == J_ARCHS[aid].family
        assert get_arch(aid) is arch
    assert set(EXTRA_ARCHS) == set(J_EXTRA) == {"louvain"}
    louvain = get_arch("louvain")
    assert louvain is EXTRA_ARCHS["louvain"]
    assert louvain.family == J_EXTRA["louvain"].family
    assert louvain.shapes == J_EXTRA["louvain"].shapes
    with pytest.raises(KeyError, match="unknown arch 'nope'; have"):
        get_arch("nope")


# ---------------------------------------------------------------------------
# The steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", [(), ("sharded_ce",),
                                     ("tp_only_params", "naive_cache")])
def test_train_step_equals_the_reference(qwen, mesh, variant):
    """Two AdamW steps: the first step's gradients, both losses, the
    moments and the parameters."""
    rng = np.random.default_rng(0)
    specs = lm_common.lm_input_specs(qwen["cfg"], "train_4k", smoke=True)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1)
    jfn, _, _ = jlm.build_lm_step(qwen["jcfg"], "train_4k", mesh,
                                  opt_cfg=jlm.AdamWConfig(**dataclasses.asdict(
                                      opt_cfg)),
                                  variant=variant, smoke_shapes=True)
    step = lm_common.build_lm_step(qwen["cfg"], "train_4k",
                                   ShardGroup.single(CPU), opt_cfg=opt_cfg,
                                   variant=variant, smoke_shapes=True)
    jp, jopt = qwen["jp"], jadamw_init(qwen["jp"])
    params = tf.nest_params({k: x.clone() for k, x in
                             tf.flat_params(qwen["params"]).items()})
    opt = adamw_init(tf.flat_params(params))
    jstep = jax.jit(jfn)
    for i in range(2):
        batch = _batch(rng, qwen["cfg"].vocab, specs)
        if i == 0:
            jg = jax.grad(lambda p: jtf.loss_fn(qwen["jcfg"], p, batch))(jp)
            jg = tf.flat_params(numpy_tree(jg))
            _, grads = step.loss_and_grads(
                params, {k: torch.from_numpy(v) for k, v in batch.items()})
            for k, g in grads.items():
                close(g, jg[k], what=k)
        with mesh:
            jp, jopt, jloss = jstep(jp, jopt, batch)
        params, opt, loss = step(params, opt,
                                 {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
        close(loss, jloss, what=("loss", i))
    # AdamW's step m / sqrt(v) divides by the gradient's own scale, so a
    # gradient near zero turns a float32 difference into a difference of
    # the step's direction: parameters are held within ADAM_ATOL x lr
    # (measured: 0.019 lr at most, on wq), the moments within 1e-5.
    want = tf.flat_params(numpy_tree(jp))
    for k, x in tf.flat_params(params).items():
        err = float(np.abs(x.numpy() - want[k]).max())
        assert err <= ADAM_ATOL * opt_cfg.lr, (k, err)
    for ours, theirs in ((opt.mu, jopt.mu), (opt.nu, jopt.nu)):
        theirs = tf.flat_params(numpy_tree(theirs))
        for k in ours:
            close(ours[k], theirs[k], what=k)
    assert int(opt.step) == int(jopt.step) == 2


def test_prefill_step_equals_the_reference(qwen, mesh):
    rng = np.random.default_rng(1)
    specs = lm_common.lm_input_specs(qwen["cfg"], "prefill_32k", smoke=True)
    assert specs == {"tokens": ((4, 128), torch.int32)}
    batch = _batch(rng, qwen["cfg"].vocab, specs)
    jfn, _, _ = jlm.build_lm_step(qwen["jcfg"], "prefill_32k", mesh,
                                  smoke_shapes=True)
    with mesh:
        want = jax.jit(jfn)(qwen["jp"], batch)
    step = lm_common.build_lm_step(qwen["cfg"], "prefill_32k",
                                   ShardGroup.single(CPU), smoke_shapes=True)
    got = step(qwen["params"], {"tokens": torch.from_numpy(batch["tokens"])})
    assert got.shape == (4, qwen["cfg"].vocab) and got.dtype == torch.float32
    close(got, want)


@pytest.mark.parametrize("variant", [(), ("int8_kv",),
                                     ("no_donate", "naive_cache",
                                      "tp_only_params")])
def test_decode_step_equals_the_reference(qwen, mesh, variant):
    """Three decode steps against a 128-position cache (``decode_32k``'s
    smoke size): logits and the cache, written in place by the port."""
    rng = np.random.default_rng(2)
    specs = lm_common.lm_input_specs(qwen["cfg"], "decode_32k", smoke=True)
    assert specs == {"tokens": ((4, 1), torch.int32),
                     "cache_len": ((), torch.int32)}
    jfn, jargs, _ = jlm.build_lm_step(qwen["jcfg"], "decode_32k", mesh,
                                      variant=variant, smoke_shapes=True)
    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), jargs[1])
    int8 = "int8_kv" in variant
    cfg = dataclasses.replace(qwen["cfg"],
                              kv_cache_dtype="int8" if int8 else "bf16")
    cache = tf.init_cache(cfg, 4, 128, CPU)
    step = lm_common.build_lm_step(qwen["cfg"], "decode_32k",
                                   ShardGroup.single(CPU), variant=variant,
                                   smoke_shapes=True)
    jstep = jax.jit(jfn)
    for i in range(3):
        tok = _batch(rng, qwen["cfg"].vocab, specs)["tokens"]
        with mesh:
            want, jcache = jstep(qwen["jp"], jcache,
                                 {"tokens": tok, "cache_len": jnp.int32(i)})
        got, back = step(qwen["params"], cache,
                         {"tokens": torch.from_numpy(tok),
                          "cache_len": torch.tensor(i, dtype=torch.int32)})
        assert back is cache
        close(got, want, what=i)
    want_cache = lm_cache_from_numpy(numpy_tree(jcache), CPU)["slots"]
    for slot, wslot in zip(cache["slots"], want_cache):
        assert set(slot) == set(wslot) == (
            {"k_q", "v_q", "k_s", "v_s"} if int8 else {"k", "v"})
        for name, x in slot.items():
            if x.dtype == torch.int8:
                assert int((x.int() - wslot[name].int()).abs().max()) <= 1
            else:
                close(x, wslot[name].numpy(), what=name)


def test_a_group_of_two_ranks_is_refused(qwen):
    """A bare group of two ranks says nothing of their layout and is
    refused, as is a grid that does not hold the group; a (1, 2) grid over
    it builds all three step kinds (the steps run in
    ``test_torch_lm_sharding.py``)."""
    pair = ShardGroup(0, 2, torch.device(CPU), "gloo")
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        with pytest.raises(ValueError, match="needs a RankGrid"):
            lm_common.build_lm_step(qwen["cfg"], shape, pair,
                                    smoke_shapes=True)
    with pytest.raises(ValueError, match="needs a RankGrid"):
        get_arch("gemma3-12b").build_step("train_4k", pair, smoke=True)
    with pytest.raises(ValueError, match="holds 4 ranks; the group has 2"):
        RankGrid(pair, (2, 2))
    grid = RankGrid(pair, (1, 2))
    train = lm_common.build_lm_step(qwen["cfg"], "train_4k", grid,
                                    smoke_shapes=True)
    assert isinstance(train, lm_common.LMTrainStep) and train.grid is grid
    for shape in ("prefill_32k", "decode_32k", "long_500k"):
        assert callable(lm_common.build_lm_step(qwen["cfg"], shape, grid,
                                                smoke_shapes=True))
    assert callable(get_arch("gemma3-12b").build_step("decode_32k", grid,
                                                      smoke=True))


def test_arch_build_step_cuts_depth(qwen):
    arch = get_arch("gemma3-12b")
    cfg = arch.config(smoke=False, n_repeats=1)
    assert (cfg.n_layers, cfg.d_model, cfg.vocab) == (6, 3840, 262144)
    step = lm_common.build_lm_step(arch.config(smoke=True, n_repeats=1),
                                   "train_4k", ShardGroup.single(CPU),
                                   smoke_shapes=True)
    assert step.cfg.n_layers == 2 and step.cfg.dtype == "float32"


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

def run_main(argv) -> dict:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(argv + ["--device", CPU])
    return json.loads(out.getvalue())


def test_cli_trains_an_lm_through_the_loop(tmp_path):
    """``python -m repro_torch.launch.train``: 20 steps of qwen2's smoke
    config through the loop with a checkpoint and int8 compression."""
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen2-1.5b", "--steps", "20", "--device", CPU, "--ckpt-dir",
         str(tmp_path), "--compression", "int8"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout)
    assert set(out) == {"arch", "steps", "loss_first", "loss_last",
                        "seconds", "n_stragglers"}
    assert np.isfinite(out["loss_last"])
    assert out["loss_last"] < out["loss_first"]
    assert sorted(os.listdir(tmp_path)) == ["step_0000000010",
                                            "step_0000000020"]


@pytest.mark.parametrize("argv,keys", [
    (["--arch", "gin-tu", "--steps", "10"],
     {"arch", "shape", "steps", "loss_first", "loss_last", "seconds"}),
    (["--arch", "gat-cora", "--shape", "full_graph_sm", "--steps", "10"],
     {"arch", "shape", "steps", "loss_first", "loss_last", "seconds"}),
    (["--arch", "fm", "--steps", "10"],
     {"arch", "steps", "loss_first", "loss_last", "seconds"})])
def test_cli_trains_a_gnn_and_the_fm(argv, keys):
    out = run_main(argv)
    assert set(out) == keys
    assert np.isfinite(out["loss_last"])
    assert out["loss_last"] < out["loss_first"]


@pytest.mark.parametrize("graph,scale", [("rmat", 9), ("sbm", 8)])
def test_cli_louvain_equals_the_reference(graph, scale):
    out = run_main(["--arch", "louvain", "--graph", graph, "--scale",
                    str(scale)])
    want = j_run_louvain(graph, scale)
    assert set(out) == set(want)
    for k in ("graph", "n", "e", "n_communities", "passes"):
        assert out[k] == want[k], k
    assert abs(out["modularity"] - want["modularity"]) <= 1e-6


def test_cli_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--arch", "fm", "--steps", "1"])
