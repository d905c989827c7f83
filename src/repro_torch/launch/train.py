"""End-to-end training launcher of the PyTorch port
(``repro.launch.train``), at smoke scale on one device:

    python -m repro_torch.launch.train --arch qwen2-1.5b --steps 100
    python -m repro_torch.launch.train --arch gin-tu --shape molecule
    python -m repro_torch.launch.train --arch fm --steps 50
    python -m repro_torch.launch.train --arch louvain --graph rmat --scale 12

Run with ``PYTHONPATH=src`` from the root of a checkout.  Every run is on
the card unless ``--device cpu`` asks for the CPU.  The LM path drives the
fault-tolerant loop (checkpoint and resume, straggler counters, gradient
compression) of ``repro_torch.train.loop``; the GNN and FM paths train
through their config's ``build_step``; ``louvain`` runs ``louvain()`` on an
R-MAT or SBM graph.  The result prints as the reference's JSON object.
"""

from __future__ import annotations

import argparse
import json
import time

import torch


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train_lm(arch_id: str, steps: int, ckpt_dir: str | None,
             compression: str, device="cuda") -> dict:
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.tokens import synthetic_token_batches
    from repro_torch.models import transformer as tf
    from repro_torch.optim import AdamWConfig, CompressionConfig
    from repro_torch.train.loop import TrainLoopConfig, train

    cfg = get_arch(arch_id).smoke_config()
    params = tf.flat_params(tf.init_params(cfg, 0, device))
    batches = synthetic_token_batches(cfg.vocab, batch=8, seq_len=128,
                                      device=device)
    t0 = time.perf_counter()
    params, metrics = train(
        lambda p, b: tf.loss_fn(cfg, tf.nest_params(p), b), params, batches,
        AdamWConfig(lr=3e-4),
        TrainLoopConfig(total_steps=steps, log_every=max(steps // 10, 1),
                        ckpt_every=max(steps // 2, 1), ckpt_dir=ckpt_dir),
        comp_cfg=CompressionConfig(scheme=compression))
    hist = metrics["history"]
    return {"arch": arch_id, "steps": steps,
            "loss_first": hist[0]["loss"], "loss_last": hist[-1]["loss"],
            "seconds": time.perf_counter() - t0,
            "n_stragglers": metrics["n_stragglers"]}


def _train_steps(model, step, batch_of, steps: int, dev: torch.device):
    """(first loss, last loss, seconds) of ``steps`` AdamW steps."""
    from repro_torch.optim import adamw_init
    opt = adamw_init(model)
    first = last = None
    t0 = time.perf_counter()
    for s in range(steps):
        opt, loss = step(model, opt, batch_of(s))
        last = float(loss)
        if s == 0:
            first = last
    _sync(dev)
    return first, last, time.perf_counter() - t0


def train_gnn(arch_id: str, shape: str, steps: int, device="cuda") -> dict:
    from repro_torch import ShardGroup
    from repro_torch.configs.registry import get_arch
    from repro_torch.optim import AdamWConfig

    arch = get_arch(arch_id)
    group = ShardGroup.single(device)
    model = arch.init_model(shape, 0, smoke=True, device=group.device)
    batch = arch.make_batch(shape, 0, smoke=True, device=group.device)
    step = arch.build_step(shape, group, smoke=True,
                           opt_cfg=AdamWConfig(lr=1e-3))
    first, last, secs = _train_steps(model, step, lambda _s: batch, steps,
                                     group.device)
    return {"arch": arch_id, "shape": shape, "steps": steps,
            "loss_first": first, "loss_last": last, "seconds": secs}


def train_fm(steps: int, device="cuda") -> dict:
    from repro_torch import FM, ShardGroup
    from repro_torch.data.recsys import synthetic_click_batches
    from repro_torch.optim import AdamWConfig

    group = ShardGroup.single(device)
    model = FM.init_model("train_batch", 0, smoke=True, device=group.device)
    step = FM.build_step("train_batch", group, smoke=True,
                         opt_cfg=AdamWConfig(lr=1e-2))
    batches = synthetic_click_batches(FM.smoke_config().vocab_sizes,
                                      batch=256, device=group.device)
    first, last, secs = _train_steps(model, step, lambda _s: next(batches),
                                     steps, group.device)
    return {"arch": "fm", "steps": steps, "loss_first": first,
            "loss_last": last, "seconds": secs}


def run_louvain(graph: str, scale: int, device="cuda") -> dict:
    from repro_torch.core.louvain import (LouvainConfig, louvain,
                                          louvain_modularity)
    from repro_torch.data import rmat_graph, sbm_graph

    if graph == "rmat":
        G = rmat_graph(scale, edge_factor=8, device=device)
    else:
        G, _ = sbm_graph(n_communities=1 << max(scale - 6, 1), size=64,
                         p_in=0.2, p_out=0.002, device=device)
    t0 = time.perf_counter()
    res = louvain(G, LouvainConfig())
    _sync(G.device)
    dt = time.perf_counter() - t0
    return {"graph": graph, "n": int(G.n_valid), "e": int(G.e_valid),
            "n_communities": res.n_communities,
            "modularity": louvain_modularity(G, res),
            "passes": res.n_passes, "seconds": dt,
            "edges_per_s": int(G.e_valid) / dt}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True,
                    help="arch id from the registry, or 'louvain'")
    ap.add_argument("--shape", default=None)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--compression", default="none",
                    choices=["none", "topk", "int8"])
    ap.add_argument("--graph", default="rmat")
    ap.add_argument("--scale", type=int, default=12)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the card)")
    args = ap.parse_args(argv)

    if args.arch == "louvain":
        out = run_louvain(args.graph, args.scale, args.device)
    else:
        from repro_torch.configs.registry import get_arch
        fam = get_arch(args.arch).family
        if fam == "lm":
            out = train_lm(args.arch, args.steps, args.ckpt_dir,
                           args.compression, args.device)
        elif fam == "gnn":
            out = train_gnn(args.arch, args.shape or "molecule", args.steps,
                            args.device)
        else:
            out = train_fm(args.steps, args.device)
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
