"""Dry run of every (arch x shape) cell on the production grids
(``repro.launch.dryrun``): shapes, FLOPs, bytes and collectives of one
step of one rank, with no device and no memory behind the tensors.

The reference lowers and compiles each cell for a 256- or 512-chip TPU
mesh and reads XLA's cost and memory analyses.  Here each cell's step is
built on rank 0 of a dry ``RankGrid`` (``launch/mesh.py``,
``collectives.ShardGroup.dry``) and run once, eagerly, on ``meta`` tensors
(``torch.device("meta")`` is the default device while it runs):
parameters, optimizer state and batch are made from the shapes alone,
every collective returns a tensor of the right shape, and
``launch/analysis.trace`` counts what the step does.  Nothing is allocated
on any device, and no ``XLA_FLAGS`` are set.  An operator whose output
size depends on the data takes its bound on a tensor without data
(``compat.is_dry``).

Usage:
    python -m repro_torch.launch.dryrun --arch gemma3-12b --shape train_4k
    python -m repro_torch.launch.dryrun --arch louvain \\
        --shape web_3.8B_aggregate --variant a2a
    python -m repro_torch.launch.dryrun --all [--multipod] [--out DIR]

Each cell writes a JSON record with the reference's keys: ``arch, shape,
mesh, n_devices, ok, variant, trace_s, memory, cost, roofline,
model_flops, useful_flops_ratio, scan_extrapolated, error, traceback``
(``trace_s`` in place of the reference's ``lower_s`` / ``compile_s``).  An
LM cell runs its stack cut to one and two pattern repeats and extrapolates
linearly to the full depth, as the reference does for its costs; here the
memory counts are extrapolated too, and ``--no-cost`` runs the full stack
once instead.  A cell that raises is recorded ``ok: false`` and the sweep
goes on.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Optional, Tuple

import torch

from repro_torch.launch import analysis

F32 = torch.float32


def _empty(spec) -> torch.Tensor:
    shape, dtype = spec
    return torch.empty(shape, dtype=dtype)


def _specs(tree):
    """Tensors (on the default device) of a ``{field: (shape, dtype)}``
    tree."""
    if isinstance(tree, dict):
        return {k: _specs(v) for k, v in tree.items()}
    return _empty(tree)


def _lm_inputs(arch, shape: str, grid, smoke: bool, variant: tuple,
               n_repeats: Optional[int], batch_specs: Optional[dict] = None,
               cache_len: Optional[int] = None):
    """(step, args, argument bytes) of an LM cell: the rank's parameter
    shares (and AdamW moments), its share of a decode cache, the global
    batch (its rows counted as the rank's arguments).  ``batch_specs`` and
    ``cache_len`` replace the shape's batch and cache length."""
    from repro_torch.configs import lm_common
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw_init
    from repro_torch.sharding.rules import split_parts

    cfg = arch.config(smoke, n_repeats)
    step = lm_common.build_lm_step(cfg, shape, grid, variant=variant,
                                   smoke_shapes=smoke)
    fsdp = "tp_only_params" not in variant
    split = lm_common.flat_split(cfg, grid, fsdp)

    def share_of(full_shape, sp, dtype):
        parts = split_parts(sp, grid)
        return torch.empty(tuple(d // n for d, n in zip(full_shape, parts)),
                           dtype=dtype)

    flat = {k: share_of(s, split[k], cfg.activation_dtype)
            for k, s in tf.flat_params(tf.param_shapes(cfg)).items()}
    params = tf.nest_params(flat)
    batch = _specs(batch_specs or arch.input_specs(shape, smoke))
    seq, b, kind = lm_common._shape_dims(shape, smoke)
    if kind == "decode":
        b, seq = batch["tokens"].shape[0], cache_len or seq
    if kind == "train":
        opt = adamw_init(flat)
        local = lm_common.local_batch(batch, grid)
        args = (params, opt, batch)
        counted = (params, opt, local)
    elif kind == "prefill":
        args = (params, batch)
        counted = (params, lm_common.local_batch(batch, grid))
    else:
        csplit = lm_common.step_cache_split(cfg, shape, grid, variant, smoke)
        dcfg = step.cfg
        cache = {"slots": [
            {name: share_of(s, csplit["slots"][i][name],
                            tf.cache_leaf_dtype(name, dcfg.activation_dtype))
             for name, s in slot.items()}
            for i, slot in enumerate(tf.cache_shapes(dcfg, b, seq)["slots"])]}
        args = (params, cache, batch)
        counted = (params, cache, lm_common.local_batch(
            batch, grid, replicated=step.seq_shard))
    return step, args, analysis.tensor_bytes(counted)


def _gnn_inputs(arch, shape: str, grid, smoke: bool, variant: tuple):
    from repro_torch.configs.gnn_common import shard_batch
    from repro_torch.optim import adamw_init

    step = arch.build_step(shape, grid, smoke=smoke, variant=variant)
    model = arch.init_model(shape, 0, smoke, device="meta")
    opt = adamw_init(model)
    batch = _specs(arch.input_specs(shape, smoke))
    local = shard_batch({k: batch[k] for k in step.split}, step.split,
                        step.group)
    counted = (list(model.parameters()), opt, local)
    return step, (model, opt, batch), analysis.tensor_bytes(counted)


def _fm_inputs(arch, shape: str, grid, smoke: bool, variant: tuple):
    from repro_torch.configs.fm import FM_SHAPES
    from repro_torch.configs.gnn_common import shard_batch
    from repro_torch.models import recsys
    from repro_torch.optim import adamw_init
    from repro_torch.sharding.rules import fm_batch_split

    step = arch.build_step(shape, grid, smoke=smoke)
    g = step.group
    cfg = arch.config(smoke)
    rows = cfg.padded_vocab // g.world_size
    model = recsys.FM(cfg, params={
        "w0": torch.empty((), dtype=F32),
        "w": torch.empty((rows,), dtype=F32),
        "v": torch.empty((rows, cfg.embed_dim), dtype=F32)},
        device="meta", row_lo=g.rank * rows)
    batch = _specs(arch.input_specs(shape, smoke))
    local = shard_batch(batch, fm_batch_split(FM_SHAPES[shape][1]), g)
    if FM_SHAPES[shape][1] == "train":
        opt = adamw_init(model)
        args, counted = (model, opt, batch), (model.params(), opt, local)
    else:
        args, counted = (model, batch), (model.params(), local)
    return step, args, analysis.tensor_bytes(counted)


def _louvain_inputs(arch, shape: str, grid, smoke: bool, variant: tuple):
    step = arch.build_step(shape, grid, smoke=smoke, variant=variant)
    batch = _specs(step.arg_specs)
    return step, (batch,), analysis.tensor_bytes(batch)


_INPUTS = {"lm": _lm_inputs, "gnn": _gnn_inputs, "recsys": _fm_inputs,
           "louvain": _louvain_inputs}


def trace_cell(arch, shape: str, grid, *, smoke: bool = False,
               variant: Tuple[str, ...] = (),
               n_repeats: Optional[int] = None,
               batch_specs: Optional[dict] = None,
               cache_len: Optional[int] = None) -> dict:
    """One step of ``arch`` x ``shape`` on this rank of ``grid`` (a
    ``RankGrid``, dry or real) over ``meta`` inputs: ``analysis.trace``'s
    record.  For an LM, ``n_repeats`` cuts the stack and ``batch_specs``
    (``{field: (shape, dtype)}``) and ``cache_len`` replace the shape's
    batch and decode cache length."""
    fam = getattr(arch, "family", "lm")
    with torch.device("meta"):
        if fam == "lm":
            step, args, arg_bytes = _lm_inputs(arch, shape, grid, smoke,
                                               tuple(variant), n_repeats,
                                               batch_specs, cache_len)
        else:
            step, args, arg_bytes = _INPUTS[fam](arch, shape, grid, smoke,
                                                 tuple(variant))
        return analysis.trace(step, args, grid, arg_bytes)


def run_cell(arch_id: str, shape: str, *, multi_pod: bool,
             out_dir: Optional[str] = None, verbose: bool = True,
             with_cost: bool = True, variant: tuple = (),
             smoke: bool = False) -> dict:
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.mesh import make_production_mesh

    arch = get_arch(arch_id)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    rec = {"arch": arch_id, "shape": shape, "mesh": mesh_name,
           "n_devices": 512 if multi_pod else 256, "ok": False,
           "variant": list(variant)}
    t0 = time.perf_counter()
    try:
        def one(n_repeats=None):
            return trace_cell(arch, shape,
                              make_production_mesh(multi_pod=multi_pod),
                              smoke=smoke, variant=variant,
                              n_repeats=n_repeats)

        if with_cost and getattr(arch, "family", "lm") == "lm":
            # The reference's extrapolation from stacks of one and two
            # pattern repeats, cost(R) = cost(1) + (R-1)[cost(2) - cost(1)],
            # here of every count of the record (the full stack is not
            # run: its time grows with the depth).
            R = arch.config(smoke).n_repeats
            c = [one(1), one(2)]
            lin = lambda a, b: a + (R - 1) * (b - a)  # noqa: E731
            r = {k: lin(c[0][k], c[1][k])
                 for k in ("flops", "bytes", "ops", "arg_bytes",
                           "out_bytes", "temp_peak")}
            r["coll"] = {k: lin(c[0]["coll"][k], c[1]["coll"][k])
                         for k in c[0]["coll"]}
            rec["scan_extrapolated"] = {
                "n_repeats": R,
                **{f"r{n}": {"flops": x["flops"], "bytes": x["bytes"],
                             "coll": x["coll"], "arg_bytes": x["arg_bytes"],
                             "temp_peak": x["temp_peak"]}
                   for n, x in zip((1, 2), c)}}
        else:
            r = one()
        rec["trace_s"] = time.perf_counter() - t0
        rec["memory"] = analysis.memory_stats(r)
        rec["cost"] = {"flops": r["flops"], "bytes accessed": r["bytes"],
                       "ops": r["ops"]}
        roof = analysis.roofline_from_trace(r)
        rec["roofline"] = roof.as_dict()
        mf = analysis.model_flops(arch, shape, smoke)
        rec["model_flops"] = mf
        if mf and roof.flops_per_chip:
            # Trace FLOPs are one rank's; model FLOPs are global.
            rec["useful_flops_ratio"] = mf / (roof.flops_per_chip
                                              * rec["n_devices"])
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 — record, don't stop the sweep
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]

    if verbose:
        if rec["ok"]:
            r = rec["roofline"]
            print(f"[OK] {arch_id} x {shape} @ {mesh_name}: "
                  f"trace {rec['trace_s']:.1f}s "
                  f"| t_comp {r['t_compute_s']:.2e} t_mem "
                  f"{r['t_memory_s']:.2e} t_coll {r['t_collective_s']:.2e}"
                  f" -> {r['bottleneck']}", flush=True)
        else:
            print(f"[FAIL] {arch_id} x {shape} @ {mesh_name}: "
                  f"{rec['error']}", flush=True)

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = ("_" + "-".join(variant)) if variant else ""
        fname = f"{arch_id}_{shape}_{mesh_name}{suffix}.json".replace(
            "/", "-")
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(rec, f, indent=1, default=str)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run every assigned (arch x shape) cell")
    ap.add_argument("--no-cost", action="store_true",
                    help="skip the LM cost-extrapolation runs (one step "
                         "per cell: success and memory)")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--variant", default="",
                    help="comma-separated switches of the step builders "
                         "(e.g. a2a, delta_c, int8_kv, naive_cache)")
    args = ap.parse_args(argv)
    variant = tuple(v for v in args.variant.split(",") if v)

    from repro_torch.configs.registry import all_cells

    if args.all:
        cells = all_cells()
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        cells = [(args.arch, args.shape)]

    n_fail = 0
    for arch_id, shape in cells:
        rec = run_cell(arch_id, shape, multi_pod=args.multipod,
                       out_dir=args.out, with_cost=not args.no_cost,
                       variant=variant)
        n_fail += 0 if rec["ok"] else 1
    print(f"dry-run complete: {len(cells) - n_fail}/{len(cells)} cells green")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
