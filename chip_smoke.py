#!/usr/bin/env python3
"""Drive the PyTorch port of GVE-Louvain on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--scale 22]

Run from the root of a checkout (it imports ``src/repro_torch``).  Phases,
each timed; any failure exits non-zero:

  1. build the CUDA kernels (one nvcc per source, started together) and
     print each kernel's ``-Xptxas -v`` report and the card's power limit;
  2. hold each kernel (K1, K2, K3) against its plain PyTorch version on the
     card, on random tiles and on the real tiles of phase 4's graph;
  3. reproduce the committed ``single__sbm`` and ``ell__sbm`` goldens;
  4. run ``louvain()`` on an R-MAT graph at scale 22, edge factor 16
     (4,194,304 vertices, ~128M directed slots): the ELL path with the
     fused kernel K1 and the aggregation kernel K3, then the scan-only
     kernel K2, then the default ``louvain()`` (sort-reduce scan + K3);
     every kernel of each path must have launched.

The line before the last is a JSON object with each kernel's launches,
error against its plain version, time, plain time and bound; the last line
is ``{"ok": true, "device": {...}}``.  Exits with code 2, printing no
result, when no CUDA device is available or the port is not importable.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "golden", "engine_memberships.npz")

#: R-MAT edge factor of phase 4 (Graph500's 16).
EDGE_FACTOR = 16

#: H100 SXM data-sheet peaks: HBM bandwidth, float32 outside tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

KERNELS = {
    "louvain_fused": ("src/repro_torch/csrc/louvain_scan.cu",
                      "src/repro/kernels/louvain_scan/fused.py:111"),
    "louvain_scan": ("src/repro_torch/csrc/louvain_scan.cu",
                     "src/repro/kernels/louvain_scan/louvain_scan.py:90"),
    "coarsen_groups": ("src/repro_torch/csrc/coarsen.cu",
                       "src/repro/kernels/aggregate/coarsen.py:113"),
}


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


class Failure(Exception):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise Failure(what)


def time_ms(torch, fn, iters: int, warmup: int = 1) -> float:
    """Mean milliseconds per call on the card (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# Phase 2 inputs: random tiles with ties, dead slots, all-dead and pad rows.
# ---------------------------------------------------------------------------

def random_tiles(torch, rng, n_rows: int, d: int, integer_w: bool,
                 sentinel: int, dev):
    n_ids = max(4, d // 4)
    c = rng.integers(0, n_ids, (n_rows, d)).astype(np.int32)
    dead = rng.random((n_rows, d)) < 0.3
    dead[n_rows // 4: n_rows // 4 + 8] = True          # all-dead rows
    dead[-8:] = True                                   # pad rows
    c[dead] = -1
    if integer_w:
        w = rng.integers(1, 4, (n_rows, d)).astype(np.float32)
    else:
        w = (rng.random((n_rows, d)) + 0.05).astype(np.float32)
    w[dead] = 0.0
    sig_tab = rng.integers(1, 60, n_ids).astype(np.float32)
    size_tab = rng.integers(1, 3, n_ids).astype(np.int32)
    live = c >= 0
    sigma_nbr = np.where(live, sig_tab[np.maximum(c, 0)], 0).astype(np.float32)
    size_nbr = np.where(live, size_tab[np.maximum(c, 0)], 0).astype(np.int32)
    c_own = rng.integers(0, n_ids, (n_rows, 1)).astype(np.int32)
    k_i = rng.integers(1, 20, (n_rows, 1)).astype(np.float32)
    sigma_own = (sig_tab[c_own[:, 0]][:, None] + k_i).astype(np.float32)
    size_own = size_tab[c_own[:, 0]][:, None].astype(np.int32)
    rows = rng.integers(-2 ** 31, 2 ** 31 - 1, (n_rows, 1)).astype(np.int32)
    rows[-8:] = sentinel
    front = rng.integers(0, 2, (n_rows, 1)).astype(np.int32)
    front[-8:] = 0
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    scan_ins = [t(x) for x in (c, w, sigma_nbr, k_i, c_own, sigma_own)]
    fused_ins = [t(x) for x in (c, w, sigma_nbr, size_nbr, k_i, c_own,
                                sigma_own, size_own, rows, front)]
    m = torch.tensor(float(rng.integers(200, 900)), dtype=torch.float32,
                     device=dev)
    return scan_ins, fused_ins, m


def compare_scan(torch, kernels, scan_ins, fused_ins, m, round_ix: int,
                 gate_fraction: int, sentinel: int, exact: bool):
    """K1 and K2 against their plain versions on one tile; returns the
    largest |dQ| difference over rows where both are finite."""
    ops, ref, fused_mod = kernels
    got = ops.louvain_scan(*scan_ins, m)
    want = ref.louvain_scan_ref(*scan_ins, m)
    fgot = ops.louvain_fused(*fused_ins, m, round_ix,
                             gate_fraction=gate_fraction, sentinel=sentinel)
    fwant = fused_mod.louvain_fused_ref(*fused_ins, m, round_ix,
                                        gate_fraction=gate_fraction,
                                        sentinel=sentinel)
    torch.cuda.synchronize()
    err = 0.0
    for a, b in ((got[1], want[1]), (fgot[1], fwant[1])):
        fin = torch.isfinite(a) & torch.isfinite(b)
        require(torch.equal(torch.isfinite(a), torch.isfinite(b)),
                "K1/K2: rows with a candidate differ from the plain version")
        if bool(fin.any()):
            err = max(err, float((a[fin] - b[fin]).abs().max()))
    if exact:
        require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                "K2 differs from its plain version")
        require(all(torch.equal(x, y) for x, y in zip(fgot, fwant)),
                "K1 differs from its plain version")
    else:
        # Float weights: the kernel mirrors the plain arithmetic, so agree
        # to 1e-6 relative at least, and on ids wherever dQ agrees exactly.
        fin = torch.isfinite(want[1])
        scale = float(want[1][fin].abs().max()) if bool(fin.any()) else 0.0
        require(err <= 1e-6 * scale,
                f"K1/K2 dQ off by {err} on float weights")
        same = got[1] == want[1]
        require(torch.equal(got[0][same], want[0][same]),
                "K2 ids differ where dQ agrees")
    return err


# ---------------------------------------------------------------------------
# Phases.
# ---------------------------------------------------------------------------

def card_name_and_power_limit() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def phase_build(torch):
    from repro_torch.kernels import _build
    log("build", f"card {card_name_and_power_limit()}")
    t = time.perf_counter()
    logs = _build.build()
    for name, text in logs.items():
        for line in text.splitlines():
            if "ptxas" in line or "spill" in line or "registers" in line:
                log("build", f"{name}: {line.strip()}")
    log("build", f"kernels built in {time.perf_counter() - t:.2f} s")
    log("build", f"device {torch.cuda.get_device_name(0)}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")


def phase_kernels_random(torch, kernels, dev):
    rng = np.random.default_rng(12)
    sentinel = 1 << 20
    err = 0.0
    for d, n_rows in ((16, 4096), (64, 2048), (256, 512)):
        for integer_w in (True, False):
            for gf in (1, 2, 4):
                scan_ins, fused_ins, m = random_tiles(
                    torch, rng, n_rows, d, integer_w, sentinel, dev)
                round_ix = int(rng.integers(0, 1 << 30))
                err = max(err, compare_scan(
                    torch, kernels, scan_ins, fused_ins, m, round_ix, gf,
                    sentinel, exact=integer_w))
        log("kernels", f"K1/K2 d={d}: {n_rows} rows x 6 tiles, exact on "
            f"integer weights, max |dQ - plain| {err:.3e} on float weights "
            f"(gate_fraction 1/2/4)")

    from repro_torch.kernels.aggregate import coarsen
    for total, n_ids in ((0, 4), (5000, 30), (300001, 700)):
        keys = np.sort(rng.integers(0, n_ids * n_ids, total))
        ci = (keys // n_ids).astype(np.int32)
        cj = (keys % n_ids).astype(np.int32)
        tail = total // 10
        if tail:
            ci[-tail:] = n_ids
            cj[-tail:] = n_ids
        w = rng.integers(1, 5, total).astype(np.float32)
        t = [torch.from_numpy(x).to(dev) for x in (ci, cj, w)]
        got = coarsen.coarsen_groups(*t, sent=n_ids)
        want = coarsen.coarsen_groups_ref(*t, sent=n_ids)
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(got, want)),
                f"K3 differs from its plain version on {total} slots")
        log("kernels", f"K3: exact on {total} sorted slots "
            f"({int(got[0].sum())} groups)")
    return err


def phase_goldens(torch, dev):
    from repro_torch import LouvainConfig, louvain, sbm_graph
    gold = np.load(GOLDEN)
    g, _ = sbm_graph(8, 16, 0.4, 0.01, seed=2, device=dev)
    cases = (("single__sbm", LouvainConfig()),
             ("single__sbm", LouvainConfig(agg_backend="sort")),
             ("ell__sbm", LouvainConfig(use_ell_kernel=True)),
             ("ell__sbm", LouvainConfig(scan_backend="ell")))
    for key, cfg in cases:
        res = louvain(g, cfg)
        require(np.array_equal(res.membership, gold[key]),
                f"{key} not reproduced with scan_backend="
                f"{cfg.scan_backend} use_ell_kernel={cfg.use_ell_kernel}")
    log("goldens", f"single__sbm and ell__sbm reproduced element for element "
        f"({len(cases)} configurations)")


def check_result(torch, res, n: int, what: str) -> None:
    """Finite, well-formed output: memberships of the right shape, each
    dendrogram level a coarsening of the one before."""
    require(res.membership.shape == (n,), f"{what}: membership shape")
    require(res.n_communities == len(np.unique(res.membership)),
            f"{what}: community count")
    prev = np.arange(n, dtype=np.int64)
    for lvl in res.levels:
        pairs = np.unique(prev * n + lvl).shape[0]
        require(pairs == len(np.unique(prev)),
                f"{what}: a level is not a coarsening of the one before")
        prev = lvl.astype(np.int64)


def modularity64(torch, g, membership) -> float:
    """Q in float64 on the card, the yardstick for the float32 Q."""
    comm = torch.full((g.n_cap + 1,), g.n_cap, dtype=torch.int64,
                      device=g.device)
    comm[: len(membership)] = torch.from_numpy(membership).to(g.device)
    w = g.weights.to(torch.float64)
    m = float(w.sum()) / 2
    internal = float(w[comm[g.src.long()] == comm[g.indices.long()]].sum())
    k = torch.zeros(g.n_cap + 1, dtype=torch.float64,
                    device=g.device).index_add_(0, g.src.long(), w)
    sig = torch.zeros(g.n_cap + 1, dtype=torch.float64,
                      device=g.device).index_add_(0, comm[:g.n_cap],
                                                  k[:g.n_cap])
    return internal / (2 * m) - float(((sig / (2 * m)) ** 2).sum())


def real_tile_state(torch, g, membership=None):
    """(comm, sigma, sizes, front) of the first round (singletons) or of the
    end of pass 0 (``membership``)."""
    from repro_torch.core.graph import segment_sum
    from repro_torch.core.modularity import community_weights
    dev, n_cap = g.device, g.n_cap
    valid = torch.arange(n_cap + 1, device=dev) < g.n_valid
    if membership is None:
        comm = torch.arange(n_cap + 1, dtype=torch.int32, device=dev)
        sigma = g.vertex_weights()
    else:
        comm = torch.full((n_cap + 1,), n_cap, dtype=torch.int32, device=dev)
        comm[: len(membership)] = torch.from_numpy(
            membership.astype(np.int32)).to(dev)
        sigma = community_weights(g, comm)
    sizes = segment_sum(valid.to(torch.int32), comm, n_cap + 1)
    return comm, sigma, sizes, valid


def phase_full(torch, kernels, args, dev, report):
    from repro_torch import LouvainConfig, louvain, membership_modularity
    from repro_torch import rmat_graph
    from repro_torch.core.graph import to_ell_blocks
    from repro_torch.kernels.aggregate import coarsen
    ops, ref, fused_mod = kernels
    launch_fns = {"louvain_fused": ops.louvain_fused,
                  "louvain_scan": ops.louvain_scan,
                  "coarsen_groups": coarsen.coarsen_groups}

    t = time.perf_counter()
    g = rmat_graph(args.scale, EDGE_FACTOR, seed=0, device=dev)
    torch.cuda.synchronize()
    n, e = g.n_valid, g.e_valid
    log("full", f"R-MAT scale {args.scale} edge factor {EDGE_FACTOR}: "
        f"{n} vertices, {e} directed slots, built in "
        f"{time.perf_counter() - t:.2f} s")

    def drive(cfg, needs, what):
        for fn in launch_fns.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        res = louvain(g, cfg)
        counts = {k: fn.launches for k, fn in launch_fns.items()}
        for i, p in enumerate(res.passes):
            log("full", f"{what} pass {i}: n_cap {p.n_cap} e_cap {p.e_cap} "
                f"iterations {p.iterations} communities {p.n_communities} "
                f"phase_s " + json.dumps(
                    {k: round(v, 6) for k, v in p.phase_seconds.items()}))
        q = membership_modularity(g, res.membership)
        q64 = modularity64(torch, g, res.membership)
        log("full", f"{what}: {res.n_passes} passes, {res.n_communities} "
            f"communities, Q {q:.6f} (float64 {q64:.6f}), "
            f"{res.total_seconds:.3f} s, {e / res.total_seconds:.4e} edges/s, "
            f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
            f"launches {json.dumps(counts)}")
        for k in needs:
            require(counts[k] > 0, f"{what}: kernel {k} never launched")
        check_result(torch, res, n, what)
        require(np.isfinite(q) and abs(q - q64) < 1e-4,
                f"{what}: Q {q} disagrees with float64 Q {q64}")
        return res, counts

    res, counts_a = drive(LouvainConfig(use_ell_kernel=True),
                          ("louvain_fused", "coarsen_groups"),
                          "louvain(use_ell_kernel=True)")
    res_b, counts_b = drive(LouvainConfig(scan_backend="ell"),
                            ("louvain_scan", "coarsen_groups"),
                            "louvain(scan_backend='ell')")
    require(np.array_equal(res.membership, res_b.membership),
            "the K1 and K2 paths give different memberships")
    res_c, _ = drive(LouvainConfig(use_ell_kernel=True),
                     ("louvain_fused", "coarsen_groups"),
                     "louvain(use_ell_kernel=True), again")
    require(np.array_equal(res.membership, res_c.membership),
            "a second run of the K1 path gives another membership")
    log("full", "the K1 and K2 paths, and a second K1 run, give equal "
        "memberships")
    # The default configuration: the sort-reduce scan over every slot, K3.
    res_d, _ = drive(LouvainConfig(), ("coarsen_groups",), "louvain()")
    log("full", "louvain() membership equals the ELL paths': "
        f"{np.array_equal(res.membership, res_d.membership)}")
    del res_b, res_c, res_d

    # K1/K2 on the real tiles: round 0 (singletons) and the end of pass 0.
    widths = LouvainConfig().ell_widths
    blocks, leftover = to_ell_blocks(g, widths)
    k, m, n_cap = g.vertex_weights(), g.total_weight(), g.n_cap
    err = 0.0
    for label, mem in (("round 0", None), ("end of pass 0", res.levels[0])):
        comm, sigma, sizes, front = real_tile_state(torch, g, mem)
        for b in blocks:
            scan_ins = ops.prepare_ell_inputs(b, comm, sigma, k, n_cap)
            fused_ins = ops.prepare_fused_inputs(b, comm, sigma, sizes, k,
                                                 front, n_cap)
            err = max(err, compare_scan(torch, kernels, scan_ins, fused_ins,
                                        m, 1, 2, n_cap, exact=True))
        log("kernels", f"K1/K2 {label}: exact on ELL rows "
            f"{[b.rows.numel() for b in blocks]} at widths {list(widths)}")

    comm, sigma, sizes, front = real_tile_state(torch, g)
    fused_all = [ops.prepare_fused_inputs(b, comm, sigma, sizes, k, front,
                                          n_cap) for b in blocks]
    scan_all = [ops.prepare_ell_inputs(b, comm, sigma, k, n_cap)
                for b in blocks]
    k1 = lambda: [ops.louvain_fused(*x, m, 1, gate_fraction=2,
                                    sentinel=n_cap) for x in fused_all]
    k1p = lambda: [fused_mod.louvain_fused_ref(*x, m, 1, gate_fraction=2,
                                               sentinel=n_cap)
                   for x in fused_all]
    k2 = lambda: [ops.louvain_scan(*x, m) for x in scan_all]
    k2p = lambda: [ref.louvain_scan_ref(*x, m) for x in scan_all]
    times = {"louvain_fused": (time_ms(torch, k1, 10), time_ms(torch, k1p, 2)),
             "louvain_scan": (time_ms(torch, k2, 10), time_ms(torch, k2p, 2))}
    # Least bytes, counted on this round's data: the id c of every ELL slot
    # (it marks the padding, c = -1), w of every occupied slot (c >= 0),
    # Sigma (K1: and |c|) of every candidate slot (c >= 0, c != c_own);
    # the per-row inputs once (K1 24 B, K2 12 B), the outputs once (K1 12 B,
    # K2 8 B), and m.  Least operations: one compare and one add per
    # (candidate slot, slot of its row).
    slots = sum(x[0].numel() for x in fused_all)
    occupied = sum(int((x[0] >= 0).sum()) for x in fused_all)
    cand = [int(((x[0] >= 0) & (x[0] != x[5])).sum()) for x in fused_all]
    n_rows = sum(x[0].shape[0] for x in fused_all)
    ops_count = 2 * sum(cv * x[0].shape[1] for cv, x in zip(cand, fused_all))
    b1 = 4 * slots + 4 * occupied + 8 * sum(cand) + 36 * n_rows + 4
    b2 = 4 * slots + 4 * occupied + 4 * sum(cand) + 20 * n_rows + 4
    bounds = {"louvain_fused": b1, "louvain_scan": b2}
    log("full", f"ELL slots {slots}: occupied {occupied}, candidates "
        f"{sum(cand)}, padding {1 - occupied / slots:.4f} of the slots; "
        f"{n_rows} rows")
    log("full", f"one round over {len(blocks)} ELL blocks: K1 "
        f"{times['louvain_fused'][0]:.4f} ms (plain "
        f"{times['louvain_fused'][1]:.4f} ms), K2 "
        f"{times['louvain_scan'][0]:.4f} ms (plain "
        f"{times['louvain_scan'][1]:.4f} ms); least bytes K1 {b1} K2 {b2}, "
        f"least operations {ops_count}")

    # Where one fused round's time goes (round 0 of pass 0).
    from repro_torch.core.ell_move import FusedELLScanner
    from repro_torch.core.engine import EngineConfig, MoveEngine, MoveState
    scanner = FusedELLScanner(g, blocks, leftover, k, m, gate_fraction=2)
    engine = MoveEngine(scanner, EngineConfig())
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    st0 = MoveState(comm, sigma, front, 0, zero, zero)
    t_round = time_ms(torch, lambda: engine.one_round(st0, front, 0), 3)
    t_prep = time_ms(torch, lambda: [
        ops.prepare_fused_inputs(b, comm, sigma, sizes, k, front, n_cap)
        for b in blocks], 3)
    t_hub = (time_ms(torch, lambda: scanner._hub_scan(comm, sigma, front), 3)
             if leftover.numel() else 0.0)
    hub_slots = scanner._hub_slots[0].numel() if leftover.numel() else 0
    t_k1 = times["louvain_fused"][0]
    log("full", f"one fused round: {t_round:.4f} ms = ELL gathers "
        f"{t_prep:.4f} + K1 {t_k1:.4f} + hub fallback {t_hub:.4f} "
        f"({leftover.numel()} hub vertices, {hub_slots} of {e} slots) "
        f"+ engine apply {t_round - t_prep - t_hub - t_k1:.4f}")
    del scanner, engine, fused_all, scan_all

    # K3 on the first aggregation's sorted slot list.
    comm0 = torch.full((n_cap + 1,), n_cap, dtype=torch.int32, device=dev)
    comm0[:n] = torch.from_numpy(res.levels[0].astype(np.int32)).to(dev)
    ci, cj = comm0[g.src], comm0[g.indices]
    key = ci.to(torch.int64) * (n_cap + 1) + cj.to(torch.int64)
    order = torch.sort(key, stable=True).indices
    s_ci, s_cj, s_w = ci[order], cj[order], g.weights[order]
    del key, order, ci, cj
    got = coarsen.coarsen_groups(s_ci, s_cj, s_w, sent=n_cap)
    want = coarsen.coarsen_groups_ref(s_ci, s_cj, s_w, sent=n_cap)
    torch.cuda.synchronize()
    require(all(torch.equal(a, b) for a, b in zip(got, want)),
            "K3 differs from its plain version on the first aggregation")
    k3_err = float((got[4] - want[4]).abs().max())
    log("kernels", f"K3 first aggregation: exact on {s_ci.numel()} slots, "
        f"{int(got[0].sum())} groups")
    del got, want
    times["coarsen_groups"] = (
        time_ms(torch, lambda: coarsen.coarsen_groups(s_ci, s_cj, s_w,
                                                      sent=n_cap), 10),
        time_ms(torch, lambda: coarsen.coarsen_groups_ref(s_ci, s_cj, s_w,
                                                          sent=n_cap), 3))
    total = s_ci.numel()
    bounds["coarsen_groups"] = 12 * total + 17 * (total + 1)
    log("full", f"K3 on {total} slots: {times['coarsen_groups'][0]:.4f} ms "
        f"(plain {times['coarsen_groups'][1]:.4f} ms)")

    op_counts = {"louvain_fused": ops_count, "louvain_scan": ops_count,
                 "coarsen_groups": total}
    launches = {"louvain_fused": counts_a["louvain_fused"],
                "louvain_scan": counts_b["louvain_scan"],
                "coarsen_groups": counts_a["coarsen_groups"]}
    errs = {"louvain_fused": err, "louvain_scan": err,
            "coarsen_groups": k3_err}
    for name, (source, replaces) in KERNELS.items():
        t_bytes = bounds[name] / HBM_BYTES_PER_S * 1e3
        t_ops = op_counts[name] / FP32_OPS_PER_S * 1e3
        report.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": times[name][0],
            "plain_ms": times[name][1], "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=22,
                    help="R-MAT scale of phase 4 (2^scale vertices)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    try:
        from repro_torch.kernels.louvain_scan import fused, ops, ref
    except ImportError as exc:
        print(f"chip_smoke: run from the root of a checkout ({exc})",
              file=sys.stderr)
        return 2
    kernels = (ops, ref, fused)
    dev = torch.device("cuda")
    report = []
    t_all = time.perf_counter()
    try:
        for name, fn in (("build", lambda: phase_build(torch)),
                         ("kernels", lambda: phase_kernels_random(
                             torch, kernels, dev)),
                         ("goldens", lambda: phase_goldens(torch, dev)),
                         ("full", lambda: phase_full(torch, kernels, args,
                                                     dev, report))):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            log(name, f"phase done in {time.perf_counter() - t:.2f} s")
    except Failure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    log("done", f"{time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": report}))
    print(card_name_and_power_limit())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
