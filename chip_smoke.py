#!/usr/bin/env python3
"""Drive the PyTorch port of GVE-Louvain on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--scale 22] [--streams 16] [--stream-scale 18]

Run from the root of a checkout (it imports ``src/repro_torch``).  Phases,
each timed; any failure exits non-zero:

  1. build the CUDA kernels (one nvcc per source, started together) and
     print each kernel's ``-Xptxas -v`` report and the card's power limit;
  2. hold each kernel (K1, K2, K3, K4) against its plain PyTorch version on
     the card, bit for bit: K1/K2 on random CSR buckets (degrees 0 to 256,
     self-loop rows, one-community rows, exact ties, integer and float
     weights) and, for their one-row-per-block layouts, on buckets of a
     width in (1024, 4096], of 16,384 (shared memory) and of 32,768 (global
     scratch), integer and float weights; K3/K4 on random sorted slot lists
     (groups over hundreds of 4096-slot tiles; K3 on float weights within
     m * 2^-23 * sum |w| over the m slots summed), each also bit-identical
     over repeated calls; then all four on the real inputs of phases 4 and
     5 (K3 and K4 there over 20 more calls, which is what catches a
     look-back race);
  3. reproduce the committed ``single__sbm``, ``ell__sbm`` and
     ``dynamic__sbm_stream`` goldens (the last with K4 on every batch), and
     with ``refine="leiden"`` ``single_leiden__sbm``, ``ell_leiden__sbm``
     (through K1 and through K2) and ``dynamic_leiden__sbm_stream``;
  4. run ``louvain()`` on an R-MAT graph at scale 22, edge factor 16
     (4,194,304 vertices, ~128M directed slots): the ELL path with the
     fused kernel K1 and the aggregation kernel K3, then the scan-only
     kernel K2, then the default ``louvain()`` (sort-reduce scan + K3);
     every kernel of each path must have launched, and all give one
     membership; then K1/K2 per round against their bounds and the round's
     breakdown; then Leiden refinement through K1 (Q against
     refine="none", connectivity audits with scipy:
     no more disconnected communities than refine="none", and a refine
     phase's communities each inside one outer community); then
     ``ell_widths=(16, 64, 256, 2048, 32768)`` through K1 and K2, whose
     2048-wide bucket takes the one-row-per-block layout in shared memory
     and whose 32768-wide bucket (the hub rows of degree 2049 to 32768)
     the one in global scratch (one membership, that of the default
     widths; every row of those buckets bit-equal to the plain versions;
     their times, plain times and bounds);
  5. stream 8 edge batches of 1e-4 |E| (80% inserts of held-out edges, 20%
     deletions) through ``louvain_dynamic()`` on phase 4's graph, applied
     by the batch-apply kernel K4; the final graph must equal the host CSR
     of the final edge set and a run with the sort backend, and Q must stay
     within 1% of a cold ``louvain()`` on the final graph;
  6. serve a fleet of ``--streams`` R-MAT tenants (scale ``--stream-scale``,
     default 16 at scale 18, ~8M directed slots each, one shared envelope)
     through the batched drivers: the cold ``louvain_batched`` (refine
     "none" and "leiden") must equal each solo tenant's ``louvain()`` with K3
     launched once per fleet aggregation; ``louvain_dynamic_batched`` over
     8 steps of phase 5's mix per tenant must equal each tenant's
     ``louvain_dynamic()`` (membership, final graph, frontier sizes) with
     K4 launched once per step; fleet K3/K4 held against their plain
     versions on the fleet's flat, stream-keyed slot lists (and over 20
     more calls); the sbm goldens through a one-stream fleet; a fleet that
     overflows its envelope regrows and equals the amply provisioned one;
  7. the sharded drivers over ``torch.distributed``: (a) through NCCL at
     world size 1 on the card, the ``sharded__sbm`` and
     ``sharded_leiden__sbm`` goldens under the gather and the delta
     exchange and the replicated and the hybrid state layout, and the
     ``sharded_dynamic__sbm_stream`` / ``sharded_dynamic_leiden__sbm_stream``
     goldens through ``louvain_dynamic_sharded`` (both layouts, K4 once
     per batch); (b) phase 4's R-MAT graph at world size 1 (NCCL, gather),
     which must give phase 4's ``louvain()`` membership, with K3 launched
     twice per sharded aggregation and both launches of the first one
     held against the plain version; (c) one launch of 4 gloo ranks on
     the one card (collectives staged through pinned host memory; their
     wall time is no multi-GPU number) at R-MAT scale ``--sharded-scale``:
     gather, delta and the hybrid layout under both, equal to world size
     1; ``reshard="auto"`` within the reference's quality parity of
     ``reshard="none"``; and phase 5's stream recipe on that graph through
     ``louvain_dynamic_sharded``, equal to world size 1;
  8. phase 5's stream once more through ``louvain_dynamic_sharded`` at
     world size 1 (NCCL, gather, replicated): its final membership must be
     phase 5's, with K4 launched once per batch in the rank's apply, and
     that K4 launch of the first batch held against its plain version;
  9. the multi-tenant sharded serving fleet (``serve_fleet``,
     ``FleetRouter``) through NCCL at world size 1: (a) the
     ``sharded_dynamic__sbm_stream`` golden through one- and two-tenant
     fleets under both state layouts, K4 once per bucket dispatch; (b) a
     whale that migrates buckets beside its buddy, and a configuration
     whose lanes replay through the solo pass loop (K3 in the replays),
     every tenant equal to its solo ``louvain_dynamic_sharded``; (c) phase
     6's tenants admitted with their cold memberships into one envelope
     and served 8 steps (one K4 launch per step over all 16 lanes, the
     first held against its plain version bit for bit and over 20 more
     calls), each ending on its phase 6 stream membership; (d) the fleet
     run of phase 7's staged launch (two tenants of its stream on 4 gloo
     ranks) equal to that launch's ``louvain_dynamic_sharded`` stream.

Cut for time: phase 4's Leiden route through K2 (its ``ell_leiden__sbm``
golden through K2 stays in phase 3), and phase 6's solo comparison to the
first ``SOLO_TENANTS`` (4) of the 16 tenants.

The line before the last is a JSON object with each kernel's launches,
error against its plain version, time, plain time and bound; the last line
is ``{"ok": true, "device": {...}}``.  Exits with code 2, printing no
result, when no CUDA device is available or the port is not importable.
"""

from __future__ import annotations

import argparse
import contextlib
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
    # K1/K2 in their one-row-per-block layout (widths above 1024).
    "louvain_fused_cta": ("src/repro_torch/csrc/louvain_scan.cu",
                          "src/repro/kernels/louvain_scan/fused.py:111"),
    "louvain_scan_cta": ("src/repro_torch/csrc/louvain_scan.cu",
                         "src/repro/kernels/louvain_scan/louvain_scan.py:90"),
    "coarsen_groups": ("src/repro_torch/csrc/coarsen.cu",
                       "src/repro/kernels/aggregate/coarsen.py:113"),
    "resolve_groups": ("src/repro_torch/csrc/batch_apply.cu",
                       "src/repro/kernels/batch_apply/resolve.py:134"),
    # K3/K4 launched once per fleet operation over a fleet's flat,
    # stream-keyed slot list (phase 6).
    "coarsen_groups_fleet": ("src/repro_torch/csrc/coarsen.cu",
                             "src/repro/kernels/aggregate/coarsen.py:113"),
    # K1/K2 in their one-row-per-block layout in global scratch (widths
    # above 16,384).
    "louvain_fused_wide": ("src/repro_torch/csrc/louvain_scan.cu",
                           "src/repro/kernels/louvain_scan/fused.py:111"),
    "louvain_scan_wide": ("src/repro_torch/csrc/louvain_scan.cu",
                          "src/repro/kernels/louvain_scan/louvain_scan.py:90"),
    # K3 in the sharded aggregation (phase 7): the local partial reduce and
    # the owner-side re-reduce, two launches per aggregation.
    "coarsen_groups_sharded": ("src/repro_torch/csrc/coarsen.cu",
                               "src/repro/kernels/aggregate/coarsen.py:113"),
    "resolve_groups_fleet": ("src/repro_torch/csrc/batch_apply.cu",
                             "src/repro/kernels/batch_apply/resolve.py:134"),
    # K4 in one rank's batch apply of the sharded stream (phase 8).
    "resolve_groups_sharded": ("src/repro_torch/csrc/batch_apply.cu",
                               "src/repro/kernels/batch_apply/resolve.py:134"),
    # K4 once per rank and bucket dispatch of the sharded serving fleet,
    # over the bucket's flat, lane-keyed slot list (phase 9).
    "resolve_groups_fleet_sharded": (
        "src/repro_torch/csrc/batch_apply.cu",
        "src/repro/kernels/batch_apply/resolve.py:134"),
}

#: Phase 5: the batch mix of the DF-Louvain dynamic evaluation (Sahu,
#: arXiv 2404.19634: 80% insertions, 20% deletions) at a batch size of
#: 1e-4 |E|, with 1e-3 |E| of the undirected edges held out to insert.
STREAM_BATCHES = 8
STREAM_B_CAP = 8192

#: Phase 4's wide-row run: the default widths plus a 2048-wide bucket
#: (degrees 257 to 2048), which K1/K2 scan one row per block in shared
#: memory, and a 32768-wide one (degrees 2049 to 32768), one row per block
#: in global scratch.
F1_WIDTHS = (16, 64, 256, 2048, 32768)

#: Slots per call of the plain K1/K2 over those buckets: (rows, width)
#: tiles of a few hundred MB each.
PLAIN_CHUNK_SLOTS = 8192 * 2048

#: Phase 6: the tenants also served alone (their solo runs are the
#: comparison; the fleet holds all ``--streams``, and phase 9 carries every
#: tenant's fleet membership through a second driver).
SOLO_TENANTS = 4

#: Phase 7: ranks and R-MAT seed of the staged gloo run on the one card,
#: and the batch capacity of its stream (phase 5's recipe at that scale).
SHARDED_RANKS = 4
SHARDED_SEED = 7
SHARDED_STREAM_B_CAP = 512

#: Phase 6: a serving fleet of R-MAT tenants (Graph500 a/b/c), seeds from
#: FLEET_SEED0, each with phase 5's stream mix: STREAM_BATCHES steps of
#: 1e-4 |E| entries, 80% inserts of held-out edges, 20% deletions.
FLEET_SEED0 = 100
RMAT_ABC = (0.57, 0.19, 0.19)


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
# Phase 2 inputs: random CSR buckets with ties, self loops, dead slots and
# pad rows.
# ---------------------------------------------------------------------------

#: Degrees every random CSR holds (three rows each, where they fit).
SPECIAL_DEGREES = (0, 1, 16, 17, 32, 33, 64, 65, 256)


def random_csr(torch, rng, n: int, max_deg: int, integer_w: bool, dev):
    """A random CSR of ``n`` vertices (``n_cap = n + 8``), its per-vertex
    state and its degrees.  Rows hit every degree of ``SPECIAL_DEGREES`` up
    to ``max_deg``; vertex 0 and 1 hold only self loops, vertex 2 only
    neighbours of one community, vertex 3 an exact dQ tie between two
    communities; 1% of the slots hold the sentinel column (dead)."""
    n_cap = n + 8
    n_ids = max(8, n // 6)
    lo = rng.random(n) < 0.7
    deg = np.where(lo, rng.integers(0, 17, n),
                   rng.integers(min(17, max_deg), max_deg + 1, n))
    special = [d for d in SPECIAL_DEGREES if d <= max_deg]
    deg[8:8 + 3 * len(special)] = np.repeat(special, 3)
    deg[0], deg[2], deg[3] = 16, min(max_deg, 200), 2
    deg[1] = 65 if max_deg >= 65 else max_deg
    comm = np.arange(n_cap + 1, dtype=np.int32)
    comm[:n] = rng.integers(0, n_ids, n)
    indptr = np.zeros(n_cap + 1, np.int64)
    indptr[1:n + 1] = np.cumsum(deg)
    indptr[n + 1:] = indptr[n]
    cols = rng.integers(0, n, int(indptr[n])).astype(np.int32)
    for v in (0, 1):
        cols[indptr[v]:indptr[v + 1]] = v
    members = np.flatnonzero(comm[:n] == comm[5])
    cols[indptr[2]:indptr[3]] = rng.choice(members, deg[2])
    a, b = (np.flatnonzero(comm[:n] == c)[0]
            for c in np.unique(comm[10:n])[:2])
    cols[indptr[3]:indptr[4]] = [a, b]
    comm[3] = n_ids
    cols[rng.random(len(cols)) < 0.01] = n_cap
    if integer_w:
        w = rng.integers(1, 4, len(cols)).astype(np.float32)
    else:
        w = (rng.random(len(cols)) + 0.05).astype(np.float32)
    w[indptr[3]:indptr[4]] = 2.0
    sigma = (rng.integers(1, 4, n_cap + 1) * 4).astype(np.float32)
    sigma[comm[b]] = sigma[comm[a]]
    sizes = np.where(rng.random(n_cap + 1) < 0.7, 1, 2).astype(np.int32)
    k = rng.integers(1, 6, n_cap + 1).astype(np.float32)
    front = rng.random(n_cap + 1) < 0.7
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    csr = (t(indptr.astype(np.int32)), t(cols), t(w))
    state = dict(comm=t(comm), sigma=t(sigma), sizes=t(sizes), k=t(k),
                 front=t(front))
    m = torch.tensor(float(rng.integers(40, 900)), dtype=torch.float32,
                     device=dev)
    return csr, state, deg, m


def wide_csr(torch, rng, n: int, degs, integer_w: bool, dev):
    """A random CSR of ``n`` vertices for the one-row-per-block layout:
    vertices 8 .. 8 + len(degs) - 1 have the degrees ``degs``, the others
    0 .. 16; vertex 0 (only self loops) and vertex 1 (only neighbours of
    one community) have degree degs[0], vertex 2 an exact dQ tie between
    two communities over degs[1] slots.  Returns what ``random_csr``
    returns."""
    n_cap = n + 8
    n_ids = max(8, n // 6)
    deg = rng.integers(0, 17, n)
    deg[8:8 + len(degs)] = degs
    deg[0] = deg[1] = degs[0]
    deg[2] = degs[1] - degs[1] % 2
    comm = np.arange(n_cap + 1, dtype=np.int32)
    comm[:n] = rng.integers(0, n_ids, n)
    indptr = np.zeros(n_cap + 1, np.int64)
    indptr[1:n + 1] = np.cumsum(deg)
    indptr[n + 1:] = indptr[n]
    cols = rng.integers(0, n, int(indptr[n])).astype(np.int32)
    cols[rng.random(len(cols)) < 0.01] = n_cap
    cols[indptr[0]:indptr[1]] = 0
    members = np.flatnonzero(comm[:n] == comm[5])
    cols[indptr[1]:indptr[2]] = rng.choice(members, deg[1])
    a, b = (10 + np.flatnonzero(comm[10:n] == c)[0]
            for c in np.unique(comm[10:n])[:2])
    half = deg[2] // 2
    cols[indptr[2]:indptr[2] + half] = a
    cols[indptr[2] + half:indptr[3]] = b
    comm[2] = n_ids
    if integer_w:
        w = rng.integers(1, 4, len(cols)).astype(np.float32)
    else:
        w = (rng.random(len(cols)) + 0.05).astype(np.float32)
    w[indptr[2]:indptr[3]] = 1.0
    sigma = (rng.integers(1, 4, n_cap + 1) * 4).astype(np.float32)
    sigma[comm[b]] = sigma[comm[a]]
    sizes = np.where(rng.random(n_cap + 1) < 0.7, 1, 2).astype(np.int32)
    k = rng.integers(1, 6, n_cap + 1).astype(np.float32)
    front = rng.random(n_cap + 1) < 0.9
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    csr = (t(indptr.astype(np.int32)), t(cols), t(w))
    state = dict(comm=t(comm), sigma=t(sigma), sizes=t(sizes), k=t(k),
                 front=t(front))
    m = torch.tensor(float(rng.integers(4000, 90000)), dtype=torch.float32,
                     device=dev)
    return csr, state, deg, m


def bucket_rows(torch, rng, deg, n_cap: int, lo: int, hi: int, dev):
    """Vertices of degree in (lo, hi] (isolated ones too when lo == 0) in
    random order, then 7 pad rows."""
    sel = np.flatnonzero((deg <= hi) & ((deg > lo) | (lo == 0)))
    rows = np.concatenate([rng.permutation(sel), np.full(7, n_cap)])
    return torch.from_numpy(rows.astype(np.int32)).to(dev)


def run_k1_k2(ops, rows, csr, st, m, width: int, round_ix: int,
              gate_fraction: int, sentinel: int, plain: bool):
    """(K2 best_c, K2 best_dq, K1 best_c, K1 best_dq, K1 do_move) of one
    bucket, from the kernels or from their plain versions."""
    scan = ops.louvain_scan_rows_ref if plain else ops.louvain_scan
    fuse = ops.louvain_fused_rows_ref if plain else ops.louvain_fused
    got = scan(rows, *csr, st["comm"], st["sigma"], st["k"], m, width=width)
    fgot = fuse(rows, *csr, st["comm"], st["sigma"], st["sizes"], st["k"],
                st["front"], m, round_ix, width=width,
                gate_fraction=gate_fraction, sentinel=sentinel)
    return list(got) + list(fgot)


def compare_rows(torch, ops, rows, csr, st, m, width: int, round_ix: int,
                 gate_fraction: int, sentinel: int, what: str):
    """K1 and K2 against their plain versions on one bucket, bit for bit;
    returns (the largest |dQ| difference, the kernels' outputs)."""
    got = run_k1_k2(ops, rows, csr, st, m, width, round_ix, gate_fraction,
                    sentinel, plain=False)
    want = run_k1_k2(ops, rows, csr, st, m, width, round_ix, gate_fraction,
                     sentinel, plain=True)
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(got, want)):
        require(a.dtype == b.dtype and torch.equal(a, b),
                f"{'K2' if i < 2 else 'K1'} differs from its plain version "
                f"({what}, output {i})")
    err = 0.0
    for a, b in ((got[1], want[1]), (got[3], want[3])):
        fin = torch.isfinite(a) & torch.isfinite(b)
        if bool(fin.any()):
            err = max(err, float((a[fin] - b[fin]).abs().max()))
    return err, got


def kernel_entry(name: str, launches: int, err: float, ms: float,
                 plain_ms: float, bound_bytes: int, ops: int) -> dict:
    """One kernel's entry of the ``kernels`` line: its bound is the larger
    of its least bytes at the HBM rate and its operations at the float32
    rate.  No single PyTorch call computes any of these functions, so no
    library time."""
    t_bytes = bound_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    source, replaces = KERNELS[name]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


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


def phase_kernels_random(torch, ops, dev):
    rng = np.random.default_rng(12)
    err = 0.0
    for lo, hi, n in ((0, 16, 20000), (16, 64, 12000), (64, 256, 6000),
                      (0, 256, 6000)):
        for integer_w in (True, False):
            for gf in (1, 2, 4):
                csr, st, deg, m = random_csr(torch, rng, n, hi, integer_w,
                                             dev)
                n_cap = st["comm"].numel() - 1
                rows = bucket_rows(torch, rng, deg, n_cap, lo, hi, dev)
                round_ix = int(rng.integers(0, 1 << 30))
                e, _ = compare_rows(torch, ops, rows, csr, st, m, hi,
                                    round_ix, gf, n_cap,
                                    f"random rows of degree ({lo}, {hi}]")
                err = max(err, e)
        log("kernels", f"K1/K2 width {hi}, degrees ({lo}, {hi}]: "
            f"{rows.numel()} rows x 6 random CSRs (integer and float "
            f"weights, gate_fraction 1/2/4) bit for bit; max |dQ - plain| "
            f"{err:.3e}")

    from repro_torch.kernels.louvain_scan.louvain_scan import SMEM_MAX_WIDTH
    # The tie row holds degs[1] rounded down to even slots: above 1024 for
    # every width drawn here.  32768 takes the global-scratch layout.
    for width in (int(rng.integers(1100, 4097)), SMEM_MAX_WIDTH, 32768):
        for integer_w in (True, False):
            degs = [width, width - 1, 1025, min(width, 2049)]
            degs += list(rng.integers(1025, width + 1, 4))
            csr, st, deg, m = wide_csr(torch, rng, 3000, degs, integer_w,
                                       dev)
            n_cap = st["comm"].numel() - 1
            wide = np.flatnonzero((deg > 1024) & (deg <= width))
            narrow = rng.choice(np.flatnonzero(deg <= 16), 10, replace=False)
            rows = torch.from_numpy(np.concatenate([
                rng.permutation(np.concatenate([wide, narrow])),
                np.full(7, n_cap)]).astype(np.int32)).to(dev)
            e, got = compare_rows(torch, ops, rows, csr, st, m, width,
                                  int(rng.integers(0, 1 << 30)), 2, n_cap,
                                  f"random rows of width {width}")
            err = max(err, e)
            r2 = int(torch.nonzero(rows == 2)[0])
            tie = int(torch.unique(st["comm"][csr[1][
                int(csr[0][2]):int(csr[0][3])].long()]).min())
            require(int(got[0][r2]) == tie,
                    f"K2 broke the exact tie of a {deg[2]}-slot row")
        layout = ("global scratch" if width > SMEM_MAX_WIDTH
                  else "shared memory")
        log("kernels", f"K1/K2 one row per block ({layout}), width {width}: "
            f"{len(wide)} rows of degree (1024, {width}] (self-loop, "
            f"one-community and tie rows of {degs[0]}/{degs[1]} slots), 10 "
            f"narrow and 7 pad rows x 2 random CSRs (integer and float "
            f"weights) bit for bit; max |dQ - plain| {err:.3e}")

    from repro_torch.kernels.aggregate import coarsen
    for total, n_ids, long_group, integer_w in (
            (0, 4, 0, True), (5000, 30, 0, True), (300001, 700, 0, True),
            (300001, 700, 0, False), (75000, 300, 70000, True),
            (75000, 300, 70000, False), (1005003, 3000, 1000003, True),
            (1005003, 3000, 1000003, False)):
        keys = np.sort(rng.integers(0, n_ids * n_ids, total - long_group))
        mid = keys[len(keys) // 2] if len(keys) else 1
        keys = np.sort(np.concatenate([keys, np.full(long_group, mid)]))
        ci = (keys // n_ids).astype(np.int32)
        cj = (keys % n_ids).astype(np.int32)
        tail = (total - long_group) // 10
        if tail:
            ci[-tail:] = n_ids
            cj[-tail:] = n_ids
        w = (rng.integers(1, 5, total).astype(np.float32) if integer_w
             else (rng.random(total) + 0.05).astype(np.float32))
        t = [torch.from_numpy(x).to(dev) for x in (ci, cj, w)]
        got = coarsen.coarsen_groups(*t, sent=n_ids)
        want = coarsen.coarsen_groups_ref(*t, sent=n_ids)
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(got[:4], want[:4])),
                f"K3 differs from its plain version on {total} slots")
        err = (got[4].double() - want[4].double()).abs().cpu().numpy()
        if integer_w:
            require(torch.equal(got[4], want[4]),
                    f"K3 sums differ from its plain version on {total} "
                    f"integer-weighted slots")
        else:
            stated, tight = k3_tolerances(ci, cj, w)
            require(bool((err <= stated).all()),
                    f"K3 sums outside m * 2^-23 * sum |w| on {total} slots")
            require(bool((err <= tight).all()),
                    f"K3 sums outside sqrt(m) * 2^-23 * sum |w| on {total} "
                    f"slots")
            ratio = float((err[tight > 0] / tight[tight > 0]).max())
        repeat_identical(torch, lambda: coarsen.coarsen_groups(
            *t, sent=n_ids), got, 10, f"K3 on {total} slots")
        log("kernels", f"K3: {'exact' if integer_w else 'within tolerance'} "
            f"on {total} sorted slots ({int(got[0].sum())} groups, one of "
            f"{long_group}; {'integer' if integer_w else 'float'} weights, "
            f"max |g_w - plain| {err.max():.3e}"
            + ("" if integer_w else f", at most {ratio:.3e} of the tight "
               f"bound") + "); 10 calls bit-identical")

    from repro_torch.kernels.batch_apply import resolve
    for total, n_ids, dead, long_group in (
            (0, 4, 0, 0), (2047, 300, 0, 0), (2048, 300, 100, 0),
            (2049, 300, 0, 2049), (4095, 300, 0, 0), (4096, 300, 100, 0),
            (4097, 300, 0, 4097), (300001, 30, 0, 0),
            (300001, 700, 30000, 5000), (1000003, 3000, 0, 70000),
            (1005003, 3000, 0, 1000003)):
        args = resolve_slots(rng, total, n_ids, dead, long_group)
        t = [torch.from_numpy(x).to(dev) for x in args]
        got = resolve.resolve_groups(*t, sent=n_ids)
        want = resolve.resolve_groups_ref(*t, sent=n_ids)
        torch.cuda.synchronize()
        require(same_records(torch, got, want),
                f"K4 differs from its plain version on {total} slots")
        repeat_identical(torch, lambda: resolve.resolve_groups(
            *t, sent=n_ids), got, 3, f"K4 on {total} slots")
        log("kernels", f"K4: bit for bit on {total} sorted slots "
            f"({n_ids} ids, {dead} dead, a group of {long_group}; "
            f"{int(got[0].sum())} kept, {int(got[5].sum())} changed); "
            f"3 more calls bit-identical")
    return err


def k3_tolerances(ci, cj, w):
    """K3's float bounds per record i, over the m slots of slot i - 1's open
    group through slot i - 1 (none for i = 0): the stated m * 2^-23 *
    sum |w| (a float32 sum in any association) and the tight sqrt(m) *
    2^-23 * sum |w| (rounding errors of random sign), which a sum that
    drops or repeats a slot or a tile exceeds."""
    total = len(ci)
    if total == 0:
        return np.zeros(1), np.zeros(1)
    first = np.ones(total, bool)
    first[1:] = (ci[1:] != ci[:-1]) | (cj[1:] != cj[:-1])
    idx = np.arange(total)
    start = np.maximum.accumulate(np.where(first, idx, 0))
    cabs = np.concatenate([[0.0], np.cumsum(np.abs(w.astype(np.float64)))])
    m = idx - start + 1
    scale = 2.0 ** -23 * (cabs[idx + 1] - cabs[start])
    return (np.concatenate([[0.0], m * scale]),
            np.concatenate([[0.0], np.sqrt(m) * scale]))


def repeat_identical(torch, fn, first, calls: int, what: str) -> None:
    """``calls`` more launches of ``fn`` give ``first``'s outputs bit for
    bit (a look-back race would show here)."""
    for _ in range(calls):
        again = fn()
        require(all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                    for a, b in zip(again, first)),
                f"{what}: a repeated call gave other bits")
        del again


def resolve_slots(rng, total: int, n_ids: int, dead: int, long_group: int):
    """A (src, dst)-sorted batch-apply slot list: per key an optional
    existing slot, then batch slots; one key repeated ``long_group`` times;
    ``dead`` trailing sentinel slots; float weights, a quarter of them 0."""
    live = total - dead
    keys = np.sort(rng.integers(0, n_ids * n_ids, live - long_group))
    mid = keys[len(keys) // 2] if len(keys) else 1
    keys = np.sort(np.concatenate([keys, np.full(long_group, mid)]))
    first = np.ones(live, bool)
    first[1:] = keys[1:] != keys[:-1]
    batch = ~first | (rng.random(live) < 0.3)
    w = np.where(rng.random(live) < 0.25, 0.0,
                 rng.choice([0.25, 3.0, 1.0, 0.7], live))
    return ((np.concatenate([keys // n_ids, np.full(dead, n_ids)])
             .astype(np.int32)),
            (np.concatenate([keys % n_ids, np.full(dead, n_ids)])
             .astype(np.int32)),
            np.concatenate([w, np.zeros(dead)]).astype(np.float32),
            np.concatenate([batch, rng.random(dead) < 0.5]))


def same_records(torch, got, want) -> bool:
    """K4's six records equal, the weights bit for bit."""
    return (all(a.dtype == b.dtype and torch.equal(a, b)
                for a, b in zip(got, want))
            and torch.equal(got[4].view(torch.int32),
                            want[4].view(torch.int32)))


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

    from repro_torch import louvain_dynamic, sbm_edge_stream
    from repro_torch.kernels.batch_apply import resolve
    for scan_backend in ("full", "compact", "auto"):
        init, batches = sbm_edge_stream(device=dev)
        resolve.resolve_groups.launches = 0
        res = louvain_dynamic(init, batches,
                              config=LouvainConfig(scan_backend=scan_backend))
        launches = resolve.resolve_groups.launches
        require(np.array_equal(res.membership, gold["dynamic__sbm_stream"]),
                f"dynamic__sbm_stream not reproduced with scan_backend="
                f"{scan_backend}")
        require(launches == len(batches),
                f"K4 launched {launches} times over {len(batches)} batches")
        log("goldens", f"dynamic__sbm_stream reproduced with scan_backend="
            f"{scan_backend}: K4 launched {launches} times, first-pass "
            f"scanners {[s.scan_backend for s in res.batch_stats]}")

    from repro_torch.kernels.aggregate import coarsen
    from repro_torch.kernels.louvain_scan import ops
    for key, cfg, fns in (
            ("single_leiden__sbm", LouvainConfig(refine="leiden"),
             (coarsen.coarsen_groups,)),
            ("ell_leiden__sbm", LouvainConfig(refine="leiden",
                                              use_ell_kernel=True),
             (ops.louvain_fused, coarsen.coarsen_groups)),
            ("ell_leiden__sbm", LouvainConfig(refine="leiden",
                                              scan_backend="ell"),
             (ops.louvain_scan, coarsen.coarsen_groups))):
        for fn in fns:
            fn.launches = 0
        res = louvain(g, cfg)
        require(np.array_equal(res.membership, gold[key]),
                f"{key} not reproduced with scan_backend={cfg.scan_backend} "
                f"use_ell_kernel={cfg.use_ell_kernel}")
        require(all(fn.launches > 0 for fn in fns),
                f"{key}: a kernel of the path never launched")
        log("goldens", f"{key} reproduced with scan_backend="
            f"{cfg.scan_backend} use_ell_kernel={cfg.use_ell_kernel}: "
            f"passes (communities, refined) "
            f"{[(p.n_communities, p.n_refined) for p in res.passes]}, "
            f"launches {[fn.launches for fn in fns]}")
    init, batches = sbm_edge_stream(device=dev)
    resolve.resolve_groups.launches = 0
    res = louvain_dynamic(init, batches, config=LouvainConfig(refine="leiden"))
    launches = resolve.resolve_groups.launches
    require(np.array_equal(res.membership,
                           gold["dynamic_leiden__sbm_stream"]),
            "dynamic_leiden__sbm_stream not reproduced")
    require(launches == len(batches),
            f"K4 launched {launches} times over {len(batches)} batches")
    log("goldens", f"dynamic_leiden__sbm_stream reproduced: K4 launched "
        f"{launches} times")


def check_result(torch, res, n: int, what: str, nested: bool) -> None:
    """Finite, well-formed output: memberships of the right shape, each
    level with its pass's community count and, where the levels nest
    (``refine="none"``), a coarsening of the one before."""
    require(res.membership.shape == (n,), f"{what}: membership shape")
    require(res.n_communities == len(np.unique(res.membership)),
            f"{what}: community count")
    prev = np.arange(n, dtype=np.int64)
    for lvl, p in zip(res.levels, res.passes):
        require(lvl.shape == (n,) and len(np.unique(lvl)) == p.n_communities,
                f"{what}: a level does not hold its pass's communities")
        pairs = np.unique(prev * n + lvl).shape[0]
        require(not nested or pairs == len(np.unique(prev)),
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


def connectivity_audit(torch, g, membership):
    """(connected components of the intra-community subgraph, communities,
    host seconds): every community is connected iff the two are equal.
    scipy on the host, over each intra-community undirected edge once."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components
    t = time.perf_counter()
    n, e = g.n_valid, g.e_valid
    comm = torch.from_numpy(membership.astype(np.int32)).to(g.device)
    src, dst = g.src[:e], g.indices[:e]
    keep = (src < dst) & (comm[src] == comm[dst])
    s, d = src[keep].cpu().numpy(), dst[keep].cpu().numpy()
    adj = coo_matrix((np.ones(len(s), np.int8), (s, d)), shape=(n, n))
    n_comp, _ = connected_components(adj.tocsr(), directed=False)
    return int(n_comp), len(np.unique(membership)), time.perf_counter() - t


def real_state(torch, g, membership=None):
    """The per-vertex state K1/K2 read in the first round (singletons) or at
    the end of pass 0 (``membership``): comm, sigma, sizes, k and front
    (every valid vertex: the first round's frontier & move-valid)."""
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
    return dict(comm=comm, sigma=sigma, sizes=sizes, k=g.vertex_weights(),
                front=valid)


def scan_work(torch, g, buckets, comm, best_c):
    """(least bytes of K1, of K2, least operations) of one round of K1/K2
    over ``buckets``, counted on this state's data, and the counts behind
    them.  Bytes: indices and weights of every CSR slot of the bucketed
    rows (8 B; a self loop must be read to be skipped), each row id and
    each of the rows' indptr entries, comm of every vertex read (live
    neighbours and rows), sigma of every own and candidate community, k
    per row (K1: front per row, 1 B, and sizes of every own and chosen
    community), m, and the outputs (K2 8 B, K1 12 B per row), each once.
    Operations: one add per live slot and one Eq. 2 (7 float operations)
    per distinct (row, candidate community).  ``best_c`` are K1's per-row
    answers (``n_cap`` = none)."""
    n_cap = g.n_cap
    rows = torch.cat([r for _, r in buckets]).long()
    real = rows[rows < n_cap]
    beg = g.indptr[real].long()
    deg = g.indptr[real + 1].long() - beg
    n_slots = int(deg.sum())
    row_of = torch.repeat_interleave(real, deg)
    first = torch.cumsum(deg, 0) - deg
    slot = (torch.repeat_interleave(beg - first, deg)
            + torch.arange(n_slots, device=g.device))
    cols = g.indices[slot].long()
    live = (cols != n_cap) & (cols != row_of)
    c = comm[cols].long()
    cand = live & (c != comm[row_of].long())
    del slot, first
    own = comm[rows].long()

    def distinct(*xs):
        return int(torch.unique(torch.cat(xs)).numel())

    found = best_c.long()[best_c < n_cap]
    counts = dict(rows=rows.numel(), slots=n_slots, live=int(live.sum()),
                  candidates=int(cand.sum()),
                  indptr=distinct(real, real + 1),
                  comm=distinct(cols[live], rows),
                  sigma=distinct(c[cand], own),
                  k=distinct(rows), sizes=distinct(own, found),
                  pairs=distinct(row_of[cand] * (n_cap + 1) + c[cand]))
    common = (8 * counts["slots"] + 4 * counts["rows"]
              + 4 * counts["indptr"] + 4 * counts["comm"]
              + 4 * counts["sigma"] + 4 * counts["k"] + 4)
    b2 = common + 8 * counts["rows"]
    b1 = common + counts["k"] + 4 * counts["sizes"] + 12 * counts["rows"]
    return b1, b2, counts["live"] + 7 * counts["pairs"], counts


def longest_group(torch, s_ci, s_cj) -> int:
    """Slots in the longest run of equal keys of a sorted slot list."""
    if s_ci.numel() == 0:
        return 0
    first = torch.ones(s_ci.numel() + 1, dtype=torch.bool, device=s_ci.device)
    first[1:-1] = (s_ci[1:] != s_ci[:-1]) | (s_cj[1:] != s_cj[:-1])
    starts = torch.nonzero(first).flatten()
    return int((starts[1:] - starts[:-1]).max())


def phase_full(torch, ops, args, dev, report):
    from repro_torch import LouvainConfig, louvain, membership_modularity
    from repro_torch import rmat_graph
    from repro_torch.core.aggregate import sorted_fleet_aggregate_slots
    from repro_torch.core.graph import ell_bucket_rows, stack_graphs
    from repro_torch.kernels.aggregate import coarsen
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

    q64s = {}

    def drive(cfg, needs, what):
        for fn in launch_fns.values():
            fn.launches = 0
        for fn in (ops.louvain_fused, ops.louvain_scan):
            fn.cta_launches = fn.wide_launches = 0
        torch.cuda.reset_peak_memory_stats()
        res = louvain(g, cfg)
        counts = {k: fn.launches for k, fn in launch_fns.items()}
        counts["louvain_fused_cta"] = ops.louvain_fused.cta_launches
        counts["louvain_scan_cta"] = ops.louvain_scan.cta_launches
        counts["louvain_fused_wide"] = ops.louvain_fused.wide_launches
        counts["louvain_scan_wide"] = ops.louvain_scan.wide_launches
        for i, p in enumerate(res.passes):
            log("full", f"{what} pass {i}: n_cap {p.n_cap} e_cap {p.e_cap} "
                f"iterations {p.iterations} communities {p.n_communities} "
                + (f"refined {p.n_refined} refine_iterations "
                   f"{p.refine_iterations} " if p.n_refined else "")
                + "phase_s " + json.dumps(
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
        check_result(torch, res, n, what, nested=cfg.refine == "none")
        require(np.isfinite(q) and abs(q - q64) < 1e-4,
                f"{what}: Q {q} disagrees with float64 Q {q64}")
        q64s[what] = q64
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
    # The R-MAT weights are integers, so every sum order is exact and the
    # memberships must agree.
    res_d, _ = drive(LouvainConfig(), ("coarsen_groups",), "louvain()")
    require(np.array_equal(res.membership, res_d.membership),
            "the default louvain() and the ELL paths give different "
            "memberships")
    log("full", "louvain() membership equals the ELL paths'")
    del res_b, res_c, res_d

    # Leiden refinement through K1 (its route through K2 is held on the
    # ell_leiden__sbm golden in phase 3, and was cut here for time).
    leiden_k1 = "louvain(use_ell_kernel=True, refine='leiden')"
    res_l, _ = drive(LouvainConfig(use_ell_kernel=True, refine="leiden"),
                     ("louvain_fused", "coarsen_groups"), leiden_k1)
    log("full", f"Leiden through K1: "
        f"{res_l.n_communities} communities (refined per pass "
        f"{[p.n_refined for p in res_l.passes]}), Q float64 "
        f"{q64s[leiden_k1]:.6f} against refine='none' "
        f"{q64s['louvain(use_ell_kernel=True)']:.6f}")
    # Connectivity audits, printed.  Neither the reported (outer) partition
    # nor a refine phase's synchronous moves are connected by construction:
    # the reference's own runs leave disconnected communities in both on
    # R-MAT graphs (tests/test_torch_leiden.py pins the port's counts to
    # the reference's at scale 11).  What must hold: refinement splits
    # communities (no refined community spans two outer ones) and Leiden
    # leaves no more disconnected communities than refine="none".
    audit = {}
    for what, mem in (("refine='leiden'", res_l.membership),
                      ("refine='none'", res.membership)):
        n_comp, n_comms, audit_s = connectivity_audit(torch, g, mem)
        audit[what] = n_comp - n_comms
        log("full", f"connectivity audit of {what}: {n_comp} components of "
            f"the intra-community subgraph for {n_comms} communities, "
            f"{n_comp - n_comms} disconnected, {audit_s:.2f} s on the host "
            f"(scipy)")
    require(audit["refine='leiden'"] <= audit["refine='none'"],
            "Leiden leaves more disconnected communities than refine='none'")
    from repro_torch.core.ell_move import move_phase_ell
    from repro_torch.core.louvain import singleton_init
    outer = torch.full((g.n_cap + 1,), g.n_cap, dtype=torch.int32,
                       device=dev)
    outer[:n] = torch.from_numpy(res_l.membership.astype(np.int32)).to(dev)
    t = time.perf_counter()
    refined, r_iters, _ = move_phase_ell(
        g, *singleton_init(g), LouvainConfig().initial_tolerance, fused=True,
        refine_outer=outer)
    torch.cuda.synchronize()
    r_s = time.perf_counter() - t
    refined = refined[:n].cpu().numpy()
    pairs = np.unique(refined.astype(np.int64) * n + res_l.membership)
    n_comp, n_refined, audit_s = connectivity_audit(torch, g, refined)
    log("full", f"one refine phase of the Leiden partition (K1, {r_iters} "
        f"iterations, {r_s:.3f} s): {n_refined} refined communities, "
        f"{n_comp} components, {n_comp - n_refined} disconnected, "
        f"{audit_s:.2f} s on the host (scipy)")
    require(len(pairs) == n_refined,
            "a refined community spans two outer communities")
    del res_l, outer, refined

    # Wide rows: a 2048-wide bucket in the one-row-per-block layout in
    # shared memory, a 32768-wide one in global scratch.
    res_f, counts_f = drive(LouvainConfig(use_ell_kernel=True,
                                          ell_widths=F1_WIDTHS),
                            ("louvain_fused", "louvain_fused_cta",
                             "louvain_fused_wide", "coarsen_groups"),
                            f"louvain(use_ell_kernel=True, ell_widths="
                            f"{F1_WIDTHS})")
    res_f2, counts_f2 = drive(LouvainConfig(scan_backend="ell",
                                            ell_widths=F1_WIDTHS),
                              ("louvain_scan", "louvain_scan_cta",
                               "louvain_scan_wide", "coarsen_groups"),
                              f"louvain(scan_backend='ell', ell_widths="
                              f"{F1_WIDTHS})")
    require(np.array_equal(res_f.membership, res_f2.membership)
            and np.array_equal(res_f.membership, res.membership),
            "ell_widths with 2048- and 32768-wide buckets: the K1 and K2 "
            "paths and the default widths do not give one membership")
    log("full", f"ell_widths={F1_WIDTHS}: the K1 and K2 paths give the "
        f"default widths' membership")
    del res_f, res_f2

    # K1/K2 on the real rows: round 0 (singletons) and the end of pass 0.
    widths = LouvainConfig().ell_widths
    rows_all, leftover = ell_bucket_rows(g, widths)
    buckets = list(zip(widths, rows_all))
    m, n_cap = g.total_weight(), g.n_cap
    csr = (g.indptr, g.indices, g.weights)
    err = 0.0
    for label, mem in (("round 0", None), ("end of pass 0", res.levels[0])):
        st = real_state(torch, g, mem)
        best = []
        for width, rows in buckets:
            e_k, got = compare_rows(torch, ops, rows, csr, st, m, width, 1,
                                    2, n_cap, f"{label}, width {width}")
            err = max(err, e_k)
            best.append(got[2])
        log("kernels", f"K1/K2 {label}: bit for bit on the rows "
            f"{[r.numel() for _, r in buckets]} of widths {list(widths)}")
        if mem is None:
            st0, best0 = st, torch.cat(best)

    st = st0

    def k1(launch=ops.louvain_fused, plain=False):
        fn = ops.louvain_fused_rows_ref if plain else launch
        return [fn(rows, *csr, st["comm"], st["sigma"], st["sizes"],
                   st["k"], st["front"], m, 1, width=w, gate_fraction=2,
                   sentinel=n_cap) for w, rows in buckets]

    def k1_one(width, rows):
        return ops.launch_louvain_fused(
            rows, *csr, st["comm"], st["sigma"], st["sizes"], st["k"],
            st["front"], m, 1, width=width, gate_fraction=2, sentinel=n_cap)

    def k2(launch=ops.louvain_scan, plain=False):
        fn = ops.louvain_scan_rows_ref if plain else launch
        return [fn(rows, *csr, st["comm"], st["sigma"], st["k"], m, width=w)
                for w, rows in buckets]

    times = {"louvain_fused": (time_ms(torch, k1, 10),
                               time_ms(torch, lambda: k1(plain=True), 2)),
             "louvain_scan": (time_ms(torch, k2, 10),
                              time_ms(torch, lambda: k2(plain=True), 2))}
    t_launch = {"louvain_fused": time_ms(
                    torch, lambda: k1(ops.launch_louvain_fused), 10),
                "louvain_scan": time_ms(
                    torch, lambda: k2(ops.launch_louvain_scan), 10)}
    per_bucket = [time_ms(torch, lambda w=w, rows=rows: k1_one(w, rows), 10)
                  for w, rows in buckets]
    b1, b2, ops_count, counts = scan_work(torch, g, buckets, st["comm"],
                                          best0)
    bounds = {"louvain_fused": b1, "louvain_scan": b2}
    log("full", f"round 0 over the {len(buckets)} buckets: "
        + json.dumps(counts))
    log("full", f"one round over {len(buckets)} buckets: K1 "
        f"{times['louvain_fused'][0]:.4f} ms (launches alone, no error-flag "
        f"read: {t_launch['louvain_fused']:.4f} ms; plain "
        f"{times['louvain_fused'][1]:.4f} ms), K2 "
        f"{times['louvain_scan'][0]:.4f} ms (launches alone "
        f"{t_launch['louvain_scan']:.4f} ms; plain "
        f"{times['louvain_scan'][1]:.4f} ms); least bytes K1 {b1} K2 {b2}, "
        f"least operations {ops_count}; K1 launches alone per bucket "
        + json.dumps({w: round(t, 4) for (w, _), t in zip(buckets,
                                                          per_bucket)}))

    # Where one fused round's time goes (round 0 of pass 0).
    from repro_torch.core.ell_move import FusedELLScanner
    from repro_torch.core.engine import EngineConfig, MoveEngine, MoveState
    scanner = FusedELLScanner(g, buckets, leftover, st["k"], m,
                              gate_fraction=2)
    engine = MoveEngine(scanner, EngineConfig())
    zero = torch.zeros(1, dtype=torch.float32, device=dev)
    st_round = MoveState(st["comm"], st["sigma"], st["front"],
                         np.zeros(1, np.int64), zero, zero,
                         scanner.stream_of == 0)
    t_round = time_ms(torch, lambda: engine.one_round(st_round, st["front"],
                                                      0), 3)
    t_hub = (time_ms(torch, lambda: scanner._hub_scan(
        st["comm"], st["sigma"], st["front"]), 3) if leftover.numel() else 0.0)
    hub_slots = scanner._hub_slots[0].numel() if leftover.numel() else 0
    t_k1 = times["louvain_fused"][0]
    log("full", f"one fused round: {t_round:.4f} ms = K1 incl. its gathers "
        f"{t_k1:.4f} + hub fallback {t_hub:.4f} ({leftover.numel()} hub "
        f"vertices, {hub_slots} of {e} slots) + engine apply "
        f"{t_round - t_hub - t_k1:.4f}")
    del scanner, engine, st, st0

    # K3 on the first aggregation's sorted slot list: a graph aggregates
    # as a one-stream fleet, whose flat sentinel is n_cap + 1.
    comm0 = torch.full((n_cap + 1,), n_cap, dtype=torch.int32, device=dev)
    comm0[:n] = torch.from_numpy(res.levels[0].astype(np.int32)).to(dev)
    s_ci, s_cj, s_w = sorted_fleet_aggregate_slots(stack_graphs([g]),
                                                   comm0[None])
    k3_sent = n_cap + 1
    got = coarsen.coarsen_groups(s_ci, s_cj, s_w, sent=k3_sent)
    want = coarsen.coarsen_groups_ref(s_ci, s_cj, s_w, sent=k3_sent)
    torch.cuda.synchronize()
    require(all(torch.equal(a, b) for a, b in zip(got, want)),
            "K3 differs from its plain version on the first aggregation")
    k3_err = float((got[4] - want[4]).abs().max())
    total = s_ci.numel()
    log("kernels", f"K3 first aggregation: exact on {total} slots, "
        f"{int(got[0].sum())} groups, the longest "
        f"{longest_group(torch, s_ci, s_cj)} slots "
        f"({coarsen.CHUNK_SLOTS}-slot tiles)")
    del want
    repeat_identical(torch, lambda: coarsen.coarsen_groups(
        s_ci, s_cj, s_w, sent=k3_sent), got, 20,
        "K3 on the first aggregation")
    log("kernels", "K3 first aggregation: 20 more calls bit-identical")
    del got
    times["coarsen_groups"] = (
        time_ms(torch, lambda: coarsen.coarsen_groups(s_ci, s_cj, s_w,
                                                      sent=k3_sent), 10),
        time_ms(torch, lambda: coarsen.coarsen_groups_ref(s_ci, s_cj, s_w,
                                                          sent=k3_sent), 3))
    bounds["coarsen_groups"] = 12 * total + 17 * (total + 1)
    ones = torch.ones(total, dtype=torch.int32, device=dev)
    t_cumsum = time_ms(torch, lambda: torch.cumsum(ones, 0,
                                                   dtype=torch.int32), 10)
    del ones
    log("full", f"yardstick: torch.cumsum over {total} int32 on the card "
        f"{t_cumsum:.4f} ms, {8 * total / t_cumsum / 1e6:.1f} GB/s (4 B "
        f"read + 4 B written per element; not K3's function)")
    k3_ms, k3_bytes = times["coarsen_groups"][0], bounds["coarsen_groups"]
    log("full", f"K3 on {total} slots: {k3_ms:.4f} ms (plain "
        f"{times['coarsen_groups'][1]:.4f} ms); bytes once {k3_bytes}, "
        f"achieved {k3_bytes / k3_ms / 1e6:.1f} GB/s, "
        f"{k3_ms / (k3_bytes / HBM_BYTES_PER_S * 1e3):.3f}x the bound")

    op_counts = {"louvain_fused": ops_count, "louvain_scan": ops_count,
                 "coarsen_groups": total}
    launches = {"louvain_fused": counts_a["louvain_fused"],
                "louvain_scan": counts_b["louvain_scan"],
                "coarsen_groups": counts_a["coarsen_groups"]}
    errs = {"louvain_fused": err, "louvain_scan": err,
            "coarsen_groups": k3_err}
    for name in bounds:
        report.append(kernel_entry(name, launches[name], errs[name],
                                   *times[name], bounds[name],
                                   op_counts[name]))
    for tag in ("cta", "wide"):
        wide_rows_check(torch, ops, g, report, tag,
                        {f"louvain_fused_{tag}":
                         counts_f[f"louvain_fused_{tag}"],
                         f"louvain_scan_{tag}":
                         counts_f2[f"louvain_scan_{tag}"]})
    return g, res.membership, res.levels[0]


def wide_rows_check(torch, ops, g, report, tag, launches):
    """K1/K2 in a one-row-per-block layout on phase 4's graph: ``tag``
    "cta" is the 2048-wide bucket of ``F1_WIDTHS`` (degrees 257 to 2048,
    shared memory), "wide" the 32768-wide one (degrees 2049 to 32768,
    global scratch), in the first round's state (every valid vertex a
    singleton and in the frontier), launched over the whole bucket, as
    the F1 run launches it.  Every row must equal the plain versions bit
    for bit; these run over the bucket in chunks of
    ``PLAIN_CHUNK_SLOTS`` slots (their (rows, width) tiles), timed once
    with CUDA events.  The bucket's times, plain times and bounds give the
    ``kernels`` line's entries."""
    from repro_torch.core.graph import ell_bucket_rows
    n_cap = g.n_cap
    m = g.total_weight()
    csr = (g.indptr, g.indices, g.weights)
    st = real_state(torch, g)
    rows, _ = ell_bucket_rows(g, F1_WIDTHS)
    at = -1 if tag == "wide" else -2
    wide = rows[at]
    width = F1_WIDTHS[at]
    lo_deg = F1_WIDTHS[at - 1]
    chunk = max(1, PLAIN_CHUNK_SLOTS // width)
    real = wide[wide < n_cap]
    deg = g.indptr[real.long() + 1] - g.indptr[real.long()]
    n_above = int((deg > lo_deg).sum())

    def k1(rows_, launch=ops.louvain_fused):
        return launch(rows_, *csr, st["comm"], st["sigma"], st["sizes"],
                      st["k"], st["front"], m, 1, width=width,
                      gate_fraction=2, sentinel=n_cap)

    def k2(rows_, launch=ops.louvain_scan):
        return launch(rows_, *csr, st["comm"], st["sigma"], st["k"], m,
                      width=width)

    def plain_chunks(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        outs = [fn(wide[i:i + chunk])
                for i in range(0, wide.numel(), chunk)]
        end.record()
        torch.cuda.synchronize()
        return [torch.cat(x) for x in zip(*outs)], start.elapsed_time(end)

    err, plain_ms, best = {}, {}, None
    for name, fn, plain in (
            (f"louvain_fused_{tag}", k1,
             lambda r: k1(r, ops.louvain_fused_rows_ref)),
            (f"louvain_scan_{tag}", k2,
             lambda r: k2(r, ops.louvain_scan_rows_ref))):
        got = fn(wide)
        want, plain_ms[name] = plain_chunks(plain)
        for i, (a, b) in enumerate(zip(got, want)):
            require(a.dtype == b.dtype and torch.equal(a, b),
                    f"{name} differs from its plain version on the "
                    f"{width}-wide bucket (output {i})")
        fin = torch.isfinite(got[1]) & torch.isfinite(want[1])
        err[name] = (float((got[1][fin] - want[1][fin]).abs().max())
                     if bool(fin.any()) else 0.0)
        best = got[0] if best is None else best
        del got, want
    log("kernels", f"K1/K2 one row per block ({tag}), first round: bit for "
        f"bit on all {real.numel()} rows of the {width}-wide bucket "
        f"({n_above} of degree ({lo_deg}, {width}]), plain versions in "
        f"chunks of {chunk} rows")

    b1, b2, n_ops, counts = scan_work(torch, g, [(width, wide)], st["comm"],
                                      best)
    t = {f"louvain_fused_{tag}": time_ms(torch, lambda: k1(wide), 10),
         f"louvain_scan_{tag}": time_ms(torch, lambda: k2(wide), 10)}
    t1_alone = time_ms(torch, lambda: k1(wide, ops.launch_louvain_fused), 10)
    t2_alone = time_ms(torch, lambda: k2(wide, ops.launch_louvain_scan), 10)

    def bound(n_bytes, n_operations):
        return max(n_bytes / HBM_BYTES_PER_S,
                   n_operations / FP32_OPS_PER_S) * 1e3

    log("full", f"the {width}-wide bucket ({wide.numel()} rows, "
        f"{counts['slots']} slots) per round: K1 "
        f"{t[f'louvain_fused_{tag}']:.4f} ms (launch alone {t1_alone:.4f} "
        f"ms, plain {plain_ms[f'louvain_fused_{tag}']:.4f} ms), K2 "
        f"{t[f'louvain_scan_{tag}']:.4f} ms (launch alone {t2_alone:.4f} ms, "
        f"plain {plain_ms[f'louvain_scan_{tag}']:.4f} ms); bounds K1 "
        f"{bound(b1, n_ops):.4f} ms ({b1} B), K2 {bound(b2, n_ops):.4f} ms "
        f"({b2} B), operations {n_ops}; " + json.dumps(counts))
    for name, b in ((f"louvain_fused_{tag}", b1),
                    (f"louvain_scan_{tag}", b2)):
        report.append(kernel_entry(name, launches[name], err[name], t[name],
                                   plain_ms[name], b, n_ops))


def host_final_csr(g, us_h, ud_h, final):
    """(indptr, keys) of the final edge set, computed on the host: phase
    4's graph is the full set in CSR order (checked), and the final set
    drops the directed slots of every undirected edge not in ``final``."""
    n_cap, e = g.n_cap, g.e_valid
    full_keys = (g.src[:e].cpu().numpy().astype(np.int64) * (n_cap + 1)
                 + g.indices[:e].cpu().numpy())
    require(bool(np.all(np.diff(full_keys) > 0)),
            "phase 4's graph is not a strictly sorted CSR")
    out = np.nonzero(~final)[0]
    u, v = us_h[out].astype(np.int64), ud_h[out].astype(np.int64)
    drop_keys = np.concatenate([u * (n_cap + 1) + v, v * (n_cap + 1) + u])
    at = np.searchsorted(full_keys, drop_keys)
    require(bool(np.all(full_keys[at] == drop_keys)),
            "a held-out or deleted edge is not in phase 4's graph")
    drop = np.zeros(e, bool)
    drop[at] = True
    keys = full_keys[~drop]
    counts = np.bincount(keys // (n_cap + 1), minlength=n_cap)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return indptr, keys


def holdout_stream(torch, g, dev, seed: int, b_cap: int):
    """Phase 5's stream recipe on ``g`` (unit weights, CSR order): 10^-3 of
    its undirected edges held out (``default_rng(seed)``), then
    ``STREAM_BATCHES`` batches of 10^-4 |E| entries, 80% inserts of
    held-out edges and 20% deletions, each padded to ``b_cap``.  Returns
    (initial graph with room for the inserts, batches, its undirected edges
    (us, ud) on the host, the final edge set as a mask over them, a line
    describing the sizes)."""
    from repro_torch import build_csr, make_edge_batch
    n, e, n_cap = g.n_valid, g.e_valid, g.n_cap
    src, dst = g.src[:e], g.indices[:e]
    und = src < dst
    us, ud = src[und], dst[und]
    n_und = us.numel()
    n_hold = n_und // 1000
    b_size = n_und // 10000
    n_ins = b_size * 4 // 5
    n_del = b_size - n_ins
    require(b_size <= b_cap and STREAM_BATCHES * n_ins <= n_hold,
            "stream sizes out of range")
    rng = np.random.default_rng(seed)
    pick = rng.choice(n_und, n_hold + STREAM_BATCHES * n_del, replace=False)
    hold, dele = pick[:n_hold], pick[n_hold:]
    keep = torch.ones(n_und, dtype=torch.bool, device=dev)
    keep[torch.from_numpy(hold).to(dev)] = False
    init = build_csr(us[keep], ud[keep],
                     torch.ones(n_und - n_hold, dtype=torch.float32,
                                device=dev),
                     n, e_cap=e + 2 * b_cap, symmetrize=True,
                     dedup=False, device=dev)
    us_h, ud_h = us.cpu().numpy(), ud.cpu().numpy()
    del src, dst, und, us, ud, keep
    batches = []
    final = np.ones(n_und, bool)
    final[hold] = False
    for i in range(STREAM_BATCHES):
        ins = hold[i * n_ins:(i + 1) * n_ins]
        de = dele[i * n_del:(i + 1) * n_del]
        final[ins] = True
        final[de] = False
        idx = np.concatenate([ins, de])
        w = np.concatenate([np.ones(n_ins), np.zeros(n_del)])
        perm = rng.permutation(len(idx))
        batches.append(make_edge_batch(us_h[idx[perm]], ud_h[idx[perm]],
                                       w[perm], n_cap, b_cap=b_cap,
                                       device=dev))
    sizes = (f"{n_und} undirected edges, {n_hold} held out; initial graph "
             f"{init.e_valid} directed slots at e_cap {init.e_cap}; "
             f"{STREAM_BATCHES} batches of {b_size} entries ({n_ins} "
             f"inserts, {n_del} deletions), b_cap {b_cap}")
    return init, batches, us_h, ud_h, final, sizes


def phase_stream(torch, g, dev, report):
    """Returns (initial graph, batches, cold membership, the stream's final
    membership): phase 8 streams them again through the sharded driver."""
    from repro_torch import louvain, louvain_dynamic, membership_modularity
    from repro_torch.core.delta import sorted_batch_slots
    from repro_torch.kernels.aggregate import coarsen
    from repro_torch.kernels.batch_apply import resolve

    t = time.perf_counter()
    n_cap = g.n_cap
    init, batches, us_h, ud_h, final, sizes = holdout_stream(
        torch, g, dev, 13, STREAM_B_CAP)
    torch.cuda.synchronize()
    log("stream", f"{sizes}; set up in {time.perf_counter() - t:.2f} s")
    cold = louvain(init)
    log("stream", f"cold louvain() on the initial graph: {cold.n_passes} "
        f"passes, {cold.n_communities} communities, "
        f"{cold.total_seconds:.3f} s")

    def stream(apply_backend):
        resolve.resolve_groups.launches = 0
        coarsen.coarsen_groups.launches = 0
        res = louvain_dynamic(init, batches, prev=cold.membership,
                              apply_backend=apply_backend)
        return res, (resolve.resolve_groups.launches,
                     coarsen.coarsen_groups.launches)

    res, (k4_launches, k3_launches) = stream("auto")
    for i, st in enumerate(res.batch_stats):
        log("stream", f"batch {i}: apply_seconds {st.apply_seconds:.6f} "
            f"update_seconds {st.update_seconds:.6f} touched {st.n_touched} "
            f"frontier {st.frontier_size} (fraction "
            f"{st.frontier_fraction:.6f}) scan_backend {st.scan_backend} "
            f"communities {st.n_communities}")
    log("stream", f"louvain_dynamic (K4): {res.total_seconds:.3f} s, "
        f"updates_per_second {res.updates_per_second:.4f}, launches K4 "
        f"{k4_launches} K3 {k3_launches}")
    require(k4_launches == STREAM_BATCHES,
            f"K4 launched {k4_launches} times over {STREAM_BATCHES} batches")

    res_s, (k4_sort, _) = stream("sort")
    mean_apply = [np.mean([x.apply_seconds for x in r.batch_stats])
                  for r in (res_s, res)]
    log("stream", f"louvain_dynamic (sort apply): {res_s.total_seconds:.3f} "
        f"s, updates_per_second {res_s.updates_per_second:.4f}; mean "
        f"apply_seconds {mean_apply[0]:.6f} (K4 stream {mean_apply[1]:.6f})")
    require(k4_sort == 0, "the sort apply launched K4")
    fin, fin_s = res.graph, res_s.graph
    require(all(torch.equal(getattr(fin, k), getattr(fin_s, k))
                for k in ("indptr", "indices", "weights", "src"))
            and fin.e_valid == fin_s.e_valid,
            "the K4 and sort streams end in different graphs")
    require(np.array_equal(res.membership, res_s.membership),
            "the K4 and sort streams end in different memberships")

    indptr, keys = host_final_csr(g, us_h, ud_h, final)
    e_f = fin.e_valid
    got_keys = (fin.src[:e_f].cpu().numpy().astype(np.int64) * (n_cap + 1)
                + fin.indices[:e_f].cpu().numpy())
    require(e_f == len(keys) and np.array_equal(got_keys, keys)
            and np.array_equal(fin.indptr.cpu().numpy(), indptr)
            and bool((fin.weights[:e_f] == 1).all())
            and bool((fin.weights[e_f:] == 0).all())
            and bool((fin.src[e_f:] == n_cap).all()),
            "the streamed graph differs from the host CSR of the final "
            "edge set")
    log("stream", f"final graph ({e_f} directed slots) equals the host CSR "
        f"of the final edge set and the sort stream's; memberships equal")

    static = louvain(fin)
    q_dyn = membership_modularity(fin, res.membership)
    q_static = membership_modularity(fin, static.membership)
    log("stream", f"Q streamed {q_dyn:.6f}, cold louvain() on the final "
        f"graph {q_static:.6f} ({static.total_seconds:.3f} s)")
    require(q_dyn >= q_static - 0.01 * abs(q_static),
            f"streamed Q {q_dyn} more than 1% below the cold {q_static}")
    del res_s, fin_s, static

    # K4 on the first batch's real sorted slot list: a graph's batch
    # applies as a one-stream fleet's, whose flat sentinel is n_cap + 1.
    slots = sorted_batch_slots(init, batches[0])
    k4_sent = n_cap + 1
    got = resolve.resolve_groups(*slots, sent=k4_sent)
    want = resolve.resolve_groups_ref(*slots, sent=k4_sent)
    torch.cuda.synchronize()
    require(same_records(torch, got, want),
            "K4 differs from its plain version on the first batch")
    total = slots[0].numel()
    k4_err = float((got[4] - want[4]).abs().max())
    log("kernels", f"K4 first batch: bit for bit on {total} sorted slots, "
        f"{int(got[0].sum())} kept, {int(got[5].sum())} changed, the "
        f"longest group {longest_group(torch, slots[0], slots[1])} slots")
    del want
    repeat_identical(torch, lambda: resolve.resolve_groups(
        *slots, sent=k4_sent), got, 20, "K4 on the first batch")
    log("kernels", "K4 first batch: 20 more calls bit-identical")
    del got
    ms = time_ms(torch, lambda: resolve.resolve_groups(*slots,
                                                       sent=k4_sent), 10)
    plain_ms = time_ms(torch, lambda: resolve.resolve_groups_ref(
        *slots, sent=k4_sent), 3)
    sort_ms = time_ms(torch, lambda: sorted_batch_slots(init, batches[0]), 3)
    bound_bytes = 13 * total + 18 * (total + 1)
    log("stream", f"K4 on {total} slots: {ms:.4f} ms (plain "
        f"{plain_ms:.4f} ms); bytes once {bound_bytes}, achieved "
        f"{bound_bytes / ms / 1e6:.1f} GB/s, "
        f"{ms / (bound_bytes / HBM_BYTES_PER_S * 1e3):.3f}x the bound; the "
        f"slot list's build and stable key sort before it: {sort_ms:.4f} ms")
    report.append(kernel_entry("resolve_groups", k4_launches, k4_err, ms,
                               plain_ms, bound_bytes, total))
    return init, batches, cold.membership, res.membership


def rmat_tenant(torch, scale: int, seed: int, dev):
    """One tenant of phase 6: an R-MAT graph (Graph500 a/b/c, edge factor
    ``EDGE_FACTOR``) drawn on the card from torch's generator seeded
    ``seed`` (``rmat_graph``'s recipe; it draws on the host, where a fleet
    of them would spend most of the phase).  Returns its undirected edges
    ``(us, ud)``, u < v, without self loops or repeats, as int32 tensors
    in ascending (u, v) order."""
    a, b, c = RMAT_ABC
    n = 1 << scale
    m = n * EDGE_FACTOR
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    src = torch.zeros(m, dtype=torch.int64, device=dev)
    dst = torch.zeros(m, dtype=torch.int64, device=dev)
    for bit in range(scale):
        r = torch.rand(m, generator=gen, device=dev)
        go_right = (r > a + b) & (r <= a + b + c)
        go_down = r > a + b + c
        pick_b = (r > a) & (r <= a + b)
        src += (go_right | go_down).to(torch.int64) << bit
        dst += (pick_b | go_down).to(torch.int64) << bit
    u, v = torch.minimum(src, dst), torch.maximum(src, dst)
    keep = u != v
    key = torch.unique(u[keep] * n + v[keep])
    return (key // n).to(torch.int32), (key % n).to(torch.int32)


def fleet_streams(torch, args, dev):
    """Phase 6's fleet: ``args.streams`` tenants at ``args.stream_scale``,
    each with phase 5's stream recipe (1e-3 |E| of its undirected edges
    held out, ``STREAM_BATCHES`` batches of 1e-4 |E| entries, 80% inserts
    of held-out edges and 20% deletions, its own ``default_rng(seed)``),
    all in one ``(n_cap, e_cap)`` envelope: ``e_cap`` the next power of
    two at or above the largest tenant's initial slots plus its inserts,
    ``b_cap`` the next power of two at or above the largest batch.
    Returns (graphs, streams, entries per step)."""
    from repro_torch import build_csr, make_edge_batch
    from repro_torch.configs.louvain_arch import _pow2_at_least
    n = 1 << args.stream_scale
    edges = [rmat_tenant(torch, args.stream_scale, FLEET_SEED0 + s, dev)
             for s in range(args.streams)]
    n_und = np.array([us.numel() for us, _ in edges])
    # Phase 5's sizes; a rehearsal at a small scale keeps 5 entries a batch.
    b_size = np.maximum(n_und // 10000, 5)
    n_ins = b_size * 4 // 5
    n_del = b_size - n_ins
    n_hold = np.maximum(n_und // 1000, STREAM_BATCHES * n_ins)
    e_cap = _pow2_at_least(int(np.max(
        2 * (n_und - n_hold) + 2 * STREAM_BATCHES * n_ins)))
    b_cap = _pow2_at_least(int(b_size.max()))
    graphs, streams = [], []
    for s, (us, ud) in enumerate(edges):
        rng = np.random.default_rng(FLEET_SEED0 + s)
        pick = rng.choice(int(n_und[s]),
                          int(n_hold[s] + STREAM_BATCHES * n_del[s]),
                          replace=False)
        hold, dele = pick[:n_hold[s]], pick[n_hold[s]:]
        keep = torch.ones(int(n_und[s]), dtype=torch.bool, device=dev)
        keep[torch.from_numpy(hold).to(dev)] = False
        graphs.append(build_csr(
            us[keep], ud[keep],
            torch.ones(int(keep.sum()), dtype=torch.float32, device=dev), n,
            n_cap=n, e_cap=e_cap, symmetrize=True, dedup=False, device=dev))
        us_h, ud_h = us.cpu().numpy(), ud.cpu().numpy()
        batches = []
        for i in range(STREAM_BATCHES):
            idx = np.concatenate([hold[i * n_ins[s]:(i + 1) * n_ins[s]],
                                  dele[i * n_del[s]:(i + 1) * n_del[s]]])
            w = np.concatenate([np.ones(n_ins[s]), np.zeros(n_del[s])])
            perm = rng.permutation(len(idx))
            batches.append(make_edge_batch(us_h[idx[perm]], ud_h[idx[perm]],
                                           w[perm], n, b_cap=b_cap,
                                           device=dev))
        streams.append(batches)
    return graphs, streams, b_size


def device_profile(torch, fn, top: int = 6):
    """One call of ``fn`` under ``torch.profiler``: (profiled wall ms, work
    on the card: device operations run, busy ms as the union of their
    intervals, and the ``top`` kernel names by device ms).  The profiler
    slows the host, not the card, so busy ms hold and the wall does not."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    ops = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy, end = 0.0, float("-inf")
    by_name = {}
    for e in sorted(ops, key=lambda e: e.time_range.start):
        a, b = e.time_range.start, e.time_range.end
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
        by_name[e.name] = by_name.get(e.name, 0.0) + (b - a) / 1e3
    names = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return wall_ms, len(ops), busy / 1e3, [(k[:60], round(v, 3))
                                           for k, v in names]


def same_graph(torch, a, b) -> bool:
    """Two ``CSRGraph``s with equal buffers, bit for bit."""
    return (all(torch.equal(getattr(a, k), getattr(b, k))
                for k in ("indptr", "indices", "src"))
            and torch.equal(a.weights.view(torch.int32),
                            b.weights.view(torch.int32))
            and (a.n_valid, a.e_valid) == (b.n_valid, b.e_valid))


def phase_fleet(torch, args, dev, report):
    """Batched multi-stream serving: the fleet against its tenants served
    alone, K3/K4 launched once per fleet operation and held against their
    plain versions, the sbm goldens through a one-stream fleet, and a
    fleet regrow."""
    from repro_torch import (FleetCapacityOverflow, LouvainConfig, build_csr,
                             louvain, louvain_batched, louvain_dynamic,
                             louvain_dynamic_batched, make_edge_batch,
                             sbm_graph, stack_batches, stack_graphs)
    from repro_torch.core.aggregate import sorted_fleet_aggregate_slots
    from repro_torch.core.delta import sorted_fleet_slots
    from repro_torch.kernels.aggregate import coarsen
    from repro_torch.kernels.batch_apply import resolve

    t = time.perf_counter()
    graphs, streams, b_size = fleet_streams(torch, args, dev)
    torch.cuda.synchronize()
    S, g0 = len(graphs), graphs[0]
    n, n_cap, e_cap = g0.n_valid, g0.n_cap, g0.e_cap
    b_cap = streams[0][0].b_cap
    fleet = stack_graphs(graphs)
    log("fleet", f"{S} R-MAT tenants, scale {args.stream_scale}, edge factor "
        f"{EDGE_FACTOR}, seeds {FLEET_SEED0}-{FLEET_SEED0 + S - 1}: "
        f"{n} vertices each, {int(fleet.e_valid.min())}-"
        f"{int(fleet.e_valid.max())} directed slots, envelope n_cap {n_cap} "
        f"e_cap {e_cap} ({S * e_cap} fleet slots); {STREAM_BATCHES} steps of "
        f"{int(b_size.min())}-{int(b_size.max())} entries per tenant, b_cap "
        f"{b_cap}; set up in {time.perf_counter() - t:.2f} s")

    # Cold start: the fleet against each tenant's louvain() (sort-reduce
    # scan + K3), for both refine modes; one K3 launch per fleet
    # aggregation.
    cold = {}
    for refine in ("none", "leiden"):
        cfg = LouvainConfig(refine=refine)
        coarsen.coarsen_groups.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        res = louvain_batched(fleet, cfg)
        torch.cuda.synchronize()
        fleet_s = time.perf_counter() - t
        k3_fleet = coarsen.coarsen_groups.launches
        peak = torch.cuda.max_memory_allocated() / 2**30
        require(k3_fleet == res.n_passes - 1 and k3_fleet > 0,
                f"refine={refine}: K3 launched {k3_fleet} times over "
                f"{res.n_passes} fleet passes")
        mem = res.membership.cpu().numpy()
        coarsen.coarsen_groups.launches = 0
        solo_s = 0.0
        for s, g in enumerate(graphs[:SOLO_TENANTS]):
            solo = louvain(g, cfg)
            solo_s += solo.total_seconds
            require(np.array_equal(mem[s, :n], solo.membership)
                    and res.n_communities[s] == solo.n_communities,
                    f"refine={refine}: tenant {s}'s fleet membership differs "
                    f"from its louvain()")
        log("fleet", f"cold louvain_batched(refine={refine!r}): "
            f"{res.n_passes} passes, communities "
            f"{res.n_communities.tolist()}, {fleet_s:.3f} s, K3 launched "
            f"{k3_fleet} times, peak memory {peak:.2f} GiB; the first "
            f"{SOLO_TENANTS} tenants' solo louvain() {solo_s:.3f} s in all, "
            f"K3 launched {coarsen.coarsen_groups.launches} times; each "
            f"equal")
        cold[refine] = (mem, k3_fleet)

    # K3 on the fleet's pass-0 partition: one sorted, stream-keyed list.
    first = louvain_batched(fleet, LouvainConfig(max_passes=1)).membership
    comm = torch.cat([first, torch.full((S, 1), n_cap, dtype=torch.int32,
                                        device=dev)], 1)
    s_ci, s_cj, s_w = sorted_fleet_aggregate_slots(fleet, comm)
    sent = fleet.sentinel
    del first, comm
    got = coarsen.coarsen_groups(s_ci, s_cj, s_w, sent=sent)
    want = coarsen.coarsen_groups_ref(s_ci, s_cj, s_w, sent=sent)
    torch.cuda.synchronize()
    require(all(torch.equal(a, b) for a, b in zip(got, want)),
            "fleet K3 differs from its plain version on the pass-0 slots")
    k3_err = float((got[4] - want[4]).abs().max())
    total = s_ci.numel()
    log("kernels", f"fleet K3: exact on {total} slots of {S} streams, "
        f"{int(got[0].sum())} groups, the longest "
        f"{longest_group(torch, s_ci, s_cj)} slots")
    del want
    repeat_identical(torch, lambda: coarsen.coarsen_groups(
        s_ci, s_cj, s_w, sent=sent), got, 20, "fleet K3")
    del got
    k3_ms = time_ms(torch, lambda: coarsen.coarsen_groups(
        s_ci, s_cj, s_w, sent=sent), 10)
    k3_plain = time_ms(torch, lambda: coarsen.coarsen_groups_ref(
        s_ci, s_cj, s_w, sent=sent), 3)
    k3_bytes = 12 * total + 17 * (total + 1)
    log("fleet", f"fleet K3 on {total} slots: {k3_ms:.4f} ms (plain "
        f"{k3_plain:.4f} ms); bytes once {k3_bytes}, "
        f"{k3_ms / (k3_bytes / HBM_BYTES_PER_S * 1e3):.3f}x the bound")
    report.append(kernel_entry("coarsen_groups_fleet", cold["none"][1],
                               k3_err, k3_ms, k3_plain, k3_bytes, total))
    del s_ci, s_cj, s_w

    # Serving: the fleet against 16 solo louvain_dynamic streams from the
    # cold memberships; one K4 launch per step.
    prevs = [cold["none"][0][s, :n] for s in range(S)]
    updates = int(sum(b.b_valid for st in streams for b in st))
    resolve.resolve_groups.launches = 0
    coarsen.coarsen_groups.launches = 0
    torch.cuda.reset_peak_memory_stats()
    res = louvain_dynamic_batched(graphs, streams, prevs=prevs)
    torch.cuda.synchronize()
    k4_fleet = resolve.resolve_groups.launches
    k3_serve = coarsen.coarsen_groups.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    for i, p in enumerate(res.pass_stats):
        log("fleet", f"step {i}: apply_seconds {res.apply_seconds[i]:.6f} "
            f"update_seconds {res.update_seconds[i]:.6f} iterations "
            f"{p.iterations} frontier max {p.frontier_size} screening "
            f"{p.screening} scan_backend {p.scan_backend} downgraded "
            f"{p.downgraded}")
    fleet_ups = updates / res.total_seconds
    log("fleet", f"louvain_dynamic_batched: {res.total_seconds:.3f} s for "
        f"{updates} entries of {S} tenants, fleet updates_per_second "
        f"{fleet_ups:.4f}, launches K4 {k4_fleet} K3 {k3_serve}, regrows "
        f"{res.n_regrows}, peak memory {peak:.2f} GiB")
    require(k4_fleet == STREAM_BATCHES,
            f"fleet K4 launched {k4_fleet} times over {STREAM_BATCHES} steps")
    solo_s, k4_solo = 0.0, 0
    for s, g in enumerate(graphs[:SOLO_TENANTS]):
        resolve.resolve_groups.launches = 0
        solo = louvain_dynamic(g, streams[s], prev=prevs[s])
        k4_solo += resolve.resolve_groups.launches
        solo_s += solo.total_seconds
        require(np.array_equal(res.stream_membership(s), solo.membership),
                f"tenant {s}: fleet membership differs from its stream's")
        require(same_graph(torch, res.graphs.stream(s), solo.graph),
                f"tenant {s}: fleet final graph differs from its stream's")
        require(res.frontier_sizes[:, s].tolist()
                == [b.frontier_size for b in solo.batch_stats],
                f"tenant {s}: frontier sizes differ from its stream's")
    solo_updates = int(sum(b.b_valid for st in streams[:SOLO_TENANTS]
                           for b in st))
    log("fleet", f"the first {SOLO_TENANTS} tenants' solo louvain_dynamic: "
        f"{solo_s:.3f} s in all, updates_per_second "
        f"{solo_updates / solo_s:.4f}, K4 launched {k4_solo} times; fleet / "
        f"solo updates_per_second {fleet_ups / (solo_updates / solo_s):.3f}; "
        f"each tenant's membership, final graph and frontier sizes equal")
    step_s = res.apply_seconds[0] + res.update_seconds[0]
    finals = [res.stream_membership(s) for s in range(S)]
    del res

    # Where a step's time goes: the first step once more under the
    # profiler, for the fleet and for one tenant alone.
    from repro_torch.core.multistream import _serve_step
    mem0 = torch.from_numpy(np.stack(prevs).astype(np.int32)).to(dev)
    batch0 = stack_batches([st[0] for st in streams])
    solo0 = louvain_dynamic(graphs[0], streams[0][:1], prev=prevs[0])
    for what, fn, wall_s in (
            ("fleet step", lambda: _serve_step(
                fleet, batch0, mem0, "community", LouvainConfig(), False,
                "auto"), step_s),
            ("solo step (tenant 0)", lambda: louvain_dynamic(
                graphs[0], streams[0][:1], prev=prevs[0]),
             solo0.total_seconds)):
        p_ms, n_ops, busy_ms, top = device_profile(torch, fn)
        log("fleet", f"profile of one {what}: {n_ops} device operations, "
            f"device busy {busy_ms:.3f} ms, {p_ms:.3f} ms profiled wall, "
            f"{wall_s * 1e3:.3f} ms unprofiled (idle share "
            f"{1 - busy_ms / (wall_s * 1e3):.3f}); top by device ms "
            f"{json.dumps(top)}")
    del mem0, batch0, solo0

    # K4 on the first step's flat, stream-keyed sorted slots.
    slots = sorted_fleet_slots(fleet, stack_batches([st[0] for st in streams]))
    got = resolve.resolve_groups(*slots, sent=sent)
    want = resolve.resolve_groups_ref(*slots, sent=sent)
    torch.cuda.synchronize()
    require(same_records(torch, got, want),
            "fleet K4 differs from its plain version on the first step")
    k4_err = float((got[4] - want[4]).abs().max())
    total = slots[0].numel()
    log("kernels", f"fleet K4 first step: bit for bit on {total} sorted "
        f"slots, {int(got[0].sum())} kept, {int(got[5].sum())} changed")
    del want
    repeat_identical(torch, lambda: resolve.resolve_groups(
        *slots, sent=sent), got, 20, "fleet K4 on the first step")
    del got
    k4_ms = time_ms(torch, lambda: resolve.resolve_groups(*slots, sent=sent),
                    10)
    k4_plain = time_ms(torch, lambda: resolve.resolve_groups_ref(
        *slots, sent=sent), 3)
    k4_bytes = 13 * total + 18 * (total + 1)
    log("fleet", f"fleet K4 on {total} slots: {k4_ms:.4f} ms (plain "
        f"{k4_plain:.4f} ms); bytes once {k4_bytes}, "
        f"{k4_ms / (k4_bytes / HBM_BYTES_PER_S * 1e3):.3f}x the bound")
    report.append(kernel_entry("resolve_groups_fleet", k4_fleet, k4_err,
                               k4_ms, k4_plain, k4_bytes, total))
    del slots, fleet

    # The sbm goldens through a one-stream fleet.
    gold = np.load(GOLDEN)
    g, _ = sbm_graph(8, 16, 0.4, 0.01, seed=2, device=dev)
    for key, cfg in (("single__sbm", LouvainConfig()),
                     ("single_leiden__sbm", LouvainConfig(refine="leiden"))):
        coarsen.coarsen_groups.launches = 0
        res = louvain_batched(stack_graphs([g]), cfg)
        require(np.array_equal(res.membership[0, :g.n_valid].cpu().numpy(),
                               gold[key]),
                f"{key} not reproduced by a one-stream fleet")
        require(coarsen.coarsen_groups.launches == res.n_passes - 1 > 0,
                f"{key}: K3 launched {coarsen.coarsen_groups.launches} "
                f"times over {res.n_passes} passes")
    log("fleet", "single__sbm and single_leiden__sbm reproduced by a "
        "one-stream louvain_batched")

    # Regrow: a two-stream fleet with two spare slots and a batch of four
    # new edges.
    full, _ = sbm_graph(4, 8, 0.5, 0.05, seed=1, device=dev)
    e = full.e_valid
    tight = build_csr(full.src[:e], full.indices[:e], full.weights[:e],
                      full.n_valid, e_cap=e + 2, device=dev)
    batch = make_edge_batch([0, 1, 2, 3], [17, 18, 19, 20], [1.0] * 4,
                            tight.n_cap, b_cap=4, device=dev)
    prevs = [louvain(tight).membership] * 2
    try:
        louvain_dynamic_batched([tight, tight], [[batch], [batch]],
                                prevs=prevs, grow_capacity=False)
        raise Failure("the tight fleet did not overflow")
    except FleetCapacityOverflow as exc:
        overflow = (exc.step, exc.e_need, exc.e_cap)
    grown = louvain_dynamic_batched([tight, tight], [[batch], [batch]],
                                    prevs=prevs)
    ample = build_csr(full.src[:e], full.indices[:e], full.weights[:e],
                      full.n_valid, e_cap=grown.graphs.e_cap, device=dev)
    ref = louvain_dynamic_batched([ample, ample], [[batch], [batch]],
                                  prevs=prevs)
    require(grown.n_regrows >= 1 and ref.n_regrows == 0
            and np.array_equal(grown.membership, ref.membership)
            and all(same_graph(torch, grown.graphs.stream(s),
                               ref.graphs.stream(s)) for s in range(2)),
            "the regrown fleet differs from the amply provisioned one")
    log("fleet", f"regrow: FleetCapacityOverflow (step, e_need, e_cap) "
        f"{overflow} without growth; with growth {grown.n_regrows} regrow to "
        f"e_cap {grown.graphs.e_cap}, equal to the amply provisioned fleet")
    # Phase 9 serves the same tenants through the sharded fleet.
    return (graphs, streams, [cold["none"][0][s, :n] for s in range(S)],
            finals)


def sharded_k3_check(torch, g, level0, report, launches):
    """Both K3 launches of the first sharded aggregation of phase 4's graph
    at world size 1 (one rank owns every vertex: n_pad = n, and its slice
    is the live slots in CSR order), held against the plain version on the
    same inputs: the local partial reduce over the rank's relabelled slots
    and the owner-side re-reduce over the gathered partial records.  The
    local one's time, plain time and bound give the ``kernels`` line's
    entry."""
    from repro_torch.core import distributed as dist_mod
    from repro_torch.kernels.aggregate import coarsen
    n, e = g.n_valid, g.e_valid
    dev = g.indices.device
    sent = n
    comm = torch.full((n + 1,), sent, dtype=torch.int32, device=dev)
    comm[:n] = torch.from_numpy(level0.astype(np.int32)).to(dev)
    src_l, dst_l, w_l = g.src[:e], g.indices[:e], g.weights[:e]
    local = dist_mod.sorted_relabelled_slots(src_l, dst_l, w_l, comm, sent)
    partial = dist_mod.reduce_sorted_slots(*local, sent, e)
    owner = dist_mod.owner_sorted_slots(*partial[:3], 0, n, sent)
    times = {}
    for what, slots in (("local partial reduce", local),
                        ("owner-side re-reduce", owner)):
        got = coarsen.coarsen_groups(*slots, sent=sent)
        want = coarsen.coarsen_groups_ref(*slots, sent=sent)
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(got, want)),
                f"K3 differs from its plain version in the sharded "
                f"aggregation's {what}")
        total = slots[0].numel()
        times[what] = (
            time_ms(torch, lambda: coarsen.coarsen_groups(*slots, sent=sent),
                    5),
            time_ms(torch, lambda: coarsen.coarsen_groups_ref(*slots,
                                                              sent=sent), 2),
            12 * total + 17 * (total + 1), total, int(got[0].sum()))
        del got, want
        log("sharded", f"K3 in the first sharded aggregation, {what}: exact "
            f"on {total} slots ({times[what][4]} groups); "
            f"{times[what][0]:.4f} ms (plain {times[what][1]:.4f} ms), "
            f"{times[what][0] / (times[what][2] / HBM_BYTES_PER_S * 1e3):.3f}"
            f"x its bound")
    ms, plain, n_bytes, total, _ = times["local partial reduce"]
    report.append(kernel_entry("coarsen_groups_sharded", launches, 0.0, ms,
                               plain, n_bytes, total))


@contextlib.contextmanager
def nccl_world_of_one(dev):
    """One NCCL rank on the card (world size 1), its store in a temporary
    directory; the group is left and the directory removed on exit."""
    import shutil
    import tempfile
    from repro_torch import ShardGroup
    tmp = tempfile.mkdtemp(prefix="chip-smoke-store-")
    group = ShardGroup.init("nccl", 0, 1,
                            "file://" + os.path.join(tmp, "store"),
                            device=dev)
    try:
        yield group
    finally:
        group.destroy()
        shutil.rmtree(tmp, ignore_errors=True)


def graph_arrays(g) -> dict:
    """A ``CSRGraph``'s buffers as numpy arrays, for spawned ranks."""
    out = {k: getattr(g, k).cpu().numpy()
           for k in ("indptr", "indices", "weights", "src")}
    out.update(n_valid=g.n_valid, e_valid=g.e_valid)
    return out


def phase_sharded(torch, args, dev, report, g, membership, level0):
    from repro_torch import (LouvainConfig, distributed_louvain,
                             louvain_dynamic_sharded, membership_modularity,
                             rmat_graph, sbm_edge_stream, sbm_graph)
    from repro_torch.core import collectives
    from repro_torch.core import distributed as dist_mod
    from repro_torch.kernels.aggregate import coarsen
    from repro_torch.kernels.batch_apply import resolve
    gold = np.load(GOLDEN)
    with nccl_world_of_one(dev) as group:
        # (a) the sharded sbm goldens through NCCL at world size 1, under
        # both state layouts, and the sharded stream goldens.
        sbm, _ = sbm_graph(8, 16, 0.4, 0.01, seed=2, device=dev)
        for refine in ("none", "leiden"):
            key = f"sharded{'_leiden' if refine == 'leiden' else ''}__sbm"
            for layout in ("replicated", "hybrid"):
                for cb in ("gather", "delta"):
                    coarsen.coarsen_groups.launches = 0
                    mem, _, stats = distributed_louvain(
                        sbm, group, comm_backend=cb, refine=refine,
                        state_layout=layout)
                    require(np.array_equal(mem, gold[key]),
                            f"{key} not reproduced under comm_backend={cb}, "
                            f"state_layout={layout}")
                    require(coarsen.coarsen_groups.launches
                            == 2 * (len(stats) - 1),
                            f"{key}: K3 not launched twice per aggregation")
                    log("sharded", f"{key} reproduced through NCCL at world "
                        f"size 1, comm_backend={cb}, state_layout={layout}: "
                        f"rounds {[s['comm_rounds'] for s in stats]}, "
                        f"fallback rounds "
                        f"{[s['comm_fallback_rounds'] for s in stats]}, "
                        f"comm_bytes {[s['comm_bytes'] for s in stats]}, K3 "
                        f"launches {coarsen.coarsen_groups.launches}")
            key = (f"sharded_dynamic{'_leiden' if refine == 'leiden' else ''}"
                   "__sbm_stream")
            for layout in ("replicated", "hybrid"):
                init, batches = sbm_edge_stream(device=dev)
                resolve.resolve_groups.launches = 0
                res = louvain_dynamic_sharded(
                    init, group, batches,
                    config=LouvainConfig(refine=refine, state_layout=layout))
                require(np.array_equal(res.membership, gold[key]),
                        f"{key} not reproduced under state_layout={layout}")
                require(resolve.resolve_groups.launches == len(batches),
                        f"{key}: K4 launched {resolve.resolve_groups.launches}"
                        f" times over {len(batches)} batches")
                log("sharded", f"{key} reproduced through NCCL at world size "
                    f"1 by louvain_dynamic_sharded, state_layout={layout}: "
                    f"K4 launched {resolve.resolve_groups.launches} times, "
                    f"comm_rounds {res.comm_rounds}, bytes_on_wire "
                    f"{res.bytes_on_wire}, halo_bytes {res.halo_bytes}")

        # (b) phase 4's graph at world size 1, gather exchange.
        coarsen.coarsen_groups.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        mem, n_comms, stats = distributed_louvain(g, group,
                                                  comm_backend="gather")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = coarsen.coarsen_groups.launches
        loop_s = sum(s["seconds"] for s in stats)
        for i, s in enumerate(stats):
            log("sharded", f"R-MAT scale {args.scale} pass {i}: n_pad "
                f"{s['n_pad']} e_per_shard {s['e_per_shard']} iterations "
                f"{s['iterations']} communities {s['n_communities']} "
                f"comm_rounds {s['comm_rounds']} comm_bytes "
                f"{s['comm_bytes']} phase_s " + json.dumps(
                    {k: round(v, 6) for k, v in s["phase_seconds"].items()}))
        log("sharded", f"distributed_louvain at world size 1 (NCCL, gather) "
            f"on R-MAT scale {args.scale}: {wall:.3f} s wall incl. the host "
            f"partition, pass loop {loop_s:.3f} s, "
            f"{g.e_valid / wall:.4e} edges/s ({g.e_valid / loop_s:.4e} over "
            f"the pass loop), {n_comms} communities, comm_rounds "
            f"{sum(s['comm_rounds'] for s in stats)}, comm_bytes "
            f"{sum(s['comm_bytes'] for s in stats)}, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, K3 "
            f"launches {launches}")
        if not np.array_equal(mem, membership):
            first = int(np.flatnonzero(mem != membership)[0])
            raise Failure(f"sharded R-MAT membership differs from phase 4's "
                          f"louvain() first at vertex {first}: {mem[first]} "
                          f"against {membership[first]}")
        require(launches == 2 * (len(stats) - 1) and launches > 0,
                f"K3 launched {launches} times over {len(stats) - 1} sharded "
                f"aggregations")
        log("sharded", "the sharded membership equals phase 4's louvain()")
        sharded_k3_check(torch, g, level0, report, launches)
        del g

        # (c) world size 1 on the staged run's graph and stream.
        g18 = rmat_graph(args.sharded_scale, EDGE_FACTOR, seed=SHARDED_SEED,
                         device=dev)
        want = {}
        for cb in ("gather", "delta"):
            want[cb] = distributed_louvain(g18, group, comm_backend=cb)[0]
        require(np.array_equal(want["gather"], want["delta"]),
                "gather and delta differ at world size 1")
        init18, batches18, _, _, _, sizes = holdout_stream(
            torch, g18, dev, 13, SHARDED_STREAM_B_CAP)
        want_stream = louvain_dynamic_sharded(init18, group,
                                              batches18).membership
        # The staged fleet's tenants start from the stream's cold start.
        cold18 = louvain_dynamic_sharded(init18, group, []).membership
        log("sharded", f"the staged run's stream at R-MAT scale "
            f"{args.sharded_scale}: {sizes}")

    graphs = {"rmat": graph_arrays(g18), "stream": graph_arrays(init18)}
    bl = [{"src": b.src.cpu().numpy(), "dst": b.dst.cpu().numpy(),
           "weight": b.weight.cpu().numpy(), "b_valid": b.b_valid}
          for b in batches18]
    runs = [("rmat", {"comm_backend": "gather"}),
            ("rmat", {"comm_backend": "auto"}),
            ("rmat", {"comm_backend": "gather", "state_layout": "hybrid"}),
            ("rmat", {"comm_backend": "delta", "state_layout": "hybrid"}),
            ("rmat", {"comm_backend": "auto", "reshard": "auto"}),
            ("stream", {"batches": bl}),
            # Phase 9 (d): two tenants of the stream through serve_fleet.
            ("stream", {"tenants": {t: {"graph": "stream", "batches": bl,
                                        "prev": cold18} for t in "ab"},
                        "screening": "community"})]
    del init18, batches18
    t = time.perf_counter()
    out = collectives.launch(dist_mod.rank_runs, SHARDED_RANKS, graphs, runs,
                             backend="gloo",
                             devices=[str(dev)] * SHARDED_RANKS,
                             timeout=300)
    wall = time.perf_counter() - t
    def memberships(res):
        if isinstance(res, tuple):
            return [res[0]]
        if isinstance(res.membership, dict):
            return list(res.membership.values())
        return [res.membership]

    for i in range(len(runs)):
        first = memberships(out[0]["results"][i])
        for o in out[1:]:
            other = memberships(o["results"][i])
            require(len(other) == len(first)
                    and all(np.array_equal(a, b)
                            for a, b in zip(other, first)),
                    f"the staged ranks disagree in run {i}")
    for i, what in enumerate(("gather", "auto (delta)", "hybrid, gather",
                              "hybrid, delta")):
        mem, n_comms, stats = out[0]["results"][i]
        require(np.array_equal(mem, want["gather"]),
                f"{SHARDED_RANKS} staged gloo ranks ({what}) differ from "
                f"world size 1")
        log("sharded", f"{SHARDED_RANKS} gloo ranks on one card, R-MAT scale "
            f"{args.sharded_scale}, {what}: equal to world size 1 "
            f"({n_comms} communities); state_layout "
            f"{stats[0]['state_layout']}, rounds "
            f"{[s['comm_rounds'] for s in stats]}, fallback rounds "
            f"{[s['comm_fallback_rounds'] for s in stats]}, comm_bytes "
            f"{sum(s['comm_bytes'] for s in stats)}, halo_bytes "
            f"{sum(s['halo_bytes'] for s in stats)}, boundary_frac "
            f"{stats[0]['boundary_frac']}, e_per_shard "
            f"{[s['e_per_shard'] for s in stats]}")
    # reshard="auto" against reshard="none" (the auto-exchange run): the
    # reference's quality-parity rule.
    mem_none, n_none, _ = out[0]["results"][1]
    mem_auto, n_auto, stats = out[0]["results"][4]
    q_none = membership_modularity(g18, mem_none)
    q_auto = membership_modularity(g18, mem_auto)
    fired = [s for s in stats if s["reshard"]]
    log("sharded", f"{SHARDED_RANKS} gloo ranks, reshard='auto': "
        f"{'fired' if fired else 'did not fire'} in {len(fired)} of "
        f"{len(stats)} passes, load fraction before "
        f"{[s['max_shard_load_frac_before'] for s in fired]} after "
        f"{[s['max_shard_load_frac_after'] for s in fired]}, reshard_bytes "
        f"{[s['reshard_bytes'] for s in fired]}; Q {q_auto:.6f} ({n_auto} "
        f"communities) against reshard='none' {q_none:.6f} ({n_none})")
    require(q_auto >= q_none - 0.01 * abs(q_none),
            f"reshard='auto' Q {q_auto} more than 1% below reshard='none' "
            f"{q_none}")
    res = out[0]["results"][5]
    require(np.array_equal(res.membership, want_stream),
            f"the {SHARDED_RANKS}-rank louvain_dynamic_sharded differs from "
            f"world size 1")
    log("sharded", f"{SHARDED_RANKS} gloo ranks, louvain_dynamic_sharded on "
        f"phase 5's recipe: equal to world size 1 ({res.n_communities} "
        f"communities), comm_backend {res.comm_backend}, comm_rounds "
        f"{res.comm_rounds}, fallback rounds {res.comm_fallback_rounds}, "
        f"regrows {res.n_regrows}, {res.total_seconds:.3f} s on rank 0 "
        f"(partition {res.partition_seconds:.3f} s)")
    log("sharded", f"staged gloo run: bytes staged through pinned host "
        f"memory per rank {[o['staged_bytes'] for o in out]}, collectives "
        f"per rank {[o['collectives'] for o in out]}; {wall:.2f} s wall for "
        f"{len(runs)} runs incl. {SHARDED_RANKS} process starts "
        f"(host-staged collectives on one card: not a multi-GPU number)")
    return out[0]["results"][6], res.membership


def phase_sharded_stream(torch, dev, report, stream):
    """Phase 5's stream once more, through ``louvain_dynamic_sharded`` at
    world size 1 (NCCL, gather exchange, replicated layout): the final
    membership must be phase 5's, with K4 launched once per batch; then K4
    of the first batch's per-rank apply against its plain version."""
    from repro_torch import LouvainConfig, louvain_dynamic_sharded
    from repro_torch.core.distributed_dynamic import sorted_shard_batch_slots
    from repro_torch.kernels.aggregate import coarsen
    from repro_torch.kernels.batch_apply import resolve
    init, batches, prev, want = stream
    with nccl_world_of_one(dev) as group:
        resolve.resolve_groups.launches = 0
        coarsen.coarsen_groups.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        res = louvain_dynamic_sharded(init, group, batches, prev=prev,
                                      config=LouvainConfig(
                                          comm_backend="gather"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        k4, k3 = resolve.resolve_groups.launches, coarsen.coarsen_groups.launches
        peak = torch.cuda.max_memory_allocated() / 2**30
    for i, st in enumerate(res.batch_stats):
        log("sharded_stream", f"batch {i}: apply_seconds "
            f"{st.apply_seconds:.6f} update_seconds {st.update_seconds:.6f} "
            f"touched {st.n_touched} frontier {st.frontier_size} "
            f"communities {st.n_communities}")
    updates = sum(st.batch_size for st in res.batch_stats)
    stream_s = res.total_seconds - res.partition_seconds
    log("sharded_stream", f"louvain_dynamic_sharded at world size 1 (NCCL, "
        f"gather, replicated) on phase 5's stream: {res.total_seconds:.3f} s "
        f"incl. the host partition ({res.partition_seconds:.3f} s), "
        f"{stream_s:.3f} s without it; updates_per_second "
        f"{res.updates_per_second:.4f} ({updates / stream_s:.4f} without "
        f"the partition); {wall:.3f} s wall; e_per_shard "
        f"{res.spec.e_per_shard}, regrows {res.n_regrows}, comm_rounds "
        f"{res.comm_rounds}, bytes_on_wire {res.bytes_on_wire}, pass loops "
        f"{res.pass_seconds_total:.3f} s; peak memory {peak:.2f} GiB; "
        f"launches K4 {k4} K3 {k3}")
    require(k4 == STREAM_BATCHES,
            f"K4 launched {k4} times over {STREAM_BATCHES} batches")
    if not np.array_equal(res.membership, want):
        first = int(np.flatnonzero(res.membership != want)[0])
        raise Failure(f"the sharded stream's membership differs from phase "
                      f"5's louvain_dynamic first at vertex {first}")
    log("sharded_stream", "the sharded stream ends on phase 5's "
        "louvain_dynamic membership")

    # K4 of the first batch on the rank's slots.  At world size 1 the rank
    # owns every vertex (n_pad = n_cap) and its slots are the graph's live
    # slots in CSR order, padded to e_per_shard (what partition_graph_host
    # and the headroom give), as the stream's first apply saw them.
    spec = res.spec
    require(res.n_regrows == 0 and spec.n_pad == init.n_cap,
            "the sharded stream's layout is not phase 5's graph")
    e, pad = init.e_valid, spec.e_per_shard - init.e_valid

    def padded(x, fill):
        return torch.cat([x[:e], torch.full((pad,), fill, dtype=x.dtype,
                                            device=dev)])

    b0 = batches[0]
    slots = sorted_shard_batch_slots(
        spec, 0, padded(init.src, spec.sentinel),
        padded(init.indices, spec.sentinel), padded(init.weights, 0.0),
        b0.src, b0.dst, b0.weight, b0.b_valid, n_limit=init.n_cap)
    sent = spec.sentinel
    got = resolve.resolve_groups(*slots, sent=sent)
    want_k4 = resolve.resolve_groups_ref(*slots, sent=sent)
    torch.cuda.synchronize()
    require(same_records(torch, got, want_k4),
            "the per-rank K4 differs from its plain version on the first "
            "batch")
    total = slots[0].numel()
    err = float((got[4] - want_k4[4]).abs().max())
    log("kernels", f"per-rank K4, first batch: bit for bit on {total} sorted "
        f"slots, {int(got[0].sum())} kept, {int(got[5].sum())} changed")
    del got, want_k4
    ms = time_ms(torch, lambda: resolve.resolve_groups(*slots, sent=sent), 10)
    plain_ms = time_ms(torch, lambda: resolve.resolve_groups_ref(
        *slots, sent=sent), 3)
    bound_bytes = 13 * total + 18 * (total + 1)
    log("sharded_stream", f"per-rank K4 on {total} slots: {ms:.4f} ms (plain "
        f"{plain_ms:.4f} ms); bytes once {bound_bytes}, "
        f"{ms / (bound_bytes / HBM_BYTES_PER_S * 1e3):.3f}x the bound")
    report.append(kernel_entry("resolve_groups_sharded", k4, err, ms,
                               plain_ms, bound_bytes, total))


def ring_whale(dev, n=64, n_batches=8, k=12):
    """Phase 9's whale: a sparse ring whose envelope is tight, and dense
    insert batches that blow through it mid-stream (the reference's
    ``tests/test_fleet.py`` whale)."""
    from repro_torch import build_csr, make_edge_batch
    s = np.arange(n, dtype=np.int64)
    d = (s + 1) % n
    g = build_csr(np.concatenate([s, d]), np.concatenate([d, s]),
                  np.ones(2 * n, np.float32), n, e_cap=2 * n + 4 * k,
                  device=dev)
    rng = np.random.default_rng(7)
    batches = []
    for _ in range(n_batches):
        bs = rng.integers(0, n, k)
        bd = (bs + 2 + rng.integers(0, n - 3, k)) % n
        batches.append(make_edge_batch(bs, bd, np.ones(k, np.float32),
                                       g.n_cap, b_cap=k, device=dev))
    return g, batches


def phase_serving_fleet(torch, args, dev, report, tenants, staged):
    """The multi-tenant sharded serving fleet (``serve_fleet``,
    ``FleetRouter``): (a) the sbm golden stream through one- and two-tenant
    fleets through NCCL at world size 1 under both state layouts; (b) the
    whale with its buddy and a fallback configuration, each tenant against
    its solo ``louvain_dynamic_sharded``; (c) phase 6's tenants from their
    cold memberships, each of which must end on its phase 6 stream
    membership, with K4 launched once per bucket dispatch and the first
    dispatch's K4 held against its plain version; (d) phase 7's staged
    4-rank fleet against that launch's solo stream."""
    from repro_torch import (FleetRouter, LouvainConfig,
                             louvain_dynamic_sharded, sbm_edge_stream,
                             sbm_holdout_stream, serve_fleet)
    from repro_torch.core.delta import FleetBatch
    from repro_torch.core.distributed import LaneLayout, ShardedGraphSpec
    from repro_torch.core.distributed_dynamic import sorted_shard_batch_slots
    from repro_torch.kernels.aggregate import coarsen
    from repro_torch.kernels.batch_apply import resolve
    gold = np.load(GOLDEN)
    graphs, streams, prevs, finals = tenants
    with nccl_world_of_one(dev) as group:
        # (a) the sbm golden stream through one- and two-tenant fleets.
        init, batches = sbm_edge_stream(device=dev)
        for layout in ("replicated", "hybrid"):
            for tids in ("a", "ab"):
                resolve.resolve_groups.launches = 0
                res = serve_fleet({t: init for t in tids},
                                  {t: batches for t in tids}, group,
                                  screening="community",
                                  config=LouvainConfig(state_layout=layout))
                k4 = resolve.resolve_groups.launches
                require(all(np.array_equal(
                    res.membership[t], gold["sharded_dynamic__sbm_stream"])
                    for t in tids),
                    f"a {len(tids)}-tenant fleet misses "
                    f"sharded_dynamic__sbm_stream under {layout}")
                require(k4 == res.n_dispatches == len(batches),
                        f"K4 launched {k4} times over {res.n_dispatches} "
                        f"dispatches")
                log("serving_fleet", f"{len(tids)}-tenant fleet, "
                    f"state_layout={layout}: sharded_dynamic__sbm_stream "
                    f"reproduced through NCCL at world size 1; K4 launched "
                    f"{k4} times ({res.n_dispatches} dispatches), comm_rounds "
                    f"{res.comm_rounds}, bytes_on_wire {res.bytes_on_wire}, "
                    f"wire_bytes {res.wire_bytes}, halo_bytes "
                    f"{res.halo_bytes}")

        # (b) the control paths, small: whale migration, fallback replay.
        whale = ring_whale(dev)
        buddy = sbm_holdout_stream(39, n_cap=128, e_cap=1400, n_hold=24,
                                   n_steps=len(whale[1]), b_cap=8,
                                   device=dev)[:2]
        cases = {"whale": whale, "buddy": buddy}
        resolve.resolve_groups.launches = 0
        res = serve_fleet({t: c[0] for t, c in cases.items()},
                          {t: c[1] for t, c in cases.items()}, group,
                          screening="community")
        k4 = resolve.resolve_groups.launches
        homes = [env for env, tids in res.buckets.items() if "whale" in tids]
        require(res.n_migrations >= 1 and len(homes) == 1
                and homes[0].e_per_shard > 2 * whale[0].n_valid,
                f"the whale did not migrate into one bigger bucket "
                f"({res.n_migrations} migrations, homes {homes})")
        for t, (g, b) in cases.items():
            solo = louvain_dynamic_sharded(g, group, b, screening="community")
            require(np.array_equal(res.membership[t], solo.membership),
                    f"fleet tenant {t} differs from its solo stream")
        log("serving_fleet", f"whale and buddy: {res.n_migrations} "
            f"migration(s), the whale's home {homes[0]}, buckets "
            f"{ {tuple(k): v for k, v in res.buckets.items()} }; K4 launched "
            f"{k4} times ({res.n_dispatches} dispatches + the re-applies); "
            f"both equal their solo louvain_dynamic_sharded")
        cfg = LouvainConfig(aggregation_tolerance=1.0, initial_tolerance=0.0)
        router = FleetRouter(group, cfg, screening="community")
        small = {}
        for tid, seed in (("a", 36), ("b", 37)):
            g, b, _ = sbm_holdout_stream(seed, n_cap=128, e_cap=1400,
                                         n_hold=24, n_steps=3, b_cap=8,
                                         device=dev)
            router.admit(tid, g, prev=np.arange(g.n_cap, dtype=np.int32),
                         b_cap=8)
            small[tid] = (g, b)
        coarsen.coarsen_groups.launches = 0
        res = router.serve({t: c[1] for t, c in small.items()})
        k3 = coarsen.coarsen_groups.launches
        require(res.n_fallbacks > 0 and k3 > 0,
                f"the fallback configuration replayed {res.n_fallbacks} "
                f"lanes, K3 launched {k3} times")
        for t, (g, b) in small.items():
            solo = louvain_dynamic_sharded(
                g, group, b, prev=np.arange(g.n_cap, dtype=np.int32),
                config=cfg, screening="community")
            require(np.array_equal(res.membership[t], solo.membership),
                    f"fallback tenant {t} differs from its solo stream")
        log("serving_fleet", f"fallback configuration: {res.n_fallbacks} "
            f"lanes replayed through the solo pass loop, K3 launched {k3} "
            f"times; both tenants equal their solo louvain_dynamic_sharded")
        del whale, buddy, cases, small, router

        # (c) phase 6's tenants from their cold memberships.
        S = len(graphs)
        tids = [f"t{s}" for s in range(S)]
        cfg = LouvainConfig(comm_backend="gather")
        router = FleetRouter(group, cfg, screening="community")
        torch.cuda.synchronize()
        t = time.perf_counter()
        envs = [router.admit(tids[s], graphs[s], prev=prevs[s],
                             b_cap=streams[s][0].b_cap) for s in range(S)]
        torch.cuda.synchronize()
        admit_s = time.perf_counter() - t
        env = envs[0]
        require(all(e == env for e in envs),
                f"phase 6's tenants landed in {len(set(envs))} envelopes")
        spec = ShardedGraphSpec(group.world_size, env.v_per_shard,
                                env.e_per_shard, env.v_cap(group.world_size))
        live = sum(int((router.tenants[x].src < spec.sentinel).sum())
                   for x in tids)
        log("serving_fleet", f"{S} tenants admitted in {admit_s:.3f} s "
            f"(two host partitions each): envelope {env}, "
            f"{S * env.e_per_shard} slots in the bucket, {live} live "
            f"(padding share {1 - live / (S * env.e_per_shard):.4f})")

        # K4 of the first dispatch: the bucket's flat, lane-keyed slot list
        # of every tenant's admitted slots and step 0's batches.
        spec0 = LaneLayout(spec, S)
        flat = spec0.flat_slots([(router.tenants[x].src,
                                  router.tenants[x].dst,
                                  router.tenants[x].w) for x in tids])
        b0 = [streams[s][0] for s in range(S)]
        batch0 = FleetBatch(src=torch.stack([b.src for b in b0]),
                            dst=torch.stack([b.dst for b in b0]),
                            weight=torch.stack([b.weight for b in b0]),
                            b_valid=np.array([b.b_valid for b in b0]))
        slots = sorted_shard_batch_slots(
            spec0.spec, 0, *flat, batch0.src, batch0.dst, batch0.weight,
            batch0.b_valid, [g.n_cap for g in graphs])
        del flat
        sent = spec0.flat.sentinel
        got = resolve.resolve_groups(*slots, sent=sent)
        want = resolve.resolve_groups_ref(*slots, sent=sent)
        torch.cuda.synchronize()
        require(same_records(torch, got, want),
                "the bucket's K4 differs from its plain version on the "
                "first dispatch")
        k4_err = float((got[4] - want[4]).abs().max())
        total = slots[0].numel()
        log("kernels", f"sharded fleet K4, first dispatch: bit for bit on "
            f"{total} sorted slots of {S} lanes, {int(got[0].sum())} kept, "
            f"{int(got[5].sum())} changed")
        del want
        repeat_identical(torch, lambda: resolve.resolve_groups(
            *slots, sent=sent), got, 20, "sharded fleet K4")
        del got
        k4_ms = time_ms(torch, lambda: resolve.resolve_groups(
            *slots, sent=sent), 10)
        k4_plain = time_ms(torch, lambda: resolve.resolve_groups_ref(
            *slots, sent=sent), 3)
        k4_bytes = 13 * total + 18 * (total + 1)
        log("serving_fleet", f"sharded fleet K4 on {total} slots: "
            f"{k4_ms:.4f} ms (plain {k4_plain:.4f} ms); bytes once "
            f"{k4_bytes}, {k4_ms / (k4_bytes / HBM_BYTES_PER_S * 1e3):.3f}x "
            f"the bound")
        del slots

        # The serving run.
        updates = int(sum(b.b_valid for st in streams for b in st))
        resolve.resolve_groups.launches = 0
        coarsen.coarsen_groups.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res = router.serve(dict(zip(tids, streams)))
        torch.cuda.synchronize()
        k4 = resolve.resolve_groups.launches
        k3 = coarsen.coarsen_groups.launches
        peak = torch.cuda.max_memory_allocated() / 2**30
        for i in range(len(res.apply_seconds)):
            log("serving_fleet", f"step {i}: apply_seconds "
                f"{res.apply_seconds[i]:.6f} update_seconds "
                f"{res.update_seconds[i]:.6f}")
        modes = sorted({p.screening for st in res.pass_stats.values()
                        for p in st}, key=str)
        log("serving_fleet", f"serve_fleet of {S} tenants ({updates} "
            f"entries, {STREAM_BATCHES} steps) at world size 1 (NCCL, "
            f"gather, {res.state_layout}): {res.total_seconds:.3f} s, fleet "
            f"updates_per_second {updates / res.total_seconds:.4f} "
            f"({updates / (res.total_seconds + admit_s):.4f} with "
            f"admission); buckets "
            f"{ {tuple(k): len(v) for k, v in res.buckets.items()} }, "
            f"n_dispatches {res.n_dispatches}, n_fallbacks "
            f"{res.n_fallbacks}, n_migrations {res.n_migrations}, "
            f"comm_rounds {res.comm_rounds}, bytes_on_wire "
            f"{res.bytes_on_wire}, wire_bytes {res.wire_bytes}, screening "
            f"{modes}; launches K4 {k4} K3 {k3}; peak memory {peak:.2f} GiB")
        require(k4 == res.n_dispatches + res.n_migrations
                if res.n_migrations == 0 else
                k4 >= res.n_dispatches + res.n_migrations,
                f"K4 launched {k4} times over {res.n_dispatches} dispatches")
        require(res.n_dispatches == len(res.buckets) * STREAM_BATCHES
                or res.n_migrations > 0,
                f"{res.n_dispatches} dispatches for {len(res.buckets)} "
                f"bucket(s) over {STREAM_BATCHES} steps")
        for s in range(S):
            got_m = res.membership[tids[s]]
            if np.array_equal(got_m, finals[s]):
                continue
            # Tell a fleet fault from a sharded-versus-single-device one.
            solo = louvain_dynamic_sharded(graphs[s], group, streams[s],
                                           prev=prevs[s], config=cfg,
                                           screening="community").membership
            first = int(np.flatnonzero(got_m != finals[s])[0])
            what = ("the fleet differs from its solo sharded stream"
                    if not np.array_equal(got_m, solo) else
                    "the solo sharded stream differs from phase 6's")
            raise Failure(f"tenant {s}: {what}; first at vertex {first}: "
                          f"{got_m[first]} against {finals[s][first]}")
        log("serving_fleet", f"all {S} tenants end on their phase 6 "
            f"louvain_dynamic_batched memberships")
        report.append(kernel_entry("resolve_groups_fleet_sharded", k4,
                                   k4_err, k4_ms, k4_plain, k4_bytes, total))
        step_s = res.apply_seconds[0] + res.update_seconds[0]
        del res

        # Where a dispatch's time goes: one more step of every tenant.
        p_ms, n_ops, busy_ms, top = device_profile(torch, lambda: router.serve(
            {x: streams[s][:1] for s, x in enumerate(tids)}))
        log("serving_fleet", f"profile of one dispatch ({S} lanes): {n_ops} "
            f"device operations, device busy {busy_ms:.3f} ms, {p_ms:.3f} ms "
            f"profiled wall, {step_s * 1e3:.3f} ms unprofiled step 0 (idle "
            f"share {1 - busy_ms / (step_s * 1e3):.3f}); top by device ms "
            f"{json.dumps(top)}")
        del router

    # (d) phase 7's staged 4-rank fleet against that launch's solo stream.
    fleet4, stream4 = staged
    require(all(np.array_equal(m, stream4)
                for m in fleet4.membership.values()),
            f"the {SHARDED_RANKS}-rank fleet differs from its "
            f"louvain_dynamic_sharded stream")
    log("serving_fleet", f"{SHARDED_RANKS} staged gloo ranks: both fleet "
        f"tenants equal the launch's louvain_dynamic_sharded stream "
        f"({fleet4.n_dispatches} dispatches, {fleet4.n_fallbacks} "
        f"fallbacks, comm_rounds {fleet4.comm_rounds}, bytes_on_wire "
        f"{fleet4.bytes_on_wire}, wire_bytes {fleet4.wire_bytes})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=22,
                    help="R-MAT scale of phase 4 (2^scale vertices)")
    ap.add_argument("--streams", type=int, default=16,
                    help="tenants of phase 6's serving fleet")
    ap.add_argument("--stream-scale", type=int, default=18,
                    help="R-MAT scale of each phase 6 tenant")
    ap.add_argument("--sharded-scale", type=int, default=18,
                    help="R-MAT scale of phase 7's staged gloo ranks")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    try:
        from repro_torch.kernels.louvain_scan import ops
    except ImportError as exc:
        print(f"chip_smoke: run from the root of a checkout ({exc})",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    report = []
    t_all = time.perf_counter()
    state = {}
    try:
        for name, fn in (("build", lambda: phase_build(torch)),
                         ("kernels", lambda: phase_kernels_random(
                             torch, ops, dev)),
                         ("goldens", lambda: phase_goldens(torch, dev)),
                         ("full", lambda: state.update(zip(
                             ("g", "membership", "level0"), phase_full(
                                 torch, ops, args, dev, report)))),
                         ("stream", lambda: state.update(stream=phase_stream(
                             torch, state["g"], dev, report))),
                         ("fleet", lambda: state.update(
                             tenants=phase_fleet(torch, args, dev, report))),
                         ("sharded", lambda: state.update(
                             staged=phase_sharded(
                                 torch, args, dev, report, state.pop("g"),
                                 state.pop("membership"),
                                 state.pop("level0")))),
                         ("sharded_stream", lambda: phase_sharded_stream(
                             torch, dev, report, state.pop("stream"))),
                         ("serving_fleet", lambda: phase_serving_fleet(
                             torch, args, dev, report, state.pop("tenants"),
                             state.pop("staged")))):
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
