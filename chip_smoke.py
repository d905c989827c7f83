#!/usr/bin/env python3
"""Drive the PyTorch port of GVE-Louvain on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--scale 22] [--streams 16] [--stream-scale 18]
                          [--sharded-scale 18] [--seed 0]

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
     ranks) equal to that launch's ``louvain_dynamic_sharded`` stream;
 10. graph workloads at full width: (a) a planted-class graph drawn on the
     card at ogbn-products' published sizes (2,449,029 vertices,
     30,929,570 pairs = 61,859,140 directed slots, 47 classes, 100
     features); (b) ``louvain_partition`` onto 8 devices under the default
     config (K3) and ``use_ell_kernel=True`` (K1 and K3), one partition
     from both, against ``random_partition``, the first K3 launch and
     the first K1 launch of each ELL bucket held against their plain
     versions, the communities' Q in float64; (c) gin-tu (5 layers, d_hidden 64) on the
     graph in Louvain order: the first step's loss and gradients against
     float64, then 5 AdamW steps through ``build_gnn_step`` (finite,
     falling loss), time a step, peak memory and a ``torch.profiler``
     breakdown; (d) the halo step through NCCL at world size 1 equal to
     (c)'s first step, and the halo layouts of 4 and 8 shards at
     halo_frac 0.25 (measured halo against the cap and the all-gather);
     (e) gat-cora on a full_graph_sm batch, gin-tu on 32 blocks sampled
     from (a)'s graph at fanout (15, 10) and on the molecule batch; (f) 4
     gloo ranks on the one card (the halo GIN, also with bf16 messages,
     the halo Equiformer at full width and the all-gather layout) equal to
     world size 1;
 11. the geometric models at full width (Equiformer-v2: 12 layers,
     d_hidden 128, l_max 6, m_max 2, 8 heads; DimeNet: 6 blocks, d 128,
     n_bilinear 8, n_spherical 7, n_radial 6): (a) Equiformer-v2 on the
     molecule batch (128 x 30 nodes x 64 edges) and a full_graph_sm batch
     (2,708 nodes, 10,556 slots, 1,433 features), both from
     ``make_batch(--seed)`` with their edge lists made undirected
     (``undirected``), after the Wigner-D blocks' orthogonality at
     l_max 6: the first step's loss and gradients against a float64 copy
     on the card, the outputs under a random rotation and translation of
     the positions, 5 AdamW steps (finite, falling loss), time a step,
     peak memory and a ``torch.profiler`` breakdown; (b) DimeNet the same
     way, its triplets built from each graph's edges by
     ``build_triplets_host``; (c) a planted-class graph of Cora's sizes
     drawn on the card, ``louvain_partition`` onto 4 devices (K3; K1 and
     K3; the first launches held against their plain versions), the
     4-shard halo layout at the smallest halo_frac that holds it, and the
     full-width Equiformer halo step through NCCL at world size 1 equal to
     the plain step (m_truncate on and off) and with bf16 edges within
     2e-2; (d) the halo Equiformer on 4 gloo ranks rides phase 10 (f);
 12. the FM recommender at full Criteo width (39 fields, embed_dim 10,
     the 29,333,260 rows of ``DEFAULT_VOCABS`` padded to 29,333,504), from
     ``--seed``: (a) train_batch (B = 65,536) from
     ``synthetic_click_batches``: the forward on 64 rows against the
     O(F^2) pairwise oracle in float64, the first step's loss and dense
     gradients against a float64 copy, two identical first steps (bit
     for bit: the gathers' backward is a sorted segment sum in a fixed
     order), 5 AdamW steps at lr 1e-2 (finite, falling
     loss), seconds a step, peak memory and a ``torch.profiler``
     breakdown with the idle share; (b) serve_p99 (B = 512) and
     serve_bulk (B = 262,144) through ``build_step`` equal to
     ``forward``, seconds a call (median of 30) and examples/s; (c)
     retrieval over 1,000,448 candidates against the float64 expression,
     top-100 sets equal, seconds a call; (d) ``train()`` at full width: 6
     steps, then 3 steps, a checkpoint (3.87 GB of npz, keep_n 1, in a
     temporary directory removed after) and a fresh ``train()`` resumed to
     6, equal to the uninterrupted run bit for bit, save / scan / restore seconds, and one step each
     with ``topk`` (fraction 0.01) and ``int8`` compression holding ``sent
     + residual == g + r`` exactly; (e) 4 gloo ranks on the one card, the
     table split by rows, train step, serve_bulk and retrieval equal to
     world size 1 within 1e-5, and the row-split train step through NCCL
     at world size 1 (its collectives counted) against the plain step;
     (f) ``lfr_graph`` and ``powerlaw_cluster(m=10, p=0.3)`` at 100,000
     vertices (NumPy on the host, CSR on the card), ``louvain()`` on each
     through K3 and through K1 + K3 (``louvain_checked``: one membership,
     the first launches held against their plain versions), the LFR
     mixing fraction against mu 0.1 and the NMI of Louvain's membership
     against the planted communities;
 13. the LM stack, weights from ``init_params(--seed)`` and tokens from
     ``synthetic_token_batches``: qwen2-1.5b at its published full width
     (28 layers, d_model 1,536, vocab 151,936; 1,543,714,304 parameter
     elements): (a) train_4k at B 4 (published 256): the first step's loss
     and gradients in float32 against a float64 copy at B 1, S 512, two
     identical bf16 first steps bit for bit, 5 AdamW steps (finite,
     falling loss), seconds a step, tokens/s, peak memory, a
     ``torch.profiler`` breakdown, and the model FLOPs' bound at the bf16
     peak; (b) prefill_32k at B 1 (published 32): seconds (median of 3),
     peak, and the last logits of a 4,096-token prefill against that
     position of the 32,768-token forward; (c) decode: 64 tokens through
     ``decode_step`` against ``forward`` in float32, the int8 cache against
     the bf16 one, and 16 timed steps at B 32 (published 128) against a
     32,768-position cache filled from the seed, each cache beside its
     bytes-once bound; (e) gemma3-12b (one 5:1 pattern, 6 layers),
     internlm2-20b, mixtral-8x22b and deepseek-v2-236b (2 layers each) at
     published widths: float32 decode against forward (MoE with no token
     dropped), bf16 prefill at S 8,192, one decode step at decode_32k (B
     16) and, for the three with long_500k, at a 524,288-position cache,
     and one bf16 train step at S 4,096 (mixtral and deepseek at 1 layer);
     (f) ``python -m repro_torch.launch.train`` in subprocesses: qwen2-1.5b
     and fm for 20 steps (falling loss) and ``--arch louvain`` on R-MAT
     scale 12, equal to an in-process ``louvain()`` whose K1/K3 launches
     are held against their plain versions (``louvain_checked``);
 14. LM sharding over a (data, model) grid of ranks (no kernel on this
     path): (a) a 1 x 1 grid over one NCCL rank equal to
     ``ShardGroup.single`` bit for bit (qwen2-1.5b bf16 at full width, 2
     layers: a train step with one AdamW step, a prefill, a decode
     step); (b) 4 gloo ranks on the one card as a (2, 2) grid, qwen2-1.5b
     at full width and 2 layers in float32 against one rank: a train
     step (loss within 1e-5, gradients within 1e-4 of each tensor's
     largest entry), ``sharded_ce`` on labels 30% ignored (and its
     identity with the dense loss), the prefill's last logits (B 4, S
     1,024), decode at B 4 against a 32,768-position cache split over
     ``model`` and at B 1 against a 524,288-position cache split over all
     4 ranks, each from the cache's last two positions (logits within
     1e-4), then a bf16 train step timed (seconds, tokens/s, peak memory
     and staged bytes per rank); (c) mixtral-8x22b and deepseek-v2-236b
     at full width and 1 layer in float32, experts split over ``model``
     (4 and 80 a rank): prefill at B 2, S 4,096 and decode (the
     ``tp_only_params`` layout) against one rank, a bf16 mixtral train
     step timed, and the mixtral smoke config's train step against one
     rank;
 15. the dry run and the Louvain arch's distributed phases: (a) on a
     road-like graph drawn on the card from ``--seed`` at road_108M's size
     (50,912,018 vertices, 108,109,320 unit-weight slots: a path and
     short shortcuts, average degree ~2.1 as europe_osm's), through NCCL
     at world size 1, ``LouvainArch``'s move step against its
     ``"delta_c"`` variant (membership exact, Sigma and dQ within 1e-4)
     and its aggregate step against ``"a2a"`` (records equal, exact), all
     four K3 launches held against the plain version bit for bit, each
     step's ms (CUDA events) and peak memory; (b) the smoke Louvain shapes
     on 4 gloo ranks on the card (a2a equal to gather, delta-C equal to
     the gather round) and (d) DimeNet's full_graph_sm at full width on
     the same 4 ranks against one rank (loss within 1e-5, gradients
     within 1e-4 of the largest entry), seconds a step; (c) qwen2-1.5b at
     2 layers on a 1 x 1 NCCL grid: train (B 4, S 4,096), prefill (B 1, S
     4,096) and decode (B 4, a 32,768-position cache) on the card under
     the dry run's counters against the dry run of the same steps: FLOPs
     and argument bytes equal, the high-water marks side by side.

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
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time
import types

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
    # K3 and K1 in the Louvain partitioner of the graph workloads (phase
    # 10).
    "coarsen_groups_partition": ("src/repro_torch/csrc/coarsen.cu",
                                 "src/repro/kernels/aggregate/coarsen.py:113"),
    "louvain_fused_partition": ("src/repro_torch/csrc/louvain_scan.cu",
                                "src/repro/kernels/louvain_scan/fused.py:111"),
    # K3 and K1 in the partition of the Equiformer halo layout (phase 11).
    "coarsen_groups_halo": ("src/repro_torch/csrc/coarsen.cu",
                            "src/repro/kernels/aggregate/coarsen.py:113"),
    "louvain_fused_halo": ("src/repro_torch/csrc/louvain_scan.cu",
                           "src/repro/kernels/louvain_scan/fused.py:111"),
    # K3 and K1 in louvain() on the NumPy LFR and powerlaw-cluster graphs
    # (phase 12 (f)).
    "coarsen_groups_lfr": ("src/repro_torch/csrc/coarsen.cu",
                           "src/repro/kernels/aggregate/coarsen.py:113"),
    "louvain_fused_lfr": ("src/repro_torch/csrc/louvain_scan.cu",
                          "src/repro/kernels/louvain_scan/fused.py:111"),
    "coarsen_groups_powerlaw": ("src/repro_torch/csrc/coarsen.cu",
                                "src/repro/kernels/aggregate/coarsen.py:113"),
    "louvain_fused_powerlaw": ("src/repro_torch/csrc/louvain_scan.cu",
                               "src/repro/kernels/louvain_scan/fused.py:111"),
    # K3 in the training CLI's louvain run on its R-MAT graph (phase 13
    # (f)); the CLI's LouvainConfig() does not take K1.
    "coarsen_groups_cli": ("src/repro_torch/csrc/coarsen.cu",
                           "src/repro/kernels/aggregate/coarsen.py:113"),
    # K3 in the Louvain arch's road_108M aggregation steps (phase 15 (a)):
    # the gather baseline (its owner-side re-reduce) and the owner-routed
    # all-to-all (its re-reduce over n_shards x cap records).
    "coarsen_groups_gather": ("src/repro_torch/csrc/coarsen.cu",
                              "src/repro/kernels/aggregate/coarsen.py:113"),
    "coarsen_groups_a2a": ("src/repro_torch/csrc/coarsen.cu",
                           "src/repro/kernels/aggregate/coarsen.py:113"),
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


# ---------------------------------------------------------------------------
# Phase 10: graph workloads (the Louvain partitioner, GNN training).
# ---------------------------------------------------------------------------

#: Phase 10 (a): ogbn-products' published sizes (``GNN_SHAPES[
#: "ogb_products"]``): vertices, undirected pairs (61,859,140 directed
#: slots), classes and features.  The dataset is not in the repository, so
#: a graph of these sizes is drawn from ``--seed``: PRODUCTS_INTRA of the
#: pairs inside a planted class, the rest uniform.
PRODUCTS_NODES = 2_449_029
PRODUCTS_PAIRS = 30_929_570
PRODUCTS_CLASSES = 47
PRODUCTS_FEAT = 100
PRODUCTS_INTRA = 0.8
#: Devices of the partition (b) and shard counts of the halo layouts (d).
PARTITION_DEVICES = 8
HALO_SHARDS = (4, 8)
GNN_STEPS = 5
#: Phase 10's AdamW: no warmup, cosine to 0.1 over the steps taken.
GNN_LR = 1e-4
#: float32 against float64 (c), and the halo step against the plain one
#: (d): relative error of the loss, and of each gradient tensor's largest
#: entry.
GNN_RTOL = 1e-4
#: Phase 10 (f): gloo ranks on the one card, and the width of the halo
#: Equiformer they run (phase 11 (d); equiformer-v2's full width).
GNN_RANKS = 4
RANKS_EQUIFORMER = dict(n_layers=12, d_hidden=128, l_max=6, m_max=2,
                        n_heads=8)


def products_graph(torch, dev, n: int, n_pairs: int, seed: int,
                   n_classes: int = PRODUCTS_CLASSES):
    """(classes, src, dst) of ``n_pairs`` undirected pairs over ``n``
    vertices, drawn on the card from ``seed``: each vertex's class uniform
    over ``n_classes``; a pair joins a uniform vertex u to a uniform
    member of u's class (probability PRODUCTS_INTRA) or to a uniform
    vertex; a pair (u, u) takes u + 1 instead."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    cls = torch.randint(n_classes, (n,), generator=gen, device=dev)
    members = torch.sort(cls, stable=True).indices
    size = torch.bincount(cls, minlength=n_classes)
    off = torch.cumsum(size, 0) - size
    u = torch.randint(n, (n_pairs,), generator=gen, device=dev)
    cu = cls[u]
    pick = (torch.rand(n_pairs, generator=gen, device=dev)
            * size[cu]).long().clamp_max(size[cu] - 1)
    v = torch.where(torch.rand(n_pairs, generator=gen, device=dev)
                    < PRODUCTS_INTRA, members[off[cu] + pick],
                    torch.randint(n, (n_pairs,), generator=gen, device=dev))
    v = torch.where(v == u, (v + 1) % n, v)
    return cls, u.to(torch.int32), v.to(torch.int32)


@contextlib.contextmanager
def first_call_recorded(module, name: str, key=None):
    """Replace ``module.name`` (a by-name import of a kernel wrapper) with a
    recorder that keeps clones of the first call's arguments and outputs
    for each value of ``key(kwargs)`` (one entry, ``None``, without a
    ``key``) and calls the wrapper itself, which counts its launches as
    before."""
    real = getattr(module, name)
    seen = {}

    def clone(a):
        return a.clone() if hasattr(a, "clone") else a

    def recorder(*args, **kwargs):
        out = real(*args, **kwargs)
        k = key(kwargs) if key else None
        if k not in seen:
            seen[k] = {"args": tuple(clone(a) for a in args),
                       "kwargs": dict(kwargs),
                       "out": tuple(o.clone() for o in out)}
        return out

    setattr(module, name, recorder)
    try:
        yield seen
    finally:
        setattr(module, name, real)


@contextlib.contextmanager
def timed_calls(torch, module, name: str):
    """Replace ``module.name`` with a wrapper that calls it between two
    syncs and records each call's seconds (the wrapper still counts its
    launches)."""
    real = getattr(module, name)
    spent = []

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real(*args, **kwargs)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t)
        return out

    setattr(module, name, timed)
    try:
        yield spent
    finally:
        setattr(module, name, real)


def modularity_f64(torch, g, membership) -> float:
    """Q (Eq. 1) of a flat membership on ``g`` in float64, from the valid
    slots alone: the share of the slot weight inside a community less the
    sum of squared community totals over 2m (no code of the port)."""
    e = g.e_valid
    src, dst = g.src[:e].long(), g.indices[:e].long()
    w = g.weights[:e].double()
    mem = torch.as_tensor(np.asarray(membership, np.int64), device=g.device)
    two_m = w.sum()
    inside = w[mem[src] == mem[dst]].sum()
    tot = torch.zeros(int(mem.max()) + 1, dtype=torch.float64,
                      device=g.device).index_add_(0, mem[src], w)
    return float(inside / two_m - ((tot / two_m) ** 2).sum())


def grads_agree(got: dict, want: dict, per_tensor: bool = True) -> float:
    """The largest, over tensors, of max |got - want| over max |want| of
    that tensor (``per_tensor``) or of all of them (a tensor whose entries
    cancel to near zero, as the attention's output bias in Equiformer's
    segment softmax, is held to the model's gradient scale)."""
    top = max(float(w.abs().max()) for w in want.values())
    worst = 0.0
    for k, w in want.items():
        scale = float(w.abs().max()) if per_tensor else top
        err = float((got[k].to(w.dtype) - w).abs().max())
        if not (np.isfinite(err) and np.isfinite(scale)):
            return float("inf")
        worst = max(worst, err / scale if scale else err)
    return worst


def gnn_run(torch, arch, shape, batch, dev, steps: int, what: str):
    """``steps`` AdamW steps of ``arch`` on ``batch`` at world size 1: the
    losses must be finite and the last below the first."""
    from repro_torch import ShardGroup
    from repro_torch.optim import AdamWConfig, adamw_init
    model = arch.init_model(shape, seed=0, device=dev)
    step = arch.build_step(shape, ShardGroup.single(dev), opt_cfg=AdamWConfig(
        lr=GNN_LR, warmup_steps=0, total_steps=steps))
    opt = adamw_init(model)
    losses = []
    t = time.perf_counter()
    for _ in range(steps):
        opt, loss = step(model, opt, batch)
        losses.append(float(loss))
    torch.cuda.synchronize()
    per = (time.perf_counter() - t) / steps
    require(all(np.isfinite(losses)) and losses[-1] < losses[0],
            f"{what}: losses {losses} not finite and falling")
    log("graph", f"{what}: {steps} steps, losses {losses}, {per:.4f} s a "
        f"step")
    return losses


def partition_checked(torch, ops, g, n_devices: int, report, phase: str,
                      step: str, k3_name: str, k1_name: str):
    """``louvain_partition(g, n_devices)`` through ``louvain_checked``;
    both configs must give one partition.  Returns the partition."""
    from repro_torch import louvain_partition
    return louvain_checked(
        torch, ops, g, lambda cfg: louvain_partition(g, n_devices, cfg),
        lambda lp: (f"louvain_partition(g, {n_devices}): cut fraction "
                    f"{lp.cut_fraction:.6f} ({lp.cut_edges} of "
                    f"{lp.total_edges} slots), balance {lp.balance:.6f}"),
        lambda lp: (lp.assignment, lp.order), report, phase, step, k3_name,
        k1_name)


def louvain_checked(torch, ops, g, run, describe, key, report, phase: str,
                    step: str, k3_name: str, k1_name: str):
    """``run(cfg)`` (a call of ``louvain()`` on ``g``, or of a partitioner over
    it) under the default config (K3) and with ``use_ell_kernel=True`` (K1
    and K3), whose ``key``s must be equal; each kernel of a run is counted
    from 0 and must have launched; the first K3 launch of the default run
    and the first K1 launch of each ELL bucket are held against their
    plain versions bit for bit, timed against their bounds and added to
    ``report`` as ``k3_name`` / ``k1_name``.  Returns the default run's
    result."""
    from repro_torch import LouvainConfig
    from repro_torch.core import aggregate
    from repro_torch.kernels.aggregate import coarsen

    parts = {}
    for what, cfg, needs in (
            ("default", LouvainConfig(), ("coarsen_groups",)),
            ("use_ell_kernel=True", LouvainConfig(use_ell_kernel=True),
             ("louvain_fused", "coarsen_groups"))):
        coarsen.coarsen_groups.launches = 0
        ops.louvain_fused.launches = 0
        with first_call_recorded(aggregate, "coarsen_groups") as first, \
                timed_calls(torch, ops, "louvain_fused") as k1_s, \
                first_call_recorded(ops, "louvain_fused",
                                    key=lambda kw: kw["width"]) as k1_first:
            torch.cuda.synchronize()
            t = time.perf_counter()
            lp = run(cfg)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
        counts = {"louvain_fused": ops.louvain_fused.launches,
                  "coarsen_groups": coarsen.coarsen_groups.launches}
        for k in needs:
            require(counts[k] > 0, f"{step} ({what}): {k} never launched")
        parts[what] = (lp, counts, secs, first.get(None), k1_first)
        log(phase, f"{step} {describe(lp)}, {what}: {secs:.3f} s, "
            f"launches {json.dumps(counts)}"
            + (f"; K1 through its checked wrapper {sum(k1_s) * 1e3:.3f} ms "
               f"in all over {len(k1_s)} calls (between syncs)"
               if k1_s else ""))
    lp, k3_counts, _, first, _ = parts["default"]
    lp_ell, k1_counts, _, _, k1_first = parts["use_ell_kernel=True"]
    require(all(np.array_equal(a, b) for a, b in zip(key(lp), key(lp_ell))),
            f"{step}: the default and the ELL runs differ")
    # The first K1 launch of each ELL bucket (round 0 of the first pass,
    # one state) against its plain version, bit for bit.
    k1_calls = [k1_first[w] for w in sorted(k1_first)]
    k1_err = 0.0
    for c in k1_calls:
        want = ops.louvain_fused_rows_ref(*c["args"], **c["kwargs"])
        for i, (a, b) in enumerate(zip(c["out"], want)):
            require(a.dtype == b.dtype and torch.equal(a, b),
                    f"{step} K1 differs from its plain version on the "
                    f"width-{c['kwargs']['width']} bucket (output {i})")
        fin = torch.isfinite(c["out"][1]) & torch.isfinite(want[1])
        if bool(fin.any()):
            k1_err = max(k1_err, float((c["out"][1][fin]
                                        - want[1][fin]).abs().max()))

    def k1_round(fn):
        return [fn(*c["args"], **c["kwargs"]) for c in k1_calls]

    k1_ms = time_ms(torch, lambda: k1_round(ops.louvain_fused), 10)
    k1_plain = time_ms(torch, lambda: k1_round(ops.louvain_fused_rows_ref), 2)
    a0 = k1_calls[0]["args"]
    csr = types.SimpleNamespace(n_cap=k1_calls[0]["kwargs"]["sentinel"],
                                indptr=a0[1], indices=a0[2], device=g.device)
    k1_bytes, _, k1_ops, k1_work = scan_work(
        torch, csr, [(c["kwargs"]["width"], c["args"][0]) for c in k1_calls],
        a0[4], torch.cat([c["out"][0] for c in k1_calls]))
    k1_bound = max(k1_bytes / HBM_BYTES_PER_S, k1_ops / FP32_OPS_PER_S) * 1e3
    log(phase, f"{step} K1, the first round over the buckets "
        f"of widths {sorted(k1_first)}: bit for bit on the rows "
        f"{[c['args'][0].numel() for c in k1_calls]}; {k1_ms:.4f} ms (plain "
        f"{k1_plain:.4f} ms), {k1_ms / k1_bound:.3f}x its bound; "
        + json.dumps(k1_work))
    report.append(kernel_entry(k1_name,
                               k1_counts["louvain_fused"], k1_err, k1_ms,
                               k1_plain, k1_bytes, k1_ops))
    del k1_calls, k1_first, a0, csr, c, want, fin
    k3_held(torch, first, k3_counts["coarsen_groups"], report, phase, step,
            k3_name)
    return lp


def k3_held(torch, first, launches: int, report, phase: str, step: str,
            k3_name: str) -> None:
    """The first K3 launch of a run (``first``, as ``first_call_recorded``
    keeps it) against its plain version, exactly, timed against its bound
    and added to ``report`` as ``k3_name`` with the run's ``launches``."""
    from repro_torch.kernels.aggregate import coarsen

    s_ci, s_cj, s_w = first["args"]
    sent = first["kwargs"]["sent"]
    want = coarsen.coarsen_groups_ref(s_ci, s_cj, s_w, sent=sent)
    torch.cuda.synchronize()
    got = first["out"]
    require(all(torch.equal(a, b) for a, b in zip(got, want)),
            f"{step} K3 differs from its plain version on the first "
            "aggregation")
    total = s_ci.numel()
    k3_ms = time_ms(torch, lambda: coarsen.coarsen_groups(
        s_ci, s_cj, s_w, sent=sent), 10)
    k3_plain = time_ms(torch, lambda: coarsen.coarsen_groups_ref(
        s_ci, s_cj, s_w, sent=sent), 3)
    k3_bytes = 12 * total + 17 * (total + 1)
    log(phase, f"{step} K3, the first aggregation: exact on "
        f"{total} slots ({int(got[0].sum())} groups); {k3_ms:.4f} ms "
        f"(plain {k3_plain:.4f} ms), "
        f"{k3_ms / (k3_bytes / HBM_BYTES_PER_S * 1e3):.3f}x its bound")
    report.append(kernel_entry(k3_name, launches,
                               float((got[4] - want[4]).abs().max()),
                               k3_ms, k3_plain, k3_bytes, total))


def phase_graph(torch, ops, args, dev, report):
    """Phase 10: the Louvain partitioner and GNN training at full width."""
    import copy
    from repro_torch import (GAT_CORA, GIN_TU, ShardGroup, build_csr,
                             build_halo_inputs, louvain,
                             membership_modularity, random_partition)
    from repro_torch.configs.gnn_common import GNN_SHAPES, pad512
    from repro_torch.core import gnn_halo
    from repro_torch.models.gnn.sampler import sample_block
    from repro_torch.optim import AdamWConfig, adamw_init

    # (a) The input: ogbn-products' sizes, drawn on the card.
    n, n_pairs = PRODUCTS_NODES, PRODUCTS_PAIRS
    t = time.perf_counter()
    cls, u, v = products_graph(torch, dev, n, n_pairs, args.seed)
    g = build_csr(u, v, torch.ones(n_pairs, device=dev), n, symmetrize=True,
                  device=dev)
    del u, v
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 1)
    means = torch.randn(PRODUCTS_CLASSES, PRODUCTS_FEAT, generator=gen,
                        device=dev)
    feat = means[cls] + torch.randn(n, PRODUCTS_FEAT, generator=gen,
                                    device=dev)
    torch.cuda.synchronize()
    log("graph", f"(a) planted-class graph at ogbn-products' sizes: {n} "
        f"vertices (n_pad {pad512(n)}), {n_pairs} pairs = {2 * n_pairs} "
        f"directed slots symmetrised, {g.e_valid} left after dedup, "
        f"{PRODUCTS_CLASSES} classes ({PRODUCTS_INTRA} of the pairs inside "
        f"one), {PRODUCTS_FEAT} features; built in "
        f"{time.perf_counter() - t:.2f} s")

    # (b) The partitioner: the default config (K3), then the ELL route (K1
    # and K3); one partition from both, its kernels held to their plain
    # versions.
    lp = partition_checked(torch, ops, g, PARTITION_DEVICES, report, "graph",
                           "(b)", "coarsen_groups_partition",
                           "louvain_fused_partition")
    rp = random_partition(g, PARTITION_DEVICES)
    log("graph", f"(b) random_partition: cut fraction {rp.cut_fraction:.6f}, "
        f"balance {rp.balance:.6f}; Louvain cuts "
        f"{rp.cut_fraction / max(lp.cut_fraction, 1e-12):.2f}x fewer slots")
    res = louvain(g)
    sizes = np.bincount(res.membership)
    q32 = membership_modularity(g, res.membership)
    q64 = modularity_f64(torch, g, res.membership)
    planted64 = modularity_f64(torch, g, cls.cpu().numpy())
    log("graph", f"(b) the communities packed: {res.n_communities} (sizes "
        f"{sizes.min()}-{sizes.max()}, median {int(np.median(sizes))}), Q "
        f"{q32:.6f} (float64 from the slots: {q64:.8f}); the planted "
        f"classes' Q {membership_modularity(g, cls.cpu().numpy()):.6f} "
        f"(float64 {planted64:.8f})")
    require(abs(q32 - q64) <= 1e-4,
            "the port's float32 Q disagrees with float64 by more than 1e-4")
    del res, sizes

    # (c) gin-tu at full width on the graph in Louvain order.
    sh = GNN_SHAPES["ogb_products"]
    n_pad, e_pad = pad512(n), pad512(max(sh.n_edges, g.e_valid))
    order = torch.from_numpy(lp.order.astype(np.int64)).to(dev)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n, device=dev)
    e = g.e_valid
    src_l, dst_l = g.src[:e], g.indices[:e]
    batch = {"node_feat": torch.zeros(n_pad, PRODUCTS_FEAT, device=dev),
             "edge_src": torch.full((e_pad,), n_pad, dtype=torch.int32,
                                    device=dev),
             "edge_dst": torch.full((e_pad,), n_pad, dtype=torch.int32,
                                    device=dev),
             "labels": torch.zeros(n_pad, dtype=torch.int32, device=dev)}
    batch["node_feat"][:n] = feat[order]
    batch["labels"][:n] = cls[order].to(torch.int32)
    batch["edge_src"][:e] = inv[src_l.long()].to(torch.int32)
    batch["edge_dst"][:e] = inv[dst_l.long()].to(torch.int32)
    del feat, inv
    opt_cfg = AdamWConfig(lr=GNN_LR, warmup_steps=0, total_steps=GNN_STEPS)
    model = GIN_TU.init_model("ogb_products", seed=0, device=dev)
    init_state = copy.deepcopy(model.state_dict())
    step = GIN_TU.build_step("ogb_products", ShardGroup.single(dev),
                             opt_cfg=opt_cfg)
    torch.cuda.reset_peak_memory_stats()
    loss32, grads32 = step.loss_and_grads(model, batch)
    model64 = copy.deepcopy(model).double()
    batch64 = dict(batch, node_feat=batch["node_feat"].double())
    loss64, grads64 = step.loss_and_grads(model64, batch64)
    del model64, batch64
    rel_loss = abs(float(loss32) - float(loss64)) / abs(float(loss64))
    rel_grad = grads_agree(grads32, grads64)
    log("graph", f"(c) first step, float32 against float64 on the card: "
        f"loss {float(loss32):.8f} / {float(loss64):.8f} (relative "
        f"{rel_loss:.3e}), gradients {rel_grad:.3e} of their largest entry "
        f"(tolerance {GNN_RTOL})")
    require(rel_loss <= GNN_RTOL and rel_grad <= GNN_RTOL,
            "the float32 step disagrees with float64")
    del grads64
    opt = adamw_init(model)
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(GNN_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        opt, loss = step(model, opt, batch)
        losses.append(float(loss))
        times.append(time.perf_counter() - t)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    require(all(np.isfinite(losses)) and losses[-1] < losses[0],
            f"gin-tu x ogb_products: losses {losses} not finite and falling")
    require(abs(losses[0] - float(loss32)) <= GNN_RTOL * abs(losses[0]),
            "the first step's loss is not the checked loss")
    log("graph", f"(c) gin-tu x ogb_products, {GNN_STEPS} AdamW steps "
        f"(5 layers, d_hidden 64, {PRODUCTS_FEAT} features, "
        f"{PRODUCTS_CLASSES} classes, {e} edges of {e_pad} slots): losses "
        f"{losses}; seconds a step {[round(x, 4) for x in times]} (mean of "
        f"the last {GNN_STEPS - 1}: {np.mean(times[1:]):.4f} s); peak memory "
        f"{peak:.2f} GiB")
    p_ms, n_ops, busy_ms, top = device_profile(
        torch, lambda: step(model, opt, batch), top=8)
    wall_ms = np.mean(times[1:]) * 1e3
    log("graph", f"(c) profile of one step: {n_ops} device operations, "
        f"device busy {busy_ms:.3f} ms, {p_ms:.3f} ms profiled wall, "
        f"{wall_ms:.3f} ms unprofiled (idle share "
        f"{1 - busy_ms / wall_ms:.3f}); top by device ms {json.dumps(top)}")
    del model, opt

    # (d) The halo step at world size 1 through NCCL: its first loss and
    # gradients equal (c)'s; then the halo layouts at 4 and 8 shards.
    order_np = lp.order
    src_np, dst_np = src_l.cpu().numpy(), dst_l.cpu().numpy()
    with nccl_world_of_one(dev) as group:
        spec = gnn_halo.make_halo_spec(n_pad, e_pad, 1, 0.25)
        t = time.perf_counter()
        halo = build_halo_inputs(src_np, dst_np, order_np, 1, n_pad, e_pad,
                                 spec, device=dev)
        halo_s = time.perf_counter() - t
        hbatch = {"node_feat": batch["node_feat"], "labels": batch["labels"],
                  **{k: torch.from_numpy(halo[k]).to(dev)
                     for k in ("edge_src", "edge_dst", "send_idx")}}
        model = GIN_TU.init_model("ogb_products", seed=0, device=dev)
        model.load_state_dict(init_state)
        hstep = GIN_TU.build_step("ogb_products", group, variant=("halo",),
                                  opt_cfg=opt_cfg, spec=spec)
        loss_h, grads_h = hstep.loss_and_grads(model, hbatch)
        rel_h = abs(float(loss_h) - float(loss32)) / abs(float(loss32))
        rel_hg = grads_agree(grads_h, grads32)
        log("graph", f"(d) halo step at world size 1 (NCCL; layout built in "
            f"{halo_s:.2f} s on the card): loss {float(loss_h):.8f} against "
            f"{float(loss32):.8f} (relative {rel_h:.3e}), gradients "
            f"{rel_hg:.3e}; wire bytes {group.wire_bytes}")
        require(rel_h <= GNN_RTOL and rel_hg <= GNN_RTOL,
                "the halo step differs from the plain step at world size 1")
        del model, hbatch, halo, grads_h, grads32
    allgather = n_pad * 64 * 4
    new_id = torch.empty(n, dtype=torch.int64, device=dev)
    new_id[order] = torch.arange(n, device=dev)
    new_src, new_dst = new_id[src_l.long()], new_id[dst_l.long()]
    del new_id
    for p in HALO_SHARDS:
        spec = gnn_halo.make_halo_spec(n_pad, e_pad, p, 0.25)
        cut = int(torch.sum(new_src // spec.v_per_shard
                            != new_dst // spec.v_per_shard))
        counts = gnn_halo.halo_counts(src_np, dst_np, order_np, p,
                                      spec.v_per_shard, device=dev)
        off = counts[~np.eye(p, dtype=bool)]
        overflow = int(counts.max()) > spec.send_cap
        t = time.perf_counter()
        try:
            build_halo_inputs(src_np, dst_np, order_np, p, n_pad, e_pad,
                              spec, device=dev)
            raised = None
        except ValueError as exc:
            raised = str(exc)
        secs = time.perf_counter() - t
        require(overflow == (raised is not None and "halo cap" in raised),
                f"{p} shards: the halo cap overflow and build_halo_inputs "
                f"disagree")
        cap_bytes = 2 * p * spec.send_cap * 64 * 4
        meas = int((counts.sum(0) + counts.sum(1)).max()) * 64 * 4
        log("graph", f"(d) {p} shards, halo_frac 0.25: cut {cut} of {e} "
            f"slots ({cut / e:.6f}); send cap S "
            f"{spec.send_cap} a peer; measured halo a peer min/mean/max "
            f"{off.min()}/{off.mean():.1f}/{off.max()}; "
            f"{'overflows: ' + raised if raised else 'fits'} ({secs:.2f} s); "
            f"halo bytes a rank and layer at d=64: {cap_bytes} at the cap, "
            f"{meas} measured (the largest rank's sent and received rows) "
            f"against the "
            f"all-gather's {allgather} ({meas / allgather:.4f}x)")
    del batch, src_l, dst_l, src_np, dst_np, new_src, new_dst, order

    # (e) The other shapes, a few steps each.
    gnn_run(torch, GAT_CORA, "full_graph_sm",
            GAT_CORA.make_batch("full_graph_sm", args.seed, device=dev),
            dev, GNN_STEPS, "(e) gat-cora x full_graph_sm")
    mb = GNN_SHAPES["minibatch_lg"]
    indptr, indices = g.indptr.cpu().numpy(), g.indices[:e].cpu().numpy()
    rng = np.random.default_rng(args.seed)
    seeds = rng.choice(n, mb.batch * mb.n_seeds, replace=False)
    t = time.perf_counter()
    blocks = [sample_block(indptr, indices, seeds[i::mb.batch], (15, 10),
                           rng) for i in range(mb.batch)]
    sample_s = time.perf_counter() - t
    cls_np = cls.cpu().numpy()
    ids = np.stack([b.node_ids for b in blocks])
    mbatch = {"node_feat": torch.from_numpy(rng.standard_normal(
                  (mb.batch, mb.n_nodes, mb.d_feat)).astype(np.float32)),
              "edge_src": torch.from_numpy(np.stack([b.edge_src
                                                     for b in blocks])),
              "edge_dst": torch.from_numpy(np.stack([b.edge_dst
                                                     for b in blocks])),
              "labels": torch.from_numpy(np.where(
                  ids >= 0, cls_np[np.maximum(ids, 0)] % mb.n_classes,
                  0).astype(np.int32))}
    mbatch = {k: x.to(dev) for k, x in mbatch.items()}
    log("graph", f"(e) sampled {mb.batch} blocks of {mb.n_seeds} seeds at "
        f"fanout (15, 10) from (a)'s graph in {sample_s:.2f} s: nodes "
        f"{[b.n_nodes for b in blocks[:4]]}... of {mb.n_nodes}")
    gnn_run(torch, GIN_TU, "minibatch_lg", mbatch, dev, GNN_STEPS,
            "(e) gin-tu x minibatch_lg")
    gnn_run(torch, GIN_TU, "molecule",
            GIN_TU.make_batch("molecule", args.seed, device=dev), dev,
            GNN_STEPS, "(e) gin-tu x molecule")
    del g, cls, mbatch, blocks

    # (f) 4 gloo ranks on the one card.
    gnn_ranks_check(torch, dev)


def gnn_ranks_check(torch, dev) -> None:
    """Phase 10 (f): GNN_RANKS gloo ranks on the one card, the halo GIN
    (float32 and bf16 messages), the halo Equiformer (phase 11 (d)) and
    the all-gather layout on a small Louvain-partitioned graph, equal to
    world size 1."""
    from repro_torch import (GAT_CORA, GIN_TU, ShardGroup, build_halo_inputs,
                             louvain_partition, sbm_graph)
    from repro_torch.configs.gnn_common import GNN_SMOKE_SHAPES
    from repro_torch.core import collectives, gnn_halo
    from repro_torch.models.gnn.equiformer import EquiformerConfig
    from repro_torch.models.gnn.gin import GINConfig

    sg, _ = sbm_graph(8, 16, 0.4, 0.01, seed=2, device=dev)
    sn = sg.n_valid
    s_order = louvain_partition(sg, GNN_RANKS).order
    s_src = sg.src[:sg.e_valid].cpu().numpy()
    s_dst = sg.indices[:sg.e_valid].cpu().numpy()
    rng = np.random.default_rng(0)
    s_feat = rng.standard_normal((sn, 8)).astype(np.float32)[s_order]
    s_lab = rng.integers(0, 4, sn).astype(np.int32)[s_order]
    s_pos = np.random.default_rng(1).standard_normal(
        (sn, 3)).astype(np.float32)[s_order]
    gcfg = GINConfig(n_layers=2, d_hidden=16, d_feat=8, n_classes=4)
    gmodel = GIN_TU.make_model(gcfg, 0, "cpu")
    gstate = {k: x.numpy() for k, x in gmodel.state_dict().items()}
    ecfg = EquiformerConfig(**RANKS_EQUIFORMER, d_feat=8, out_dim=4,
                            node_level=True)

    def halo_run(p, bf16, arch="gin-tu"):
        spec = gnn_halo.HaloSpec(p, sn // p, len(s_src), sn // p)
        h = build_halo_inputs(s_src, s_dst, s_order, p, sn,
                              len(s_src) * p, spec, device=dev)
        run = {"arch": arch, "cfg": gcfg, "state": gstate, "steps": 2,
               "batch": {"node_feat": s_feat, "labels": s_lab,
                         **{k: h[k] for k in ("edge_src", "edge_dst",
                                              "send_idx")}},
               "halo": {"spec": spec, "n_valid": sn, "bf16_msgs": bf16}}
        if arch == "equiformer-v2":
            # Full width; every rank draws the weights from seed 0.
            del run["state"]
            run["cfg"] = ecfg
            run["batch"]["positions"] = s_pos
        return run

    def step_run(arch, shape, seed):
        cfg = arch.make_config(GNN_SMOKE_SHAPES[shape], True)
        m = arch.make_model(cfg, 0, "cpu")
        b = arch.make_batch(shape, seed, smoke=True, device="cpu")
        return {"arch": arch.arch_id, "cfg": cfg, "shape": shape,
                "smoke": True, "steps": 2,
                "state": {k: x.numpy() for k, x in m.state_dict().items()},
                "batch": {k: x.numpy() for k, x in b.items()}}

    def runs(p):
        return ([halo_run(p, False), halo_run(p, True)]
                + [step_run(GIN_TU, "full_graph_sm", 1),
                   step_run(GAT_CORA, "full_graph_sm", 2),
                   step_run(GIN_TU, "molecule", 3)]
                + [halo_run(p, False, "equiformer-v2")])

    t = time.perf_counter()
    solo = gnn_halo.gnn_rank_runs(ShardGroup.single(dev), runs(1))
    solo_s = time.perf_counter() - t
    t = time.perf_counter()
    out = collectives.launch(gnn_halo.gnn_rank_runs, GNN_RANKS,
                             runs(GNN_RANKS), backend="gloo",
                             devices=[str(dev)] * GNN_RANKS, timeout=300)
    wall = time.perf_counter() - t
    eq = len(solo["results"]) - 1
    for rank, rank_out in enumerate(out):
        for i, (a, b) in enumerate(zip(rank_out["results"],
                                       solo["results"])):
            rtol = 1e-2 if i == 1 else GNN_RTOL
            rel = abs(a["loss"] - b["loss"]) / abs(b["loss"])
            worst = grads_agree({k: torch.from_numpy(x)
                                 for k, x in a["grads"].items()},
                                {k: torch.from_numpy(x)
                                 for k, x in b["grads"].items()},
                                per_tensor=i != eq)
            require(rel <= rtol / 10 and worst <= rtol
                    and np.allclose(a["losses"], b["losses"],
                                    rtol=rtol / 10),
                    f"{GNN_RANKS} gloo ranks differ from world size 1 in "
                    f"run {i}: loss {rel:.3e}, gradients {worst:.3e}")
            if i == eq:
                log("graph", f"(f) Equiformer halo, rank {rank}: loss {a['loss']:.8f} against "
                    f"{b['loss']:.8f} (relative {rel:.3e}), gradients "
                    f"{worst:.3e} of the largest entry, step losses "
                    f"{a['losses']} against {b['losses']}")
    log("graph", f"(f) {GNN_RANKS} gloo ranks on one card (halo GIN in "
        f"float32 and with bf16 messages, and the halo Equiformer "
        f"{json.dumps(RANKS_EQUIFORMER)}, on "
        f"the sbm golden graph in Louvain order; the all-gather layout of "
        f"gin-tu and gat-cora, the molecule split): equal to world size 1; "
        f"wire bytes a rank {[o['wire_bytes'] for o in out]}, staged "
        f"{[o['staged_bytes'] for o in out]}; {wall:.2f} s with the rank "
        f"starts, world size 1 {solo_s:.2f} s (no multi-GPU number)")


# ---------------------------------------------------------------------------
# Phase 11: the geometric models (Equiformer-v2, DimeNet) at full width, and
# the Equiformer halo step on a Louvain partition.
# ---------------------------------------------------------------------------

#: Phase 11 (c): Cora's published sizes (``GNN_SHAPES["full_graph_sm"]``):
#: vertices, undirected pairs (10,556 directed slots), classes, features;
#: drawn like phase 10's graph, positions normal.
CORA_NODES = 2708
CORA_PAIRS = 5278
CORA_CLASSES = 7
CORA_FEAT = 1433
#: Phase 11 (c): shards of the Louvain partition and of the measured halo
#: layout, and the step of the halo_frac search.
GEO_SHARDS = 4
HALO_FRAC_STEP = 0.05
#: Phase 11: outputs under a global rotation and translation of the
#: positions (energies, or logits), relative to their largest magnitude;
#: the bf16-edge halo loss against the float32 one, relative.
GEO_INVARIANCE_RTOL = 1e-3
GEO_BF16_RTOL = 2e-2
#: Phase 11's AdamW: no warmup, cosine to 0.1 over the steps taken.  At
#: 1e-4 Adam's first steps (every weight moved by about lr) raise the
#: full-width Equiformer's molecule loss.
GEO_LR = 1e-5


def as_float64(batch: dict) -> dict:
    return {k: x.double() if x.is_floating_point() else x
            for k, x in batch.items()}


def geo_outputs(torch, arch, model, shape: str, batch: dict):
    """The model's outputs on ``batch`` without autograd: a full graph's
    node logits (Equiformer) or energy (DimeNet); a molecule batch's
    energies, one a molecule."""
    from repro_torch.configs.gnn_common import merged_graph, shape_of
    from repro_torch.models.gnn.common import GraphBatch
    sh = shape_of(shape)
    with torch.no_grad():
        if sh.kind == "full":
            nf = batch["node_feat"]
            g = GraphBatch(node_feat=nf, edge_src=batch["edge_src"],
                           edge_dst=batch["edge_dst"], n_nodes=sh.n_nodes,
                           labels=batch["labels"],
                           graph_id=torch.zeros(nf.shape[0],
                                                dtype=torch.int64,
                                                device=nf.device),
                           n_graphs=1, positions=batch["positions"])
            extra = ((batch["t_kj"], batch["t_ji"]) if arch.needs_triplets
                     else ())
            out = model(g, *extra)
            return out[:sh.n_nodes] if arch.label_kind_for(shape) == "node" \
                else out[:1, 0]
        g = merged_graph(batch)
        extra = (g.t_kj, g.t_ji) if arch.needs_triplets else ()
        return model(g, *extra)[:g.n_graphs, 0]


def random_rigid_motion(torch, dev, seed: int):
    """A rotation (QR of a normal matrix, sign-fixed to det +1) and a
    translation, float32 on the card."""
    gen = torch.Generator().manual_seed(seed)
    q, r = torch.linalg.qr(torch.randn(3, 3, generator=gen,
                                       dtype=torch.float64))
    q = q * torch.sign(torch.diagonal(r))
    if torch.det(q) < 0:
        q[:, 0] = -q[:, 0]
    shift = 3.0 * torch.randn(3, generator=gen, dtype=torch.float64)
    return q.float().to(dev), shift.float().to(dev)


def geo_train(torch, arch, shape: str, batch: dict, dev, what: str,
              seed: int) -> dict:
    """One geometric model on one batch at full width, world size 1: the
    first step's loss and gradients against a float64 copy of the model
    on the card; its outputs under a random rotation and translation of
    the positions; GNN_STEPS AdamW steps (finite, falling loss), seconds a
    step, peak memory and a ``torch.profiler`` breakdown of one step."""
    import copy
    from repro_torch import ShardGroup
    from repro_torch.optim import AdamWConfig, adamw_init
    model = arch.init_model(shape, seed=0, device=dev)
    step = arch.build_step(shape, ShardGroup.single(dev), opt_cfg=AdamWConfig(
        lr=GEO_LR, warmup_steps=0, total_steps=GNN_STEPS))
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    loss32, grads32 = step.loss_and_grads(model, batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    peak32 = torch.cuda.max_memory_allocated() / 2 ** 30
    model64 = copy.deepcopy(model).double()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    loss64, grads64 = step.loss_and_grads(model64, as_float64(batch))
    torch.cuda.synchronize()
    f64_s = time.perf_counter() - t
    peak64 = torch.cuda.max_memory_allocated() / 2 ** 30
    del model64
    rel_loss = abs(float(loss32) - float(loss64)) / abs(float(loss64))
    rel_grad = grads_agree(grads32, grads64, per_tensor=False)
    rel_tensor = grads_agree(grads32, grads64)
    log("geometric", f"{what}: {n_params} parameters; first step, float32 "
        f"against float64 on the card: loss {float(loss32):.8f} / "
        f"{float(loss64):.10f} (relative {rel_loss:.3e}), gradients "
        f"{rel_grad:.3e} of the largest entry ({rel_tensor:.3e} of each "
        f"tensor's own; tolerance {GNN_RTOL} of the largest entry); "
        f"{first_s:.3f} s float32, {f64_s:.3f} s float64; peak "
        f"{peak32:.2f} / {peak64:.2f} GiB")
    require(rel_loss <= GNN_RTOL and rel_grad <= GNN_RTOL,
            f"{what}: the float32 step disagrees with float64")
    del grads32, grads64

    rot, shift = random_rigid_motion(torch, dev, seed)
    moved = dict(batch, positions=batch["positions"] @ rot.T + shift)
    before = geo_outputs(torch, arch, model, shape, batch)
    after = geo_outputs(torch, arch, model, shape, moved)
    inv = float((after - before).abs().max() / before.abs().max())
    log("geometric", f"{what}: outputs {tuple(before.shape)} under a random "
        f"rotation and translation: max |change| {inv:.3e} of the largest "
        f"magnitude {float(before.abs().max()):.6g} (tolerance "
        f"{GEO_INVARIANCE_RTOL})")
    require(inv <= GEO_INVARIANCE_RTOL,
            f"{what}: outputs not invariant under a rigid motion")
    del moved, before, after

    opt = adamw_init(model)
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(GNN_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        opt, loss = step(model, opt, batch)
        losses.append(float(loss))
        times.append(time.perf_counter() - t)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    require(all(np.isfinite(losses)) and losses[-1] < losses[0],
            f"{what}: losses {losses} not finite and falling")
    require(abs(losses[0] - float(loss32)) <= GNN_RTOL * abs(losses[0]),
            f"{what}: the first step's loss is not the checked loss")
    wall_ms = float(np.mean(times[1:])) * 1e3
    p_ms, n_ops, busy_ms, top = device_profile(
        torch, lambda: step(model, opt, batch), top=8)
    log("geometric", f"{what}: {GNN_STEPS} AdamW steps, losses {losses}; "
        f"seconds a step {[round(x, 4) for x in times]} (mean of the last "
        f"{GNN_STEPS - 1}: {wall_ms / 1e3:.4f} s); peak memory {peak:.2f} "
        f"GiB; profile of one step: {n_ops} device operations, device busy "
        f"{busy_ms:.3f} ms, {p_ms:.3f} ms profiled wall (idle share "
        f"{1 - busy_ms / wall_ms:.3f} of the unprofiled step); top by "
        f"device ms {json.dumps(top)}")
    return {"step_s": wall_ms / 1e3, "peak_gib": peak, "losses": losses}


def undirected(batch: dict, n_edges: int, sentinel: int) -> dict:
    """``batch`` with undirected edge lists: of each graph's edge slots
    (the last dimension), the first ``n_edges // 2`` keep their pairs, the
    next as many hold the reverses, and any slot past ``n_edges`` is
    padding (``sentinel``).  Cora's 10,556 slots and a molecule's bonds
    are such pairs.  A node with out-edges and no in-edges keeps zero
    l >= 1 irreps through every Equiformer layer, where the irrep norm's
    slope is its scale over sqrt(1e-8); those rows' adjoints grow 1e4-fold
    a norm and overflow float32 (NaN gradients, in the JAX reference
    too)."""
    out = dict(batch)
    half = n_edges // 2
    for k, rev in (("edge_src", "edge_dst"), ("edge_dst", "edge_src")):
        x = batch[k].clone()
        x[..., half:2 * half] = batch[rev][..., :half]
        x[..., 2 * half:] = sentinel
        out[k] = x
    return out


def wigner_orthogonality(torch, vec, l_max: int) -> list:
    """max |D Dᵀ - I| per l of the Wigner blocks of the edge vectors
    ``vec`` (non-zero rows), in their type."""
    from repro_torch.models.gnn.wigner import rotation_to_z, wigner_d_stack
    keep = torch.linalg.norm(vec, dim=-1) > 0
    n = vec[keep] / torch.linalg.norm(vec[keep], dim=-1, keepdim=True)
    out = []
    for l, d in enumerate(wigner_d_stack(rotation_to_z(n), l_max)):
        eye = torch.eye(2 * l + 1, dtype=d.dtype, device=d.device)
        out.append(float((d @ d.transpose(1, 2) - eye).abs().max()))
    return out


def phase_geometric(torch, ops, args, dev, report):
    """Phase 11: Equiformer-v2 and DimeNet trained at full width on the
    molecule and full_graph_sm batches, and the Equiformer halo step on a
    Louvain partition of a graph of Cora's sizes."""
    from repro_torch import (DIMENET, EQUIFORMER_V2, ShardGroup, build_csr,
                             build_halo_inputs)
    from repro_torch.configs.gnn_common import GNN_SHAPES, pad512
    from repro_torch.core import gnn_halo
    from repro_torch.models.gnn.dimenet import build_triplets_host
    require(not torch.backends.cuda.matmul.allow_tf32,
            "TF32 matmuls are on: the float64 checks assume float32 GEMMs")

    # (a) Equiformer-v2 at full width (12 layers, d_hidden 128, l_max 6,
    # m_max 2, 8 heads) on the molecule and full_graph_sm batches.
    results = {}
    for shape in ("molecule", "full_graph_sm"):
        sh = GNN_SHAPES[shape]
        batch = EQUIFORMER_V2.make_batch(shape, args.seed, device=dev)
        batch = undirected(batch, sh.n_edges, batch["node_feat"].shape[-2])
        if shape == "molecule":
            pos = batch["positions"]
            vec = (pos.gather(1, batch["edge_dst"].long()[..., None]
                              .expand(-1, -1, 3))
                   - pos.gather(1, batch["edge_src"].long()[..., None]
                                .expand(-1, -1, 3))).reshape(-1, 3)
            orth32 = wigner_orthogonality(torch, vec, 6)
            orth64 = wigner_orthogonality(torch, vec.double(), 6)
            log("geometric", f"(a) Wigner-D blocks of the molecule batch's "
                f"{vec.shape[0]} edges, max |D Dᵀ - I| per l = 0..6: float32 "
                f"{[f'{x:.2e}' for x in orth32]}, float64 "
                f"{[f'{x:.2e}' for x in orth64]}")
            require(max(orth32) <= 1e-5 and max(orth64) <= 1e-12,
                    "Wigner-D blocks at l_max 6 are not orthogonal")
        results[("equiformer-v2", shape)] = geo_train(
            torch, EQUIFORMER_V2, shape, batch, dev,
            f"(a) equiformer-v2 x {shape}", args.seed + 21)
        del batch
        torch.cuda.empty_cache()

    # (b) DimeNet at full width (6 blocks, d 128, n_bilinear 8,
    # n_spherical 7, n_radial 6), triplets from each graph's edges.
    for shape in ("molecule", "full_graph_sm"):
        batch = DIMENET.make_batch(shape, args.seed, device=dev)
        es, ed = batch["edge_src"].cpu().numpy(), batch["edge_dst"].cpu().numpy()
        cap = batch["t_kj"].shape[-1]
        t = time.perf_counter()
        if es.ndim == 2:
            tri = [build_triplets_host(es[b], ed[b], es.shape[1], cap)
                   for b in range(es.shape[0])]
            tkj = np.stack([x[0] for x in tri])
            tji = np.stack([x[1] for x in tri])
            n_edges = es.shape[1]
        else:
            tkj, tji = build_triplets_host(es, ed, es.shape[0], cap)
            n_edges = es.shape[0]
        tri_s = time.perf_counter() - t
        live = int((tkj < n_edges).sum())
        batch["t_kj"] = torch.from_numpy(tkj).to(dev)
        batch["t_ji"] = torch.from_numpy(tji).to(dev)
        log("geometric", f"(b) dimenet x {shape}: triplets from the edges "
            f"by build_triplets_host in {tri_s:.3f} s: {live} live of "
            f"{tkj.size} slots (cap {cap} a graph)")
        results[("dimenet", shape)] = geo_train(
            torch, DIMENET, shape, batch, dev, f"(b) dimenet x {shape}",
            args.seed + 22)
        del batch
        torch.cuda.empty_cache()

    # (c) The Equiformer halo path: a planted-class graph of Cora's sizes
    # drawn on the card, partitioned by Louvain onto GEO_SHARDS devices
    # (K3; K1 and K3), laid out for the halo step in Louvain order.
    n, n_pairs = CORA_NODES, CORA_PAIRS
    cls, u, v = products_graph(torch, dev, n, n_pairs, args.seed + 11,
                               CORA_CLASSES)
    g = build_csr(u, v, torch.ones(n_pairs, device=dev), n, symmetrize=True,
                  device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 12)
    means = torch.randn(CORA_CLASSES, CORA_FEAT, generator=gen, device=dev)
    feat = means[cls] + torch.randn(n, CORA_FEAT, generator=gen, device=dev)
    pos = torch.randn(n, 3, generator=gen, device=dev)
    log("geometric", f"(c) planted-class graph at Cora's sizes: {n} "
        f"vertices, {n_pairs} pairs = {2 * n_pairs} directed slots, "
        f"{g.e_valid} after dedup, {CORA_CLASSES} classes, {CORA_FEAT} "
        f"features, normal positions")
    lp = partition_checked(torch, ops, g, GEO_SHARDS, report, "geometric",
                           "(c)", "coarsen_groups_halo", "louvain_fused_halo")
    sh = GNN_SHAPES["full_graph_sm"]
    n_pad, e_pad = pad512(n), pad512(max(sh.n_edges, g.e_valid))
    e = g.e_valid
    src_np = g.src[:e].cpu().numpy()
    dst_np = g.indices[:e].cpu().numpy()
    order_np = lp.order
    spec_p = gnn_halo.make_halo_spec(n_pad, e_pad, GEO_SHARDS, 0.25)
    counts = gnn_halo.halo_counts(src_np, dst_np, order_np, GEO_SHARDS,
                                  spec_p.v_per_shard, device=dev)
    k = 1
    while gnn_halo.make_halo_spec(n_pad, e_pad, GEO_SHARDS, k
                                  * HALO_FRAC_STEP).send_cap < counts.max():
        k += 1
    frac = round(k * HALO_FRAC_STEP, 2)
    spec_p = gnn_halo.make_halo_spec(n_pad, e_pad, GEO_SHARDS, frac)
    # A Louvain shard may own more than e_pad / P edges: the layout's edge
    # cap is the largest shard's count.
    new_id = np.empty(n, np.int64)
    new_id[order_np] = np.arange(n)
    e_counts = np.bincount(new_id[dst_np] // spec_p.v_per_shard,
                           minlength=GEO_SHARDS)
    spec_p = dataclasses.replace(spec_p, e_per_shard=int(e_counts.max()))
    build_halo_inputs(src_np, dst_np, order_np, GEO_SHARDS, n_pad, e_pad,
                      spec_p, device=dev)
    ecfg = EQUIFORMER_V2.make_config(sh, False)
    row_bytes = ecfg.n_coef * ecfg.d_hidden * 4
    off = counts[~np.eye(GEO_SHARDS, dtype=bool)]
    meas = int((counts.sum(0) + counts.sum(1)).max()) * row_bytes
    cap_bytes = 2 * GEO_SHARDS * spec_p.send_cap * row_bytes
    allgather = n_pad * row_bytes
    log("geometric", f"(c) {GEO_SHARDS}-shard halo layout: measured halo a "
        f"peer min/mean/max {off.min()}/{off.mean():.1f}/{off.max()}; "
        f"halo_frac {frac} (the smallest multiple of {HALO_FRAC_STEP} that "
        f"holds it: send cap S {spec_p.send_cap} a peer, V_l "
        f"{spec_p.v_per_shard}, edge cap E_l {spec_p.e_per_shard}, edges a "
        f"shard {e_counts.tolist()} against e_pad / P "
        f"{e_pad // GEO_SHARDS}); irreps bytes a rank and layer: {cap_bytes} "
        f"at the cap, {meas} measured (the largest rank's sent and received "
        f"rows), the all-gather's {allgather} ({meas / allgather:.4f}x, at "
        f"the cap {cap_bytes / allgather:.4f}x)")

    # The plain step on the ordered graph, then the halo step at world
    # size 1 through NCCL: m_truncate on and off, bf16 edges.
    order = torch.from_numpy(order_np.astype(np.int64)).to(dev)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n, device=dev)
    batch = {"node_feat": torch.zeros(n_pad, CORA_FEAT, device=dev),
             "positions": torch.zeros(n_pad, 3, device=dev),
             "edge_src": torch.full((e_pad,), n_pad, dtype=torch.int32,
                                    device=dev),
             "edge_dst": torch.full((e_pad,), n_pad, dtype=torch.int32,
                                    device=dev),
             "labels": torch.zeros(n_pad, dtype=torch.int32, device=dev)}
    batch["node_feat"][:n] = feat[order]
    batch["positions"][:n] = pos[order]
    batch["labels"][:n] = cls[order].to(torch.int32)
    batch["edge_src"][:e] = inv[g.src[:e].long()].to(torch.int32)
    batch["edge_dst"][:e] = inv[g.indices[:e].long()].to(torch.int32)
    del feat, pos, inv, g
    model = EQUIFORMER_V2.init_model("full_graph_sm", seed=0, device=dev)
    plain = EQUIFORMER_V2.build_step("full_graph_sm", ShardGroup.single(dev))
    torch.cuda.synchronize()
    t = time.perf_counter()
    loss_p, grads_p = plain.loss_and_grads(model, batch)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t
    with nccl_world_of_one(dev) as group:
        spec1 = gnn_halo.make_halo_spec(n_pad, e_pad, 1, frac)
        halo = build_halo_inputs(src_np, dst_np, order_np, 1, n_pad, e_pad,
                                 spec1, device=dev)
        hbatch = {k: batch[k] for k in ("node_feat", "positions", "labels")}
        hbatch.update({k: torch.from_numpy(halo[k]).to(dev)
                       for k in ("edge_src", "edge_dst", "send_idx")})
        for variant in (("halo",), ("halo", "no_mtrunc"),
                        ("halo", "bf16_msgs")):
            hstep = EQUIFORMER_V2.build_step("full_graph_sm", group,
                                             variant=variant, spec=spec1)
            wire0 = group.wire_bytes
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss_h, grads_h = hstep.loss_and_grads(model, hbatch)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            rel = abs(float(loss_h) - float(loss_p)) / abs(float(loss_p))
            rel_g = grads_agree(grads_h, grads_p, per_tensor=False)
            log("geometric", f"(c) halo step {'+'.join(variant)} at world "
                f"size 1 (NCCL): loss {float(loss_h):.8f} against the plain "
                f"step's {float(loss_p):.8f} (relative {rel:.3e}), gradients "
                f"{rel_g:.3e} of the largest entry; {secs:.3f} s (plain "
                f"{plain_s:.3f} s), peak {peak:.2f} GiB, wire bytes "
                f"{group.wire_bytes - wire0}")
            if "bf16_msgs" in variant:
                require(rel <= GEO_BF16_RTOL,
                        "the bf16-edge halo loss is not within "
                        f"{GEO_BF16_RTOL} of the float32 loss")
            else:
                require(rel <= GNN_RTOL and rel_g <= GNN_RTOL,
                        f"the halo step ({'+'.join(variant)}) differs from "
                        f"the plain step at world size 1")
            del grads_h
    del model, batch, hbatch, grads_p
    torch.cuda.empty_cache()
    log("geometric", "(d) the Equiformer halo step on 4 gloo ranks ran in "
        "phase 10 (f)'s launch")
    return results


# ---------------------------------------------------------------------------
# Phase 12: the FM recommender at full Criteo width, the training loop with
# checkpoints and compression, and the NumPy LFR / powerlaw-cluster graphs.
# ---------------------------------------------------------------------------

#: Phase 12 (a): the launcher's FM learning rate (no warmup, cosine to 0.1
#: over the steps taken), the steps, and the rows held to the O(F^2)
#: pairwise oracle.
FM_LR = 1e-2
FM_STEPS = 5
FM_ORACLE_ROWS = 64
#: float32 against float64 and the row split (4 gloo ranks, or NCCL at
#: world size 1) against the plain step: relative error of the loss and of
#: each tensor's largest entry (the CPU tests' tolerance).
FM_RTOL = 1e-5
#: (b)-(c): calls timed after the warm-up; the retrieval's top set.
FM_CALLS = 30
FM_TOPK = 100
#: (d): the loop's uninterrupted steps, the checkpoint's step, and the
#: top-k fraction of the compressed step.
LOOP_STEPS = 6
LOOP_SPLIT = 3
TOPK_FRACTION = 0.01
#: (e): gloo ranks on the one card, and whether they run the smoke width.
FM_RANKS = 4
FM_RANKS_SMOKE = False
#: (f): vertices of each generated graph, Holme-Kim's m and p.
GEN_VERTICES = 100_000
HK_M, HK_P = 10, 0.3


def median_call_s(torch, fn, calls: int = FM_CALLS, warmup: int = 3):
    """The median of ``calls`` host-clock seconds of ``fn()``, each ending
    in a sync, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    spent = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t)
    return float(np.median(spent))


def nmi(a, b) -> float:
    """Normalized mutual information of two labelings (arithmetic mean of
    the entropies) from their contingency table (NumPy; no code of the
    port)."""
    _, a = np.unique(a, return_inverse=True)
    _, b = np.unique(b, return_inverse=True)
    cont = np.zeros((a.max() + 1, b.max() + 1))
    np.add.at(cont, (a, b), 1)
    p = cont / cont.sum()
    pa, pb = p.sum(1), p.sum(0)
    nz = p > 0
    mi = (p[nz] * np.log(p[nz] / np.outer(pa, pb)[nz])).sum()
    ent = -(pa[pa > 0] * np.log(pa[pa > 0])).sum() - (
        pb[pb > 0] * np.log(pb[pb > 0])).sum()
    return float(2 * mi / ent)


def fm_oracle64(torch, cfg, params, field_ids):
    """The FM's logits in float64 by the O(F^2) pairwise sum (the reference
    test's oracle), on the card."""
    rows = (field_ids.long()
            + torch.as_tensor(cfg.field_offsets, device=field_ids.device))
    v = params["v"].detach()[rows].double()            # (B, F, k)
    w = params["w"].detach()[rows].double()
    gram = torch.einsum("bik,bjk->bij", v, v)
    pair = torch.triu(gram, diagonal=1).sum((1, 2))
    return params["w0"].detach().double() + w.sum(1) + pair


def fm_train_checks(torch, dev, args, report_fm):
    """Phase 12 (a): the train step at full width.  Returns the model."""
    from repro_torch import FM, ShardGroup
    from repro_torch.data.recsys import synthetic_click_batches
    from repro_torch.models import recsys
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg = FM.full_config()
    b = FM.input_specs("train_batch")["field_ids"][0][0]
    torch.cuda.synchronize()
    t = time.perf_counter()
    model = FM.init_model("train_batch", seed=args.seed, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log("recsys", f"(a) FM at full width: {cfg.n_fields} fields, embed_dim "
        f"{cfg.embed_dim}, {cfg.total_vocab} rows ({cfg.padded_vocab} "
        f"padded), {n_params} float32 parameters ({n_params * 4} B), drawn "
        f"on the card in {time.perf_counter() - t:.3f} s")
    stream = synthetic_click_batches(cfg.vocab_sizes, b, seed=args.seed,
                                     device=dev)
    t = time.perf_counter()
    batches = [next(stream) for _ in range(FM_STEPS + 1)]
    log("recsys", f"(a) {len(batches)} click batches of {b} from "
        f"synthetic_click_batches in {time.perf_counter() - t:.3f} s (host "
        f"NumPy, then the card)")
    batch0 = batches[0]
    ids = batch0["field_ids"]
    rows = recsys.field_rows(cfg, ids).long()
    per_field = [int(torch.unique(rows[:, f]).numel())
                 for f in range(cfg.n_fields)]
    log("recsys", f"(a) the first batch touches {int(torch.unique(rows).numel())} "
        f"distinct rows of {b * cfg.n_fields} ids (per field: {per_field})")

    # The forward on FM_ORACLE_ROWS rows against the float64 pairwise oracle.
    with torch.no_grad():
        got = recsys.forward(cfg, model.params(), ids[:FM_ORACLE_ROWS])
    want = fm_oracle64(torch, cfg, model.params(), ids[:FM_ORACLE_ROWS])
    err = float((got.double() - want).abs().max())
    scale = float(want.abs().max())
    log("recsys", f"(a) forward on {FM_ORACLE_ROWS} rows against the O(F^2) "
        f"pairwise oracle in float64: max error {err:.3e} of the largest "
        f"|logit| {scale:.3e}")
    require(err <= FM_RTOL * scale, "the FM forward differs from the "
            "pairwise oracle")

    # The first step's loss and gradients against a float64 copy.
    group = ShardGroup.single(dev)
    opt_cfg = AdamWConfig(lr=FM_LR, warmup_steps=0, total_steps=FM_STEPS)
    step = FM.build_step("train_batch", group, opt_cfg=opt_cfg)
    loss32, g32 = step.loss_and_grads(model, batch0)
    p64 = {k: p.detach().double().requires_grad_(True)
           for k, p in model.params().items()}
    loss64 = recsys.loss_fn(cfg, p64, batch0)
    g64 = dict(zip(p64, torch.autograd.grad(loss64, list(p64.values()))))
    loss64 = float(loss64.detach())
    rel = abs(float(loss32) - loss64) / abs(loss64)
    worst = grads_agree(g32, g64)
    log("recsys", f"(a) first step against float64: loss {float(loss32):.8f} "
        f"against {loss64:.8f} (relative {rel:.3e}), gradients "
        f"{worst:.3e} of each tensor's largest entry; nonzero gradient rows "
        f"{int((g32['w'] != 0).sum())} of {cfg.padded_vocab} (dense)")
    require(rel <= FM_RTOL and worst <= FM_RTOL,
            "the float32 FM step differs from float64")
    del p64, g64, loss64
    torch.cuda.empty_cache()

    # Two identical first steps: the gradients' run-to-run stability.
    loss_b, g_b = step.loss_and_grads(model, batch0)
    diff = max(float((g_b[k] - g32[k]).abs().max()) for k in g32)
    stable = torch.equal(loss_b, loss32) and all(
        torch.equal(g_b[k], g32[k]) for k in g32)
    log("recsys", f"(a) two identical first steps: "
        + ("bit for bit equal (loss and every gradient)" if stable else
           f"NOT bit-stable: max gradient difference {diff:.3e}"))
    require(stable, "two identical FM steps differ: the gathers' sorted "
            "segment sum should make the step bit-stable")
    del g_b, g32
    torch.cuda.empty_cache()

    # FM_STEPS AdamW steps on fresh batches.
    opt = adamw_init(model)
    torch.cuda.reset_peak_memory_stats()
    losses, secs = [], []
    for bt in batches[:FM_STEPS]:
        torch.cuda.synchronize()
        t = time.perf_counter()
        opt, loss = step(model, opt, bt)
        losses.append(float(loss))
        secs.append(time.perf_counter() - t)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    step_s = float(np.median(secs[1:]))
    log("recsys", f"(a) {FM_STEPS} AdamW steps (lr {FM_LR}, dense over every "
        f"row): losses {losses}; seconds a step {[round(x, 5) for x in secs]} "
        f"(median after the first {step_s:.5f} s, {b / step_s:.0f} "
        f"examples/s); peak {peak:.2f} GiB")
    require(all(np.isfinite(losses)) and losses[-1] < losses[0],
            f"FM losses {losses} not finite and falling")
    wall_ms, n_ops, busy_ms, top = device_profile(
        torch, lambda: step(model, opt, batches[FM_STEPS]), top=8)
    idle_plain = max(0.0, 1 - busy_ms / (step_s * 1e3))
    log("recsys", f"(a) one train step under torch.profiler: wall "
        f"{wall_ms:.2f} ms, {n_ops} device operations, busy {busy_ms:.2f} ms, "
        f"idle share {1 - busy_ms / wall_ms:.3f} (the profiler slows the "
        f"host; against the unprofiled step {idle_plain:.3f}); top kernels "
        f"(ms) {top}")
    report_fm.update(step_s=step_s, peak_gib=peak, stable=stable,
                     idle=1 - busy_ms / wall_ms, idle_unprofiled=idle_plain)
    return model


def fm_serve_checks(torch, dev, args, model, report_fm):
    """Phase 12 (b) and (c): online and bulk scoring, and retrieval."""
    from repro_torch import FM, ShardGroup
    from repro_torch.models import recsys
    cfg = FM.full_config()
    group = ShardGroup.single(dev)
    params = {k: p.detach() for k, p in model.params().items()}
    for i, shape in enumerate(("serve_p99", "serve_bulk")):
        batch = FM.make_batch(shape, args.seed + 1 + i, device=dev)
        step = FM.build_step(shape, group)
        got = step(model, batch)
        with torch.no_grad():
            want = recsys.forward(cfg, params, batch["field_ids"])
        require(torch.equal(got, want),
                f"{shape}: build_step's logits differ from forward")
        require(bool(torch.isfinite(got).all()), f"{shape}: logits not "
                "finite")
        secs = median_call_s(torch, lambda: step(model, batch))
        b = batch["field_ids"].shape[0]
        log("recsys", f"(b) {shape} (B = {b}): logits equal forward through "
            f"build_step; {secs * 1e3:.4f} ms a call (median of {FM_CALLS}), "
            f"{b / secs:.0f} examples/s")
        report_fm[shape] = secs

    batch = FM.make_batch("retrieval_cand", args.seed + 3, device=dev)
    step = FM.build_step("retrieval_cand", group)
    scores = step(model, batch)
    rows = recsys.field_rows(cfg, batch["user_fields"])[0].long()
    cand = batch["cand_rows"].long()
    v64 = params["v"].double()
    v_u = v64[rows].sum(0)
    want = v64[cand] @ v_u + params["w"].double()[cand]
    err = float((scores.double() - want).abs().max())
    scale = float(want.abs().max())
    top_got = set(torch.topk(scores, FM_TOPK).indices.tolist())
    top_want = set(torch.topk(want, FM_TOPK).indices.tolist())
    kth = float(torch.topk(want, FM_TOPK).values[-1])
    swaps = top_got ^ top_want
    near = all(abs(float(want[i]) - kth) <= FM_RTOL * scale for i in swaps)
    secs = median_call_s(torch, lambda: step(model, batch))
    log("recsys", f"(c) retrieval over {cand.numel()} candidates: scores "
        f"within {err:.3e} of the float64 expression (largest "
        f"{scale:.3e}); top-{FM_TOPK} sets {'equal' if not swaps else f'differ in {len(swaps)} near-ties'}; "
        f"{secs * 1e3:.4f} ms a call (median of {FM_CALLS})")
    require(err <= FM_RTOL * scale and near,
            "retrieval scores or their top set differ from float64")
    report_fm["retrieval"] = secs


def fm_loop_checks(torch, dev, args, report_fm):
    """Phase 12 (d): the training loop at full width, its checkpoint and
    resume, and one compressed step of each scheme."""
    import shutil
    import tempfile
    from repro_torch import FM
    from repro_torch.data.recsys import synthetic_click_batches
    from repro_torch.models import recsys
    from repro_torch.optim import (AdamWConfig, CompressionConfig,
                                   compress_grads, compression_init)
    from repro_torch.train import TrainLoopConfig, checkpoint, train

    cfg = FM.full_config()
    b = FM.input_specs("train_batch")["field_ids"][0][0]
    opt_cfg = AdamWConfig(lr=FM_LR, warmup_steps=0, total_steps=LOOP_STEPS)

    def loss_fn(p, bt):
        return recsys.loss_fn(cfg, p, bt)

    def stream():
        return synthetic_click_batches(cfg.vocab_sizes, b, seed=args.seed + 4,
                                       device=dev)

    p0 = recsys.init_params(cfg, args.seed + 3, device=dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    p_full, m_full = train(loss_fn, p0, stream(), opt_cfg,
                           TrainLoopConfig(total_steps=LOOP_STEPS,
                                           log_every=1))
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t
    losses = [h["loss"] for h in m_full["history"]]
    log("recsys", f"(d) train(): {LOOP_STEPS} uninterrupted steps in "
        f"{full_s:.3f} s (batches drawn on the host inside), losses {losses}")
    require(all(np.isfinite(losses)), "the loop's losses are not finite")
    tmp = tempfile.mkdtemp(prefix="chip-smoke-ckpt-")
    try:
        with timed_calls(torch, checkpoint, "save_checkpoint") as save_s:
            train(loss_fn, p0, stream(), opt_cfg,
                  TrainLoopConfig(total_steps=LOOP_SPLIT,
                                  ckpt_every=LOOP_SPLIT, ckpt_dir=tmp,
                                  keep_n=1))
        payload = os.path.join(tmp, f"step_{LOOP_SPLIT:010d}", "arrays.npz")
        size = os.path.getsize(payload)
        with timed_calls(torch, checkpoint, "latest_step") as scan_s, \
                timed_calls(torch, checkpoint,
                            "restore_checkpoint") as restore_s:
            p_res, m_res = train(loss_fn, p0, stream(), opt_cfg,
                                 TrainLoopConfig(total_steps=LOOP_STEPS,
                                                 ckpt_every=100,
                                                 ckpt_dir=tmp, keep_n=1,
                                                 log_every=1))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    require(m_res["history"][0]["step"] == LOOP_SPLIT,
            "the resumed loop did not start at the checkpoint")
    worst = max(float((p_res[k] - p_full[k]).abs().max()) for k in p_full)
    exact = all(torch.equal(p_res[k], p_full[k]) for k in p_full)
    log("recsys", f"(d) {LOOP_SPLIT} steps, a checkpoint ({size} B of npz, "
        f"keep_n 1), then a fresh train() resumed to {LOOP_STEPS}: "
        f"parameters {'bit for bit equal to' if exact else f'within {worst:.3e} of'} "
        f"the uninterrupted run's; save {save_s[0]:.3f} s, latest_step "
        f"{scan_s[0]:.3f} s, restore {restore_s[0]:.3f} s (each hashes the "
        f"payload)")
    require(exact, "the resumed run differs from the uninterrupted one")
    report_fm.update(save_s=save_s[0], restore_s=restore_s[0],
                     scan_s=scan_s[0], ckpt_bytes=size)
    del p_res, p_full, m_res
    torch.cuda.empty_cache()

    # One compressed step of each scheme: the residual of a first call
    # carried into a second, the invariant held exactly.
    bt = next(stream())
    leaves = {k: v.detach().requires_grad_(True) for k, v in p0.items()}
    loss = recsys.loss_fn(cfg, leaves, bt)
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    for scheme in ("topk", "int8"):
        ccfg = CompressionConfig(scheme=scheme, topk_fraction=TOPK_FRACTION)
        res = compression_init(p0)
        _, res = compress_grads(ccfg, grads, res)
        torch.cuda.synchronize()
        t = time.perf_counter()
        sent, left = compress_grads(ccfg, grads, res)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        exact = all(torch.equal(sent[k] + left[k], grads[k] + res[k])
                    for k in grads)
        kept = {k: int((sent[k] != 0).sum()) for k in sent}
        require(exact, f"{scheme}: sent + residual != g + r")
        if scheme == "topk":
            require(all(kept[k] >= max(int(grads[k].numel() * TOPK_FRACTION),
                                       1) for k in grads),
                    "topk kept fewer entries than its fraction")
        t = time.perf_counter()
        _, m_c = train(loss_fn, p0, stream(), opt_cfg,
                       TrainLoopConfig(total_steps=1, log_every=1),
                       comp_cfg=ccfg)
        loop_s = time.perf_counter() - t
        require(np.isfinite(m_c["history"][0]["loss"]),
                f"{scheme}: the compressed loop step is not finite")
        log("recsys", f"(d) {scheme} compression at full width: sent + "
            f"residual == g + r exactly on every tensor; nonzero sent "
            f"{kept}; compress_grads {secs:.4f} s; one loop step with it "
            f"{loop_s:.3f} s (loss {m_c['history'][0]['loss']:.8f})")
        del sent, left, res
    del grads, leaves, p0
    torch.cuda.empty_cache()


def load_paths(tree):
    """``tree`` with each ``.npy`` path read into memory."""
    if isinstance(tree, dict):
        return {k: load_paths(v) for k, v in tree.items()}
    if isinstance(tree, str) and tree.endswith(".npy"):
        return np.load(tree)
    return tree


def fm_ranks_checks(torch, dev, args):
    """Phase 12 (e): the full-width FM with the table split over FM_RANKS
    gloo ranks on the one card (each rank saves its share's arrays to a
    temporary directory), against world size 1; and the row-split train
    step through NCCL at world size 1 against the plain step."""
    import shutil
    import tempfile
    from repro_torch import FM, ShardGroup
    from repro_torch.configs.fm import fm_rank_runs
    from repro_torch.core import collectives

    runs = [{"shape": "train_batch", "seed": args.seed + 5, "steps": 1,
             "lr": FM_LR, "smoke": FM_RANKS_SMOKE},
            {"shape": "serve_bulk", "seed": args.seed + 6,
             "smoke": FM_RANKS_SMOKE},
            {"shape": "retrieval_cand", "seed": args.seed + 7,
             "smoke": FM_RANKS_SMOKE}]
    t = time.perf_counter()
    solo = fm_rank_runs(ShardGroup.single(dev), runs)
    solo_s = time.perf_counter() - t
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-fm-ranks-")
    try:
        t, t_wall = time.perf_counter(), time.time()
        out = collectives.launch(fm_rank_runs, FM_RANKS, runs, tmp,
                                 backend="gloo",
                                 devices=[str(dev)] * FM_RANKS, timeout=400)
        wall = time.perf_counter() - t
        t_back = time.time()
        out = [[load_paths(r) for r in o] for o in out]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    runs_s = [sum(r["seconds"] for r in o) for o in out]
    done = max(o[-1]["finished"] for o in out)
    log("recsys", f"(e) the ranks' runs took {[round(x, 2) for x in runs_s]} "
        f"s; the last finished {done - t_wall:.2f} s after the launch (rank "
        f"starts and runs) and its results reached this process "
        f"{t_back - done:.2f} s later")

    def worst_of(parts, want):
        got = np.concatenate(parts)
        return float(np.abs(got.astype(np.float64) - want).max()
                     / max(np.abs(want).max(), 1e-30))

    tr = [o[0] for o in out]
    rel = max(abs(o["loss"] - solo[0]["loss"]) / abs(solo[0]["loss"])
              for o in tr)
    errs = {f"grad {k}": worst_of([o["grads"][k] for o in tr],
                                  solo[0]["grads"][k]) for k in ("w", "v")}
    errs.update({f"param {k}": worst_of([o["params"][k] for o in tr],
                                        solo[0]["params"][k])
                 for k in ("w", "v")})
    errs["grad w0"] = max(abs(float(o["grads"]["w0"])
                              - float(solo[0]["grads"]["w0"]))
                          / abs(float(solo[0]["grads"]["w0"])) for o in tr)
    errs["serve"] = worst_of([o[1]["out"] for o in out], solo[1]["out"])
    errs["retrieval"] = worst_of([o[2]["out"] for o in out], solo[2]["out"])
    log("recsys", f"(e) {FM_RANKS} gloo ranks on one card, the table split "
        f"by rows ({FM.config(FM_RANKS_SMOKE).padded_vocab // FM_RANKS} a "
        f"rank{', smoke width' if FM_RANKS_SMOKE else ''}): train "
        f"step loss within {rel:.3e}, errors against world size 1 (of the "
        f"largest entry) {json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})}; "
        f"{wall:.2f} s with the rank starts, world size 1 {solo_s:.2f} s "
        f"(no multi-GPU number)")
    require(rel <= FM_RTOL and max(errs.values()) <= FM_RTOL,
            f"{FM_RANKS} gloo ranks differ from world size 1")
    del out, solo, tr

    with nccl_world_of_one(dev) as group:
        model = FM.init_model("train_batch", seed=args.seed + 8, device=dev)
        batch = FM.make_batch("train_batch", args.seed + 9, device=dev)
        loss_1, g_1 = FM.build_step("train_batch", ShardGroup.single(
            dev)).loss_and_grads(model, batch)
        step = FM.build_step("train_batch", group)
        before = group.collectives
        loss_n, g_n = step.loss_and_grads(model, batch)
        n_coll = group.collectives - before
        rel = abs(float(loss_n) - float(loss_1)) / abs(float(loss_1))
        worst = grads_agree(g_n, g_1)
        log("recsys", f"(e) the row-split train step through NCCL at world "
            f"size 1 ({n_coll} NCCL collectives): loss {float(loss_n):.8f} "
            f"within {rel:.3e} of the plain step's, gradients within "
            f"{worst:.3e} of each tensor's largest entry")
        require(n_coll > 0 and rel <= FM_RTOL and worst <= FM_RTOL,
                "the NCCL world-of-one step differs from the plain step")
        del model, batch, g_1, g_n
    torch.cuda.empty_cache()


def phase_recsys(torch, ops, args, dev, report):
    """Phase 12: the FM at full width (train, serve, retrieval, the loop
    with checkpoints and compression, 4 gloo ranks) and ``louvain()`` on
    the NumPy LFR and powerlaw-cluster graphs."""
    from repro_torch import lfr_graph, louvain, powerlaw_cluster
    require(not torch.backends.cuda.matmul.allow_tf32,
            "TF32 matmuls are on: the float64 checks assume float32 GEMMs")
    fm_nums = {}
    model = fm_train_checks(torch, dev, args, fm_nums)
    fm_serve_checks(torch, dev, args, model, fm_nums)
    del model
    torch.cuda.empty_cache()
    fm_loop_checks(torch, dev, args, fm_nums)
    fm_ranks_checks(torch, dev, args)
    log("recsys", "FM summary " + json.dumps(
        {k: (v if isinstance(v, bool) else float(v))
         for k, v in fm_nums.items()}))

    # (f) The NumPy generators at GEN_VERTICES vertices, louvain() on each
    # through K3 (default) and K1 + K3 (ELL).
    for name, make in (
            ("lfr", lambda: lfr_graph(GEN_VERTICES, seed=args.seed + 42,
                                      device=dev)),
            ("powerlaw", lambda: (powerlaw_cluster(
                GEN_VERTICES, HK_M, HK_P, seed=args.seed + 7, device=dev),
                None))):
        torch.cuda.synchronize()
        t = time.perf_counter()
        g, planted = make()
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t
        e = g.e_valid
        deg = torch.bincount(g.src[:e].long(), minlength=g.n_valid)
        log("recsys", f"(f) {name}: {g.n_valid} vertices, {e} slots, degree "
            f"min/mean/max {int(deg.min())}/{float(deg.float().mean()):.3f}/"
            f"{int(deg.max())}, generated in {gen_s:.3f} s (host NumPy, CSR "
            f"on the card)")
        res = louvain_checked(
            torch, ops, g, lambda cfg: louvain(g, cfg),
            lambda r: (f"louvain() on the {name} graph: {len(r.passes)} "
                       f"passes, {int(r.passes[-1].n_communities)} "
                       f"communities, Q {modularity_f64(torch, g, r.membership):.6f}"),
            lambda r: (np.asarray(r.membership),), report, "recsys",
            f"(f) {name}", f"coarsen_groups_{name}",
            f"louvain_fused_{name}")
        if planted is not None:
            src = g.src[:e].cpu().numpy()
            dst = g.indices[:e].cpu().numpy()
            mixing = float((planted[src] != planted[dst]).mean())
            score = nmi(np.asarray(res.membership), planted)
            log("recsys", f"(f) lfr: {int(planted.max()) + 1} planted "
                f"communities, measured mixing fraction {mixing:.4f} against "
                f"mu 0.1; NMI of Louvain's membership against them "
                f"{score:.4f}")
            require(abs(mixing - 0.1) <= 0.05 and score > 0.5,
                    "LFR mixing or Louvain's NMI out of range")
        del g, res
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 13: the LM stack at full width.
# ---------------------------------------------------------------------------

#: H100 SXM data-sheet bf16 dense peak (tensor cores).
BF16_OPS_PER_S = 989e12
#: qwen2-1.5b's ``param_count()`` (the reference's: no biases, no norms).
QWEN_PARAM_COUNT = 1_543_569_408
#: (a) qwen2-1.5b train_4k: the batch (published 256, cut to one card),
#: the float64 check's batch and length, AdamW steps and learning rate.
LM_TRAIN_B = 4
LM_CHECK_B, LM_CHECK_S = 1, 512
LM_STEPS = 5
LM_LR = 3e-4
#: float32 against float64: the loss (relative) and each gradient tensor
#: (of its largest entry).
LM_LOSS_RTOL = 1e-5
LM_GRAD_RTOL = 1e-4
#: (b) prefill_32k at B 1 (published 32); the prefix whose last logits must
#: equal the long run's at that position bit for bit: the two runs cut the
#: queries into blocks of 512 and 4,096 rows, but both cut the keys into
#: 512-wide blocks, so each query row meets the same KV blocks in the same
#: order, and a masked future block adds exactly 0.
LM_PREFILL_B = 1
LM_PREFIX = 4096
LM_PREFILL_CALLS = 3
#: (c) decode: the prompt fed token by token and its float32 tolerance
#: against ``forward``; int8 against bf16 (the reference's test's
#: criteria); the timed batch (published 128) and steps.
LM_PROMPT = 64
LM_DECODE_TOL = 1e-4
INT8_AGREE, INT8_DRIFT = 0.9, 0.08
LM_DECODE_B = 32
LM_DECODE_STEPS = 16
#: (e) the other four LMs at published widths: (arch, pattern repeats,
#: repeats of the train step).  gemma3 runs one 5:1 pattern (6 layers),
#: the others 2 layers; mixtral and deepseek train at 1 layer, since 2 do
#: not fit beside AdamW's float32 moments (mixtral's 2 layers: 5.3e9
#: parameters, 63.6 GB of bf16 weights and gradients and float32 moments).
LM_OTHERS = (("gemma3-12b", 1, 1), ("internlm2-20b", 2, 2),
             ("mixtral-8x22b", 2, 1), ("deepseek-v2-236b", 2, 1))
LM_OTHER_PROMPT = 32
LM_OTHER_PREFILL = 8192
LM_OTHER_DECODE_B = 16
#: (d) the one-rank step without a grid against the same step over a 1 x 1
#: grid: the train and decode calls of each path, taken in the order
#: plain, grid, grid, plain (decode: that order over each two positions),
#: and the grid's prefill calls beside (b)'s.
LM_PAIR_TRAIN = 2
LM_PAIR_DECODE = 8
LM_PAIR_PREFILL = 2
#: (f) the CLI's runs: (name, arguments); and the R-MAT scale of its
#: louvain run.
CLI_SCALE = 12
CLI_RUNS = (("qwen2-1.5b", ["--arch", "qwen2-1.5b", "--steps", "20"]),
            ("fm", ["--arch", "fm", "--steps", "20"]),
            ("louvain", ["--arch", "louvain", "--graph", "rmat", "--scale",
                         str(CLI_SCALE)]))


def attention_flops(cfg, b: int, s: int) -> float:
    """Forward FLOPs of causal attention over ``s`` positions (QK^T and PV,
    2 per multiply-add), each layer's keys per query counted exactly: all
    earlier positions, or at most its window."""
    if cfg.mla is not None:
        d_qk = cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim
        d_v = cfg.mla.v_head_dim
    else:
        d_qk = d_v = cfg.d_head
    total = 0
    for w in cfg.layer_windows:
        if w is None or w >= s:
            pairs = s * (s + 1) // 2
        else:
            pairs = w * (w + 1) // 2 + (s - w) * w
        total += cfg.n_repeats * pairs
    return 2.0 * b * total * cfg.n_heads * (d_qk + d_v)


def lm_step_flops(cfg, b: int, s: int, kind: str) -> float:
    """Model FLOPs: 2 N T a forward (N the active parameters) plus causal
    attention; a train step is a forward, the rematerialised forward and a
    backward of twice the forward."""
    fwd = 2.0 * cfg.active_param_count() * b * s + attention_flops(cfg, b, s)
    return 4 * fwd if kind == "train" else fwd


def nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(nbytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(nbytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def fill_cache(torch, cache, seed: int) -> None:
    """A decode cache's positions drawn on the card from ``seed``: normal
    keys and values, or int8 values in [-127, 127] with scales in [0,
    0.05)."""
    gen = None
    for slot in cache["slots"]:
        for name, x in slot.items():
            if gen is None:
                gen = torch.Generator(device=x.device).manual_seed(seed)
            if x.dtype == torch.int8:
                x.random_(-127, 128, generator=gen)
            elif name in ("k_s", "v_s"):
                x.uniform_(0.0, 0.05, generator=gen)
            else:
                x.normal_(generator=gen)


def decode_plain_bytes(cfg, cache) -> int:
    """A model, from the shapes alone, of the bytes the plain decode ops
    move in its attention (no profiler or counter reads them): each layer reads its cache (every position, masked) and writes
    a float32 copy; the einsum copies that into its (B, H, S, D) product
    order (a read and a write) and the product reads it: the cache's bytes
    plus 16 B an element."""
    total = 0
    for slot in cache["slots"]:
        for x in slot.values():
            total += x.numel() * (x.element_size() + 16)
    return total


def timed_s(torch, fn):
    """(result, host seconds) of one call ending in a sync."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def peak_gib(torch) -> float:
    return torch.cuda.max_memory_allocated() / 2**30


def lm_token_batch(torch, vocab: int, b: int, s: int, seed: int, dev):
    from repro_torch.data.tokens import synthetic_token_batches
    return next(synthetic_token_batches(vocab, b, s, seed=seed, device=dev))


def decode_prompt(torch, cfg, params, tokens, dev):
    """``forward``'s teacher-forced logits of ``tokens`` and the logits of
    feeding them one at a time through ``decode_step`` from an empty
    cache."""
    from repro_torch.models import transformer as tf
    b, s = tokens.shape
    with torch.no_grad():
        full = tf.forward(cfg, params, tokens)
        cache = tf.init_cache(cfg, b, s, dev)
        steps = [tf.decode_step(cfg, params, cache, tokens[:, i:i + 1],
                                i)[0][:, 0] for i in range(s)]
    return full, torch.stack(steps, 1)


def rel_err(got, want) -> float:
    """max |got - want| over max |want|."""
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max())


def lm_train_checks(torch, dev, args, nums):
    """Phase 13 (a): qwen2-1.5b's train step at full width.  Returns the
    float32 parameters (for (c)) and the bf16 ones."""
    from repro_torch import ShardGroup
    from repro_torch.configs.lm_common import LMTrainStep, build_lm_step
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.tokens import synthetic_token_batches
    from repro_torch.models import transformer as tf
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg = get_arch("qwen2-1.5b").full_config()
    n_elems = sum(int(np.prod(s)) for s in
                  tf.flat_params(tf.param_shapes(cfg)).values())
    log("lm", f"qwen2-1.5b: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads, KV {cfg.n_kv_heads}, d_head {cfg.d_head}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, tied embeddings, QKV bias; "
        f"{n_elems} parameter elements, param_count() {cfg.param_count()}")
    require(cfg.param_count() == QWEN_PARAM_COUNT,
            "qwen2-1.5b's param_count() is not the reference's")
    nums["qwen_param_elements"] = n_elems
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    (p32, init_s) = timed_s(torch, lambda: tf.init_params(cfg32, args.seed,
                                                          dev))
    log("lm", f"(a) float32 weights drawn on the card in {init_s:.3f} s")

    # 1. float32 against a float64 copy on the card.
    check = lm_token_batch(torch, cfg.vocab, LM_CHECK_B, LM_CHECK_S,
                           args.seed + 1, dev)
    loss32, g32 = LMTrainStep(cfg32).loss_and_grads(p32, check)
    cfg64 = dataclasses.replace(cfg, dtype="float64")
    p64 = tf.nest_params({k: x.double() for k, x in
                          tf.flat_params(p32).items()})
    loss64, g64 = LMTrainStep(cfg64).loss_and_grads(p64, check)
    loss_rel = abs(float(loss32) - float(loss64)) / abs(float(loss64))
    grad_rel = grads_agree(g32, g64)
    log("lm", f"(a) B {LM_CHECK_B}, S {LM_CHECK_S}: float32 loss "
        f"{float(loss32):.6f} against float64 {float(loss64):.6f} (relative "
        f"{loss_rel:.3e}); gradients within {grad_rel:.3e} of each tensor's "
        f"largest entry")
    require(loss_rel <= LM_LOSS_RTOL and grad_rel <= LM_GRAD_RTOL,
            "qwen2-1.5b: float32 and float64 disagree")
    nums.update(f64_loss_rel=loss_rel, f64_grad_rel=grad_rel)
    del p64, g64, g32
    torch.cuda.empty_cache()

    # 2-4. bf16: two first steps bit for bit, 5 AdamW steps, time.
    params = tf.nest_params({k: x.to(torch.bfloat16) for k, x in
                             tf.flat_params(p32).items()})
    seq = lm_seq("train_4k")
    batches = synthetic_token_batches(cfg.vocab, LM_TRAIN_B, seq,
                                      seed=args.seed + 2, device=dev)
    b0 = next(batches)
    step = build_lm_step(cfg, "train_4k", ShardGroup.single(dev),
                         opt_cfg=AdamWConfig(lr=LM_LR, warmup_steps=1,
                                             total_steps=LM_STEPS))
    torch.cuda.reset_peak_memory_stats()
    l1, g1 = step.loss_and_grads(params, b0)
    l2, g2 = step.loss_and_grads(params, b0)
    same = torch.equal(l1, l2) and all(torch.equal(g1[k], g2[k]) for k in g1)
    log("lm", f"(a) two bf16 first steps at B {LM_TRAIN_B}, S {seq}: loss "
        f"{float(l1):.6f}, bit for bit: {same}")
    require(same, "two identical bf16 first steps differ")
    del g1, g2
    opt = adamw_init(tf.flat_params(params))
    losses, secs = [], []
    for i in range(LM_STEPS):
        batch = b0 if i == 0 else next(batches)
        (params, opt, loss), s = timed_s(torch, lambda: step(params, opt,
                                                             batch))
        losses.append(float(loss))
        secs.append(s)
    step_s = float(np.median(secs[1:]))
    peak = peak_gib(torch)
    flops = lm_step_flops(cfg, LM_TRAIN_B, seq, "train")
    bound_s = flops / BF16_OPS_PER_S
    log("lm", f"(a) {LM_STEPS} AdamW steps at lr {LM_LR}: losses {losses}; "
        f"seconds {secs}: {step_s:.4f} s a step (median after the first), "
        f"{LM_TRAIN_B * seq / step_s:.1f} tokens/s; peak {peak:.2f} GiB; "
        f"{flops:.4e} model FLOPs, bound {bound_s:.4f} s at the bf16 peak "
        f"({step_s / bound_s:.2f}x)")
    require(all(np.isfinite(losses)) and losses[-1] < losses[0],
            f"qwen2-1.5b: losses {losses} not finite and falling")
    batch = next(batches)
    wall, n_ops, busy, top = device_profile(
        torch, lambda: step(params, opt, batch))
    log("lm", f"(a) one profiled step: {n_ops} device operations, busy "
        f"{busy:.2f} ms of {wall:.2f} ms (idle {1 - busy / wall:.3f}); top "
        f"{top}")
    nums.update(train_step_s=step_s, train_tokens_per_s=LM_TRAIN_B * seq
                / step_s, train_peak_gib=peak, train_flops=flops,
                train_bound_s=bound_s, train_busy_ms=busy,
                train_idle=1 - busy / wall)
    del opt, batch, batches
    torch.cuda.empty_cache()
    return cfg, p32, params


def lm_seq(shape: str) -> int:
    """The sequence length of an LM shape (``lm_common.LM_SHAPES``)."""
    from repro_torch.configs.lm_common import LM_SHAPES
    return LM_SHAPES[shape][0]


def lm_prefill_checks(torch, dev, args, cfg, params, nums):
    """Phase 13 (b): prefill_32k, and the causal prefix."""
    from repro_torch import ShardGroup
    from repro_torch.configs.lm_common import build_lm_step
    from repro_torch.models import transformer as tf

    seq = lm_seq("prefill_32k")
    tokens = lm_token_batch(torch, cfg.vocab, LM_PREFILL_B, seq,
                            args.seed + 3, dev)["tokens"]
    pre = build_lm_step(cfg, "prefill_32k", ShardGroup.single(dev))
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for _ in range(LM_PREFILL_CALLS):
        last, s = timed_s(torch, lambda: pre(params, {"tokens": tokens}))
        secs.append(s)
    peak = peak_gib(torch)
    pre_s = float(np.median(secs))
    flops = lm_step_flops(cfg, LM_PREFILL_B, seq, "prefill")
    bound_s = flops / BF16_OPS_PER_S
    require(bool(torch.isfinite(last).all()), "prefill logits not finite")
    log("lm", f"(b) prefill at B {LM_PREFILL_B}, S {seq}: seconds {secs}, "
        f"median {pre_s:.4f} s ({LM_PREFILL_B * seq / pre_s:.1f} tokens/s); "
        f"peak {peak:.2f} GiB; {flops:.4e} model FLOPs, bound "
        f"{bound_s:.4f} s ({pre_s / bound_s:.2f}x)")
    with torch.no_grad():
        at = tf.forward(cfg, params, tokens)[:, LM_PREFIX - 1]
    prefix = pre(params, {"tokens": tokens[:, :LM_PREFIX]})
    err = rel_err(prefix, at)
    log("lm", f"(b) the last logits of a {LM_PREFIX}-token prefill against "
        f"position {LM_PREFIX - 1} of the {seq}-token forward: within "
        f"{err:.3e} of the largest logit; argmax equal "
        f"{bool((prefix.argmax(-1) == at.argmax(-1)).all())}")
    require(torch.equal(prefix, at), "the prefill is not causal")
    nums.update(prefill_s=pre_s, prefill_peak_gib=peak,
                prefill_flops=flops, prefill_bound_s=bound_s,
                prefix_err=err)
    del at, prefix
    torch.cuda.empty_cache()
    return tokens, last


def lm_decode_timed(torch, dev, args, cfg, params, b: int, max_len: int,
                    steps: int, variant=(), profile=False):
    """``steps`` decode steps of ``cfg`` through ``build_lm_step`` at batch
    ``b`` against a ``max_len`` cache filled from the seed, from position
    ``max_len - 64``: (median seconds a step, peak GiB, cache bytes,
    modelled plain-op bytes, profile or None)."""
    from repro_torch import ShardGroup
    from repro_torch.configs.lm_common import build_lm_step
    from repro_torch.models import transformer as tf

    if "int8_kv" in variant:
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    torch.cuda.reset_peak_memory_stats()
    cache = tf.init_cache(cfg, b, max_len, dev)
    fill_cache(torch, cache, args.seed + 5)
    step = build_lm_step(cfg, "decode_32k", ShardGroup.single(dev),
                         variant=variant)
    toks = lm_token_batch(torch, cfg.vocab, b, steps, args.seed + 6,
                          dev)["tokens"]
    start = max_len - 64
    secs = []
    for i in range(steps):
        (logits, _), s = timed_s(torch, lambda: step(
            params, cache, {"tokens": toks[:, i:i + 1],
                            "cache_len": torch.tensor(start + i,
                                                      dtype=torch.int32,
                                                      device=dev)}))
        secs.append(s)
    require(bool(torch.isfinite(logits).all()),
            f"{cfg.name}: decode logits not finite")
    peak = peak_gib(torch)
    prof = None
    if profile:
        prof = device_profile(torch, lambda: step(
            params, cache, {"tokens": toks[:, :1], "cache_len": start}))
    out = (float(np.median(secs[1:] if steps > 1 else secs)), peak,
           nbytes(cache), decode_plain_bytes(cfg, cache), prof)
    del cache, _
    torch.cuda.empty_cache()
    return out


def lm_decode_checks(torch, dev, args, cfg, p32, params, nums):
    """Phase 13 (c): decode against forward in float32, the int8 cache
    against bf16, and timed steps at B 32 against a 32,768-position cache,
    beside the bytes-once bound."""
    toks = lm_token_batch(torch, cfg.vocab, 2, LM_PROMPT, args.seed + 4,
                          dev)["tokens"]
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    full, got = decode_prompt(torch, cfg32, p32, toks, dev)
    err = rel_err(got, full)
    log("lm", f"(c) float32: {LM_PROMPT} tokens through decode_step from an "
        f"empty cache against forward's teacher-forced logits: within "
        f"{err:.3e} of the largest")
    require(err <= LM_DECODE_TOL, "qwen2-1.5b: decode differs from forward")
    nums["decode_f32_err"] = err
    del full, got
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    full, bf = decode_prompt(torch, cfg, params, toks, dev)
    _, q8 = decode_prompt(torch, cfg8, params, toks, dev)
    agree = float((bf.argmax(-1) == q8.argmax(-1)).float().mean())
    drift = float((bf - q8).abs().max() / max(float(bf.abs().max()), 1.0))
    log("lm", f"(c) bf16 model, int8 cache against bf16 cache on the same "
        f"{LM_PROMPT} tokens: argmax agreement {agree:.4f}, drift "
        f"{drift:.4e} of the largest logit; bf16 decode against forward "
        f"within {rel_err(bf, full):.3e}")
    require(agree >= INT8_AGREE and drift < INT8_DRIFT,
            "the int8 cache strays from the bf16 cache")
    nums.update(int8_agree=agree, int8_drift=drift)
    del full, bf, q8
    seq = lm_seq("decode_32k")
    param_bytes = nbytes(params)
    for variant in ((), ("int8_kv",)):
        step_s, peak, cache_b, plain_b, prof = lm_decode_timed(
            torch, dev, args, cfg, params, LM_DECODE_B, seq,
            LM_DECODE_STEPS, variant, profile=True)
        bound_ms = (cache_b + param_bytes) / HBM_BYTES_PER_S * 1e3
        wall, n_ops, busy, top = prof
        tag = "int8" if variant else "bf16"
        log("lm", f"(c) {tag} cache: B {LM_DECODE_B}, {seq} positions from "
            f"cache_len {seq - 64}: {step_s * 1e3:.3f} ms a step (median "
            f"of {LM_DECODE_STEPS - 1} after the first), "
            f"{LM_DECODE_B / step_s:.1f} tokens/s, peak {peak:.2f} GiB; "
            f"bytes once {cache_b + param_bytes} (cache {cache_b}, weights "
            f"{param_bytes}): bound {bound_ms:.3f} ms "
            f"({step_s * 1e3 / bound_ms:.2f}x); the plain ops' bytes by "
            f"a model from the shapes (not measured) ~"
            f"{plain_b + param_bytes}; profiled step: {n_ops} device "
            f"operations, busy {busy:.2f} of {wall:.2f} ms (idle "
            f"{1 - busy / wall:.3f}); top {top}")
        nums.update({f"decode_{tag}_ms": step_s * 1e3,
                     f"decode_{tag}_peak_gib": peak,
                     f"decode_{tag}_bound_ms": bound_ms,
                     f"decode_{tag}_plain_bytes_model":
                     plain_b + param_bytes,
                     f"decode_{tag}_idle": 1 - busy / wall})


def lm_grid_vs_plain(torch, dev, args, cfg, params, prefill, nums):
    """Phase 13 (d): ``build_lm_step`` on one rank (a ``ShardGroup``: the
    model without a grid) against the same step over a 1 x 1 ``RankGrid``
    (the grid path: per-layer FSDP gathers of one rank, the vocab-parallel
    CE, the decode's partials and merge), in bf16 at (a)-(c)'s shapes:
    the train step's loss and gradients, the prefill (``prefill``: (b)'s
    tokens and last logits) and decode against a 32,768-position cache.
    The grid's numbers say why one rank takes the plain path."""
    from repro_torch import ShardGroup
    from repro_torch.configs.lm_common import build_lm_step
    from repro_torch.core.collectives import RankGrid
    from repro_torch.models import transformer as tf

    groups = {"plain": ShardGroup.single(dev), "grid": RankGrid.single(dev)}
    order = ("plain", "grid", "grid", "plain")
    seq = lm_seq("train_4k")
    batch = lm_token_batch(torch, cfg.vocab, LM_TRAIN_B, seq, args.seed + 2,
                           dev)
    steps = {k: build_lm_step(cfg, "train_4k", g) for k, g in groups.items()}
    secs, loss, peak = {k: [] for k in groups}, {}, {}
    for _ in range(LM_PAIR_TRAIN // 2):
        for k in order:
            torch.cuda.reset_peak_memory_stats()
            (l, g), t = timed_s(torch, lambda: steps[k].loss_and_grads(
                params, batch))
            secs[k].append(t)
            loss[k], peak[k] = float(l), peak_gib(torch)
            del g
    train = {k: float(np.median(v)) for k, v in secs.items()}
    log("lm", f"(d) train loss and gradients at B {LM_TRAIN_B}, S {seq}, "
        f"plain against a 1 x 1 grid: seconds {secs}; median plain "
        f"{train['plain']:.4f} s, grid {train['grid']:.4f} s "
        f"({train['grid'] / train['plain']:.3f}x); losses {loss}; peak GiB "
        f"{ {k: round(v, 2) for k, v in peak.items()} }")
    require(abs(loss["grid"] - loss["plain"]) <= 1e-2 * abs(loss["plain"]),
            "(d) the grid's bf16 loss strays from the plain one")
    del steps, batch
    torch.cuda.empty_cache()

    tokens, plain_last = prefill
    pre = build_lm_step(cfg, "prefill_32k", groups["grid"])
    pre_secs = []
    for _ in range(LM_PAIR_PREFILL):
        last, t = timed_s(torch, lambda: pre(params, {"tokens": tokens}))
        pre_secs.append(t)
    log("lm", f"(d) prefill at S {tokens.shape[1]} over the grid: seconds "
        f"{pre_secs} (plain in (b): median {nums['prefill_s']:.4f} s); last "
        f"logits equal the plain ones bit for bit: "
        f"{torch.equal(last, plain_last)}")
    del last, pre
    torch.cuda.empty_cache()

    seq = lm_seq("decode_32k")
    cache = tf.init_cache(cfg, LM_DECODE_B, seq, dev)
    fill_cache(torch, cache, args.seed + 5)
    dsteps = {k: build_lm_step(cfg, "decode_32k", g)
              for k, g in groups.items()}
    toks = lm_token_batch(torch, cfg.vocab, LM_DECODE_B, LM_PAIR_DECODE,
                          args.seed + 6, dev)["tokens"]
    start = seq - 64
    dsecs, logits = {k: [] for k in groups}, {}
    for i in range(LM_PAIR_DECODE):
        at = torch.tensor(start + i, dtype=torch.int32, device=dev)
        for k in order[(i % 2) * 2:(i % 2) * 2 + 2]:
            out, t = timed_s(torch, lambda: dsteps[k](
                params, cache, {"tokens": toks[:, i:i + 1], "cache_len": at}))
            logits[k] = out[0]
            del out
            dsecs[k].append(t)
    decode = {k: float(np.median(v[1:])) * 1e3 for k, v in dsecs.items()}
    err = rel_err(logits["grid"], logits["plain"])
    log("lm", f"(d) decode at B {LM_DECODE_B} against {seq} positions, "
        f"plain and grid in turn: seconds {dsecs}; median after the first "
        f"plain {decode['plain']:.3f} ms, grid {decode['grid']:.3f} ms "
        f"({decode['grid'] / decode['plain']:.3f}x); the last step's grid "
        f"logits within {err:.3e} of the plain ones")
    require(err <= 1e-2, "(d) the grid's decode strays from the plain one")
    nums["grid_vs_plain"] = {
        "train_s": train, "train_peak_gib": peak,
        "prefill_grid_s": float(np.median(pre_secs)),
        "decode_ms": decode, "decode_err": err}
    del cache, dsteps, logits
    torch.cuda.empty_cache()


def lm_other_checks(torch, dev, args, nums):
    """Phase 13 (e): gemma3, internlm2, mixtral and deepseek at published
    widths and reduced depth."""
    from repro_torch import ShardGroup
    from repro_torch.configs.lm_common import build_lm_step
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import transformer as tf
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update_

    group = ShardGroup.single(dev)
    for aid, n_rep, n_train in LM_OTHERS:
        arch = get_arch(aid)
        cfg = arch.config(n_repeats=n_rep)
        # (i) float32 decode against forward, no MoE token dropped:
        # capacity = tokens x top_k.
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        if cfg.moe is not None:
            cfg32 = dataclasses.replace(cfg32, moe=dataclasses.replace(
                cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
        p32 = tf.init_params(cfg32, args.seed, dev)
        toks = lm_token_batch(torch, cfg.vocab, 1, LM_OTHER_PROMPT,
                              args.seed + 7, dev)["tokens"]
        full, got = decode_prompt(torch, cfg32, p32, toks, dev)
        err = rel_err(got, full)
        log("lm", f"(e) {aid}: {cfg.n_layers} layers (published "
            f"{arch.full_config().n_layers}), d_model {cfg.d_model}, vocab "
            f"{cfg.vocab}, {cfg.param_count()} parameters; float32 decode of "
            f"{LM_OTHER_PROMPT} tokens against forward within {err:.3e}"
            + (f" (capacity_factor {cfg32.moe.capacity_factor}: no drops)"
               if cfg.moe is not None else ""))
        require(err <= LM_DECODE_TOL, f"{aid}: decode differs from forward")
        params = tf.nest_params({k: x.to(torch.bfloat16) for k, x in
                                 tf.flat_params(p32).items()})
        del p32, full, got
        torch.cuda.empty_cache()
        # (iii) prefill at S 8192, then one decode step at decode_32k and
        # at long_500k.
        ptoks = lm_token_batch(torch, cfg.vocab, 1, LM_OTHER_PREFILL,
                               args.seed + 8, dev)["tokens"]
        pre = build_lm_step(cfg, "prefill_32k", group)
        torch.cuda.reset_peak_memory_stats()
        secs = [timed_s(torch, lambda: pre(params, {"tokens": ptoks}))[1]
                for _ in range(2)]
        pre_peak = peak_gib(torch)
        rec = {"prefill_s": secs[-1], "prefill_peak_gib": pre_peak}
        msg = (f"(e) {aid}: bf16 prefill at S {LM_OTHER_PREFILL}, B 1: "
               f"{secs} s, peak {pre_peak:.2f} GiB")
        shapes = [("decode_32k", LM_OTHER_DECODE_B)]
        if "long_500k" in arch.shapes:
            shapes.append(("long_500k", 1))
        for shape, b in shapes:
            seq = lm_seq(shape)
            step_s, peak, cache_b, _, _ = lm_decode_timed(
                torch, dev, args, cfg, params, b, seq, 2)
            bound_ms = (cache_b + nbytes(params)) / HBM_BYTES_PER_S * 1e3
            msg += (f"; {shape} at B {b}: {step_s * 1e3:.3f} ms a step, "
                    f"peak {peak:.2f} GiB, bytes-once bound {bound_ms:.3f} "
                    f"ms")
            rec[f"{shape}_ms"] = step_s * 1e3
            rec[f"{shape}_peak_gib"] = peak
        log("lm", msg)
        # (ii) one bf16 train step at S 4096, B 1: the step's loss and
        # gradients, then its AdamW update in place.  A first step's
        # moments are zeros; they are allocated after the backward, beside
        # the gradients, so the backward's activations do not meet them.
        cfg_t = arch.config(n_repeats=n_train)
        p_t = tf.nest_params({k: x[:n_train].clone() if k.startswith(
            "layers.") else x for k, x in tf.flat_params(params).items()})
        del params
        torch.cuda.empty_cache()
        seq = lm_seq("train_4k")
        batch = lm_token_batch(torch, cfg.vocab, 1, seq, args.seed + 9, dev)
        step = build_lm_step(cfg_t, "train_4k", group,
                             opt_cfg=AdamWConfig(lr=LM_LR, warmup_steps=1))
        torch.cuda.reset_peak_memory_stats()
        (loss, grads), s_grad = timed_s(
            torch, lambda: step.loss_and_grads(p_t, batch))
        finite = bool(torch.isfinite(loss)) and all(
            bool(torch.isfinite(g).all()) for g in grads.values())
        flat = tf.flat_params(p_t)
        opt = adamw_init(flat)
        _, s_opt = timed_s(torch, lambda: adamw_update_(step.opt_cfg, flat,
                                                        grads, opt))
        s = s_grad + s_opt
        peak = peak_gib(torch)
        finite = finite and all(bool(torch.isfinite(x).all())
                                for x in flat.values())
        log("lm", f"(e) {aid}: one bf16 train step at {cfg_t.n_layers} "
            f"layer(s), S {seq}, B 1: loss {float(loss):.6f}, {s:.4f} s "
            f"(first call: loss and gradients {s_grad:.4f} s, AdamW "
            f"{s_opt:.4f} s), peak {peak:.2f} GiB; loss, gradients and "
            f"updated weights finite: {finite}")
        require(finite, f"{aid}: the train step is not finite")
        rec.update(train_s=s, train_peak_gib=peak, train_layers=n_train,
                   f32_decode_err=err)
        nums[aid] = rec
        del p_t, flat, grads, opt, step
        torch.cuda.empty_cache()


def lm_cli_checks(torch, dev, report, nums):
    """Phase 13 (f): ``python -m repro_torch.launch.train`` on the card in
    subprocesses (started together), and its louvain run against the CLI's
    own ``run_louvain`` in process, whose K3 launches are counted from 0
    and whose first K3 launch is held against the plain version."""
    from repro_torch.core import aggregate
    from repro_torch.kernels.aggregate import coarsen
    from repro_torch.launch.train import run_louvain

    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    procs = {}
    try:
        for name, argv in CLI_RUNS:
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.train", *argv],
                cwd=HERE, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
        outs = {}
        for name, p in procs.items():
            out, err = p.communicate(timeout=600)
            require(p.returncode == 0,
                    f"the CLI's {name} run failed: {err[-2000:]}")
            outs[name] = json.loads(out)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for name in ("qwen2-1.5b", "fm"):
        o = outs[name]
        log("lm", f"(f) CLI --arch {name}: {json.dumps(o)}")
        require(np.isfinite(o["loss_last"]) and o["loss_last"]
                < o["loss_first"], f"the CLI's {name} loss did not fall")
    o = outs["louvain"]
    log("lm", f"(f) CLI --arch louvain: {json.dumps(o)}")
    coarsen.coarsen_groups.launches = 0
    with first_call_recorded(aggregate, "coarsen_groups") as first:
        mine = run_louvain("rmat", CLI_SCALE, dev)
    torch.cuda.synchronize()
    launches = coarsen.coarsen_groups.launches
    log("lm", f"(f) run_louvain('rmat', {CLI_SCALE}) in process: "
        f"{json.dumps(mine)}; K3 launches {launches}")
    require(launches > 0, "(f) the CLI's louvain run never launched K3")
    require(all(o[k] == mine[k] for k in ("n", "e", "n_communities",
                                          "passes"))
            and abs(o["modularity"] - mine["modularity"]) <= 1e-6,
            "the CLI's louvain run differs from run_louvain in process")
    k3_held(torch, first[None], launches, report, "lm", "(f) cli",
            "coarsen_groups_cli")
    nums["cli"] = {k: outs[k]["seconds"] for k in outs}


def phase_lm(torch, args, dev, report):
    """Phase 13: the LM stack at full width (qwen2-1.5b train, prefill and
    decode; the four other LMs at reduced depth) and the training CLI."""
    require(not torch.backends.cuda.matmul.allow_tf32,
            "TF32 matmuls are on: the float64 checks assume float32 GEMMs")
    nums = {}
    cfg, p32, params = lm_train_checks(torch, dev, args, nums)
    prefill = lm_prefill_checks(torch, dev, args, cfg, params, nums)
    lm_decode_checks(torch, dev, args, cfg, p32, params, nums)
    del p32
    torch.cuda.empty_cache()
    lm_grid_vs_plain(torch, dev, args, cfg, params, prefill, nums)
    del params, prefill
    torch.cuda.empty_cache()
    lm_other_checks(torch, dev, args, nums)
    lm_cli_checks(torch, dev, report, nums)
    log("lm", "LM summary " + json.dumps(nums))


#: Phase 14: LM sharding on a (data, model) grid of gloo ranks on the card.
SHARD_GRID = (2, 2)
SHARD_RANKS = 4
#: qwen2-1.5b's depth in phase 14 (published 28; cut for time).
SHARD_QWEN_LAYERS = 2
SHARD_B, SHARD_S = 4, 1024
SHARD_DECODE_B, SHARD_DECODE_LEN = 4, 32768
SHARD_LONG_LEN = 524288
#: Decode steps from the last two positions of each cache (the last one
#: is the last rank's).
SHARD_DECODE_STEPS = 2
SHARD_MOE_PREFILL = (2, 4096)
SHARD_MOE_TRAIN = (2, 1024)
SHARD_IGNORED = 0.3
SHARD_LOSS_RTOL = 1e-5
SHARD_GRAD_RTOL = 1e-4
SHARD_LOGIT_RTOL = 1e-4
#: Grid runs are held to one rank; a rank has this long in all.
SHARD_TIMEOUT = 600


def shard_batch_np(torch, vocab: int, b: int, s: int, seed: int,
                   ignored: float = 0.0) -> dict:
    """A global token batch as numpy (``synthetic_token_batches`` on the
    host), a share ``ignored`` of its labels set to -1."""
    batch = {k: v.numpy() for k, v in lm_token_batch(
        torch, vocab, b, s, seed, "cpu").items()}
    if ignored:
        rng = np.random.default_rng(seed)
        batch["labels"] = np.where(rng.random(batch["labels"].shape)
                                   < ignored, -1, batch["labels"]).astype(
                                       batch["labels"].dtype)
    return batch


def shard_decode_steps(torch, vocab: int, b: int, max_len: int, seed: int):
    toks = lm_token_batch(torch, vocab, b, SHARD_DECODE_STEPS, seed,
                          "cpu")["tokens"].numpy()
    first = max_len - SHARD_DECODE_STEPS
    return [(toks[:, j:j + 1], first + j) for j in range(SHARD_DECODE_STEPS)]


def lm_sharded_runs(torch, args):
    """Phase 14's runs for ``lm_common.lm_rank_runs``, each tagged:
    ``checked`` runs are held against the same run on one rank, ``timed``
    ones are only timed."""
    from repro_torch.configs.registry import get_arch
    qwen = dataclasses.replace(get_arch("qwen2-1.5b").full_config(),
                               n_layers=SHARD_QWEN_LAYERS)
    q32 = dataclasses.replace(qwen, dtype="float32")
    mix = get_arch("mixtral-8x22b").config(n_repeats=1)
    ds = get_arch("deepseek-v2-236b").config(n_repeats=1)
    mix32 = dataclasses.replace(mix, dtype="float32")
    ds32 = dataclasses.replace(ds, dtype="float32")
    smoke = get_arch("mixtral-8x22b").smoke_config()
    seed = args.seed + 40
    v = qwen.vocab
    runs = [
        ("qwen f32 train", True, dict(
            cfg=q32, shape="train_4k", seed=seed, adam=False,
            batches=[shard_batch_np(torch, v, SHARD_B, SHARD_S, seed + 1)])),
        ("qwen f32 sharded_ce", True, dict(
            cfg=q32, shape="train_4k", seed=seed, adam=False,
            keep_grads=False, variant=("sharded_ce",),
            batches=[shard_batch_np(torch, v, SHARD_B, SHARD_S, seed + 2,
                                    SHARD_IGNORED)])),
        ("qwen f32 prefill", True, dict(
            cfg=q32, shape="prefill_32k", seed=seed,
            batch={"tokens": shard_batch_np(torch, v, SHARD_B, SHARD_S,
                                            seed + 3)["tokens"]})),
        ("qwen f32 decode_32k", True, dict(
            cfg=q32, shape="decode_32k", seed=seed, cache_seed=seed + 4,
            batch_size=SHARD_DECODE_B, max_len=SHARD_DECODE_LEN,
            keep_cache=False,
            steps=shard_decode_steps(torch, v, SHARD_DECODE_B,
                                     SHARD_DECODE_LEN, seed + 5))),
        ("qwen f32 long_500k", True, dict(
            cfg=q32, shape="long_500k", seed=seed, cache_seed=seed + 6,
            variant=("tp_only_params",),
            batch_size=1, max_len=SHARD_LONG_LEN, keep_cache=False,
            steps=shard_decode_steps(torch, v, 1, SHARD_LONG_LEN,
                                     seed + 7))),
        ("qwen bf16 train", False, dict(
            cfg=qwen, shape="train_4k", seed=seed, keep_grads=False,
            keep_params=False, opt=dict(lr=LM_LR),
            batches=[shard_batch_np(torch, v, SHARD_B, SHARD_S, seed + k)
                     for k in (8, 9)])),
        ("mixtral f32 prefill", True, dict(
            cfg=mix32, shape="prefill_32k", seed=seed + 10,
            variant=("tp_only_params",),
            batch={"tokens": shard_batch_np(
                torch, mix.vocab, *SHARD_MOE_PREFILL, seed + 11)["tokens"]})),
        ("mixtral f32 decode_32k", True, dict(
            cfg=mix32, shape="decode_32k", seed=seed + 10,
            variant=("tp_only_params",),
            cache_seed=seed + 12, batch_size=SHARD_DECODE_B,
            max_len=SHARD_DECODE_LEN, keep_cache=False,
            steps=shard_decode_steps(torch, mix.vocab, SHARD_DECODE_B,
                                     SHARD_DECODE_LEN, seed + 13))),
        ("deepseek f32 prefill", True, dict(
            cfg=ds32, shape="prefill_32k", seed=seed + 14,
            variant=("tp_only_params",),
            batch={"tokens": shard_batch_np(
                torch, ds.vocab, *SHARD_MOE_PREFILL, seed + 15)["tokens"]})),
        ("deepseek f32 decode_32k", True, dict(
            cfg=ds32, shape="decode_32k", seed=seed + 14,
            variant=("tp_only_params",),
            cache_seed=seed + 16, batch_size=SHARD_DECODE_B,
            max_len=SHARD_DECODE_LEN, keep_cache=False,
            steps=shard_decode_steps(torch, ds.vocab, SHARD_DECODE_B,
                                     SHARD_DECODE_LEN, seed + 17))),
        ("mixtral bf16 train", False, dict(
            cfg=mix, shape="train_4k", seed=seed + 10, keep_grads=False,
            keep_params=False, opt=dict(lr=LM_LR),
            batches=[shard_batch_np(torch, mix.vocab, *SHARD_MOE_TRAIN,
                                    seed + 18)])),
        ("mixtral smoke train", True, dict(
            cfg=smoke, shape="train_4k", seed=seed + 20, adam=False,
            batches=[shard_batch_np(torch, smoke.vocab, SHARD_B, 64,
                                    seed + 21)])),
    ]
    return runs


def load_result(tree):
    """A rank's result with each ``.npy`` path read back."""
    if isinstance(tree, dict):
        return {k: load_result(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [load_result(v) for v in tree]
    if isinstance(tree, str) and tree.endswith(".npy"):
        return np.load(tree)
    return tree


def nccl_grid_checks(torch, args, dev, nums):
    """Phase 14 (a): a 1 x 1 grid over one NCCL rank (every collective runs
    through the process group) against the 1 x 1 grid over
    ``ShardGroup.single`` (``lm_rank_runs`` lays either out), bit for bit:
    qwen2-1.5b at full width and SHARD_QWEN_LAYERS layers in bf16, a train
    step with one AdamW step, a prefill and a decode step."""
    from repro_torch import ShardGroup
    from repro_torch.configs.lm_common import lm_rank_runs
    from repro_torch.configs.registry import get_arch
    cfg = dataclasses.replace(get_arch("qwen2-1.5b").full_config(),
                              n_layers=SHARD_QWEN_LAYERS)
    seed = args.seed + 60
    runs = [dict(cfg=cfg, shape="train_4k", seed=seed, grid=(1, 1),
                 opt=dict(lr=LM_LR),
                 batches=[shard_batch_np(torch, cfg.vocab, 2, SHARD_S,
                                         seed + 1)]),
            dict(cfg=cfg, shape="prefill_32k", seed=seed, grid=(1, 1),
                 batch={"tokens": shard_batch_np(torch, cfg.vocab, 1,
                                                 SHARD_S, seed + 2)[
                                                     "tokens"]}),
            dict(cfg=cfg, shape="decode_32k", seed=seed, grid=(1, 1),
                 cache_seed=seed + 3, batch_size=2, max_len=4096,
                 steps=shard_decode_steps(torch, cfg.vocab, 2, 4096,
                                          seed + 4))]
    single = lm_rank_runs(ShardGroup.single(dev), runs)
    with nccl_world_of_one(dev) as group:
        nccl = lm_rank_runs(group, runs)

    def same(a, b) -> bool:
        if isinstance(a, dict):
            return set(a) == set(b) and all(same(a[k], b[k]) for k in a)
        if isinstance(a, list):
            return len(a) == len(b) and all(map(same, a, b))
        if isinstance(a, np.ndarray):
            return a.dtype == b.dtype and np.array_equal(a, b)
        return a == b

    keys = ("loss", "grads", "params", "losses", "logits", "cache")
    equal = [all(same(n.get(k), o.get(k)) for k in keys)
             for n, o in zip(nccl, single)]
    colls = [n["stats"]["collectives"] for n in nccl]
    log("lm_sharded", f"(a) a 1 x 1 grid over one NCCL rank against one "
        f"over ShardGroup.single, qwen2-1.5b bf16 at {SHARD_QWEN_LAYERS} layers: "
        f"train step (loss {nccl[0]['loss']:.6f}, gradients, one AdamW "
        f"step), prefill, decode: bit for bit {equal}; NCCL collectives "
        f"{colls}")
    require(all(equal), "the NCCL grid of one differs from one rank")
    require(all(c > 0 for c in colls), "the NCCL grid ran no collective")
    nums["nccl_bit_equal"] = all(equal)


def phase_lm_sharded(torch, args, dev, report):
    """Phase 14: LM sharding.  (a) ``nccl_grid_checks``; (b)-(c) every run
    of ``lm_sharded_runs`` on SHARD_RANKS gloo ranks on the one card as a
    SHARD_GRID grid (FSDP over data, tensor and expert parallelism over
    model, the decode caches' sequence over model, or over every rank at
    batch 1), each checked run against the same run on one rank in this
    process; the timed bf16 train steps' seconds, tokens/s, peak memory
    per rank and staged bytes."""
    import shutil
    import tempfile
    from repro_torch import ShardGroup
    from repro_torch.configs.lm_common import flat_split, lm_rank_runs
    from repro_torch.core import collectives
    from repro_torch.interop import lm_tree_assemble
    from repro_torch.sharding.rules import assemble, lm_batch_split
    require(not torch.backends.cuda.matmul.allow_tf32,
            "TF32 matmuls are on: the float32 checks assume float32 GEMMs")
    nums = {}
    t0 = time.perf_counter()
    nccl_grid_checks(torch, args, dev, nums)
    nums["a_s"] = time.perf_counter() - t0
    log("lm_sharded", f"(a) {nums['a_s']:.2f} s")
    torch.cuda.empty_cache()

    tagged = lm_sharded_runs(torch, args)
    t0 = time.perf_counter()
    one = {}
    for tag, checked, run in tagged:
        if checked:
            one[tag] = lm_rank_runs(ShardGroup.single(dev),
                                    [dict(run, grid=(1, 1))])[0]
            torch.cuda.empty_cache()
    nums["one_rank_s"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    log("lm_sharded", f"one-rank references of {len(one)} runs: "
        f"{nums['one_rank_s']:.2f} s; this process then holds "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
        f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved, beside "
        f"the ranks")
    tmp = tempfile.mkdtemp(prefix="chip-smoke-lm-ranks-")
    # The ranks draw deepseek's whole expert tensors (5 GB each) and keep
    # their shares: with the caching allocator's segments split, a rank
    # once held 2.52 GiB reserved but unallocated when another ran out of
    # memory on the card.  The spawned ranks read this at their first CUDA
    # call; this process has made its own allocator already.
    alloc_conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        runs = [dict(run, grid=SHARD_GRID) for _, _, run in tagged]
        t0, t_wall = time.perf_counter(), time.time()
        out = collectives.launch(lm_rank_runs, SHARD_RANKS, runs, tmp,
                                 backend="gloo",
                                 devices=[str(dev)] * SHARD_RANKS,
                                 timeout=SHARD_TIMEOUT)
        nums["launch_s"] = time.perf_counter() - t0
        t_back = time.time()
        out = [load_result(o) for o in out]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        if alloc_conf is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc_conf
    log("lm_sharded", f"{SHARD_RANKS} gloo ranks on one card as a "
        f"{SHARD_GRID} grid, {len(runs)} runs: {nums['launch_s']:.2f} s with "
        f"the rank starts; the ranks' step seconds "
        f"{[round(sum(sum(r['step_seconds']) for r in o), 2) for o in out]}; "
        f"rank 0's step seconds a run "
        f"{[round(sum(r['step_seconds']), 2) for r in out[0]]} of its run "
        f"seconds {[round(r['seconds'], 2) for r in out[0]]}; the first "
        f"run started {min(o[0]['started'] for o in out) - t_wall:.2f} s "
        f"after the launch, the last ended "
        f"{max(o[-1]['finished'] for o in out) - t_wall:.2f} s after it, "
        f"and the launch returned {t_back - t_wall:.2f} s after it")

    class Grid:
        shape = dict(zip(("data", "model"), SHARD_GRID))
        axis_names = ("data", "model")

    def rel(got, want) -> float:
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        return float(np.abs(got - want).max()
                     / max(np.abs(want).max(), 1e-30))

    errs = {}
    for j, (tag, checked, run) in enumerate(tagged):
        ranks = [o[j] for o in out]
        cfg = run["cfg"]
        if not checked:
            secs = [r["step_seconds"] for r in ranks]
            step_s = max(s[-1] for s in secs)
            toks = int(np.prod(run["batches"][0]["tokens"].shape))
            peak = [round(r["peak_bytes"] / 2**30, 2) for r in ranks]
            staged = [r["stats"]["staged_bytes"] for r in ranks]
            losses = ranks[0]["losses"]
            log("lm_sharded", f"{tag} on the grid, B x S "
                f"{run['batches'][0]['tokens'].shape}: losses {losses}; "
                f"step seconds per rank {secs}; {step_s:.4f} s a step "
                f"(slowest rank, last step), {toks / step_s:.1f} tokens/s; "
                f"peak GiB per rank {peak}; staged bytes per rank {staged}")
            require(all(np.isfinite(losses)), f"{tag}: losses not finite")
            key = tag.split()[0]
            nums.update({f"{key}_bf16_step_s": step_s,
                         f"{key}_bf16_tokens_per_s": toks / step_s,
                         f"{key}_bf16_peak_gib": max(peak),
                         f"{key}_bf16_staged_bytes": max(staged)})
            continue
        want = one[tag]
        kind = run["shape"]
        if kind == "train_4k":
            err = {"loss": max(abs(r["loss"] - want["loss"])
                               / abs(want["loss"]) for r in ranks)}
            tol = {"loss": SHARD_LOSS_RTOL}
            if "grads" in want:
                split = flat_split(cfg, Grid)
                err["grads"] = max(rel(lm_tree_assemble(
                    [r["grads"][k] for r in ranks], split[k], Grid),
                    g) for k, g in want["grads"].items())
                tol["grads"] = SHARD_GRAD_RTOL
            if "sharded_ce" in run.get("variant", ()):
                err.update(sharded_ce_identity(torch, dev, run, want))
                tol["identity"] = SHARD_LOSS_RTOL
        elif kind == "prefill_32k":
            got = assemble([r["logits"] for r in ranks],
                           lm_batch_split(Grid)["tokens"], Grid)
            err = {"logits": rel(got, want["logits"])}
            tol = {"logits": SHARD_LOGIT_RTOL}
        else:
            long = run["batch_size"] == 1
            split = (None, None, None) if long else (
                lm_batch_split(Grid)["tokens"] + (None,))
            # The last step writes the cache's last position, which only
            # the last rank of the sequence holds, and attends it.
            err = {"logits": max(rel(assemble(
                [r["logits"][s] for r in ranks], split, Grid),
                want["logits"][s]) for s in range(SHARD_DECODE_STEPS))}
            tol = {"logits": SHARD_LOGIT_RTOL}
        secs = max(sum(r["step_seconds"]) for r in ranks)
        log("lm_sharded", f"{tag}: errors against one rank "
            f"{ {k: float(f'{v:.3e}') for k, v in err.items()} } (limits "
            f"{tol}); slowest rank {secs:.3f} s, one rank "
            f"{sum(want['step_seconds']):.3f} s; peak GiB per rank "
            f"{[round(r['peak_bytes'] / 2**30, 2) for r in ranks]}")
        require(all(err[k] <= tol[k] for k in tol),
                f"{tag}: the grid differs from one rank")
        errs[tag] = max(err[k] / tol[k] for k in tol)
    nums["worst_err_over_limit"] = max(errs.values())
    log("lm_sharded", "LM sharding summary " + json.dumps(
        {k: (v if isinstance(v, bool) else float(v))
         for k, v in nums.items()}))


def sharded_ce_identity(torch, dev, run, want) -> dict:
    """The sharded CE counts an ignored label's ``lse``: on one rank,
    ``sharded * n_all`` must equal ``dense * n_kept + sum(lse over the
    ignored)``, with the dense loss and ``lse`` from full float32 logits."""
    from repro_torch.models import transformer as tf
    from repro_torch.configs.lm_common import init_param_shares
    from repro_torch.core.collectives import RankGrid
    cfg = run["cfg"]
    grid = RankGrid.single(dev)
    params = init_param_shares(cfg, grid, run["seed"], dev)
    batch = run["batches"][0]
    tokens = torch.from_numpy(batch["tokens"]).to(dev)
    labels = torch.from_numpy(batch["labels"]).to(dev)
    with torch.no_grad():
        logits = tf.forward(cfg, params, tokens)
        lse = torch.logsumexp(logits, dim=-1)
        dense = float(tf.cross_entropy_loss(logits, labels))
    ignored = labels == -1
    n_all, n_kept = labels.numel(), int((~ignored).sum())
    want_sum = dense * n_kept + float(lse[ignored].double().sum())
    del params, logits
    torch.cuda.empty_cache()
    return {"identity": abs(want["loss"] * n_all - want_sum)
            / abs(want_sum)}


# ---------------------------------------------------------------------------
# Phase 15: the dry run and the Louvain arch's distributed phases.
# ---------------------------------------------------------------------------

#: Phase 15 (a) runs at road_108M's size (``louvain_arch.LOUVAIN_SHAPES``,
#: the europe_osm row of the paper's Table 1: 50,912,018 vertices,
#: 108,109,320 directed slots).  Its start membership: blocks of this many consecutive vertices (the
#: path makes a block a good community; its boundary vertices move).
ROAD_BLOCK = 50
#: Longest shortcut of the road graph beyond its path.
ROAD_REACH = 64
#: Float tolerance of the delta round against the gather round.
DRY_TOL = 1e-4
#: (b), (d): gloo ranks on the one card.
DRY_RANKS = 4
#: (c): qwen2-1.5b cut to 2 layers; train at B 4, S 4,096, prefill at B 1,
#: S 4,096, one decode step at B 4 against a 32,768-position cache.
DRY_LM_LAYERS = 2
DRY_TRAIN = (4, 4096)
DRY_PREFILL = (1, 4096)
DRY_DECODE = (4, 32768)
#: (c): a dry high-water mark more than this far from the card's is written
#: down with its cause.
DRY_PEAK_GAP = 0.10


def road_graph(torch, dev, n: int, slots: int, seed: int):
    """A road-like graph of ``n`` vertices and ``slots`` directed unit-weight
    slots (average degree ~2.1, as europe_osm's), drawn on the card from
    ``seed``: the path 0-1-...-(n-1) and random shortcuts (u, u + d), d in
    [2, ROAD_REACH], each pair in both directions."""
    extra = slots // 2 - (n - 1)
    gen = torch.Generator(device=dev).manual_seed(seed)
    u = torch.randint(0, n - ROAD_REACH, (extra,), generator=gen,
                      device=dev)
    d = torch.randint(2, ROAD_REACH + 1, (extra,), generator=gen, device=dev)
    a = torch.cat([torch.arange(n - 1, device=dev), u])
    b = torch.cat([torch.arange(1, n, device=dev), u + d])
    del u, d
    src = torch.cat([a, b]).to(torch.int32)
    dst = torch.cat([b, a]).to(torch.int32)
    del a, b
    return src, dst, torch.ones(slots, dtype=torch.float32, device=dev)


def block_state(torch, src, w, n: int):
    """Blocks of ROAD_BLOCK consecutive vertices as the membership (each
    labelled by its first vertex), with K, Sigma, the community sizes and
    m, each (n + 1,) with the sentinel n."""
    dev = src.device
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    comm = torch.cat([ids // ROAD_BLOCK * ROAD_BLOCK,
                      torch.full((1,), n, dtype=torch.int32, device=dev)])
    k = torch.zeros(n + 1, dtype=torch.float64, device=dev).index_add_(
        0, src.long(), w.double()).float()
    sigma = torch.zeros(n + 1, dtype=torch.float64, device=dev).index_add_(
        0, comm[:n].long(), k[:n].double()).float()
    sizes = torch.zeros(n + 1, dtype=torch.int32, device=dev).index_add_(
        0, comm[:n].long(), torch.ones(n, dtype=torch.int32, device=dev))
    m = (w.double().sum() / 2).float()
    return comm, k, sigma, sizes, m


@contextlib.contextmanager
def k3_calls(torch):
    """Every K3 call of the aggregation (``core.aggregate.coarsen_groups``,
    the by-name import ``reduce_sorted_slots`` reaches): each call's
    inputs and outputs kept (clones); the wrapper counts its launches."""
    from repro_torch.core import aggregate
    real = aggregate.coarsen_groups
    calls = []

    def recorder(s_ci, s_cj, s_w, *, sent):
        out = real(s_ci, s_cj, s_w, sent=sent)
        calls.append(((s_ci.clone(), s_cj.clone(), s_w.clone()), sent,
                      tuple(o.clone() for o in out)))
        return out

    aggregate.coarsen_groups = recorder
    try:
        yield calls
    finally:
        aggregate.coarsen_groups = real


def k3_calls_held(torch, calls, what: str):
    """Each recorded K3 call against its plain version, bit for bit; the
    (ms, plain ms, bound bytes, slots) of each, CUDA events."""
    from repro_torch.kernels.aggregate import coarsen
    out = []
    for i, (slots, sent, got) in enumerate(calls):
        want = coarsen.coarsen_groups_ref(*slots, sent=sent)
        torch.cuda.synchronize()
        require(all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                    for a, b in zip(got, want)),
                f"{what}: K3 launch {i} differs from its plain version")
        del want
        total = slots[0].numel()
        ms = time_ms(torch, lambda: coarsen.coarsen_groups(*slots,
                                                           sent=sent), 3)
        plain = time_ms(torch, lambda: coarsen.coarsen_groups_ref(
            *slots, sent=sent), 1, warmup=0)
        out.append((ms, plain, 12 * total + 17 * (total + 1), total))
        log("dryrun", f"(a) {what}, K3 launch {i}: exact on {total} slots "
            f"({int(got[0].sum())} groups); {ms:.4f} ms (plain "
            f"{plain:.4f} ms), {ms / (out[-1][2] / HBM_BYTES_PER_S * 1e3):.3f}"
            f"x its bound")
    return out


def dry_road_checks(torch, args, dev, report, nums):
    """Phase 15 (a): ``LouvainArch``'s road_108M steps at world size 1
    through NCCL on a road-like graph of that size: the delta-C round
    against the gather round (membership exact, Sigma and dQ within
    DRY_TOL, no overflow), the a2a aggregation against the gather one
    (records equal; exact, the weights being units), every K3 launch held
    against its plain version bit for bit; each step's ms (CUDA events)
    and peak memory."""
    from repro_torch.configs import louvain_arch as la
    from repro_torch.kernels.aggregate import coarsen

    n, e, _ = la.LOUVAIN_SHAPES["road_108M_move"]
    src, dst, w = road_graph(torch, dev, n, e, args.seed)
    comm, k, sigma, sizes, m = block_state(torch, src, w, n)
    log("dryrun", f"(a) road graph on the card: {n} vertices, {e} slots "
        f"(seed {args.seed}), blocks of {ROAD_BLOCK}; edges "
        f"{3 * 4 * e / 1e9:.2f} GB")
    move = {"src": src, "dst": dst, "w": w, "comm": comm, "sigma": sigma,
            "k": k, "m": m}
    agg = {"src": src, "dst": dst, "w": w, "comm": comm}
    outs, ms, peaks = {}, {}, {}
    with nccl_world_of_one(dev) as group:
        steps = {name: la.ARCH.build_step(shape, group, variant=variant)
                 for name, shape, variant in (
                     ("move", "road_108M_move", ()),
                     ("delta_c", "road_108M_move", ("delta_c",)),
                     ("gather", "road_108M_aggregate", ()),
                     ("a2a", "road_108M_aggregate", ("a2a",)))}
        require(steps["a2a"].spec == la.spec_for(group, n, e)
                and steps["a2a"].spec.e_per_shard == e,
                "the road layout is not one rank's whole graph")
        inputs = {"move": move, "delta_c": dict(move, comm_sizes=sizes),
                  "gather": agg, "a2a": agg}
        k3 = {}
        coarsen.coarsen_groups.launches = 0
        for name, step in steps.items():
            with k3_calls(torch) as calls:
                outs[name] = step(inputs[name])
            k3[name] = calls
        launches = coarsen.coarsen_groups.launches
        require(launches == 4 and len(k3["gather"]) == 2
                and len(k3["a2a"]) == 2 and not k3["move"]
                and not k3["delta_c"],
                f"K3 launched {launches} times in the four steps; want 2 "
                f"per aggregation")

        cb, sb, _, dqb = outs["move"]
        cd, sd, szd, _, dqd, ovf = outs["delta_c"]
        moved = int((cb[:n] != comm[:n]).sum())
        require(int(ovf) <= 0 and torch.equal(cb, cd) and moved > 0,
                f"the delta-C round's membership differs from the gather "
                f"round's (overflow {int(ovf)}, movers {moved})")
        sig_err = float((sb - sd).abs().max())
        dq_err = abs(float(dqb) - float(dqd))
        require(sig_err <= DRY_TOL and dq_err <= DRY_TOL,
                f"delta-C round: Sigma {sig_err:.3e}, dQ {dq_err:.3e}")
        want_sizes = torch.zeros_like(szd).index_add_(
            0, cd[:n].long(), torch.ones(n, dtype=szd.dtype, device=dev))
        require(torch.equal(szd, want_sizes),
                "the delta-C round's sizes are not its membership's")
        log("dryrun", f"(a) delta-C round = gather round: {moved} movers "
            f"(cap {n // la.DELTA_C_MOVE_CAP_FRAC}), Sigma within "
            f"{sig_err:.3e}, dQ {float(dqd):.6f} within {dq_err:.3e}")

        gc_, gj, gw, gvalid, gmax = outs["gather"]
        ac, aj, aw, avalid, dropped = outs["a2a"]
        ev = int(gvalid)
        require(ev == int(avalid) == int(gmax) and int(dropped) == 0
                and torch.equal(gc_[:ev], ac[:ev])
                and torch.equal(gj[:ev], aj[:ev])
                and torch.equal(gw[:ev], aw[:ev])
                and bool((ac[ev:] == n).all())
                and float(aw.double().sum()) == float(e),
                f"a2a and gather coarse graphs differ ({ev} and "
                f"{int(avalid)} coarse edges, {int(dropped)} dropped)")
        log("dryrun", f"(a) a2a aggregation = gather aggregation: {ev} "
            f"coarse edges, total weight {e} exactly, nothing dropped")
        del outs
        times = {name: k3_calls_held(torch, k3[name], name)
                 for name in ("gather", "a2a")}
        del k3
        for name, step in steps.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            ms[name] = time_ms(torch, lambda: step(inputs[name]), 2)
            peaks[name] = torch.cuda.max_memory_allocated() - base
        nums["road_ms"] = ms
        nums["road_peak_gib"] = {k_: v / 2**30 for k_, v in peaks.items()}
        log("dryrun", "(a) step ms (CUDA events, mean of 2): "
            + ", ".join(f"{k_} {v:.1f}" for k_, v in ms.items())
            + "; peak GiB above the inputs: "
            + ", ".join(f"{k_} {v / 2**30:.2f}" for k_, v in peaks.items()))
    for name in ("gather", "a2a"):
        t_ms, plain, n_bytes, total = times[name][-1]
        report.append(kernel_entry(f"coarsen_groups_{name}", 2, 0.0, t_ms,
                                   plain, n_bytes, total))


def dry_smoke_runs(torch, seed: int):
    """(b)'s inputs: the smoke Louvain shapes laid out for DRY_RANKS ranks
    (each rank's slots have sources it owns; each slot's target within 3
    ids of its source), unit weights; the move runs start from blocks of 8,
    the aggregations label by blocks of 16."""
    from repro_torch.configs import louvain_arch as la
    n, e = la.LOUVAIN_SMOKE
    v_per, e_per = n // DRY_RANKS, e // DRY_RANKS
    rng = np.random.default_rng(seed)
    src = (np.repeat(np.arange(DRY_RANKS) * v_per, e_per)
           + rng.integers(0, v_per, e)).astype(np.int32)
    dst = np.clip(src + rng.choice([-3, -2, -1, 1, 2, 3], e), 0,
                  n - 1).astype(np.int32)
    w = np.ones(e, np.float32)
    k = np.zeros(n + 1, np.float32)
    np.add.at(k, src, w)
    runs = []
    for shape, variant, block in (("road_108M_move", (), 8),
                                  ("road_108M_move", ("delta_c",), 8),
                                  ("road_108M_aggregate", (), 16),
                                  ("road_108M_aggregate", ("a2a",), 16)):
        comm = np.append(np.arange(n) // block * block, n).astype(np.int32)
        sigma = np.zeros(n + 1, np.float32)
        np.add.at(sigma, comm[:n], k[:n])
        batch = {"src": src, "dst": dst, "w": w, "comm": comm}
        if "move" in shape:
            batch.update(sigma=sigma, k=k, m=np.float32(e / 2))
            if variant:
                batch["comm_sizes"] = np.bincount(
                    comm[:n], minlength=n + 1).astype(np.int32)
        runs.append({"shape": shape, "variant": variant, "batch": batch})
    return runs


def dry_smoke_checks(torch, out) -> None:
    """(b): on the ranks, a2a equals gather and delta-C equals the gather
    round (membership exact, Sigma and dQ within DRY_TOL)."""
    from repro_torch.configs import louvain_arch as la
    n = la.LOUVAIN_SMOKE[0]
    for rank, res in enumerate(out):
        cb, sb, _, dqb = res[0]["out"]
        cd, sd, _, _, dqd, ovf = res[1]["out"]
        require(int(ovf) <= 0 and np.array_equal(cb, cd)
                and np.abs(sb - sd).max() <= DRY_TOL
                and abs(float(dqb) - float(dqd)) <= DRY_TOL
                and int((cb[:n] != np.arange(n) // 8 * 8).sum()) > 0,
                f"(b) rank {rank}: the delta-C round differs from the "
                f"gather round")

    def records(i):
        got = {}
        for res in out:
            ci, cj, cw = res[i]["out"][:3]
            for a, b, x in zip(ci, cj, cw):
                if a < n:
                    got[(int(a), int(b))] = float(x)
        return got

    base, a2a = records(2), records(3)
    require(base == a2a and len(base) > 0
            and all(int(res[3]["out"][4]) == 0 for res in out),
            "(b) the a2a coarse graph differs from the gather one")
    log("dryrun", f"(b) smoke shapes on {len(out)} gloo ranks on the card: "
        f"a2a = gather ({len(base)} coarse edges), delta-C = gather round; "
        f"step seconds rank 0: "
        + ", ".join(f"{r['seconds']:.3f}" for r in out[0]))


def dry_lm_checks(torch, dev, args, nums) -> None:
    """(c): qwen2-1.5b at DRY_LM_LAYERS layers on a 1 x 1 grid over one
    NCCL rank: its train, prefill and decode steps on the card under the
    dry run's counters (``analysis.trace``: ``FlopCounterMode`` and the
    storages the operators return), against the dry run of the same steps
    (a dry 1 x 1 grid, meta tensors): FLOPs and argument bytes equal; the
    dry high-water mark beside ``max_memory_allocated`` and beside the
    counters' mark on the card."""
    from repro_torch import compat
    from repro_torch.configs import lm_common
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.collectives import RankGrid, ShardGroup
    from repro_torch.launch import analysis, dryrun
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw_init

    arch = get_arch("qwen2-1.5b")
    cfg = arch.config(False, DRY_LM_LAYERS)
    runs = (("train_4k", DRY_TRAIN), ("prefill_32k", DRY_PREFILL),
            ("decode_32k", DRY_DECODE))
    with nccl_world_of_one(dev) as group:
        grid = RankGrid(group, (1, 1))
        params = lm_common.init_param_shares(cfg, grid, args.seed, dev)
        for shape, (b, s) in runs:
            kind = lm_common.LM_SHAPES[shape][2]
            step = lm_common.build_lm_step(cfg, shape, grid)
            if kind == "train":
                tok = lm_token_batch(torch, cfg.vocab, b, s, args.seed, dev)
                batch = {"tokens": tok["tokens"], "labels": tok["labels"]}
                opt = adamw_init(tf.flat_params(params))
                call = (params, opt, batch)
                specs = {k: ((b, s), torch.int32) for k in batch}
            elif kind == "prefill":
                batch = {"tokens": lm_token_batch(
                    torch, cfg.vocab, b, s, args.seed, dev)["tokens"]}
                call = (params, batch)
                specs = {"tokens": ((b, s), torch.int32)}
            else:
                cache = lm_common.random_cache(
                    cfg, b, s, args.seed, dev, grid,
                    lm_common.step_cache_split(cfg, shape, grid))
                batch = {"tokens": torch.zeros((b, 1), dtype=torch.int32,
                                               device=dev),
                         "cache_len": torch.tensor(s - 1, dtype=torch.int32,
                                                   device=dev)}
                call = (params, cache, batch)
                specs = {"tokens": ((b, 1), torch.int32),
                         "cache_len": ((), torch.int32)}
            local = lm_common.local_batch(batch, grid)
            real_args = analysis.tensor_bytes(call[:-1] + (local,))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t = time.perf_counter()
            # The dry run's counters on the card's tensors: FLOPs
            # (``FlopCounterMode``) and the storages the operators return.
            card = analysis.trace(step, call, grid, real_args)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
            real_peak = real_args + torch.cuda.max_memory_allocated() - base
            real_flops = card["flops"]
            del call, batch, local
            dry_grid = compat.make_mesh((1, 1), ("data", "model"),
                                        ShardGroup.dry(0, 1))
            t = time.perf_counter()
            rec = dryrun.trace_cell(arch, shape, dry_grid,
                                    n_repeats=DRY_LM_LAYERS,
                                    batch_specs=specs, cache_len=s)
            dry_s = time.perf_counter() - t
            dry_peak = analysis.memory_stats(rec)["peak_memory_in_bytes"]
            gap = dry_peak / real_peak - 1.0
            traced_peak = real_args + card["temp_peak"]
            nums[f"lm_{kind}"] = {"flops": real_flops, "arg_bytes": real_args,
                                  "dry_peak": dry_peak,
                                  "card_peak": real_peak, "gap": gap,
                                  "card_traced_peak": traced_peak,
                                  "step_s": secs, "dry_s": dry_s}
            require(rec["flops"] == real_flops > 0,
                    f"(c) {kind}: the dry run counts {rec['flops']:.6e} "
                    f"FLOPs, the card's step {real_flops:.6e}")
            require(rec["arg_bytes"] == real_args,
                    f"(c) {kind}: the dry run's argument bytes "
                    f"{rec['arg_bytes']} differ from the shares' "
                    f"{real_args}")
            log("dryrun", f"(c) qwen2-1.5b {kind} (B {b}, S {s}, "
                f"{DRY_LM_LAYERS} layers): FLOPs {real_flops:.6e} equal, "
                f"argument bytes {real_args} equal; high-water dry "
                f"{dry_peak / 2**30:.3f} GiB, card {real_peak / 2**30:.3f} "
                f"GiB (gap {gap * 100:+.1f}%"
                f"{', above ' + str(int(DRY_PEAK_GAP * 100)) + '%' if abs(gap) > DRY_PEAK_GAP else ''}"
                f"), the dry counters on the card's step "
                f"{traced_peak / 2**30:.3f} GiB; step {secs:.3f} s on the "
                f"card under the counters, dry trace {dry_s:.2f} s")
        del params
    torch.cuda.empty_cache()


def dry_dimenet_runs(torch, args):
    """(d)'s run: DimeNet at full width on a full_graph_sm batch from
    ``make_batch(--seed)`` (triplets drawn at random, as the arch's batch
    draws them), the weights drawn from seed 0 on every rank."""
    from repro_torch.configs.gnn_common import GNN_SHAPES
    from repro_torch.configs.registry import get_arch
    arch = get_arch("dimenet")
    cfg = arch.make_config(GNN_SHAPES["full_graph_sm"], False)
    batch = arch.make_batch("full_graph_sm", args.seed, smoke=False,
                            device="cpu")
    return {"arch": "dimenet", "cfg": cfg, "shape": "full_graph_sm",
            "smoke": False, "batch": {k: v.numpy() for k, v in batch.items()}}


def phase_dryrun(torch, args, dev, report):
    """Phase 15: (a) ``dry_road_checks``; (b) the smoke Louvain shapes and
    (d) DimeNet's full graph on DRY_RANKS gloo ranks on the one card, in
    one launch, against world size 1; (c) ``dry_lm_checks``."""
    from repro_torch import ShardGroup
    from repro_torch.core import collectives, gnn_halo

    nums = {}
    t0 = time.perf_counter()
    dry_road_checks(torch, args, dev, report, nums)
    log("dryrun", f"(a) {time.perf_counter() - t0:.2f} s")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    smoke = dry_smoke_runs(torch, args.seed)
    dn = dry_dimenet_runs(torch, args)
    one = gnn_halo.gnn_rank_runs(ShardGroup.single(dev), [dn, dn])
    out = collectives.launch(dry_rank_runs, DRY_RANKS, smoke, dn,
                             backend="gloo",
                             devices=[str(dev)] * DRY_RANKS, timeout=300)
    wall = time.perf_counter() - t0
    dry_smoke_checks(torch, [o["louvain"] for o in out])

    def grads(run):
        return {k: torch.from_numpy(x) for k, x in run["grads"].items()}

    want, again = one["results"]
    # The float32 scatter-adds' atomics make one rank differ from itself
    # run to run: the floor of the per-tensor comparison.
    floor = grads_agree(grads(again), grads(want))
    for rank, o in enumerate(out):
        got = o["dimenet"]["results"][0]
        rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
        # Within 1e-4 of the largest gradient entry, the CPU test's bound
        # (``tests/_gnn_parity.assert_grads_close``).
        worst = grads_agree(grads(got), grads(want), per_tensor=False)
        per = grads_agree(grads(got), grads(want))
        require(rel <= 1e-5 and worst <= 1e-4,
                f"(d) DimeNet on {DRY_RANKS} ranks, rank {rank}: loss "
                f"{rel:.3e}, gradients {worst:.3e}")
        log("dryrun", f"(d) DimeNet full_graph_sm at full width, rank "
            f"{rank}: loss {got['loss']:.8f} against {want['loss']:.8f} "
            f"({rel:.3e}), gradients {worst:.3e} of the largest entry "
            f"({per:.3e} of each tensor's; one rank against itself "
            f"{floor:.3e}); {got['seconds']:.3f} s a step (one rank "
            f"{want['seconds']:.3f} s, {again['seconds']:.3f} s again); "
            f"wire bytes {got['wire_bytes']}")
    log("dryrun", f"(b)+(d) {wall:.2f} s with the rank starts (no "
        f"multi-GPU number)")

    t0 = time.perf_counter()
    dry_lm_checks(torch, dev, args, nums)
    log("dryrun", f"(c) {time.perf_counter() - t0:.2f} s")
    log("dryrun", "numbers " + json.dumps(nums, default=float))


def dry_rank_runs(group, smoke: list, dimenet_run: dict) -> dict:
    """The rank entry of phase 15's launch: (b)'s Louvain runs and (d)'s
    DimeNet run."""
    from repro_torch.configs.louvain_arch import louvain_rank_runs
    from repro_torch.core.gnn_halo import gnn_rank_runs
    return {"louvain": louvain_rank_runs(group, smoke),
            "dimenet": gnn_rank_runs(group, [dimenet_run])}


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
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of phases 10-13's graphs, features, "
                         "weights, tokens and batches")
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
                             state.pop("staged"))),
                         ("graph", lambda: phase_graph(torch, ops, args, dev,
                                                       report)),
                         ("geometric", lambda: phase_geometric(
                             torch, ops, args, dev, report)),
                         ("recsys", lambda: phase_recsys(
                             torch, ops, args, dev, report)),
                         ("lm", lambda: phase_lm(torch, args, dev, report)),
                         ("lm_sharded", lambda: phase_lm_sharded(
                             torch, args, dev, report)),
                         ("dryrun", lambda: phase_dryrun(
                             torch, args, dev, report))):
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
