"""Roofline bookkeeping over a dry run's trace (``repro.launch.analysis``).

Terms (per rank; one H100 SXM at its 700 W limit, NVIDIA's data sheet):
    compute    = FLOPs_per_rank       / peak FLOP/s
    memory     = bytes_per_rank       / HBM bandwidth
    collective = coll_bytes_per_rank  / link bandwidth

The reference reads these from XLA: ``cost_dict`` normalises
``compiled.cost_analysis()``, ``roofline_from_compiled`` adds the collective
bytes that ``collective_bytes`` parses out of the optimised HLO text, and
``memory_stats`` reads ``compiled.memory_analysis()``.  PyTorch compiles no
HLO and has no cost analysis, so those three have no counterpart here.
Their place is taken by one eager run of the step on ``meta`` tensors over
a dry group (``collectives.ShardGroup.dry``), recorded by ``trace``:

  * FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` (matrix products,
    convolutions and attention; elementwise work counts 0, as it does in
    the reference's useful-FLOPs model);
  * bytes touched: every operator's tensor inputs and outputs, each once
    (``OpRecorder``; views and uninitialised allocations move nothing);
  * collective bytes by kind: the output bytes of each collective the dry
    group issued, the reference's definition (``ShardGroup.coll_bytes``);
  * memory: the argument bytes (the rank's parameter, optimizer-state and
    batch shares), the output bytes, and the high-water mark of the bytes
    the step allocated, each storage counted from the operator that made
    it to the release of its last tensor.

``roofline_from_trace`` and ``memory_stats`` read that record.  Every
number is a model from the shapes, not a measurement.
"""

from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.core.collectives import COLLECTIVE_KINDS

# ---- H100 SXM constants (per card, 700 W) ----------------------------------
PEAK_FLOPS = 989e12          # bf16 dense FLOP/s
HBM_BW = 3.35e12             # bytes/s
LINK_BW = 450e9              # bytes/s each way (NVLink 4: 900 GB/s both)

#: The reference's collective kinds.
_COLLECTIVES = COLLECTIVE_KINDS


@dataclasses.dataclass
class Roofline:
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: float
    coll_by_kind: Dict[str, int]

    @property
    def t_compute(self) -> float:
        return self.flops_per_chip / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_per_chip / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_chip / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    def as_dict(self) -> dict:
        return {
            "flops_per_chip": self.flops_per_chip,
            "bytes_per_chip": self.bytes_per_chip,
            "coll_bytes_per_chip": self.coll_bytes_per_chip,
            "coll_by_kind": self.coll_by_kind,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
        }


# ---------------------------------------------------------------------------
# The trace of one step.
# ---------------------------------------------------------------------------

def tensor_bytes(tree) -> int:
    """Bytes of every tensor in a nested structure, each storage once (a
    view of a counted storage adds nothing)."""
    seen, total = set(), 0
    for x in tree_flatten(tree)[0]:
        if isinstance(x, torch.Tensor):
            key = _storage_key(x)
            if key not in seen:
                seen.add(key)
                total += x.numel() * x.element_size()
    return total


def _storage_key(x: torch.Tensor):
    try:
        return x.untyped_storage()._cdata
    except (RuntimeError, NotImplementedError):
        return id(x)


_UNTOUCHED = ("empty", "empty_like", "new_empty", "empty_strided",
              "new_empty_strided", "lift_fresh", "detach", "alias")


def _meta_cumsum(x: torch.Tensor, dim: int, dtype=None) -> torch.Tensor:
    """``cumsum``'s output on a meta tensor.  PyTorch's meta kernel for it
    broadcasts an (n, n) mask, whose element count overflows int64 past
    ~3e9 elements (an sk-2005 edge list on one rank)."""
    if dtype is None:
        dtype = (x.dtype if x.is_floating_point() or x.is_complex()
                 else torch.int64)
    return torch.empty(x.shape, dtype=dtype, device=x.device)


class OpRecorder(TorchDispatchMode):
    """Counts, for every operator dispatched under it, the bytes of its
    tensor inputs and outputs (``bytes``; views and uninitialised
    allocations excluded), and follows the storages its outputs allocate:
    ``live`` bytes now and their high-water mark ``peak``.  A storage
    counts from the operator that made it until its last tensor seen here
    is released."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0
        self.live = 0
        self.peak = 0
        self._refs: Dict[int, list] = {}
        self._known = set()

    def know(self, tree) -> None:
        """Storages of tensors made before the trace (the arguments): not
        counted as allocations of the step."""
        for x in tree_flatten(tree)[0]:
            if isinstance(x, torch.Tensor):
                self._known.add(_storage_key(x))

    def _release(self, key: int, nbytes: int) -> None:
        refs = self._refs.get(key)
        if refs is None:
            return
        refs[0] -= 1
        if refs[0] == 0:
            del self._refs[key]
            self.live -= nbytes

    def _track(self, out: torch.Tensor) -> None:
        key = _storage_key(out)
        if key in self._known:
            return
        refs = self._refs.get(key)
        if refs is None:
            nbytes = out.untyped_storage().nbytes()
            refs = self._refs[key] = [0, nbytes]
            self.live += nbytes
            self.peak = max(self.peak, self.live)
        refs[0] += 1
        weakref.finalize(out, self._release, key, refs[1])

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if (func is torch.ops.aten.cumsum.default
                and args[0].device.type == "meta"):
            out = _meta_cumsum(*args, **kwargs)
        else:
            out = func(*args, **kwargs)
        self.ops += 1
        name = func.overloadpacket.__name__
        outs = [x for x in tree_flatten(out)[0]
                if isinstance(x, torch.Tensor)]
        if not func.is_view and name not in _UNTOUCHED:
            ins = [x for x in tree_flatten((args, kwargs))[0]
                   if isinstance(x, torch.Tensor)]
            self.bytes += sum(x.numel() * x.element_size()
                              for x in ins + outs)
        for x in outs:
            self._track(x)
        return out


def _coll_stats(grid) -> Dict[str, int]:
    """Collective output bytes by kind issued so far by a ``RankGrid``'s
    groups (``stats``) or by one ``ShardGroup``."""
    if hasattr(grid, "stats"):
        return dict(grid.stats()["coll_bytes"])
    return dict(grid.coll_bytes)


def trace(fn: Callable, args: tuple, grid, arg_bytes: Optional[int] = None
          ) -> dict:
    """Run ``fn(*args)`` once under the counters and return its record:
    ``flops``, ``bytes``, ``ops``, ``coll`` (bytes by kind issued by the
    groups of ``grid`` during the run), ``arg_bytes`` (default: every
    tensor of ``args``, each storage once), ``out_bytes``, ``temp_peak``
    (the high-water mark of the storages the run allocated) and
    ``seconds``."""
    from torch.utils.flop_counter import FlopCounterMode

    before = _coll_stats(grid)
    rec = OpRecorder()
    rec.know(args)
    flops = FlopCounterMode(display=False)
    t0 = time.perf_counter()
    with flops, rec:
        out = fn(*args)
    seconds = time.perf_counter() - t0
    after = _coll_stats(grid)
    return {"flops": float(flops.get_total_flops()),
            "bytes": float(rec.bytes), "ops": rec.ops,
            "coll": {k: after[k] - before[k] for k in _COLLECTIVES},
            "arg_bytes": int(tensor_bytes(args) if arg_bytes is None
                             else arg_bytes),
            "out_bytes": int(tensor_bytes(out)),
            "temp_peak": int(rec.peak), "seconds": seconds}


def roofline_from_trace(record: dict) -> Roofline:
    """The three roofline terms of one rank from a ``trace`` record."""
    coll = dict(record["coll"])
    return Roofline(flops_per_chip=float(record["flops"]),
                    bytes_per_chip=float(record["bytes"]),
                    coll_bytes_per_chip=float(sum(coll.values())),
                    coll_by_kind=coll)


def memory_stats(record: dict) -> dict:
    """Per-rank memory of a ``trace`` record under the reference's keys:
    arguments, outputs, the step's own allocations at their high-water
    mark (``temp``), and ``peak`` = arguments + that mark."""
    return {"argument_size_in_bytes": int(record["arg_bytes"]),
            "output_size_in_bytes": int(record["out_bytes"]),
            "temp_size_in_bytes": int(record["temp_peak"]),
            "peak_memory_in_bytes": int(record["arg_bytes"]
                                        + record["temp_peak"])}


# ---------------------------------------------------------------------------
# Analytic MODEL_FLOPS (the "useful work" numerator for the waste ratio).
# ---------------------------------------------------------------------------

def lm_model_flops(cfg, shape_name: str, n_tokens: int, kind: str) -> float:
    """6·N_active·D for training, 2·N_active·D for inference steps."""
    n_active = cfg.active_param_count()
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_active * n_tokens


def model_flops(arch, shape: str, smoke: bool = False) -> Optional[float]:
    """Analytic useful FLOPs a step for any registered arch, the
    reference's arithmetic number for number (None for the Louvain
    phases, as there)."""
    fam = getattr(arch, "family", "lm")
    if fam == "lm":
        from repro_torch.configs.lm_common import LM_SHAPES
        seq, batch, kind = LM_SHAPES[shape]
        cfg = arch.smoke_config() if smoke else arch.full_config()
        n_tok = batch * (1 if kind == "decode" else seq)
        return lm_model_flops(cfg, shape, n_tok, kind)
    if fam == "recsys":
        from repro_torch.configs.fm import FM_SHAPES, N_CANDIDATES
        batch, kind = FM_SHAPES[shape]
        cfg = arch.smoke_config() if smoke else arch.full_config()
        k, f = cfg.embed_dim, cfg.n_fields
        if kind == "retrieval":
            n_cand = 1024 if smoke else N_CANDIDATES
            return 2.0 * n_cand * k
        fwd = 4.0 * batch * f * k          # sum-square trick: 2 passes
        return (3.0 * fwd) if kind == "train" else fwd
    if fam == "gnn":
        from repro_torch.configs.gnn_common import (GNN_SHAPES,
                                                    GNN_SMOKE_SHAPES,
                                                    triplet_cap)
        sh = (GNN_SMOKE_SHAPES if smoke else GNN_SHAPES)[shape]
        cfg = arch.make_config(sh, smoke)
        b = sh.batch if sh.kind != "full" else 1
        n, e, d = sh.n_nodes, sh.n_edges, getattr(cfg, "d_hidden", 64)
        L = (getattr(cfg, "n_layers", None) or getattr(cfg, "n_blocks", 4))
        # per layer: node transform 2·N·d_in·d_out + edge gather/scatter
        node_flops = 2.0 * n * (sh.d_feat * d + (L - 1) * d * d) / max(L, 1)
        per_layer = node_flops + 2.0 * e * d
        if arch.arch_id == "dimenet":
            t = triplet_cap(shape, sh)
            per_layer += 2.0 * t * cfg.n_bilinear * d * 2   # bilinear
        if arch.arch_id == "equiformer-v2":
            n_coef = (cfg.l_max + 1) ** 2
            per_layer += 2.0 * e * n_coef * d * 4     # rotate+conv+rotate
        return 3.0 * b * L * per_layer                # train: fwd+bwd
    return None
