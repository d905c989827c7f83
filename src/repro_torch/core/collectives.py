"""Ranks and collectives of the sharded paths: ``torch.distributed`` in
place of the reference's ``shard_map`` with ``jax.lax.psum`` / ``pmax`` /
``all_gather`` / ``axis_index``.

A ``ShardGroup`` is one rank's view: its rank, the world size, its device,
the backend and the process group.  The reference flattens its mesh axes
into one vertex axis (``repro.core.distributed._shard_index``): a mesh
``(2, 4)`` over ``("data", "model")`` is world size 8 with rank ``data * 4 +
model`` (``mesh_rank``).

The backend is the caller's choice and is never changed behind its back:

  * ``"nccl"``: one rank per GPU, rank r on ``cuda:r``.  Two ranks on one
    device are refused (NCCL cannot run them);
  * ``"gloo"``: CPU ranks, or several ranks on one card.  Gloo cannot
    gather CUDA tensors, so on a CUDA device each collective copies its
    operand to pinned host memory and back; the rank counts those bytes in
    ``staged_bytes``.  Its wall time is no multi-GPU number;
  * ``"single"``: one rank and no process group (``ShardGroup.single``);
    every collective is the identity.  A process group of world size 1
    (NCCL on the one card) still runs each collective through it.

Float sums across ranks (``psum`` of a float tensor) gather the partials
and add them in rank order in float64, rounding once, so every rank gets
the same bits whatever order the backend reduces in.  Integer sums and
maxima go through ``all_reduce``, which is exact in any order.

``launch`` runs a function on ``world`` spawned ranks, initialised through
a ``file://`` store in a temporary directory (no network), each under a
hard timeout; any rank's failure is an error, never a partial result.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.core.graph import resolve_device

class RankFailure(RuntimeError):
    """A spawned rank raised, died or ran past its timeout."""


def mesh_rank(coords: Sequence[int], shape: Sequence[int]) -> int:
    """The flat rank of mesh coordinates, the reference's ``_shard_index``:
    row-major over the axes, ``(data, model)`` in a ``(D, M)`` mesh ->
    ``data * M + model``."""
    rank = 0
    for c, n in zip(coords, shape):
        if not 0 <= c < n:
            raise ValueError(f"mesh coordinate {c} outside [0, {n})")
        rank = rank * n + int(c)
    return rank


def _default_device(backend: str, rank: int) -> torch.device:
    if backend == "nccl":
        return torch.device(f"cuda:{rank}")
    resolve_device("cuda")     # raises without a card
    return torch.device(f"cuda:{rank % torch.cuda.device_count()}")


@dataclasses.dataclass
class ShardGroup:
    """One rank of the sharded driver: ``rank`` of ``world_size`` on
    ``device``, over ``backend`` (see the module docstring)."""

    rank: int
    world_size: int
    device: torch.device
    backend: str
    group: Any = None
    #: Bytes this rank copied between the card and pinned host memory for
    #: gloo collectives on CUDA tensors (both directions).
    staged_bytes: int = 0
    #: Collectives this rank issued.
    collectives: int = 0
    #: Host reads of replicated values that chose a branch (the delta
    #: exchange's overflow test, one per round).
    branch_reads: int = 0
    #: Bytes this rank handed to the collectives (each operand once, as it
    #: goes on the wire; counted at world size 1 too, where a collective is
    #: the identity).  The sharded move phase reads its own share of it.
    wire_bytes: int = 0

    @classmethod
    def single(cls, device="cuda") -> "ShardGroup":
        """World size 1 without a process group, on ``device`` (the card
        unless the caller asks for the CPU)."""
        return cls(0, 1, resolve_device(device), "single")

    @classmethod
    def init(cls, backend: str, rank: int, world_size: int,
             init_method: str, device=None,
             timeout: float = 600.0) -> "ShardGroup":
        """Join the process group of ``world_size`` ranks as ``rank``.
        ``device`` defaults to ``cuda:rank`` under NCCL and to a card under
        gloo (``"cpu"`` must be asked for); it raises without a card."""
        if backend not in ("nccl", "gloo"):
            raise ValueError(f"backend must be 'nccl' or 'gloo'; "
                             f"got {backend!r}")
        dev = (_default_device(backend, rank) if device is None
               else resolve_device(device))
        if backend == "nccl":
            if dev.type != "cuda":
                raise ValueError("the NCCL backend needs a CUDA device per "
                                 "rank; use gloo for CPU ranks")
            if dev.index is None:
                dev = torch.device(f"cuda:{rank}")
            if world_size > torch.cuda.device_count():
                raise ValueError(
                    f"NCCL runs one rank per GPU: {world_size} ranks on "
                    f"{torch.cuda.device_count()} device(s); put several "
                    f"ranks on one card with backend='gloo'")
            if dev.index != rank % torch.cuda.device_count():
                raise ValueError(f"NCCL rank {rank} must run on cuda:{rank}, "
                                 f"not {dev}")
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=init_method, rank=rank,
            world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout))
        return cls(rank, world_size, dev, backend, dist.group.WORLD)

    def destroy(self) -> None:
        """Leave the process group (a no-op for ``single``)."""
        if self.group is not None and dist.is_initialized():
            dist.destroy_process_group()
        self.group = None

    def shard_index(self) -> int:
        """This rank's shard: the reference's ``_shard_index``."""
        return self.rank

    # -- collectives -------------------------------------------------------
    def _staged(self, x: torch.Tensor) -> bool:
        return self.backend == "gloo" and x.device.type == "cuda"

    def _to_wire(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        if x.dtype == torch.bool:
            x = x.view(torch.uint8)
        if self._staged(x):
            # Gloo reads host memory only: stage through pinned memory.
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            host.copy_(x)
            self.staged_bytes += host.numel() * host.element_size()
            return host
        return x

    def _from_wire(self, y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        if y.device != like.device:
            self.staged_bytes += y.numel() * y.element_size()
            y = y.to(like.device)
        return y.view(torch.bool) if like.dtype == torch.bool else y

    def all_gather(self, x: torch.Tensor, tiled: bool = True) -> torch.Tensor:
        """Every rank's ``x`` in rank order: concatenated along dim 0
        (``tiled``) or stacked on a new leading axis."""
        self.wire_bytes += x.numel() * x.element_size()
        if self.group is None:
            return x if tiled else x[None]
        self.collectives += 1
        wire = self._to_wire(x)
        parts = [torch.empty_like(wire) for _ in range(self.world_size)]
        dist.all_gather(parts, wire, group=self.group)
        out = torch.cat(parts) if tiled else torch.stack(parts)
        return self._from_wire(out, x)

    def _all_reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        self.wire_bytes += x.numel() * x.element_size()
        if self.group is None:
            return x
        self.collectives += 1
        wire = self._to_wire(x.clone())
        dist.all_reduce(wire, op=op, group=self.group)
        return self._from_wire(wire, x)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over ranks.  Integers: ``all_reduce``.  Floats: the
        gathered partials added in rank order in float64, rounded once to
        ``x``'s type, so every rank holds the same bits."""
        if not x.is_floating_point():
            return self._all_reduce(x, dist.ReduceOp.SUM)
        if self.group is None:
            self.wire_bytes += x.numel() * x.element_size()
            return x
        parts = self.all_gather(x, tiled=False)
        acc = parts[0].to(torch.float64)
        for r in range(1, self.world_size):
            acc = acc + parts[r].to(torch.float64)
        return acc.to(x.dtype)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """The maximum over ranks."""
        return self._all_reduce(x, dist.ReduceOp.MAX)


# ---------------------------------------------------------------------------
# Launcher.
# ---------------------------------------------------------------------------

def _rank_main(fn, rank, world_size, backend, init_method, device, args,
               timeout, results):
    group = None
    try:
        if device is not None and torch.device(device).type == "cpu":
            torch.set_num_threads(1)
        group = ShardGroup.init(backend, rank, world_size, init_method,
                                device=device, timeout=timeout)
        out = fn(group, *args)
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 — reported to the parent
        results.put((rank, False, traceback.format_exc()))
    finally:
        if group is not None:
            try:
                group.destroy()
            except Exception:  # noqa: BLE001 — the result is already out
                pass


def launch(fn: Callable, world_size: int, *args, backend: str = "gloo",
           devices: Optional[Sequence] = None,
           timeout: float = 600.0) -> List[Any]:
    """Run ``fn(group, *args)`` on ``world_size`` spawned ranks and return
    their results in rank order.

    ``fn`` and ``args`` must pickle (``fn`` a module-level function of an
    importable module: with ``spawn`` each rank imports it afresh, and the
    CUDA state of this process is not forked).  ``devices[r]`` is rank r's
    device (default: ``ShardGroup.init``'s).  The ranks meet through a
    ``file://`` store in a temporary directory.  Raises ``RankFailure`` if
    any rank raises, dies or is still running ``timeout`` seconds after
    the start; every rank is stopped before this returns or raises.
    """
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="shard-group-")
    init_method = "file://" + os.path.join(tmp, "store")
    results = ctx.Queue()
    procs = []
    try:
        for r in range(world_size):
            dev = None if devices is None else devices[r]
            p = ctx.Process(target=_rank_main,
                            args=(fn, r, world_size, backend, init_method,
                                  dev, args, timeout, results),
                            daemon=True)
            p.start()
            procs.append(p)
        deadline = time.monotonic() + timeout
        out: dict = {}
        while len(out) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                late = sorted(set(range(world_size)) - set(out))
                raise RankFailure(f"ranks {late} still running after "
                                  f"{timeout} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [i for i, p in enumerate(procs)
                        if not p.is_alive() and i not in out]
                if dead:
                    # A rank that died without reporting (killed, or a
                    # crash below Python); give its message a moment.
                    try:
                        rank, ok, value = results.get(timeout=2.0)
                    except queue.Empty:
                        raise RankFailure(
                            f"rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode} and no result")
                else:
                    continue
            if not ok:
                raise RankFailure(f"rank {rank} failed:\n{value}")
            out[rank] = value
        return [out[r] for r in range(world_size)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
