"""Ranks and collectives of the sharded paths: ``torch.distributed`` in
place of the reference's ``shard_map`` with ``jax.lax.psum`` / ``pmax`` /
``all_gather`` / ``all_to_all`` / ``axis_index``.

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

A ``RankGrid`` lays a group's ranks out as a mesh over named axes
(``("data", "model")`` for the LM layouts) and hands out a ``ShardGroup``
per axis, over the dp axes and over the whole grid.  Beside the
differentiable ``AllGather`` / ``ReduceScatter`` / ``AllSum`` are
Megatron's two conjugate operators, ``CopyToRanks`` (identity forward,
sum backward) and ``SumFromRanks`` (sum forward, identity backward).

``launch`` runs a function on ``world`` spawned ranks, initialised through
a ``file://`` store in a temporary directory (no network), each under a
hard timeout; any rank's failure is an error, never a partial result.
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
import math
import os
import pickle
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

    def all_gather(self, x: torch.Tensor, tiled: bool = True,
                   dim: int = 0) -> torch.Tensor:
        """Every rank's ``x`` in rank order: concatenated along ``dim``
        (``tiled``) or stacked on a new leading axis."""
        self.wire_bytes += x.numel() * x.element_size()
        if self.group is None:
            return x if tiled else x[None]
        self.collectives += 1
        wire = self._to_wire(x)
        parts = [torch.empty_like(wire) for _ in range(self.world_size)]
        dist.all_gather(parts, wire, group=self.group)
        out = torch.cat(parts, dim) if tiled else torch.stack(parts)
        del parts
        return self._from_wire(out, x)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` cut along dim 0 into ``world_size`` equal blocks, block p
        sent to rank p; returns the received blocks in rank order (block q
        from rank q), the reference's tiled ``all_to_all`` with
        ``split_axis = concat_axis = 0``.  Gloo moves the bytes (any
        type)."""
        self.wire_bytes += x.numel() * x.element_size()
        if self.group is None:
            return x
        if x.shape[0] % self.world_size:
            raise ValueError(f"all_to_all: {x.shape[0]} rows do not split "
                             f"over {self.world_size} ranks")
        self.collectives += 1
        raw = x.contiguous()
        if self.backend == "gloo":
            raw = raw.view(torch.uint8)
        wire = self._to_wire(raw)
        out = torch.empty_like(wire)
        dist.all_to_all_single(out, wire, group=self.group)
        out = self._from_wire(out, raw)
        return out.view(x.dtype) if self.backend == "gloo" else out

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

    def reduce_scatter(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's part of the sum over ranks: ``x`` cut along ``dim``
        into ``world_size`` equal parts, part r of every rank sent to rank
        r (one ``all_to_all``) and added there in rank order in float64,
        rounding once (integers in int64, exact).  The bits are
        ``psum(x)``'s part r, for a ``1 / world_size`` of its traffic."""
        if self.group is None:
            self.wire_bytes += x.numel() * x.element_size()
            return x
        moved = x.movedim(dim, 0).contiguous()
        parts = self.all_to_all(moved).unflatten(
            0, (self.world_size, moved.shape[0] // self.world_size))
        wide = torch.float64 if x.is_floating_point() else torch.int64
        acc = parts[0].to(wide)
        for r in range(1, self.world_size):
            acc = acc + parts[r].to(wide)
        return acc.to(x.dtype).movedim(0, dim).contiguous()

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """The maximum over ranks."""
        return self._all_reduce(x, dist.ReduceOp.MAX)


# ---------------------------------------------------------------------------
# Differentiable collectives: the backward of each is its adjoint.
# ---------------------------------------------------------------------------

class AllGather(torch.autograd.Function):
    """Owned rows -> every row (dim 0, or ``dim``, rank order); backward:
    summed over ranks, owned rows.  ``AllGather.apply(x, group[, dim])``."""

    @staticmethod
    def forward(ctx, x, group, dim=0):
        ctx.group, ctx.dim = group, dim
        return group.all_gather(x, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.reduce_scatter(grad, ctx.dim), None, None


class ReduceScatter(torch.autograd.Function):
    """Every row's partial sums -> the owned rows' sums (dim 0 split in rank
    order, ``ShardGroup.reduce_scatter``); backward: the owned rows'
    gradients gathered."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.reduce_scatter(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.all_gather(grad.contiguous()), None


class AllSum(torch.autograd.Function):
    """The sum over ranks; backward: the gradients summed over ranks."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.psum(x.contiguous())

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.psum(grad.contiguous()), None


class CopyToRanks(torch.autograd.Function):
    """Megatron's ``f``, placed before a column-parallel product: the
    identity; backward: the gradients summed over ranks.  Each rank's
    product reads the same (replicated) input, and the input's gradient is
    the sum of the ranks' partials."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.psum(grad.contiguous()), None


class SumFromRanks(torch.autograd.Function):
    """Megatron's ``g``, placed after a row-parallel product: the sum over
    ranks; backward: the identity.  The sum is replicated, so each rank's
    gradient of it is already the whole gradient of its partial."""

    @staticmethod
    def forward(ctx, x, group):
        return group.psum(x.contiguous())

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class AllGatherReplicated(torch.autograd.Function):
    """Owned rows -> every row (``dim``, rank order), for a consumer that
    computes the same thing on every rank; backward: the owned rows of the
    (replicated) gradient, not summed."""

    @staticmethod
    def forward(ctx, x, group, dim=0):
        ctx.group, ctx.dim = group, dim
        return group.all_gather(x, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        g, dim = ctx.group, ctx.dim
        part = grad.shape[dim] // g.world_size
        return grad.narrow(dim, g.rank * part, part).contiguous(), None, None


def all_gather_dim(x: torch.Tensor, dim: int, group: ShardGroup,
                   backward: str = "sum") -> torch.Tensor:
    """Every rank's ``x`` concatenated in rank order along ``dim``, laid
    out contiguously (a product reading it then takes the path it takes on
    one rank).  Its gradient is ``AllGather``'s (``backward="sum"``: the
    ranks consume the gathered tensor differently) or
    ``AllGatherReplicated``'s (``"own"``)."""
    if group.world_size == 1 and group.group is None:
        return x
    op = {"sum": AllGather, "own": AllGatherReplicated}[backward]
    return op.apply(x.contiguous(), group, dim % x.dim())


# ---------------------------------------------------------------------------
# A grid of ranks.
# ---------------------------------------------------------------------------

class RankGrid:
    """The ranks of a ``ShardGroup`` laid out as a mesh over named axes,
    ``("data", "model")`` or ``("pod", "data", "model")`` (the reference's
    ``launch/mesh.py``): rank ``mesh_rank(coords, shape)``.

    ``shape`` maps each axis name to its size and ``axis_names`` orders
    them, as a JAX ``Mesh`` does, so the split rules read a grid or a mesh
    alike.  ``coords`` is this rank's coordinate on each axis.  ``sub(axes)``
    is the ``ShardGroup`` of the ranks that share this rank's coordinates on
    every other axis, ranked row-major over ``axes``: one for each axis,
    ``dp`` over the data-parallel axes (all but ``model``), ``model``, and
    the whole grid.  The process groups are made with ``dist.new_group`` in
    the same order on every rank; a subgroup of one rank has no process
    group (its collectives are the identity) and one that spans the world
    reuses the parent's.  At ``ShardGroup.single`` every subgroup is
    single.
    """

    def __init__(self, group: ShardGroup, shape: Sequence[int],
                 axis_names: Sequence[str] = ("data", "model")):
        axis_names = tuple(axis_names)
        if len(axis_names) != len(shape) or "model" not in axis_names:
            raise ValueError(f"a grid needs one size per axis and a 'model' "
                             f"axis; got {tuple(shape)} over {axis_names}")
        if math.prod(shape) != group.world_size:
            raise ValueError(
                f"a grid {tuple(shape)} over {axis_names} holds "
                f"{math.prod(shape)} ranks; the group has {group.world_size}")
        self.group = group
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, (int(n) for n in shape)))
        coords, r = [], group.rank
        for n in reversed(tuple(shape)):
            coords.append(r % n)
            r //= n
        self.coords = dict(zip(axis_names, reversed(coords)))
        self._subs = {}
        wanted = [(a,) for a in axis_names] + [self.dp_axes, axis_names]
        for axes in wanted:
            if axes not in self._subs:
                self._subs[axes] = self._make_sub(axes)

    @classmethod
    def single(cls, device="cuda") -> "RankGrid":
        """A 1 x 1 ``("data", "model")`` grid over ``ShardGroup.single``."""
        return cls(ShardGroup.single(device), (1, 1))

    @property
    def dp_axes(self) -> tuple:
        return tuple(a for a in self.axis_names if a != "model")

    @property
    def device(self) -> torch.device:
        return self.group.device

    def _make_sub(self, axes: tuple) -> ShardGroup:
        g = self.group
        sizes = [self.shape[a] for a in axes]
        size = math.prod(sizes)
        sub_rank = mesh_rank([self.coords[a] for a in axes], sizes)
        if size == g.world_size:
            return ShardGroup(sub_rank, size, g.device, g.backend, g.group)
        others = [a for a in self.axis_names if a not in axes]
        mine = None
        if size > 1:
            # Every rank makes every group, in one order.
            full = [self.shape[a] for a in self.axis_names]
            for fixed in itertools.product(
                    *(range(self.shape[a]) for a in others)):
                at = dict(zip(others, fixed))
                ranks = []
                for pt in itertools.product(*map(range, sizes)):
                    at.update(zip(axes, pt))
                    ranks.append(mesh_rank(
                        [at[a] for a in self.axis_names], full))
                pg = dist.new_group(ranks)
                if g.rank in ranks:
                    mine = pg
        backend = g.backend if mine is not None else "single"
        return ShardGroup(sub_rank, size, g.device, backend, mine)

    def sub(self, axes: Sequence[str]) -> ShardGroup:
        """The subgroup over ``axes`` (in grid order)."""
        key = tuple(a for a in self.axis_names if a in tuple(axes))
        if key not in self._subs:
            raise KeyError(f"no subgroup over {tuple(axes)}; have "
                           f"{sorted(self._subs)}")
        return self._subs[key]

    @property
    def model(self) -> ShardGroup:
        return self.sub(("model",))

    @property
    def dp(self) -> ShardGroup:
        return self.sub(self.dp_axes)

    @property
    def everyone(self) -> ShardGroup:
        return self.sub(self.axis_names)

    def stats(self) -> dict:
        """``staged_bytes``, ``collectives`` and ``wire_bytes`` summed over
        the parent group and every subgroup (each counts its own)."""
        groups = [self.group] + [s for s in self._subs.values()
                                 if s is not self.group]
        return {k: sum(getattr(s, k) for s in groups)
                for k in ("staged_bytes", "collectives", "wire_bytes")}



# ---------------------------------------------------------------------------
# Launcher.
# ---------------------------------------------------------------------------

def _rank_main(payload, rank, world_size, backend, init_method, device,
               timeout, results):
    group = None
    try:
        with open(payload, "rb") as f:
            fn, args = pickle.load(f)
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
    # ``fn`` and ``args`` go through a file, not the spawn pipe: a child
    # reads the pipe only after importing the parent's main module, so a
    # pipe over its buffer's size would start the ranks one at a time.
    payload = os.path.join(tmp, "payload.pkl")
    with open(payload, "wb") as f:
        pickle.dump((fn, args), f, protocol=pickle.HIGHEST_PROTOCOL)
    results = ctx.Queue()
    procs = []
    try:
        for r in range(world_size):
            dev = None if devices is None else devices[r]
            p = ctx.Process(target=_rank_main,
                            args=(payload, r, world_size, backend,
                                  init_method, dev, timeout, results),
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
