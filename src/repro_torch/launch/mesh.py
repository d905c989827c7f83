"""Production grids of ranks (``repro.launch.mesh``).

Functions, not module constants, so importing this module touches no
device.  The reference's production topology (TPU v5e) is kept as the dry
run's:
  single-pod:  16 x 16 = 256 ranks,      axes (data, model)
  multi-pod:    2 x 16 x 16 = 512 ranks, axes (pod, data, model)
Those grids are dry (``ShardGroup.dry``): seen from rank 0, with no process
group, for ``launch/dryrun.py``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.compat import make_mesh


def make_production_mesh(*, multi_pod: bool = False):
    """The dry ``RankGrid`` of the production topology, seen from rank 0."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_host_mesh(group=None):
    """The local CUDA devices as a grid ``(n, 1)`` over ``("data",
    "model")``: the reference's 1-D ``("data",)`` host mesh with a
    ``model`` axis of size 1, which a ``RankGrid`` needs.  The port runs
    one process per card, so ``n`` is the world of ``group`` (default: the
    process group this process has joined, as rank r on ``cuda:r``, or one
    card without a process group)."""
    from repro_torch.core.collectives import ShardGroup

    if group is None:
        if dist.is_initialized():
            rank, world = dist.get_rank(), dist.get_world_size()
            group = ShardGroup(rank, world, torch.device(f"cuda:{rank}"),
                               dist.get_backend(), dist.group.WORLD)
        else:
            group = ShardGroup.single("cuda")
    return make_mesh((group.world_size, 1), ("data", "model"), group)
