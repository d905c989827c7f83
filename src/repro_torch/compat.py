"""Version and capability probing of the PyTorch port (``repro.compat``).

The reference's shims paper over JAX API skew (mesh construction,
``lax.axis_size``).  The port's counterparts:

  * ``make_mesh(axis_shapes, axis_names, group=None)``: a
    ``collectives.RankGrid`` over ``group``, or, with no group, over a dry
    group of ``prod(axis_shapes)`` ranks seen from rank 0 (the dry run's
    production meshes, ``launch/mesh.py``);
  * ``axis_size(grid, axis)``: the size of a named axis;
  * ``capabilities()``: what this installation offers of what the port
    relies on: a Hopper card (compute capability 9.0, for ``sm_90a``),
    bf16 on it, ``nvcc`` (``nvcc_path``), and
    ``torch.utils.flop_counter``;
  * ``is_dry(x)``: whether a tensor holds no data (a ``meta`` tensor of
    the dry run, or a ``FakeTensor``), so an operator whose output size
    depends on the data takes its bound.

Keep the probing here: call sites ask this module, not ``torch``.
"""

from __future__ import annotations

import math
import os
import shutil
from typing import Optional, Sequence

import torch


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str],
              group=None):
    """A ``RankGrid`` of ``axis_shapes`` over ``axis_names``: over
    ``group`` (a ``ShardGroup`` of ``prod(axis_shapes)`` ranks), or over
    ``ShardGroup.dry(0, prod(axis_shapes))`` when none is given."""
    from repro_torch.core.collectives import RankGrid, ShardGroup

    axis_shapes = tuple(int(n) for n in axis_shapes)
    if group is None:
        group = ShardGroup.dry(0, math.prod(axis_shapes))
    return RankGrid(group, axis_shapes, tuple(axis_names))


def axis_size(grid, axis: str) -> int:
    """The size of the named axis of a ``RankGrid``."""
    return grid.shape[axis]


def is_dry(x) -> bool:
    """Whether ``x`` is a tensor without data: a ``FakeTensor`` or on the
    ``meta`` device."""
    if not isinstance(x, torch.Tensor):
        return False
    from torch._subclasses.fake_tensor import is_fake
    return x.device.type == "meta" or is_fake(x)


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under PyTorch's
    CUDA_HOME; raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (nvcc on PATH or CUDA_HOME set)")


def _has_nvcc() -> bool:
    try:
        nvcc_path()
    except RuntimeError:
        return False
    return True


def has_flop_counter() -> bool:
    """Whether ``torch.utils.flop_counter.FlopCounterMode`` exists (the
    dry run's FLOP count)."""
    try:
        from torch.utils.flop_counter import FlopCounterMode  # noqa: F401
    except ImportError:
        return False
    return True


def capabilities(device: Optional[int] = None) -> dict:
    """What this installation offers the port: ``torch`` and its CUDA
    version, whether a card is present, its name and compute capability,
    whether that is Hopper's 9.0 (the kernels build for ``sm_90a``),
    whether it runs bf16, whether ``nvcc`` is found, and whether
    ``FlopCounterMode`` exists.  Reads the card ``device`` (default: the
    current one) without allocating on it."""
    cuda = torch.cuda.is_available()
    out = {"torch": torch.__version__, "cuda": torch.version.cuda,
           "card": cuda, "name": None, "capability": None,
           "sm_90a": False, "bf16": False, "nvcc": _has_nvcc(),
           "flop_counter": has_flop_counter()}
    if cuda:
        dev = torch.cuda.current_device() if device is None else device
        cap = torch.cuda.get_device_capability(dev)
        out.update(name=torch.cuda.get_device_name(dev), capability=cap,
                   sm_90a=cap == (9, 0),
                   bf16=bool(torch.cuda.is_bf16_supported()))
    return out
