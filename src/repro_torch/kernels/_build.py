"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source under ``repro_torch/csrc`` compiles on first use into its own
shared library with a plain C interface, under ``build/kernels`` at the root
of the checkout (listed in ``.gitignore``).  The file name carries a hash of
the source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source never loads a stale build; a finished build is renamed into place
atomically, so concurrent processes can build the same library safely.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Iterable

import torch

from repro_torch.compat import nvcc_path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

#: One shared library per source.
SOURCES = {"louvain_scan": "louvain_scan.cu", "coarsen": "coarsen.cu",
           "batch_apply": "batch_apply.cu"}

#: ``--fmad=false`` is part of the kernels' exactness contract (see the
#: sources); ``--use_fast_math`` must never be added.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
_entries: Dict[str, Callable[..., int]] = {}


def library_path(name: str) -> Path:
    src = (CSRC_DIR / SOURCES[name]).read_bytes()
    # The shared headers are part of every source's build.
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        src += header.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, str]:
    """Compile the named kernels, one nvcc process per source, all started
    together.  Returns each kernel's compiler output (``-Xptxas -v``), or
    ``"cached"`` when its library was already built; raises on a failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    logs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            logs[name] = "cached"
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / SOURCES[name])]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    failed = []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source ``name``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
        return lib


def entry(name: str, symbol: str, argtypes) -> Callable[..., int]:
    """The C entry point ``symbol`` of kernel source ``name``, bound once:
    ``argtypes`` set, returning its ``cudaGetLastError()`` code."""
    fn = _entries.get(symbol)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _entries[symbol] = fn
    return fn


def current_stream_handle(device) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream


def check(err: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
