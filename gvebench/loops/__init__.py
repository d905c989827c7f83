"""The general loops that traffic mixes parameterise, one module per
``loop`` named in a mix's file.  A loop module exposes ``Loop(system, n,
us, ud, traffic, seed, device)``, whose construction is the set-up
(warm-up included), and the methods ``window(seconds, span)``,
``end_to_end()``, ``record()``, ``release()`` and ``check(params)``.

``check`` returns ``(attempted, failed, checks, extra)``: ``checks`` maps
a short name to ``(number, limit)``, each number compared with its limit
(the run is correct when none exceeds it); ``extra`` holds end-to-end
metrics that the reference computes, such as float64 modularity.
"""

import time

import torch

now = time.perf_counter


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def host(x: torch.Tensor) -> torch.Tensor:
    """A copy in host memory, so the benchmark's own data stays out of the
    device's memory peak during the window."""
    return x.to("cpu", copy=True)
