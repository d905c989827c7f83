"""Cold calls in a closed loop: one caller hands the resident graph to
``louvain()`` and waits for the membership on the host before it makes the
next call.  Every call does the whole work (singleton start, all passes),
so every call of a window must return one and the same membership: the
reference's.  The seed draws the order in which the edge list reaches the
program's graph build; the graph built, and so the work, is the same."""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from gvebench.gen import generator
from gvebench.loops import host, now, sync
from gvebench.reference import louvain as ref
from gvebench.reference.edges import EdgeSet
from gvebench.system import membership_of


def _digest(mem: np.ndarray) -> str:
    return hashlib.sha1(np.ascontiguousarray(mem, np.int32)).hexdigest()


class Loop:
    def __init__(self, system, n, us, ud, traffic, seed, device):
        self.system, self.n, self.device = system, n, device
        order = torch.randperm(us.shape[0], device=us.device,
                               generator=generator(seed, us.device))
        self.graph = system.build(n, us[order], ud[order])
        del order
        self.us, self.ud = host(us), host(ud)
        self.slots = system.slots(self.graph)
        # The warm-up: one whole call on the window's graph.
        t = now()
        system.louvain(self.graph)
        sync(device)
        self.setup_parts = {"warm_call_s": now() - t}

    def window(self, seconds: float, span) -> None:
        self.calls, self.digests, self.last = [], [], None
        t0 = now()
        while True:
            with span("gvebench.call"):
                res = self.system.louvain(self.graph)
                mem = membership_of(res)
            t = now()
            self.calls.append({
                "total_seconds": float(res.total_seconds),
                "passes": [{"iterations": int(p.iterations),
                            "local_move": float(p.phase_seconds["local_move"]),
                            "aggregate": float(p.phase_seconds["aggregate"]),
                            "e_cap": int(p.e_cap)} for p in res.passes]})
            self.digests.append(_digest(mem))
            self.last = mem
            if t - t0 >= seconds:
                break
        self.window_s = t - t0

    def end_to_end(self) -> dict:
        return {"edges_per_s": self.slots * len(self.calls) / self.window_s}

    def record(self) -> dict:
        return {"kind": "cold", "calls": self.calls}

    def release(self) -> None:
        del self.graph

    def check(self, params: ref.Params):
        dev = self.device
        g = EdgeSet.of_pairs(self.n, self.us.to(dev), self.ud.to(dev)).graph()
        want = ref.louvain(g, params)
        want_h = want.cpu().numpy().astype(np.int32)
        wrong = sum(d != _digest(want_h) for d in self.digests)
        off = (int(np.count_nonzero(self.last != want_h))
               if self.last.shape == want_h.shape else self.n)
        q = ref.modularity64(g, torch.from_numpy(self.last))
        checks = {"answers_wrong": (wrong, 0), "labels_off_last": (off, 0)}
        return len(self.calls), wrong, checks, {"modularity": q}
