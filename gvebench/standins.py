"""What the control runs put in the program's place (``control.py``): the
reference scoring Eq. 2 in a lower precision, and the program with one
fault planted.  Each keeps the calls of ``system.Program``."""

from types import SimpleNamespace

import numpy as np
import torch

from gvebench.loops import now
from gvebench.reference import louvain as ref
from gvebench.reference.edges import EdgeSet, frontier
from gvebench.system import Program


class ReferenceSystem:
    """The reference in the program's place, Eq. 2 in ``dq_dtype``."""

    def __init__(self, louvain_params: dict, device,
                 dq_dtype=torch.bfloat16):
        self.params = ref.Params.of(louvain_params)
        self.device, self.dq_dtype = torch.device(device), dq_dtype

    def build(self, n, us, ud, e_headroom=0):
        return EdgeSet.of_pairs(n, us.to(self.device), ud.to(self.device))

    def make_batch(self, u, v, w, n, b_cap):
        return tuple(torch.as_tensor(np.asarray(x)).to(self.device)
                     for x in (u, v, w))

    def louvain(self, graph):
        t = now()
        mem = ref.louvain(graph.graph(), self.params, dq_dtype=self.dq_dtype)
        return SimpleNamespace(membership=mem.cpu().numpy(), passes=[],
                               total_seconds=now() - t)

    def louvain_dynamic(self, graph, batch, prev, screening):
        t0 = now()
        new, touched = graph.apply(*batch)
        t1 = now()
        prev_t = torch.from_numpy(np.asarray(prev)).to(self.device)
        fr = frontier(touched, prev_t, graph.n, screening)
        mem = ref.louvain(new.graph(), self.params, prev=prev_t, frontier=fr,
                          dq_dtype=self.dq_dtype)
        stats = SimpleNamespace(batch_size=int(batch[0].shape[0]),
                                apply_seconds=t1 - t0,
                                update_seconds=now() - t1,
                                frontier_size=int(fr.sum()),
                                n_vertices=graph.n)
        return SimpleNamespace(graph=new, membership=mem.cpu().numpy(),
                               batch_stats=[stats])

    @staticmethod
    def slots(graph) -> int:
        return int(graph.graph().src.shape[0])

    @staticmethod
    def e_cap(graph) -> int:
        return graph.n          # no capacity: one value for every graph

    @staticmethod
    def directed(graph):
        return (graph.n, *graph.directed())


class Unchanged(Program):
    def louvain(self, graph):
        res = super().louvain(graph)
        res.membership = np.arange(graph.n_valid, dtype=np.int32)
        return res

    def louvain_dynamic(self, graph, batch, prev, screening):
        res = super().louvain_dynamic(graph, batch, prev, screening)
        res.graph, res.membership = graph, np.asarray(prev)
        return res


class HalfBatch(Program):
    def make_batch(self, u, v, w, n, b_cap):
        h = len(u) // 2
        return super().make_batch(u[:h], v[:h], w[:h], n, b_cap)


def _alter(mem) -> np.ndarray:
    mem = np.array(mem, dtype=np.int32)
    j = len(mem) // 3
    mem[j] = mem[j] + 1 if mem[j] + 1 < len(mem) else mem[j] - 1
    return mem


class Altered(Program):
    def louvain(self, graph):
        res = super().louvain(graph)
        res.membership = _alter(res.membership)
        return res

    def louvain_dynamic(self, graph, batch, prev, screening):
        res = super().louvain_dynamic(graph, batch, prev, screening)
        res.membership = _alter(res.membership)
        return res


STAND_INS = {"control": ReferenceSystem, "unchanged": Unchanged,
             "half_batch": HalfBatch, "altered": Altered}
