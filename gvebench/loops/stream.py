"""Edge batches in a closed loop: one caller keeps the graph resident,
hands ``louvain_dynamic()`` one batch with ``prev`` set to the membership
it last got back, and waits for the new membership on the host before it
sends the next batch.

The mix (the DF-Louvain batches: Sahu, arXiv 2404.19634): each batch has
``batch_frac * |E|`` entries (|E| undirected edges), ``insert_share`` of
them inserts of edges held out of the graph at set-up and the rest
deletions of edges in it, in an order shuffled from the seed.  Every
entry changes the graph: an edge is inserted or deleted once.  The inserts
of ``max_batches`` batches are held out, so the resident graph starts that
many edges short of the configuration's; the graph is built with
``e_headroom`` spare edge slots.  Set-up builds every batch, runs the cold
``louvain()`` that gives the first ``prev`` and streams the first batch,
which warms the window's path.
"""

from __future__ import annotations

import numpy as np
import torch

from gvebench.gen import generator
from gvebench.loops import host, now, sync
from gvebench.reference import louvain as ref
from gvebench.reference.edges import EdgeSet, frontier
from gvebench.system import membership_of

#: Batches whose answers the check replays besides the window's last.
SAMPLED = 2


class Loop:
    def __init__(self, system, n, us, ud, traffic, seed, device):
        self.system, self.n, self.device = system, n, device
        self.seed = int(seed)
        self.screening = traffic["screening"]
        n_und = int(us.shape[0])
        b = max(1, int(traffic["batch_frac"] * n_und))
        n_ins = int(b * traffic["insert_share"])
        n_del = b - n_ins
        self.max_batches = n_b = int(traffic["max_batches"])
        if n_b * b > n_und:
            raise ValueError(f"a stream of {n_b} batches of {b} entries "
                             f"needs more than the {n_und} edges")
        # A generator apart from the graph's, drawn from the same seed.
        gen = generator(int(seed) + 1, device)
        perm = torch.randperm(n_und, generator=gen, device=device)
        pool, dele = perm[:n_b * n_ins], perm[n_b * n_ins:n_b * b]
        keep = torch.ones(n_und, dtype=torch.bool, device=device)
        keep[pool] = False
        self.us, self.ud = host(us[keep]), host(ud[keep])
        self.graph = system.build(n, us[keep], ud[keep],
                                  int(traffic["e_headroom"]))
        ins_u, ins_v = us[pool].cpu().numpy(), ud[pool].cpu().numpy()
        del_u, del_v = (us[dele].cpu().numpy(), ud[dele].cpu().numpy())
        del perm, pool, dele, keep
        rng = np.random.default_rng(int(seed) % 2 ** 63)
        w = np.concatenate([np.ones(n_ins, np.float32),
                            np.zeros(n_del, np.float32)])
        t = now()
        self.entries, self.batches = [], []
        for i in range(n_b):
            u = np.concatenate([ins_u[i * n_ins:(i + 1) * n_ins],
                                del_u[i * n_del:(i + 1) * n_del]])
            v = np.concatenate([ins_v[i * n_ins:(i + 1) * n_ins],
                                del_v[i * n_del:(i + 1) * n_del]])
            p = rng.permutation(b)
            self.entries.append((u[p], v[p], w[p]))
            self.batches.append(system.make_batch(u[p], v[p], w[p], n, b))
        self.b = b
        sync(device)
        self.setup_parts = {"batches_s": now() - t}
        # The cold start that gives the first prev, and the first batch.
        t = now()
        self.cold = membership_of(system.louvain(self.graph))
        self.setup_parts["cold_s"] = now() - t
        t = now()
        res = system.louvain_dynamic(self.graph, self.batches[0], self.cold,
                                     self.screening)
        self.graph = res.graph
        self.memberships = [membership_of(res)]
        self.regrows = 0
        sync(device)
        self.setup_parts["first_batch_s"] = now() - t

    def window(self, seconds: float, span) -> None:
        self.stats, self.latency = [], []
        sys_, b = self.system, self.b
        t0 = now()
        while True:
            i = len(self.memberships)
            if i >= self.max_batches:
                raise RuntimeError(
                    f"the stream ran dry after {i} batches: the mix's "
                    f"max_batches is too small for this window")
            e_cap = sys_.e_cap(self.graph)
            with span("gvebench.batch"):
                t = now()
                res = sys_.louvain_dynamic(self.graph, self.batches[i],
                                           self.memberships[-1],
                                           self.screening)
                mem = membership_of(res)
                t_done = now()
            self.latency.append(t_done - t)
            st = res.batch_stats[0]
            grown = sys_.e_cap(res.graph)
            k4 = [e_cap + 2 * b]
            if grown != e_cap:
                self.regrows += 1
                k4.append(grown + 2 * b)
            self.stats.append({
                "batch_size": int(st.batch_size),
                "apply_seconds": float(st.apply_seconds),
                "update_seconds": float(st.update_seconds),
                "frontier_size": int(st.frontier_size),
                "n_vertices": int(st.n_vertices), "k4_slots": k4})
            self.graph = res.graph
            self.memberships.append(mem)
            if t_done - t0 >= seconds:
                break
        self.window_s = t_done - t0

    def end_to_end(self) -> dict:
        lat = np.asarray(self.latency)
        return {"updates_per_s": sum(s["batch_size"] for s in self.stats)
                / self.window_s,
                "batch_p90_ms": float(np.percentile(lat, 90)) * 1e3}

    def record(self) -> dict:
        return {"kind": "stream", "batches": self.stats,
                "regrows": self.regrows}

    def release(self) -> None:
        n, key, w = self.system.directed(self.graph)
        self.final = (n, host(key), host(w))
        del self.graph

    def check(self, params: ref.Params):
        """The final graph against the edge set the reference rebuilds from
        the batches; the cold start and a sample of the batches' answers
        (drawn from the seed, the window's last among them) against the
        reference's step from the program's previous answer."""
        dev, n = self.device, self.n
        done = len(self.memberships)         # batches streamed, warm-up's too
        last = done - 1
        first = done - len(self.stats)
        rng = np.random.default_rng(self.seed % 2 ** 63)
        pool = np.arange(first, last)
        sample = set(rng.choice(pool, min(SAMPLED, len(pool)),
                                replace=False).tolist()) | {last}
        state = EdgeSet.of_pairs(n, self.us.to(dev), self.ud.to(dev))
        want = ref.louvain(state.graph(), params).cpu().numpy()
        off_cold = _off(self.cold, want)
        off, wrong = 0, 0
        for i in range(done):
            prev = self.cold if i == 0 else self.memberships[i - 1]
            state, touched = state.apply(*self.entries[i])
            if i in sample:
                prev_t = torch.from_numpy(prev).to(dev)
                want = ref.louvain(state.graph(), params, prev=prev_t,
                                   frontier=frontier(touched, prev_t, n,
                                                     self.screening))
                o = _off(self.memberships[i], want.cpu().numpy())
                off += o
                wrong += o > 0
        key, w = state.directed()
        n_p, key_p, w_p = self.final
        graph_off = abs(int(key_p.shape[0]) - int(key.shape[0])) + (n_p != n)
        if not graph_off:
            key, w = key.cpu(), w.cpu()
            graph_off = int(torch.count_nonzero((key_p != key) | (w_p != w)))
        checks = {"graph_slots_off": (graph_off, 0),
                  "labels_off_cold": (off_cold, 0),
                  "labels_off_sampled": (off, 0)}
        return (len(self.stats), min(len(self.stats), wrong + (graph_off > 0)),
                checks, {})


def _off(got: np.ndarray, want: np.ndarray) -> int:
    """Labels of ``got`` that differ from ``want`` (all, if the shapes
    differ)."""
    if got.shape != want.shape:
        return int(max(got.size, want.size))
    return int(np.count_nonzero(got != want))
