"""Driver of the exact-kNN entry point, `ops.knn.knn(query, base, k,
engine="auto")`, as the pipelines call it: a base resident on the card,
each call a fresh batch of queries made on the card from (seed, call),
the (distances, ids) result copied to the host before the next call is
issued (a closed loop of one client).

Counted on the way (the class-A, class-B and whole-batch repairs of
every screened call, read from the engine's own diagnostics): the
per-layer `certified_share`. Kept for the check: 256 rows of every call,
drawn from (seed, call); the check judges a sample of them, drawn from
the seed, by the float64 reference (reference/knn.py).
"""

import sys
import time

import numpy as np
import torch

from nwbench import seeds
from nwbench.reference import knn as ref
from nwbench.trace import span

# the kernels a call may load (the fallback's too), loaded in set-up so
# that nothing builds or loads inside the window
KERNELS = ("screen_keys", "prepare_base", "rerank_rows", "verified_select",
           "distance_tile")
KEPT_ROWS = 256
WARM_CALLS = 2


class Driver:
    def __init__(self, run):
        self.run = run
        shape = run.config["knn"]
        self.n_query = int(shape["queries"])
        self.n_base = int(shape["base_rows"])
        self.dim = int(shape["dim"])
        self.k = int(shape["k"])
        self.attempted = self.failed = 0
        self.latencies, self.kept, self.diags = [], [], []
        self.calls = 0

    def setup(self):
        from neighborhoodwatch_tpu_torch.ops import knn as engine
        run = self.run
        with run.stage("base"):
            self.traffic = run.traffic.make(
                run.mix, run.seed, run.device, n_base=self.n_base,
                n_query=self.n_query, dim=self.dim)
            self.base = self.traffic.base()
        if run.device.type == "cuda":
            from neighborhoodwatch_tpu_torch.utils import cuda_build
            with run.stage("kernels"):
                for name in KERNELS:
                    cuda_build.load(name)
        self._count_repairs(engine)

        def program(q):
            return engine.knn(q, self.base, self.k, engine="auto",
                              device=run.device)
        self.program = program
        with run.stage("warm calls"):
            for w in range(WARM_CALLS):
                d, i = self.program(self.traffic.queries(w, tag=seeds.WARM))
                d.cpu(), i.cpu()
        self.diags.clear()

    def _count_repairs(self, engine):
        """Wrap the screened engine, which knn() looks up at call time, so
        that each call's (class A, class B, whole batch) triple is kept;
        the engine computes it on every call anyway."""
        real, diags = engine.screened_knn_traced, self.diags

        def counted(*args, with_diagnostics=False, **kw):
            d, i, diag = real(*args, with_diagnostics=True, **kw)
            diags.append(diag)
            return (d, i, diag) if with_diagnostics else (d, i)
        engine.screened_knn_traced = counted
        self._restore = lambda: setattr(engine, "screened_knn_traced", real)

    def step(self):
        run, c = self.run, self.calls
        with span("nwbench.queries", run.traced):
            q = self.traffic.queries(c)
            run.sync()
        t0 = time.perf_counter()
        self.attempted += self.n_query
        try:
            with span("nwbench.call", run.traced):
                d, i = self.program(q)
            with span("nwbench.readback", run.traced):
                d, i = d.cpu().numpy(), i.cpu().numpy()
        except Exception as exc:       # a failed call counts, the run goes on
            print(f"knn call {c} failed: {exc!r}")
            self.failed += self.n_query
            self.calls += 1
            return
        self.latencies.append(time.perf_counter() - t0)
        rows = seeds.numpy_rng(run.seed, seeds.SAMPLE, c).choice(
            self.n_query, min(KEPT_ROWS, self.n_query), replace=False)
        self.kept.append((c, rows, d[rows].copy(), i[rows].copy()))
        self.calls += 1

    def end_to_end(self, kinds, window_s):
        """{metric: (value, unit)} for the cell's {metric: kind}: kinds
        "pairs_per_s" (queries x base rows of every call completed, over
        the window) and "call_p95_ms" (95th percentile of every call's
        latency, issue to result on the host)."""
        done = len(self.latencies)
        lat = np.asarray(self.latencies) * 1e3
        repaired = sum(1 for _, b, _ in self.diags if b)
        whole = sum(1 for _, _, w in self.diags if w)
        print(f"knn calls {done}: ms min {lat.min():.2f} median "
              f"{np.median(lat):.2f} p95 {np.percentile(lat, 95):.2f} max "
              f"{lat.max():.2f}; calls with class-B repairs {repaired}, "
              f"whole-batch {whole}", file=sys.stderr)
        out = {}
        for name, kind in kinds.items():
            if kind == "pairs_per_s":
                out[name] = (done * self.n_query * self.n_base / window_s
                             / 1e9, "Gpair/s")
            elif kind == "call_p95_ms":
                out[name] = (float(np.percentile(self.latencies, 95)) * 1e3,
                             "ms")
            else:
                raise KeyError(f"the knn driver has no kind {kind!r}")
        return out

    def counters(self):
        return {"calls": len(self.latencies), "queries": self.n_query,
                "base_rows": self.n_base, "dim": self.dim,
                "repairs": list(self.diags)}

    def free_program(self):
        self._restore()
        self.program = None

    def check(self, control: bool = False):
        """The reference's numbers for a sample, drawn from the seed, of
        the kept rows (the control's answers in place of the served ones
        with control=True)."""
        run = self.run
        n = int(run.cell["check_sample"])
        pool = [(j, r) for j, entry in enumerate(self.kept)
                for r in range(len(entry[1]))]
        if not pool:
            return {"dist_err": float("nan"), "excess": float("nan"),
                    "bad_rows": self.n_query}
        pick = seeds.numpy_rng(run.seed, seeds.SAMPLE, 1 << 30).choice(
            len(pool), min(n, len(pool)), replace=False)
        by_entry = {}
        for p in sorted(pick):
            j, r = pool[p]
            by_entry.setdefault(j, []).append(r)
        qs, ds, ids = [], [], []
        for j, rs in by_entry.items():
            c, rows, d, i = self.kept[j]
            qs.append(self.traffic.queries(c)[torch.as_tensor(
                rows[rs], device=run.device)])
            ds.append(torch.from_numpy(d[rs]))
            ids.append(torch.from_numpy(i[rs].astype(np.int64)))
        q = torch.cat(qs)
        d, i = torch.cat(ds), torch.cat(ids)
        if control:
            d, i = ref.tf32_knn(q, self.base, self.k)
        return ref.judge(q, self.base, d, i, self.k)
