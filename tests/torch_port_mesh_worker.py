"""Rank program of the port's mesh tests (tests/test_torch_port_sharded.py
and tests/test_torch_port_sharded_maxsim.py).

    python tests/torch_port_mesh_worker.py SUITE RANK WORLD DP PORT DIR

Each of WORLD processes joins a gloo group at tcp://localhost:PORT as rank
RANK, builds a (DP, WORLD / DP) mesh on the CPU, runs every case of SUITE
listed for WORLD, and writes DIR/<case>.r<RANK>.npz: the case's arrays, or
`error`, the message of the exception it raised. A case that needs files
finds them under DIR/<case>/, put there by the test's fixture.

The inputs come from the functions below, made from seeds with numpy; the
tests hand the same arrays to the JAX package. This file imports neither
jax nor the JAX package, and nothing of the port until a rank runs.
"""

import os
import sys

import numpy as np

# ------------------------------------------------------------- inputs


def normalized(q_rows=100, b_rows=1000, dim=384, seed=42):
    """The unit-norm Gaussian query and base sets of tests/conftest.py."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((q_rows, dim)).astype(np.float32)
    b = rng.standard_normal((b_rows, dim)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    return q.astype(np.float32), b.astype(np.float32)


def gauss(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def duplicates():
    """16 exact copies of query 0 at rows 0, 4, ..., 60 of a 64-row base:
    twice as many zero-distance ties as k=8, spread over every shard."""
    b, q = gauss(3, (64, 16), (4, 16))
    b[np.arange(0, 64, 4)] = q[0]
    return q, b


def padded_base():
    """The first 950 base rows, zero-padded to 960 (n_valid=950)."""
    q, b = normalized()
    bp = np.zeros((960, b.shape[1]), np.float32)
    bp[:950] = b[:950]
    return q, bp, 950


def random_docs(seed, n, td, dim, q_n=0, tq=0):
    """(queries, q_mask, docs, d_mask): ragged doc token counts (a tail of
    each doc masked), full query masks; as tests/test_sharded_maxsim.py."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((q_n, tq, dim)).astype(np.float32)
    qm = np.ones((q_n, tq), dtype=bool)
    docs = rng.standard_normal((n, td, dim)).astype(np.float32)
    mask = np.ones((n, td), dtype=bool)
    for i, length in enumerate(rng.integers(1, td + 1, n)):
        mask[i, length:] = False
    return q, qm, docs, mask


MEGA = 28 * 1024            # ops/screen_kernel.MEGA
MEGA_DOCS = 8192            # ops/maxsim_kernel.MEGA_DOCS

KNN_STREAM = (400, 400, 200)            # ragged streamed batch widths
SCREENED_RAGGED = (2 * MEGA * 2, MEGA + 12_345)
MAXSIM_TILES = (160, 240, 80)


def maxsim_inputs(name):
    """Inputs of the MaxSim cases, by case name."""
    if name == "matches":
        q, qm, d, dm = random_docs(5, 480, 8, 32, 6, 4)
        qm[:, 3] = False                   # ragged query tokens
        return q, qm, d, dm
    if name == "tile_padding":
        return random_docs(6, 101, 6, 16, 5, 3)
    if name == "screened":
        return random_docs(7, 2 * MEGA_DOCS, 8, 32, 4, 8)
    if name == "checkpoint":
        return random_docs(8, 320, 8, 16, 4, 4)
    if name == "ragged_tail":
        return random_docs(17, 2 * MEGA_DOCS + 10, 6, 16, 3, 4)
    if name == "forced_repair":
        return random_docs(18, 2 * MEGA_DOCS, 6, 24, 3, 4)
    if name == "escalation":
        return concentrated_docs()
    if name == "adaptive":
        return random_docs(19, 3 * 2 * MEGA_DOCS, 8, 32, 16, 8)
    raise KeyError(name)


def concentrated_docs(n=2 * MEGA_DOCS, td=8, dim=32, q_n=16, tq=8):
    """Two tiles of docs crowded around one doc each: the first within
    0.003 (scores too close for the 1-pass and the 3-pass certificates),
    the second within 0.05 (too close for the 1-pass one only)."""
    rng = np.random.default_rng(20)
    q = rng.standard_normal((q_n, tq, dim)).astype(np.float32)
    tiles = [rng.standard_normal((1, td, dim))
             + scale * rng.standard_normal((n, td, dim))
             for scale in (0.003, 0.05)]
    docs = np.concatenate(tiles).astype(np.float32)
    return q, np.ones((q_n, tq), bool), docs, np.ones((2 * n, td), bool)


# ------------------------------------------------------------- cases

CASES = {"knn": {}, "maxsim": {}}


def case(suite, worlds):
    def register(fn):
        CASES[suite][fn.__name__] = (worlds, fn)
        return fn
    return register


def case_names(suite, world):
    return [n for n, (w, _) in CASES[suite].items() if world in w]


def _np(x):
    import torch
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class _Spy:
    """Record the calls of `owner.name` (args, kwargs) while it still runs;
    `restore()` puts the original back."""

    def __init__(self, owner, name):
        self.owner, self.name = owner, name
        self.real = getattr(owner, name)
        self.calls = []

        def spy(*args, **kwargs):
            self.calls.append((args, kwargs))
            return self.real(*args, **kwargs)
        setattr(owner, name, spy)

    def restore(self):
        setattr(self.owner, self.name, self.real)


# ---- kNN (parallel/sharded_knn.py)

@case("knn", (2, 4))
def sharded(mesh, work):
    from neighborhoodwatch_tpu_torch.parallel import sharded_knn as SK
    q, b = normalized()
    d, i = SK.sharded_knn(q, b[:960], 10, mesh)
    return {"d": d, "i": i}


@case("knn", (2,))
def k_exceeds_shard(mesh, work):
    from neighborhoodwatch_tpu_torch.parallel import sharded_knn as SK
    q, b = normalized()
    SK.sharded_knn(q, b[:160], 100, mesh)


@case("knn", (2, 4))
def ring(mesh, work):
    from neighborhoodwatch_tpu_torch.parallel import sharded_knn as SK
    q, b = normalized()
    d, i = SK.ring_knn(q, b[:960], 10, mesh)
    return {"d": d, "i": i}


@case("knn", (4,))
def ring_cosine(mesh, work):
    from neighborhoodwatch_tpu_torch.parallel import sharded_knn as SK
    q, b = normalized()
    d, i = SK.ring_knn(q, b[:960], 8, mesh, metric="cosine")
    return {"d": d, "i": i}


@case("knn", (2,))
def ring_duplicates(mesh, work):
    from neighborhoodwatch_tpu_torch.parallel import sharded_knn as SK
    q, b = duplicates()
    d, i = SK.ring_knn(q, b, 8, mesh)
    return {"d": d, "i": i}


@case("knn", (2,))
def padded_sharded(mesh, work):
    from neighborhoodwatch_tpu_torch.parallel import sharded_knn as SK
    q, bp, n_valid = padded_base()
    d, i = SK.sharded_knn(q, bp, 10, mesh, n_valid=n_valid)
    return {"d": d, "i": i}


@case("knn", (2,))
def padded_ring(mesh, work):
    from neighborhoodwatch_tpu_torch.parallel import sharded_knn as SK
    q, bp, n_valid = padded_base()
    d, i = SK.ring_knn(q, bp, 10, mesh, n_valid=n_valid)
    return {"d": d, "i": i}


@case("knn", (2,))
def unknown_engine(mesh, work):
    from neighborhoodwatch_tpu_torch.parallel import sharded_knn as SK
    q, b = normalized()
    errors = []
    for call in (lambda: SK.sharded_knn(q, b[:960], 10, mesh,
                                        engine="screen"),
                 lambda: SK.ShardedStreamingKNN(q, 10, mesh,
                                                engine="verfied")):
        try:
            call()
            errors.append("")
        except ValueError as e:
            errors.append(str(e))
    return {"errors": np.array(errors)}


@case("knn", (2,))
def colmajor(mesh, work):
    from neighborhoodwatch_tpu_torch.parallel import sharded_knn as SK
    q, b = normalized()
    a1 = SK.ShardedStreamingKNN(q, 10, mesh)
    a2 = SK.ShardedStreamingKNN(q, 10, mesh)
    for s in range(0, 1000, 250):
        a1.update(b[s:s + 250], s)
        lo, hi = a2.local_update_range(250)
        a2.update_colmajor(np.ascontiguousarray(b[s:s + 250].T)[:, lo:hi], s,
                           global_rows=250)
        a2.force_state(a2.state)
    d1, i1 = a1.finalize()
    d2, i2 = a2.finalize()
    return {"d_row": d1, "i_row": i1, "d_col": d2, "i_col": i2}


@case("knn", (4,))
def stream_ragged(mesh, work):
    from neighborhoodwatch_tpu_torch.parallel import sharded_knn as SK
    q, b = normalized()
    acc = SK.ShardedStreamingKNN(q, 10, mesh)
    off = 0
    for size in KNN_STREAM:
        acc.update(b[off:off + size], off)
        off += size
    d, i = acc.finalize()
    return {"d": d, "i": i}


@case("knn", (4,))
def odd_rows(mesh, work):
    from neighborhoodwatch_tpu_torch.parallel import sharded_knn as SK
    q, b = gauss(7, (13, 64), (512, 64))
    acc = SK.ShardedStreamingKNN(q, 5, mesh)
    acc.update(b[:256], 0)
    acc.update(b[256:], 256)
    d, i = acc.finalize()
    return {"d": d, "i": i}


def _screened_stream(mesh, q, b, k, batches):
    """ShardedStreamingKNN(engine="screened") over `batches` widths: the
    result, the diagnostics the tier controller observed and the one still
    pending, and the screened engine's calls."""
    from neighborhoodwatch_tpu_torch.ops import knn as K
    from neighborhoodwatch_tpu_torch.parallel import sharded_knn as SK
    observe = _Spy(K.ScreenTierController, "observe")
    screened = _Spy(K, "screened_knn_traced")
    try:
        acc = SK.ShardedStreamingKNN(q, k, mesh, engine="screened")
        off = 0
        for size in batches:
            acc.update(b[off:off + size], off)
            off += size
        d, i = acc.finalize()
    finally:
        observe.restore()
        screened.restore()
    return {"d": d, "i": i,
            "observed": np.array([c[0][1] for c in observe.calls],
                                 dtype=np.int64).reshape(-1, 3),
            "pending": np.array(acc._pending_diag[0]
                                if acc._pending_diag else (-1, -1, -1)),
            "screened_calls": np.array(len(screened.calls)),
            "tier": np.array(acc._tier_idx)}


@case("knn", (2,))
def small_shard_screened(mesh, work):
    q, b = gauss(22, (8, 24), (2 * 64, 24))
    return _screened_stream(mesh, q, b, 5, (len(b),))


@case("knn", (2,))
def screened_one_mega(mesh, work):
    q, b = gauss(21, (6, 16), (MEGA * 2, 16))
    return _screened_stream(mesh, q, b, 7, (len(b),))


@case("knn", (2,))
def screened_ragged(mesh, work):
    q, b = gauss(31, (8, 16), (sum(SCREENED_RAGGED), 16))
    return _screened_stream(mesh, q, b, 7, SCREENED_RAGGED)


@case("knn", (4,))
def checkpoint(mesh, work):
    from neighborhoodwatch_tpu_torch.parallel import sharded_knn as SK
    q, b = normalized()
    q = q[:99]                          # 99 rows: padded to 100 over dp=2
    a1 = SK.ShardedStreamingKNN(q, 10, mesh)
    a1.update(b[:500], 0)
    dist, idx, seen = a1.state_arrays()
    a2 = SK.ShardedStreamingKNN(q, 10, mesh)
    a2.restore(dist, idx, seen)
    a2.update(b[500:], 500)
    a1.update(b[500:], 500)
    try:
        a2.restore(dist[:98], idx[:98], seen)
        mismatch = ""
    except ValueError as e:
        mismatch = str(e)
    d1, i1 = a1.finalize()
    d2, i2 = a2.finalize()
    return {"ckpt_d": dist, "ckpt_i": idx, "seen": np.array(seen),
            "d_whole": d1, "i_whole": i1, "d": d2, "i": i2,
            "mismatch": np.array(mismatch)}


def _finals(data_dir):
    import pyarrow.parquet as pq
    from neighborhoodwatch_tpu_torch.utils import naming
    return [pq.read_table(fn(data_dir, -1)).to_pandas().values
            for fn in (naming.get_partial_indices_filename,
                       naming.get_partial_distances_filename)]


def _fixed_plan(module, rows):
    """Pin compute_knn_ds' base batches to `rows` rows (plan_knn would grow
    them to the memory budget)."""
    from neighborhoodwatch_tpu_torch.core.tuner import KnnPlan
    module.plan_knn = lambda *a, **kw: KnnPlan(
        batch_size=rows, tile_size=128, query_block=100,
        bytes_limit=1 << 24, est_bytes=1 << 22)


@case("knn", (2,))
def pipeline(mesh, work):
    from neighborhoodwatch_tpu_torch.core import pipeline as P
    q, b = normalized()
    data_dir = os.path.join(work, "pipeline")
    P.compute_knn_ds(data_dir, q.shape[1], "q.parquet", len(q), "b.parquet",
                     len(b), k=10, initial_batch_size=300, mesh=mesh,
                     device="cpu")
    mesh.barrier()                     # rank 0 writes the finals
    idx, dist = _finals(data_dir)
    return {"i": idx, "d": dist}


@case("knn", (4,))
def handoff(mesh, work):
    """Resume the JAX mesh run's checkpoint (written after 400 of 1000
    rows by the fixture's killed JAX compute_knn_ds) and finish."""
    from neighborhoodwatch_tpu_torch.core import pipeline as P
    from neighborhoodwatch_tpu_torch.parallel import sharded_knn as SK
    q, b = normalized()
    data_dir = os.path.join(work, "handoff")
    _fixed_plan(P, 200)
    updates = _Spy(SK.ShardedStreamingKNN, "update_colmajor")
    try:
        P.compute_knn_ds(data_dir, q.shape[1], "q.parquet", len(q),
                         "b.parquet", len(b), k=10, mesh=mesh,
                         checkpoint_every=1, device="cpu")
    finally:
        updates.restore()
    mesh.barrier()
    idx, dist = _finals(data_dir)
    return {"i": idx, "d": dist,
            "offsets": np.array([c[0][2] for c in updates.calls]),
            "ckpt_left": np.array(os.path.exists(
                P._stream_ckpt_path(data_dir)))}


# ---- MaxSim (parallel/sharded_maxsim.py)

def _maxsim_stream(mesh, name, k, tiles, **kw):
    """ShardedStreamingMaxSim over `tiles` widths of case `name`'s docs:
    the result and, after each tile, the tier and the escalation and
    repair counts."""
    from neighborhoodwatch_tpu_torch.parallel import sharded_maxsim as SM
    q, qm, d, dm = maxsim_inputs(name)
    acc = SM.ShardedStreamingMaxSim(q, qm, k, mesh, **kw)
    off, trail = 0, []
    for size in tiles:
        acc.update(d[off:off + size], dm[off:off + size], off)
        off += size
        trail.append((acc._tier_idx, acc.escalated_tiles, acc.repaired_rows))
    s, i = acc.finalize()
    return {"s": s, "i": i, "trail": np.array(trail, dtype=np.int64)}


@case("maxsim", (4,))
def matches(mesh, work):
    return _maxsim_stream(mesh, "matches", 9, MAXSIM_TILES)


@case("maxsim", (4,))
def tile_padding(mesh, work):
    return _maxsim_stream(mesh, "tile_padding", 4, (57, 44))


@case("maxsim", (2,))
def screened(mesh, work):
    return _maxsim_stream(mesh, "screened", 6, (2 * MEGA_DOCS,),
                          engine="screened")


@case("maxsim", (2,))
def maxsim_checkpoint(mesh, work):
    from neighborhoodwatch_tpu_torch.parallel import sharded_maxsim as SM
    q, qm, d, dm = maxsim_inputs("checkpoint")
    a1 = SM.ShardedStreamingMaxSim(q, qm, 5, mesh)
    a1.update(d[:160], dm[:160], 0)
    s0, i0, seen = a1.state_arrays()
    a2 = SM.ShardedStreamingMaxSim(q, qm, 5, mesh)
    a2.restore(s0, i0, seen)
    a2.update(d[160:], dm[160:], 160)
    try:
        a2.restore(s0[:, :4], i0[:, :4], seen)
        mismatch = ""
    except ValueError as e:
        mismatch = str(e)
    s, i = a2.finalize()
    return {"seen": np.array(seen), "s": s, "i": i,
            "mismatch": np.array(mismatch)}


@case("maxsim", (2,))
def ragged_tail(mesh, work):
    return _maxsim_stream(mesh, "ragged_tail", 12, (2 * MEGA_DOCS, 10),
                          engine="screened")


@case("maxsim", (2,))
def forced_repair(mesh, work):
    """Every certificate fails: each screened tile's rows are all repaired
    exactly."""
    import torch
    from neighborhoodwatch_tpu_torch.ops import maxsim as M
    real = M._maxsim_select

    def failing(*args, **kwargs):
        out = real(*args, **kwargs)
        return (out[0], out[1], torch.zeros_like(out[2])) + tuple(out[3:])
    M._maxsim_select = failing
    try:
        return _maxsim_stream(mesh, "forced_repair", 9, (2 * MEGA_DOCS,),
                              engine="screened")
    finally:
        M._maxsim_select = real


@case("maxsim", (2,))
def escalation(mesh, work):
    return _maxsim_stream(mesh, "escalation", 10, (2 * MEGA_DOCS,) * 2,
                          engine="screened", screen_precision="default")


@case("maxsim", (2,))
def adaptive(mesh, work):
    return _maxsim_stream(mesh, "adaptive", 10, (2 * MEGA_DOCS,) * 3,
                          engine="screened")


@case("maxsim", (4,))
def maxsim_handoff(mesh, work):
    """Resume the JAX mesh run's checkpoint of compute_maxsim_knn (written
    by the fixture's killed run) and finish."""
    from neighborhoodwatch_tpu_torch.core import colbert_pipeline as CP
    from neighborhoodwatch_tpu_torch.parallel import sharded_maxsim as SM
    root = os.path.join(work, "maxsim_handoff")
    restores = _Spy(SM.ShardedStreamingMaxSim, "restore")
    try:
        _, n_q, n_b = CP.compute_maxsim_knn(
            root, f"{root}/q_src.parquet", f"{root}/b_src.parquet", k=4,
            tile_docs=8, batch_rows=40, checkpoint_every=1, mesh=mesh,
            device="cpu")
    finally:
        restores.restore()
    mesh.barrier()
    idx, dist = _finals(root)
    return {"i": idx, "d": dist, "counts": np.array([n_q, n_b]),
            "resumed_at": np.array([c[0][3] for c in restores.calls])}


# ------------------------------------------------------------- main

def main(argv):
    suite, rank, world, dp, port, out = argv
    rank, world, dp = int(rank), int(world), int(dp)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch
    torch.set_num_threads(1)
    from neighborhoodwatch_tpu_torch.parallel.mesh import (
        init_distributed, make_mesh,
    )
    init_distributed(coordinator=f"localhost:{port}", num_processes=world,
                     process_id=rank, device="cpu")
    mesh = make_mesh(world, dp=dp, device="cpu")
    for name in case_names(suite, world):
        _, fn = CASES[suite][name]
        try:
            arrays = {k: _np(v) for k, v in (fn(mesh, out) or {}).items()}
        except (AssertionError, ValueError) as e:
            arrays = {"error": np.array(f"{type(e).__name__}: {e}")}
        np.savez(os.path.join(out, f"{name}.r{rank}.npz"), **arrays)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
