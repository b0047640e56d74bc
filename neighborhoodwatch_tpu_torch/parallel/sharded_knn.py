"""Multi-device exact kNN over a (dp, mp) mesh of torch.distributed ranks
(counterpart of parallel/sharded_knn.py).

The base corpus is split row-wise over the "mp" axis: every rank computes
an exact top-k against its own shard with *global* indices (shard offset =
mp rank x shard rows), then the (dist, idx) lists, k per query and not the
shard, are all-gathered over the rank's mp line and merged on its device.
Queries are split over "dp", so the payload per rank is (Q/dp, k) pairs.
Rows past the real row count (the padding that makes the base divide mp)
are masked to +inf in every engine: a zero pad row's distance is ||q||^2,
which beats true neighbours on unit vectors.

Every rank passes the same full query and base (host arrays or tensors)
and moves only its own rows to its device; results come back whole on
every rank (gathered over dp).

Engine per shard: ops/knn._select_engine on the shard's row count and
device. "auto" takes the screened engine (the hand-written screen kernel,
csrc/screen_keys.cu) on CUDA shards of >= 2 mega-tiles and the verified
engine (csrc/verified_select.cu) below; an "auto" or screened request on a
shard below one mega-tile scans on the verified engine on the card and
the exact one on the CPU (`_small_shard_engine`, the JAX package's choice
on a TPU and off it). `precision` sets the exact and verified scans'
products, as in ops/knn.knn.

`ring_knn` rotates the base shards around the mp line with send and recv,
folding each visiting shard into a running top-k; every fold merges
lexicographically on (distance, global index).
"""

import numpy as np
import torch

from neighborhoodwatch_tpu_torch.ops import knn as K
from neighborhoodwatch_tpu_torch.ops import screen_kernel
from neighborhoodwatch_tpu_torch.ops.topk import merge_topk, merge_topk_many
from neighborhoodwatch_tpu_torch.parallel.mesh import (
    DP_AXIS, MP_AXIS, all_gather, all_reduce_max, base_rows, query_rows,
    ring_shift,
)

_INF = float("inf")


def _check_engine(engine: str) -> str:
    """Unknown names raise: a typo silently coerced to "auto" would run
    another engine than the caller believes."""
    if engine not in K.ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected one of "
                         f"{'/'.join(K.ENGINES)}")
    return engine


def _pad_rows(x, pad: int, axis: int = 0):
    """Zero rows appended on `axis` of a numpy array or a tensor."""
    if not pad:
        return x
    if isinstance(x, torch.Tensor):
        shape = list(x.shape)
        shape[axis] = pad
        return torch.cat([x, x.new_zeros(shape)], dim=axis)
    width = [(0, 0)] * x.ndim
    width[axis] = (0, pad)
    return np.pad(x, width)


def _host_or_tensor(x, dtype=np.float32):
    return x if isinstance(x, torch.Tensor) else np.asarray(x, dtype=dtype)


def _small_shard_engine(engine: str, device) -> str:
    """The scan engine of a shard the screen does not take (or of an
    exact/verified request)."""
    if engine in ("exact", "verified"):
        return engine
    return K._fallback_engine(device)


def _shard_topk(q_local, b_local, local_valid: int, shard_off: int, k: int,
                metric: str, engine: str, tile_size: int,
                screen_precision: str, with_diagnostics: bool,
                precision: str = "highest"):
    """Exact top-k of this rank's queries against its shard, global ids;
    diag = (class-A, class-B, whole-batch) of the screened engine."""
    shard_rows = b_local.shape[0]
    diag = (0, 0, 0)
    if engine == "screened" and shard_rows >= screen_kernel.MEGA:
        out = K.screened_knn_traced(q_local, b_local, local_valid, shard_off,
                                    k, metric,
                                    screen_precision=screen_precision,
                                    with_diagnostics=with_diagnostics)
        d, i = out[:2]
        if with_diagnostics:
            diag = out[2]
    elif shard_rows > tile_size:
        d, i = K._knn_scan(q_local, b_local, local_valid, shard_off, k,
                           metric, tile_size,
                           _small_shard_engine(engine, q_local.device),
                           precision)
    else:
        d, i = K._knn_full(q_local, b_local, local_valid, shard_off, k,
                           metric, _small_shard_engine(engine,
                                                       q_local.device),
                           precision)
    return d, i, diag


def _sharded_fold(mesh, run_d, run_i, q_local, b_local, offset: int,
                  n_valid: int, k: int, metric: str, engine: str,
                  tile_size: int, screen_precision: str = "auto",
                  with_diagnostics: bool = False,
                  precision: str = "highest"):
    """One sharded step: fold this rank's shard of an mp-split base batch
    into its dp slice of the running top-k. `offset` is the global row id
    of the batch's row 0, `n_valid` the batch's real rows. With
    `with_diagnostics`, also the WORST shard's (class-A, class-B,
    whole-batch) counts over the whole mesh: a sum would dilute one hot
    shard's repair pressure by the shard count, and the budgets are
    per-shard quantities."""
    shard_rows = b_local.shape[0]
    start = mesh.mp_rank * shard_rows
    local_valid = min(max(n_valid - start, 0), shard_rows)
    kk = min(k, shard_rows)
    d, i, diag = _shard_topk(q_local, b_local, local_valid, offset + start,
                             kk, metric, engine, tile_size, screen_precision,
                             with_diagnostics, precision)
    all_d = all_gather(mesh, d, MP_AXIS)          # (mp, q_local, kk)
    all_i = all_gather(mesh, i, MP_AXIS)
    md, mi = merge_topk_many(all_d, all_i, min(k, mesh.mp * kk))
    out_d, out_i = merge_topk(run_d, run_i, md, mi, k)
    if with_diagnostics:
        worst = all_reduce_max(mesh, torch.tensor(diag, dtype=torch.int32,
                                                  device=d.device))
        return out_d, out_i, tuple(worst.tolist())
    return out_d, out_i


def _gather_rows(mesh, t):
    """This rank's dp slice of a result -> the whole (rows, ...) result."""
    return all_gather(mesh, t, DP_AXIS).flatten(0, 1)


def sharded_knn(query, base, k: int, mesh, metric: str = "sqeuclidean",
                precision: str = "highest", tile_size: int = 2048,
                engine: str = "auto", n_valid: int | None = None,
                screen_precision: str = "auto"):
    """Exact kNN over a (dp, mp) mesh. `query` rows must divide dp and
    `base` rows mp; pad the base beforehand if needed AND pass `n_valid` =
    the real row count: pad rows are masked per shard.

    Every rank passes the same full `query` and `base` and moves only its
    own rows to its device. Returns (distances, indices) tensors of shape
    (Q, k) on the mesh's device, whole on every rank, global base
    indices."""
    K._check_precision(precision)
    _check_engine(engine)
    n_base, q_rows = base.shape[0], query.shape[0]
    mp, dp = mesh.mp, mesh.dp
    if n_valid is None:
        n_valid = n_base
    assert 0 < n_valid <= n_base
    assert q_rows % dp == 0, f"query rows {q_rows} not divisible by dp={dp}"
    assert n_base % mp == 0, f"base rows {n_base} not divisible by mp={mp}"
    shard_rows = n_base // mp
    assert k <= shard_rows, \
        f"k={k} exceeds per-shard base rows {shard_rows}; lower mp or pad base"
    assert k <= n_valid, f"k={k} exceeds valid base rows {n_valid}"

    dev = mesh.device
    q_lo, q_hi = query_rows(mesh, q_rows)
    b_lo, b_hi = base_rows(mesh, n_base)
    q_local = K._as_tensor(query[q_lo:q_hi], dev)
    b_local = K._as_tensor(base[b_lo:b_hi], dev)
    engine = K._select_engine(engine, shard_rows, dev)
    run_d = torch.full((q_hi - q_lo, k), _INF, device=dev)
    run_i = torch.zeros((q_hi - q_lo, k), dtype=torch.int32, device=dev)
    d, i = _sharded_fold(mesh, run_d, run_i, q_local, b_local, 0, n_valid, k,
                         metric, engine, tile_size, screen_precision,
                         precision=precision)
    return _gather_rows(mesh, d), _gather_rows(mesh, i)


class ShardedStreamingKNN:
    """Running top-k over streamed base batches, sharded over a mesh: the
    multi-device form of ops.knn.StreamingKNN. Each batch is row-split over
    the "mp" axis (a device holds batch/mp rows), every rank folds its
    shard with global indices, and the per-shard top-k lists merge by an
    all-gather over the mp line. The queries and the running (dist, idx)
    state stay split over "dp" on the devices across batches.

    Every rank passes the same full query set. A batch is fed either whole
    on every rank (`update(batch)`; each rank moves only its own rows to
    its device) or as each rank's own rows with the batch's real row count
    (`update(rows, global_rows=n)`, the rows of `local_update_range`)."""

    def __init__(self, query, k: int, mesh, metric: str = "sqeuclidean",
                 precision: str = "highest", tile_size: int = 8192,
                 engine: str = "auto", screen_precision: str = "auto"):
        K._check_precision(precision)
        self.engine = _check_engine(engine)
        self.mesh = mesh
        self.device = mesh.device
        self.k = k
        self.metric = metric
        self.precision = precision
        self.tile_size = tile_size
        self.screen_precision = screen_precision
        self.dp, self.mp = mesh.dp, mesh.mp
        # adaptive screen-tier controller (screen_precision == "auto"): the
        # ladder of ops.knn.StreamingKNN, fed the mesh-wide worst shard
        self._ctrl = K.ScreenTierController()
        self._pending_diag = None     # (diag, tier_idx, q_rows, shard_rows)
        # zero query pad rows make junk result rows, cut off in finalize
        query = _host_or_tensor(query)
        self._q_rows = query.shape[0]
        query = _pad_rows(query, (-self._q_rows) % self.dp)
        self.q_pad = query.shape[0]
        lo, hi = query_rows(mesh, self.q_pad)
        self.query = K._as_tensor(query[lo:hi], self.device)
        self.state = (torch.full((hi - lo, k), _INF, device=self.device),
                      torch.zeros((hi - lo, k), dtype=torch.int32,
                                  device=self.device))
        self._seen = 0
        self._batch_rows = None

    def _widen(self, n: int) -> int:
        """Pad batches to the widest seen, so a ragged tail keeps the
        widest batch's shard shape; returns the shard's row count."""
        if self._batch_rows is None or n > self._batch_rows:
            self._batch_rows = -(-n // self.mp) * self.mp
        return self._batch_rows // self.mp

    def local_update_range(self, n_rows: int):
        """[start, stop) of the NEXT `n_rows`-row batch this rank supplies
        to update()/update_colmajor() with `global_rows`, clipped to the
        real rows (an all-pad shard's range is empty): rows, or columns of
        a col-major batch."""
        rows = self._batch_rows
        if rows is None or n_rows > rows:
            rows = -(-n_rows // self.mp) * self.mp
        shard = rows // self.mp
        lo = self.mesh.mp_rank * shard
        return min(lo, n_rows), min(lo + shard, n_rows)

    def _local(self, batch, axis: int, n: int, global_rows):
        """This rank's rows of a batch (the whole batch, or its own rows
        when `global_rows` is given), checked and padded to the shard."""
        shard = self._widen(n)
        lo = self.mesh.mp_rank * shard
        want = (min(lo, n), min(lo + shard, n))
        if global_rows is None:
            index = [slice(None)] * 2
            index[axis] = slice(*want)
            batch = batch[tuple(index)]
        elif batch.shape[axis] != want[1] - want[0]:
            raise ValueError(
                f"rank-local batch has {batch.shape[axis]} rows on axis "
                f"{axis}; this rank owns [{want[0]}, {want[1]}) of the "
                f"{n}-row batch (padded to {self._batch_rows})")
        return _pad_rows(batch, shard - batch.shape[axis], axis)

    def update(self, base_batch, offset: int | None = None,
               global_rows: int | None = None) -> None:
        """Fold one (rows, d) base batch: the whole batch on every rank, or
        this rank's rows plus `global_rows` (see local_update_range)."""
        offset = self._check_offset(offset)
        base_batch = _host_or_tensor(base_batch)
        n = global_rows if global_rows is not None else base_batch.shape[0]
        local = self._local(base_batch, 0, n, global_rows)
        self._fold(K._as_tensor(local, self.device), offset, n)
        self._seen += n

    def update_colmajor(self, batch_t, offset: int | None = None,
                        global_rows: int | None = None) -> None:
        """Fold a host COLUMN-MAJOR (d, rows) batch: each rank ships only
        its own columns and transposes them on its device (no host
        transpose). Whole batch, or this rank's columns plus
        `global_rows`, as update()."""
        offset = self._check_offset(offset)
        batch_t = np.asarray(batch_t, dtype=np.float32)
        n = global_rows if global_rows is not None else batch_t.shape[1]
        local_t = self._local(batch_t, 1, n, global_rows)
        local = torch.from_numpy(np.ascontiguousarray(local_t)) \
            .to(self.device).T.contiguous()
        self._fold(local, offset, n)
        self._seen += n

    def _check_offset(self, offset) -> int:
        if offset is None:
            offset = self._seen
        assert offset == self._seen, \
            "batches must arrive in ascending contiguous offset order"
        return offset

    def _fold(self, local, offset: int, n: int) -> None:
        """One fold at the controller's screen tier; the repair diagnostics
        wait for the next fold's harvest (tier moves lag one batch, as in
        ops.knn.StreamingKNN). Diagnostics are asked for only where the
        screen kernel runs."""
        shard_rows = local.shape[0]
        engine = K._select_engine(self.engine, shard_rows, self.device)
        adaptive = (self.screen_precision == "auto"
                    and engine == "screened"
                    and shard_rows >= screen_kernel.MEGA)
        used_tier = self._ctrl.tier_idx
        tier = (K.SCREEN_TIER_AUTO_LADDER[used_tier]
                if self.screen_precision == "auto"
                else self.screen_precision)
        out = _sharded_fold(self.mesh, *self.state, self.query, local, offset,
                            n, self.k, self.metric, engine, self.tile_size,
                            tier, with_diagnostics=adaptive,
                            precision=self.precision)
        self.state = out[:2]
        new_diag = None
        if adaptive:
            new_diag = (out[2], used_tier, self.query.shape[0], shard_rows)
        if adaptive and self._pending_diag is not None:
            diag, t_idx, q_loc, sh_rows = self._pending_diag
            self._ctrl.observe(diag, t_idx, q_loc, sh_rows, self.k)
        self._pending_diag = new_diag

    @property
    def _tier_idx(self) -> int:
        return self._ctrl.tier_idx

    @property
    def rows_seen(self) -> int:
        return self._seen

    def force_state(self, state) -> None:
        """Backpressure: wait until this rank's fold that produced `state`
        has run (one 4-byte read of its state)."""
        state[0][:1, :1].cpu()

    def state_arrays(self):
        """(dist, idx, seen) as host arrays, gathered over dp so every rank
        holds the whole padded state: the streaming checkpoint, in the JAX
        package's layout (a collective: every rank calls it)."""
        return (_gather_rows(self.mesh, self.state[0]).cpu().numpy(),
                _gather_rows(self.mesh, self.state[1]).cpu().numpy(),
                self._seen)

    def restore(self, dist, idx, seen: int) -> None:
        """Resume from whole checkpoint arrays (state_arrays of either
        package); a state of another padded shape fails here."""
        expect = (self.q_pad, self.k)
        if tuple(dist.shape) != expect or tuple(idx.shape) != expect:
            raise ValueError(f"checkpoint state {tuple(dist.shape)} / "
                             f"{tuple(idx.shape)} does not match this "
                             f"mesh's padded state {expect}")
        lo, hi = query_rows(self.mesh, self.q_pad)
        self.state = (
            torch.as_tensor(np.asarray(dist[lo:hi], dtype=np.float32),
                            device=self.device),
            torch.as_tensor(np.asarray(idx[lo:hi], dtype=np.int32),
                            device=self.device))
        self._seen = int(seen)

    def finalize(self):
        """(distances, indices) as numpy, the original query rows only,
        whole on every rank."""
        assert self._seen >= self.k, \
            f"saw only {self._seen} base rows but k={self.k}"
        dist, idx, _ = self.state_arrays()
        return dist[: self._q_rows], idx[: self._q_rows]


def _lex_merge(run_d, run_i, d, i, k: int):
    """k smallest of two lists, ordered by (distance, global index): the
    order does not depend on which list came first."""
    cd = torch.cat([run_d, d], dim=1)
    ci = torch.cat([run_i, i], dim=1)
    by_id = torch.sort(ci, dim=1, stable=True).indices
    cd, ci = torch.gather(cd, 1, by_id), torch.gather(ci, 1, by_id)
    order = torch.sort(cd, dim=1, stable=True).indices[:, :k]
    return torch.gather(cd, 1, order), torch.gather(ci, 1, order)


def ring_knn(query, base, k: int, mesh, metric: str = "sqeuclidean",
             precision: str = "highest", n_valid: int | None = None):
    """Ring variant: each rank starts with its own base shard and passes it
    around its mp line by send/recv, folding each visiting shard into a
    running top-k. The send of the held shard is posted before its fold,
    so the transfer overlaps the fold, and the last step sends nothing
    (mp - 1 transfers). The shard held at step s came from mp rank
    (rank - s) % mp.

    Pad the base to mp-divisibility if needed and pass `n_valid`: pad rows
    are masked. Every fold merges lexicographically on (distance, global
    index): a distance-only merge loses tied lower ids at the k boundary
    on ranks that visit later shards first. Arguments and result as
    sharded_knn; the per-shard engine is the exact scan."""
    K._check_precision(precision)
    n_base, q_rows = base.shape[0], query.shape[0]
    mp, dp = mesh.mp, mesh.dp
    if n_valid is None:
        n_valid = n_base
    assert 0 < n_valid <= n_base
    assert q_rows % dp == 0 and n_base % mp == 0
    shard_rows = n_base // mp
    assert k <= shard_rows and k <= n_valid

    dev = mesh.device
    q_lo, q_hi = query_rows(mesh, q_rows)
    b_lo, b_hi = base_rows(mesh, n_base)
    q_local = K._as_tensor(query[q_lo:q_hi], dev)
    held = K._as_tensor(base[b_lo:b_hi], dev)
    run_d = torch.full((q_hi - q_lo, k), _INF, device=dev)
    run_i = torch.zeros((q_hi - q_lo, k), dtype=torch.int32, device=dev)
    for step in range(mp):
        shift = ring_shift(mesh, held) if step < mp - 1 else None
        start = ((mesh.mp_rank - step) % mp) * shard_rows
        valid = min(max(n_valid - start, 0), shard_rows)
        d, i, _ = _shard_topk(q_local, held, valid, start, k, metric,
                              "exact", K.DEFAULT_TILE, "auto", False,
                              precision)
        run_d, run_i = _lex_merge(run_d, run_i, d, i, k)
        if shift is not None:
            held = shift.wait()
    return _gather_rows(mesh, run_d), _gather_rows(mesh, run_i)
