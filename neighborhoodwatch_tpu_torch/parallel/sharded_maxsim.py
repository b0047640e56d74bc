"""Multi-device ColBERT MaxSim over a (dp, mp) mesh of torch.distributed
ranks: doc-axis sharding with an all-gather merge (counterpart of
parallel/sharded_maxsim.py).

Every streamed (tile, Td, d) doc tile is row-split over the "mp" axis; each
rank screens its shard with the hand-written MaxSim kernel
(csrc/maxsim_keys.cu, through ops/maxsim_kernel.py) and exactly re-ranks
and certifies the candidates, then the per-shard top-k (score, global doc
id) lists, k per query and not the shard, are all-gathered over the rank's
mp line and merged on its device. Queries and the running state stay split
over "dp" across tiles.

Exactness: the per-query certificates travel with the shard results. When
more than max(4, Q/20) queries fail at a sub-high tier, the tile is run
again at the 3-pass tier and the failed rows are replaced; every query
that still fails is recomputed exactly, each rank against its own shard,
and the partial lists are merged over the mp line (merge_partial_topk_desc)
before they REPLACE the screened rows: the repair contract of the
single-device maxsim_topk_screened, never a lossy merge.
"""

import numpy as np
import torch

from neighborhoodwatch_tpu_torch.ops import knn as K
from neighborhoodwatch_tpu_torch.ops import maxsim as M
from neighborhoodwatch_tpu_torch.ops import maxsim_kernel as mk
from neighborhoodwatch_tpu_torch.ops.screen_kernel import PASSES
from neighborhoodwatch_tpu_torch.ops.topk import (
    merge_topk, merge_topk_many, smallest_k,
)
from neighborhoodwatch_tpu_torch.parallel.mesh import (
    MP_AXIS, all_gather, query_rows,
)
from neighborhoodwatch_tpu_torch.parallel.sharded_knn import (
    _gather_rows, _pad_rows,
)

_INF = float("inf")
ENGINES = ("auto", "exact", "screened")


def _sharded_maxsim_tile(mesh, q_local, qm_local, t_local, m_local,
                         offset: int, n_valid: int, k: int, engine: str,
                         m: int, block: int, screen_precision: str = "high",
                         with_diagnostics: bool = False,
                         precision: str = "highest"):
    """One sharded tile: this rank's queries against its shard of the
    tile, merged over the mp line. Returns (scores desc, global doc ids,
    fail) for this rank's queries, fail any-reduced over the mp shards;
    with `with_diagnostics` (screened only) also the (q, 2) bool predicted
    certificate failure at the [medium, default] tiers, any-reduced too (a
    query is cheap-tier-feasible only if every shard's band holds). The
    per-shard selection width is the static kk = min(k, shard docs); the
    caller's maxsim_screen_plan guarantees m >= kk."""
    shard_docs = t_local.shape[0]
    kk = min(k, shard_docs)
    assert engine != "screened" or m >= kk, (m, kk)
    dev = q_local.device
    start = mesh.mp_rank * shard_docs
    local_valid = min(max(n_valid - start, 0), shard_docs)
    valid = torch.arange(shard_docs, device=dev) < local_valid
    # padding docs past the tile's real doc count lose every token
    m_local = m_local & valid[:, None]
    pf = None
    if engine == "screened":
        cand_neg, cand_doc, _, doc_stats = mk.screen_maxsim(
            q_local, qm_local, t_local, m_local,
            screen_precision=screen_precision,
            want_dlo_stat=with_diagnostics)
        out = M._maxsim_select(q_local, qm_local, t_local, m_local, cand_neg,
                               cand_doc, kk, m, block=block,
                               passes=PASSES[screen_precision],
                               doc_stats=doc_stats,
                               with_diagnostics=with_diagnostics)
        s, i, ok = out[:3]
        fail = ~ok.to(dev)
        if with_diagnostics:
            pf = out[3].to(dev)
    else:
        scores = M.maxsim_scores(q_local, qm_local, t_local, m_local,
                                 precision)
        scores = torch.where(valid[None, :], scores, -_INF)
        neg, i = smallest_k(-scores, kk)
        s = -neg
        fail = torch.zeros(q_local.shape[0], dtype=torch.bool, device=dev)
    i = (i + offset + start).to(torch.int32)
    all_s = all_gather(mesh, s, MP_AXIS)          # (mp, q_local, kk)
    all_i = all_gather(mesh, i, MP_AXIS)
    md, mi = merge_topk_many(-all_s, all_i, min(k, mesh.mp * kk))
    fail = all_gather(mesh, fail, MP_AXIS).any(0)
    if pf is None:
        return -md, mi, fail
    return -md, mi, fail, all_gather(mesh, pf, MP_AXIS).any(0)


def merge_partial_topk_desc(all_s, all_i, k: int):
    """Merge of per-rank partial top lists: (P, rows, kk) score/id arrays
    (scores DESCENDING per row, -inf padding) -> the global top-k per row,
    ties broken by ascending doc id: the tie order of `maxsim_topk`, so
    the sharded repair equals a whole-tile recompute. numpy in and out."""
    all_s = np.asarray(all_s)
    all_i = np.asarray(all_i)
    rows = all_s.shape[1]
    cat_s = all_s.transpose(1, 0, 2).reshape(rows, -1)
    cat_i = all_i.transpose(1, 0, 2).reshape(rows, -1)
    order = np.lexsort((cat_i, -cat_s), axis=-1)[:, :k]
    return (np.take_along_axis(cat_s, order, axis=1),
            np.take_along_axis(cat_i, order, axis=1))


def _shard_engine(requested: str, shard_docs: int, tq: int, plan_ok: bool,
                  dim: int, device) -> str:
    """The engine of one tile's shards. `plan_ok` gates even an explicit
    "screened" request: when the shard's bins cannot hold k (or the
    re-rank gather is unaffordable) the exact path runs. "auto" asks the
    same device-taking kernel predicate as ops.maxsim._maxsim_engine (two
    copies of the gate once went out of sync in the JAX package) plus one
    mega-tile of docs per shard."""
    if requested == "exact" or not plan_ok:
        return "exact"
    if requested == "screened":
        return "screened"
    if shard_docs >= mk.MEGA_DOCS and M.maxsim_kernel_shape_ok(tq, dim,
                                                               device):
        return "screened"
    return "exact"


class ShardedStreamingMaxSim:
    """Running top-k of document MaxSim scores over streamed doc tiles,
    sharded over a (dp, mp) mesh: the multi-device form of
    ops.maxsim.StreamingMaxSim with its update/checkpoint/finalize
    contract. Every rank passes the same full query tensors and the same
    whole tiles, and moves only its own docs of a tile to its device.

    `escalated_tiles` counts the tiles re-run at the 3-pass tier after a
    mass certificate failure, `repaired_rows` the query rows recomputed
    exactly; both are mesh-wide."""

    def __init__(self, queries, q_mask, k: int, mesh,
                 precision: str = "highest", engine: str = "auto",
                 screen_precision: str = "auto"):
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r}; expected one of "
                             f"{'/'.join(ENGINES)}")
        K._check_precision(precision)
        self.mesh = mesh
        self.device = mesh.device
        self.k = k
        self.precision = precision
        self._engine_req = engine
        # "auto" on a stream is adaptive (cf. ops.maxsim.StreamingMaxSim):
        # start at the always-certifying 3-pass tier, downshift when the
        # tiles' diagnostics predict a cheaper tier certifies, re-escalate
        # on realized failures. Fixed tiers stay fixed.
        self._adaptive = screen_precision == "auto"
        self._ctrl = M.MaxSimTierController() if self._adaptive else None
        self.screen_precision = M.resolve_maxsim_tier(screen_precision)
        self.dp, self.mp = mesh.dp, mesh.mp
        if not isinstance(queries, torch.Tensor):
            queries = np.asarray(queries, dtype=np.float32)
            q_mask = np.asarray(q_mask, dtype=bool)
        self._q_rows = queries.shape[0]
        pad = (-self._q_rows) % self.dp
        queries, q_mask = _pad_rows(queries, pad), _pad_rows(q_mask, pad)
        self.q_pad = queries.shape[0]
        self._q_lo, hi = query_rows(mesh, self.q_pad)
        self.queries = M._f32(queries[self._q_lo:hi], self.device)
        self.q_mask = M._mask(q_mask[self._q_lo:hi], self.device)
        q_local = hi - self._q_lo
        self.state = (torch.full((q_local, k), -_INF, device=self.device),
                      torch.zeros((q_local, k), dtype=torch.int32,
                                  device=self.device))
        self._seen = 0
        self._tile_docs = None
        self.escalated_tiles = 0
        self.repaired_rows = 0

    def _engine(self, shard_docs: int, tq: int, plan_ok: bool,
                dim: int) -> str:
        return _shard_engine(self._engine_req, shard_docs, tq, plan_ok, dim,
                             self.device)

    def _gather_q(self, t):
        """This rank's rows of a per-query vector -> the mesh-wide vector
        on the host (the mp copies are equal; dp lines are stacked)."""
        return _gather_rows(self.mesh, t).cpu().numpy()

    def update(self, doc_tile, tile_mask, offset: int | None = None,
               n_valid: int | None = None) -> None:
        """Fold one (tile, Td, d) doc tile. `n_valid` < tile rows marks the
        tile's trailing rows as padding."""
        if offset is None:
            offset = self._seen
        assert offset == self._seen, \
            "doc tiles must arrive in ascending contiguous offset order"
        rows = doc_tile.shape[0]
        n = rows if n_valid is None else n_valid
        if self._tile_docs is None or rows > self._tile_docs:
            # pad tiles to the widest seen so every tile keeps one shard
            # shape (the policy of ShardedStreamingKNN)
            self._tile_docs = -(-rows // self.mp) * self.mp
        shard_docs = self._tile_docs // self.mp
        lo = self.mesh.mp_rank * shard_docs
        doc_tile = doc_tile[min(lo, rows):min(lo + shard_docs, rows)]
        tile_mask = tile_mask[min(lo, rows):min(lo + shard_docs, rows)]
        pad = shard_docs - doc_tile.shape[0]
        t_local = M._f32(_pad_rows(doc_tile, pad), self.device)
        m_local = M._mask(_pad_rows(tile_mask, pad), self.device)
        td, dim = t_local.shape[1], t_local.shape[2]
        # STATIC per-shard selection width: a width from the dynamic
        # min(k, n) crashed ragged tiles in the JAX package
        kk_shard = min(self.k, shard_docs)
        used_idx = self._ctrl.tier_idx if self._adaptive else 0
        used_tier = (self._ctrl.tier_arg if self._adaptive
                     else self.screen_precision)
        m, block, plan_ok = M.maxsim_screen_plan(
            shard_docs, kk_shard, td, dim, passes=PASSES[used_tier])
        engine = self._engine(shard_docs, self.queries.shape[1], plan_ok,
                              dim)
        # a shard with fewer valid docs than kk cannot prove its
        # certificate (tau = -inf padding -> every query fails): shard
        # validity falls with the shard index, so when the LAST shard
        # cannot fill kk the tile runs on the exact mesh path instead
        tail_valid = min(shard_docs, max(0, n - (self.mp - 1) * shard_docs))
        if engine == "screened" and tail_valid < kk_shard:
            engine = "exact"

        want_diag = self._adaptive and engine == "screened"
        out = _sharded_maxsim_tile(
            self.mesh, self.queries, self.q_mask, t_local, m_local, offset,
            n, self.k, engine, m, block, screen_precision=used_tier,
            with_diagnostics=want_diag, precision=self.precision)
        ts, ti, fail = out[:3]
        if engine == "screened":
            fail_h = self._gather_q(fail)
            if want_diag:
                # the controller sees the tier that actually ran, before
                # any escalation
                pf_h = self._gather_q(out[3])
                diag = np.array([int(fail_h.sum()), int(pf_h[:, 0].sum()),
                                 int(pf_h[:, 1].sum())])
                self._ctrl.observe(diag, used_idx, fail_h.shape[0])
            if (used_tier != "high"
                    and fail_h.sum() > max(4, fail_h.shape[0] // 20)):
                # the sub-high escalation of maxsim_topk_screened: run the
                # whole tile again at the 3-pass screen (for every query:
                # a dynamic failed subset would change shapes per tile)
                # and replace the failed rows; what still fails takes the
                # exact repair below. The re-run keeps this tier's merge
                # width and block, as the JAX package does.
                ts2, ti2, fail2 = _sharded_maxsim_tile(
                    self.mesh, self.queries, self.q_mask, t_local, m_local,
                    offset, n, self.k, engine, m, block,
                    screen_precision="high")
                ts = torch.where(fail[:, None], ts2, ts)
                ti = torch.where(fail[:, None], ti2, ti)
                fail = fail2
                fail_h = self._gather_q(fail)
                self.escalated_tiles += 1
            if fail_h.any():
                self.repaired_rows += int(fail_h.sum())
                ts, ti = self._repair(ts, ti, fail, t_local, m_local, offset,
                                      n, lo)
        if ts.shape[1] < self.k:
            pad_k = self.k - ts.shape[1]
            ts = torch.cat([ts, ts.new_full((ts.shape[0], pad_k), -_INF)], 1)
            ti = torch.cat([ti, ti.new_zeros((ti.shape[0], pad_k))], 1)
        md, mi = merge_topk(-self.state[0], self.state[1], -ts, ti, self.k)
        self.state = (-md, mi)
        self._seen += n

    def _repair(self, ts, ti, fail, t_local, m_local, offset: int, n: int,
                lo: int):
        """Exact recompute of this rank's failed queries: each rank scores
        them against its own shard's real docs, the partial lists merge
        over the mp line (ties by ascending doc id, as a whole-tile
        maxsim_topk), and the result REPLACES the rows (a merge would count
        docs present in both lists twice). A ragged tile may hold fewer
        docs than the width: the row is then the exact top-min(width, n)
        padded with -inf, which never survives the fold."""
        bad = torch.nonzero(fail)[:, 0]
        if not len(bad):           # this dp line's queries all certified
            return ts, ti
        kk = min(ts.shape[1], n)
        local_real = min(max(n - lo, 0), t_local.shape[0])
        kk_p = min(kk, max(local_real, 1))
        s_p = torch.full((len(bad), kk), -_INF, device=ts.device)
        i_p = torch.zeros((len(bad), kk), dtype=torch.int32, device=ts.device)
        if local_real:
            s_l, i_l = M._exact_topk(self.queries[bad], self.q_mask[bad],
                                     t_local[:local_real],
                                     m_local[:local_real], kk_p, 2048,
                                     self.precision)
            s_p[:, :kk_p] = s_l
            i_p[:, :kk_p] = i_l + offset + lo
        s_f, i_f = merge_partial_topk_desc(
            all_gather(self.mesh, s_p, MP_AXIS).cpu().numpy(),
            all_gather(self.mesh, i_p, MP_AXIS).cpu().numpy(), kk)
        ts, ti = ts.clone(), ti.clone()
        ts[bad] = -_INF
        ti[bad] = 0
        ts[bad, :kk] = torch.as_tensor(s_f, device=ts.device)
        ti[bad, :kk] = torch.as_tensor(i_f, device=ts.device)
        return ts, ti

    @property
    def docs_seen(self) -> int:
        return self._seen

    @property
    def _tier_idx(self) -> int:
        """Current adaptive ladder level; 0 = "high". Always 0 when a
        fixed tier was requested."""
        return self._ctrl.tier_idx if self._adaptive else 0

    def force_state(self, state) -> None:
        """Backpressure: one 4-byte read of this rank's `state`."""
        state[0][:1, :1].cpu()

    def state_arrays(self):
        """(scores, idx, seen) as host arrays, whole on every rank (a
        collective): the streaming checkpoint, padded query rows included,
        in the JAX package's layout."""
        return (_gather_rows(self.mesh, self.state[0]).cpu().numpy(),
                _gather_rows(self.mesh, self.state[1]).cpu().numpy(),
                self._seen)

    def restore(self, scores, idx, seen: int) -> None:
        expect = (self.q_pad, self.k)
        if tuple(scores.shape) != expect or tuple(idx.shape) != expect:
            raise ValueError(f"checkpoint state {tuple(scores.shape)} / "
                             f"{tuple(idx.shape)} does not match this "
                             f"mesh's padded state {expect}")
        lo, hi = query_rows(self.mesh, self.q_pad)
        self.state = (
            torch.as_tensor(np.asarray(scores[lo:hi], dtype=np.float32),
                            device=self.device),
            torch.as_tensor(np.asarray(idx[lo:hi], dtype=np.int32),
                            device=self.device))
        self._seen = int(seen)

    def finalize(self):
        """(scores desc, doc indices) as numpy, the original query rows
        only, whole on every rank."""
        assert self._seen >= self.k, \
            f"saw only {self._seen} base docs but k={self.k}"
        s, i, _ = self.state_arrays()
        return s[: self._q_rows], i[: self._q_rows]
