"""Batched ColBERT MaxSim scoring (counterpart of ops/maxsim.py).

    score(q, doc) = sum_{i in q tokens} max_{j in doc tokens} <q_i, d_j>

- "exact": MaxSim scores per document tile (`maxsim_scores`: on the card
  M1, ops/maxsim_fused.py, the products and the max/sum reductions in one
  kernel; on the CPU a matmul and the reductions op by op), a per-tile
  top-k and a running merge (lowest position wins ties).
- "screened": the fused screen kernel (ops/maxsim_kernel.py) keeps the 4
  best packed keys per lane bin, the merged candidates are re-ranked
  exactly in fp32 (M2, read by id on the card), and per-query bin +
  count certificates prove the result exact. Bin collisions with an
  intact count certificate are repaired by re-ranking the suspicious
  bins' members (class A); what remains escalates to the 3-pass screen
  and from there to the exact engine. The eps math is a line-for-line
  port of the JAX engine.
- "auto" picks "screened" for CUDA tensors when the tile holds >= 4096 docs
  and the kernel takes the shape, "exact" otherwise (and always on the
  CPU). engine="screened" on CPU tensors runs the kernel's plain version.

Inputs are padded token tensors + token masks:
  queries:  (Q, Tq, d) with q_mask (Q, Tq)
  docs:     (D, Td, d) with d_mask (D, Td)

Host syncs: the JAX engine's lazy `lax.cond` repair becomes a Python `if`
on a count that reaches the host in the same single device-to-host copy as
the `ok` certificate vector and the tier prediction: one copy per
maxsim_topk_screened call (plus one per escalation).
"""

import sys
import types

import numpy as np
import torch

from neighborhoodwatch_tpu_torch import resolve_device
from neighborhoodwatch_tpu_torch.ops import maxsim_fused
from neighborhoodwatch_tpu_torch.ops import maxsim_kernel as mk
from neighborhoodwatch_tpu_torch.ops.knn import (
    REPAIR_BINS, _chernoff_budget, _first_rows, _merge_select,
    _check_precision, _smallest_k,
)
from neighborhoodwatch_tpu_torch.ops.screen_kernel import LANES, PASSES
from neighborhoodwatch_tpu_torch.ops.topk import merge_topk, smallest_k
from neighborhoodwatch_tpu_torch.utils.misc import round_up

NEG = maxsim_fused.NEG
_INF = float("inf")
# what the screened engine did, for the smoke run and the tests to read:
# device-to-host copies made by the select, queries repaired from their
# bins (class A), queries escalated to the 3-pass screen, queries sent to
# the exact engine
counts = types.SimpleNamespace(host_copies=0, repaired=0, escalated=0,
                               exact_fallbacks=0)
# smallest tile for which "auto" takes the screened engine
SCREEN_MIN_DOCS = 4096


def _f32(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)


def _mask(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.bool)
    return torch.as_tensor(np.asarray(x, dtype=bool), device=device)


def _scalar(value, like):
    return torch.full((), value, device=like.device, dtype=like.dtype)


def maxsim_scores(queries, q_mask, docs, d_mask, precision: str = "highest"):
    """Dense MaxSim scores (Q, D) of tensors on one device, the token
    products at `precision` (ops/distance.py), fp32 sums and maxima.
    A doc whose score is NaN (inf/NaN garbage tokens) scores NEG, so it
    loses in every engine, like the screen's NaN -> +inf key. On the card
    one launch of M1 (ops/maxsim_fused.py), on the CPU its plain version."""
    return maxsim_fused.maxsim_dense(queries, q_mask, docs, d_mask,
                                     precision)


def pad_token_lists(token_lists, dim, max_tokens=None):
    """[(t_i, d)] -> ((N, T, d) padded array, (N, T) bool mask), numpy."""
    if max_tokens is None:
        max_tokens = max((len(t) for t in token_lists), default=1)
        max_tokens = round_up(max(max_tokens, 1), 8)
    n = len(token_lists)
    out = np.zeros((n, max_tokens, dim), dtype=np.float32)
    mask = np.zeros((n, max_tokens), dtype=bool)
    for i, toks in enumerate(token_lists):
        t = min(len(toks), max_tokens)
        if t:
            out[i, :t] = np.asarray(toks)[:t]
            mask[i, :t] = True
    return out, mask


def _maxsim_tile_step(run_s, run_i, queries, q_mask, tile, tmask, start: int,
                      n_docs: int, k: int, precision: str = "highest"):
    """Fold one doc tile into the running (scores desc, ids) top-k; tile
    rows at or past n_docs - start are padding."""
    tile_docs = tile.shape[0]
    scores = maxsim_scores(queries, q_mask, tile, tmask, precision)
    valid = torch.arange(tile_docs, device=tile.device) + start < n_docs
    scores = torch.where(valid[None, :], scores, _scalar(-_INF, scores))
    # larger score is better: negate into the smaller-is-better selection
    # (lowest position wins ties; K7 on the card, the stable sort on the
    # CPU). The scores carry no NaN: maxsim_scores maps it to NEG
    td_, ti = _smallest_k(-scores, min(k, tile_docs))
    ti = (ti + start).to(torch.int32)
    # the running list first: on ties the earlier (lower) doc ids win
    md, sel = _smallest_k(torch.cat([-run_s, td_], dim=1), k)
    mi = torch.gather(torch.cat([run_i, ti], dim=1), 1, sel)
    return -md, mi.to(torch.int32)


def maxsim_kernel_shape_ok(tq: int, dim: int, device) -> bool:
    """Device + shape gates of the fused MaxSim kernel: CUDA tensors, at
    most 32 query tokens, token dim <= 128 or a multiple of 128; doc token
    counts are unbounded. The JAX package's gate is TPU-only and would
    never pick the kernel here."""
    return (torch.device(device).type == "cuda"
            and tq <= mk.MAX_QUERY_TOKENS
            and (dim <= LANES or dim % LANES == 0))


def _maxsim_engine(engine: str, n_docs: int, tq: int, dim: int,
                   device) -> str:
    """Resolve "auto"; unknown names raise (a typo silently coerced to
    the slower exact path would run the wrong engine)."""
    if engine not in ("auto", "exact", "screened"):
        raise ValueError(f"unknown engine {engine!r}; expected one of "
                         f"auto/exact/screened")
    if engine != "auto":
        return engine
    if n_docs >= SCREEN_MIN_DOCS and maxsim_kernel_shape_ok(tq, dim, device):
        return "screened"
    return "exact"


def _exact_topk(queries, q_mask, docs, d_mask, k: int, tile_docs: int,
                precision: str = "highest"):
    n_docs = docs.shape[0]
    q_n = queries.shape[0]
    run_s = torch.full((q_n, k), -_INF, device=queries.device)
    run_i = torch.zeros((q_n, k), dtype=torch.int32, device=queries.device)
    for start in range(0, n_docs, tile_docs):
        run_s, run_i = _maxsim_tile_step(
            run_s, run_i, queries, q_mask, docs[start:start + tile_docs],
            d_mask[start:start + tile_docs], start, n_docs, k, precision)
    return run_s, run_i


def maxsim_topk(queries, q_mask, docs, d_mask, k: int,
                precision: str = "highest", tile_docs: int = 128,
                engine: str = "exact", screen_precision: str = "high",
                device=None):
    """Top-k documents per query by MaxSim score: (scores desc, doc ids
    int32) tensors on `device` (None = "cuda"; raises without a card unless
    device="cpu"), exact with every engine. engine="auto" takes the fused
    screen kernel for CUDA tensors when the shape fits; `screen_precision`
    then picks its pass tier (see maxsim_topk_screened). The exact path
    walks `tile_docs`-doc tiles with a running top-k, its products at
    `precision` ("default", "high" or "highest"; ops/distance.py); the
    screened engine re-ranks in fp32 whatever it is."""
    dev = resolve_device(device)
    _check_precision(precision)
    queries, docs = _f32(queries, dev), _f32(docs, dev)
    q_mask, d_mask = _mask(q_mask, dev), _mask(d_mask, dev)
    engine = _maxsim_engine(engine, docs.shape[0], queries.shape[1],
                            docs.shape[-1], dev)
    if engine == "screened":
        return maxsim_topk_screened(queries, q_mask, docs, d_mask, k,
                                    screen_precision=screen_precision,
                                    device=dev)
    assert k <= docs.shape[0]
    return _exact_topk(queries, q_mask, docs, d_mask, k, tile_docs,
                       precision)


def _maxsim_tier_eps(queries, q_mask, q_scale, d_max, dlo_max, rerank_acc,
                     g_sum, dim: int, passes: int):
    """Per-query screening-error bound of a `passes`-pass MaxSim screen on
    the score scale: one definition shared by the certificate and the
    adaptive tier probe (which evaluates it for tiers other than the one
    that ran)."""
    if passes >= 3:
        # bf16x3 residual + worst-case fp32 accumulation + quantization
        return mk.maxsim_eps3_rel(dim) * q_scale * d_max + rerank_acc
    # 2-pass drops q_t . d_lo,s: per token <= |q_t| * max||d_lo||, from the
    # data, plus the q-side double rounding (the kernel ships bf16(q_lo));
    # + worst-case fp32 accumulation and key quantization
    eps = q_scale * dlo_max + rerank_acc \
        + (mk.maxsim_acc_rel(dim) + mk.PACK_EPS_REL) * q_scale * d_max
    qhi = mk.bf16_round(queries)
    qlo = queries - qhi                        # exact (Sterbenz)
    if passes == 1:
        qres = qlo                             # drops q_lo . d_hi whole
    else:
        qres = qlo - mk.bf16_round(qlo)
    qres_n = torch.linalg.vector_norm(qres, dim=2)
    qres_scale = torch.where(q_mask, qres_n, _scalar(0.0, qres_n)).sum(1) \
        * g_sum
    # ||d_hi|| <= (1 + 2^-8) ||d||
    return eps + qres_scale * 1.004 * d_max


def _maxsim_select(queries, q_mask, docs, d_mask, cand_neg, cand_doc,
                   k: int, m: int, block: int = 128, passes: int = 3,
                   doc_stats=None, with_diagnostics: bool = False):
    """Top-M merge of screened MaxSim candidates + exact fp32 re-rank +
    exactness certificate + class-A repair (certificate failures with an
    intact count certificate are repaired by exactly re-ranking the
    suspicious bins' members, so those rows return ok=True without the
    caller's fallback). Returns (scores desc, doc ids, ok) with `ok` a
    host bool tensor; `with_diagnostics=True` adds a host (Q, 2) bool
    prediction of per-query certificate failure at the cheaper tiers
    [medium, default], evaluated from this screen's candidates with each
    tier's own eps: a query is predicted to fail when its eps band would
    overflow 3/4 of the merge width m or flag more than REPAIR_BINS bins.
    The prediction routes the adaptive stream controller and is never an
    exactness input; the caller's doc_stats must then carry a real dlo_max
    (screen_maxsim(..., want_dlo_stat=True)).

    `ok`, the prediction and the count that decides whether the repair
    runs reach the host in ONE device-to-host copy."""
    q_count, tq, dim = queries.shape
    n_docs = docs.shape[0]
    keep, lanes = mk.KEEP, mk.LANES
    dev = queries.device
    n4 = cand_neg.reshape(q_count, -1, keep, lanes)
    d4 = cand_doc.reshape(q_count, -1, keep, lanes)
    cert_last = n4[:, :, keep - 1, :]
    merge_n = n4[:, :, : keep - 1, :].reshape(q_count, -1)
    merge_d = d4[:, :, : keep - 1, :].reshape(q_count, -1)

    scr, doc_m = _merge_select(merge_n, merge_d, m)
    doc_m = torch.clamp_max(doc_m, n_docs - 1)   # last mega decodes past D

    # exact fp32 scores of each query's own candidates (M2 on the card, read
    # by id; the plain version gathers `block` queries' candidates at once)
    s_exact = maxsim_fused.maxsim_pairs(queries, q_mask, docs, d_mask, doc_m,
                                        block=block)
    # huge negated screen values are padding bins/docs, never candidates
    s_exact = torch.where(scr > 1e29, _scalar(-_INF, s_exact), s_exact)

    neg_k, selk = smallest_k(-s_exact, k)
    sk = -neg_k
    doc_k = torch.gather(doc_m, 1, selk)
    tau = sk[:, k - 1]

    # per-query screening error bound on the score scale: score = sum_t
    # max_s <q_t, d_s> and |max a - max b| <= max|a - b|, so the per-token
    # dot error bounds sum over the valid query tokens. Every computed norm
    # carries the worst-case fp32 accumulation guard; the q-side scales are
    # sums of up to tq norms, so their guard budgets that sum too
    g_sum = mk.norm_guard(dim + 2 * tq)
    q_norms = torch.linalg.vector_norm(queries, dim=2)
    q_scale = torch.where(q_mask, q_norms, _scalar(0.0, q_norms)).sum(1) \
        * g_sum
    if doc_stats is None:
        doc_stats = mk.doc_cert_stats(docs, d_mask, dim,
                                      need_dlo=passes < 3
                                      or with_diagnostics)
    d_max, dlo_max = doc_stats[0], doc_stats[1]
    d_max = torch.clamp_min(d_max, 1e-6)
    # the re-rank recomputes every candidate score with its own fp32
    # accumulation: one extra maxsim_acc_rel on the score scale
    rerank_acc = mk.maxsim_acc_rel(dim) * q_scale * d_max
    eps = _maxsim_tier_eps(queries, q_mask, q_scale, d_max, dlo_max,
                           rerank_acc, g_sum, dim, passes)
    thresh = (-tau + eps)[:, None]

    cert_bins = cert_last.amin(dim=(1, 2)) >= thresh[:, 0]
    c_all = (merge_n < thresh).sum(1)
    c_sel = (scr < thresh).sum(1)
    cert_merge = c_all == c_sel
    ok = cert_bins & cert_merge

    # ---- class-A repair: exact re-rank of suspicious bins ----
    # When the count certificate holds, every candidate below thresh
    # outside the suspicious bins was merged and re-ranked exactly, and the
    # bin certificate proves the other bins' unkept members score beyond
    # the band, so the true top-k lies in (returned top-k) U (members of
    # the suspicious bins). A bin's members are its mega's docs with
    # id % 128 == lane (64 of them). Queries the repair cannot prove (count
    # failures, > REPAIR_BINS collisions, budget overflow) keep ok=False.
    # A NaN thresh makes every comparison False: such a query must keep
    # ok=False, never be "repaired" from zero bins.
    fail = ~ok
    sflat = (cert_last < thresh[:, :, None]).reshape(q_count, -1)
    n_susp = sflat.sum(1)
    binfix = fail & torch.isfinite(thresh[:, 0]) & cert_merge \
        & (n_susp <= REPAIR_BINS)
    # bin collisions are band-occupancy events, so one conservative rate
    # sizes every tier's budget
    na = _chernoff_budget(q_count, 0.05, k)
    rows_a = _first_rows(binfix, na)
    take_a = binfix[rows_a]
    # rows_a holds only the first na flagged queries; anything past the
    # budget keeps ok=False and escalates
    repaired = torch.zeros_like(binfix)
    repaired[rows_a] = take_a
    ok = ok | repaired

    pred = None
    if with_diagnostics:
        # ---- adaptive-tier probe: predicted failure at cheaper tiers ----
        # band occupancy (vs 3/4 of the merge width) and flagged-bin count
        # (vs REPAIR_BINS) are the two statistics whose overflow makes a
        # sub-high tier escalate. A NaN thresh predicts failure.
        preds = []
        for p in (2, 1):
            eps_p = _maxsim_tier_eps(queries, q_mask, q_scale, d_max,
                                     dlo_max, rerank_acc, g_sum, dim, p)
            thr_p = (-tau + eps_p)[:, None]
            band_p = (merge_n < thr_p).sum(1)
            susp_p = (cert_last < thr_p[:, :, None]).sum(dim=(1, 2))
            pfail = (band_p > (3 * m) // 4) | (susp_p > REPAIR_BINS)
            preds.append(pfail | ~torch.isfinite(thr_p[:, 0]))
        pred = torch.stack(preds, dim=1)

    # the one device-to-host copy of the call
    parts = [ok.to(torch.int32), take_a.sum().to(torch.int32)[None]]
    if pred is not None:
        parts.append(pred.reshape(-1).to(torch.int32))
    host = torch.cat(parts).cpu()
    counts.host_copies += 1
    ok_host = host[:q_count].bool()
    n_take = int(host[q_count])
    pred_host = host[q_count + 1:].reshape(q_count, 2).bool() \
        if pred is not None else None

    if n_take:
        counts.repaired += n_take
        # flagged rows come first in rows_a: repair exactly those
        rows = rows_a[:n_take]
        members = mk.MEGA_DOCS // lanes               # 64 docs per bin
        w = REPAIR_BINS * members
        bins_a = _first_rows(sflat[rows], REPAIR_BINS)   # (n, S)
        mega_a = bins_a // lanes
        lane_a = bins_a % lanes
        step = torch.arange(members, device=dev)
        rg = (mega_a[..., None] * mk.MEGA_DOCS + step[None, None, :] * lanes
              + lane_a[..., None]).reshape(n_take, w)
        valid = rg < n_docs          # the last mega's decode runs past D
        rgc = torch.clamp_max(rg, n_docs - 1)
        # the bins' members scored by id (M2 on the card; the plain version
        # bounds its gather at ~256 MB)
        sc = maxsim_fused.maxsim_pairs(queries[rows], q_mask[rows], docs,
                                       d_mask, rgc)
        # NaN scores and phantom rows must lose: the repair pulls bin rows
        # by position, so the screen's NaN handling never saw them
        keep_s = valid & ~torch.isnan(sc)
        s_bin = torch.where(keep_s, sc, _scalar(-_INF, sc))
        # dedup: a returned top-k doc living in a gathered bin has its
        # exact score in s_bin already
        sk_a = sk[rows]
        dk_a = doc_k[rows]
        binid_k = (dk_a // mk.MEGA_DOCS) * lanes + (dk_a % lanes)
        dup = (binid_k[:, :, None] == bins_a[:, None, :]).any(2)
        sk_a = torch.where(dup, _scalar(-_INF, sk_a), sk_a)
        neg_new, sel2 = smallest_k(-torch.cat([sk_a, s_bin], dim=1), k)
        d_new = torch.gather(torch.cat([dk_a, rgc.to(dk_a.dtype)], dim=1),
                             1, sel2)
        sk[rows] = -neg_new
        doc_k[rows] = d_new

    if with_diagnostics:
        return sk, doc_k, ok_host, pred_host
    return sk, doc_k, ok_host




def maxsim_bin_cap(n_docs: int) -> int:
    """Merge capacity of the MaxSim screen's candidate bins (excludes the
    certificate slab, 1 of KEEP per mega): the one definition shared by
    maxsim_screen_plan and maxsim_topk_screened."""
    return (-(-n_docs // mk.MEGA_DOCS)) * mk.LANES * (mk.KEEP - 1)


def resolve_maxsim_tier(screen_precision: str) -> str:
    """Resolve the tier knob for a SINGLE MaxSim call. "auto" means "high"
    here: with the sound eps only the 3-pass certificate holds on
    concentrated MaxSim score distributions, and a one-shot call has no
    batch history to learn from. The streaming accumulator treats "auto"
    adaptively instead (MaxSimTierController)."""
    return "high" if screen_precision == "auto" else screen_precision


# adaptive-stream ladder, SAFEST first (index 0 = the tier that always
# certifies); downshifts move right, re-escalations move left. Inverted
# against ops.knn.SCREEN_TIER_AUTO_LADDER: kNN's 1-pass certificates hold
# on realistic corpora (start cheap, escalate on repairs), MaxSim's
# concentrate and fail (start safe, downshift only when the high-tier
# probe says the cheap band is sparse).
MAXSIM_TIER_LADDER = ("high", "medium", "default")


class MaxSimTierController:
    """Adaptive screen-tier state for StreamingMaxSim, the MaxSim
    counterpart of ops.knn.ScreenTierController with the inverted ladder.

    Every batch screened with diagnostics yields (a) the realized
    certificate-failure count at the tier that ran and (b) per-query
    predicted failure at the two cheaper tiers. The controller downshifts
    to the cheapest tier predicted clean for DOWN_AFTER consecutive
    batches, and re-escalates when realized failures exceed FAIL_FRAC of
    the queries: one rung, or straight to "high" past JUMP_FRAC. Each
    re-escalation doubles the streak required before the next downshift
    (capped), so a persistently marginal corpus converges to the safe tier
    instead of thrashing. Every tier is exact: tier moves only price the
    repair work. The thresholds are the JAX package's, kept for parity."""

    DOWN_AFTER = 2
    FAIL_FRAC = 0.25
    JUMP_FRAC = 0.60
    MAX_DOWN_AFTER = 32

    def __init__(self):
        self.tier_idx = 0
        self._streak = 0
        self._target = 0
        self._down_need = self.DOWN_AFTER

    @property
    def tier_arg(self) -> str:
        return MAXSIM_TIER_LADDER[self.tier_idx]

    def observe(self, diag, diag_idx: int, q_rows: int) -> None:
        """Fold one batch's diagnostics, taken at ladder level `diag_idx`:
        diag = (n_fail_realized, pred_fail_medium, pred_fail_default)
        query counts."""
        if diag_idx != self.tier_idx:
            self._streak = 0
            return
        n_fail, pred_med, pred_low = (int(x) for x in np.asarray(diag))
        if self.tier_idx > 0 and n_fail > max(1, int(q_rows
                                                     * self.FAIL_FRAC)):
            if n_fail > q_rows * self.JUMP_FRAC:
                self.tier_idx = 0          # wholesale failure: go safe
            else:
                self.tier_idx -= 1
            self._streak = 0
            self._down_need = min(self.MAX_DOWN_AFTER, 2 * self._down_need)
            print(f"  [maxsim tier] re-escalating to "
                  f"'{MAXSIM_TIER_LADDER[self.tier_idx]}' "
                  f"({n_fail}/{q_rows} certificates failed; the failed "
                  f"queries were repaired exactly via escalation)",
                  file=sys.stderr)
            return
        # cheapest tier predicted clean (within the per-batch tolerance)
        tol = max(1, q_rows // 50)
        target = self.tier_idx
        if pred_med <= tol:
            target = max(target, 1)
        if pred_low <= tol:
            target = max(target, 2)
        if target <= self.tier_idx:
            self._streak = 0
            return
        self._streak = self._streak + 1 if target == self._target else 1
        self._target = target
        if self._streak >= self._down_need:
            self.tier_idx = target
            self._streak = 0
            print(f"  [maxsim tier] downshifting to "
                  f"'{MAXSIM_TIER_LADDER[self.tier_idx]}' (the cheap-tier "
                  f"eps band held for {self._down_need} consecutive "
                  f"batches) — exactness unaffected", file=sys.stderr)


def maxsim_screen_plan(n_docs: int, k: int, td: int, dim: int,
                       passes: int = 2):
    """Static merge-width/block plan for the screened MaxSim select.
    Returns (m, block, ok): ok=False means the screen cannot represent k
    candidates (k > bin capacity) or even the smallest re-rank gather
    exceeds the ~256 MB buffer budget (very long docs), and the caller
    must use the exact engine. MaxSim scores concentrate (a sum of tq
    per-token maxima), so one width serves every tier: sub-high tiers stay
    available for corpora with wider score gaps and escalate failed
    queries, never silently. The widths are the JAX package's."""
    cap = maxsim_bin_cap(n_docs)
    del passes  # one width for every tier (see docstring)
    m = max(256, round_up(k + 156, 128))
    m = min(max(m, k), cap)
    budget = 1 << 28
    per_cand = td * dim * 4
    block = 128
    while block > 8 and block * m * per_cand > budget:
        block //= 2
    m_floor = min(max(k, 128), cap)
    while m > m_floor and block * m * per_cand > budget:
        m = max(m_floor, m - 128)
    ok = (cap >= k) and (block * m * per_cand <= budget)
    return m, block, ok


def maxsim_topk_screened(queries, q_mask, docs, d_mask, k: int,
                         m: int | None = None,
                         screen_precision: str = "high",
                         with_diagnostics: bool = False, device=None):
    """Exact top-k documents by MaxSim via the fused screen kernel
    (ops/maxsim_kernel.py) + certified fp32 re-rank. `screen_precision`
    trades tensor-core passes against certificate margin (high/medium/
    default = 3/2/1); every tier is exact via the certificates + repair.

    Bin collisions with an intact count certificate are repaired inside
    _maxsim_select. Remaining failed queries at a sub-high tier escalate
    to the 3-pass screen; residual 3-pass failures (count overflows,
    > REPAIR_BINS collisions) fall back to the exact engine.

    Returns (scores desc, doc ids int32) tensors on `device`.
    `with_diagnostics=True` returns (scores, idx, diag) where diag is a
    host (3,) int array (realized certificate failures, predicted failures
    at the medium tier, predicted failures at the default tier) for the
    adaptive stream controller, or None when the screen could not run at
    all (maxsim_screen_plan said no). It costs one extra doc-residual
    statistic pass and no extra host copy."""
    dev = resolve_device(device)
    screen_precision = resolve_maxsim_tier(screen_precision)
    passes = PASSES[screen_precision]
    queries, docs = _f32(queries, dev), _f32(docs, dev)
    q_mask, d_mask = _mask(q_mask, dev), _mask(d_mask, dev)
    n_docs = docs.shape[0]
    assert k <= n_docs

    plan_m, block, plan_ok = maxsim_screen_plan(
        n_docs, k, docs.shape[1], docs.shape[2], passes=passes)
    if not plan_ok:   # k unrepresentable / gather unaffordable -> exact
        s, i = _exact_topk(queries, q_mask, docs, d_mask, k, 2048)
        return (s, i, None) if with_diagnostics else (s, i)
    if m is None:
        m = plan_m
    m = min(max(m, k), maxsim_bin_cap(n_docs))

    cand_neg, cand_doc, _, doc_stats = mk.screen_maxsim(
        queries, q_mask, docs, d_mask, screen_precision=screen_precision,
        want_dlo_stat=with_diagnostics)
    out = _maxsim_select(queries, q_mask, docs, d_mask, cand_neg, cand_doc,
                         k, m, block=block, passes=passes,
                         doc_stats=doc_stats,
                         with_diagnostics=with_diagnostics)
    scores, idx, ok = out[:3]
    idx = idx.to(torch.int32)
    bad = torch.nonzero(~ok)[:, 0]
    if len(bad):
        bad = bad.to(dev)
        if screen_precision != "high":
            # escalate to the 3-pass screen: cheaper than the exact
            # engine, and exact itself (certificate + exact fallback)
            s_f, i_f = maxsim_topk_screened(
                queries[bad], q_mask[bad], docs, d_mask, k=k, m=m,
                screen_precision="high", device=dev)
            counts.escalated += len(bad)
        else:
            s_f, i_f = _exact_topk(queries[bad], q_mask[bad], docs, d_mask,
                                   k, 2048)
            counts.exact_fallbacks += len(bad)
        scores[bad] = s_f
        idx[bad] = i_f
    if with_diagnostics:
        pf = out[3].numpy()
        diag = np.array([int((~ok).sum()), int(pf[:, 0].sum()),
                         int(pf[:, 1].sum())], dtype=np.int64)
        return scores, idx, diag
    return scores, idx




class StreamingMaxSim:
    """Running top-k of document MaxSim scores over streamed doc tiles:
    the doc-level analog of ops.knn.StreamingKNN. Feed padded
    (tile, Td, d) token tensors in ascending doc-offset order; the
    (score, idx) state stays on `device`."""

    def __init__(self, queries, q_mask, k: int, precision: str = "highest",
                 engine: str = "auto", screen_precision: str = "auto",
                 device=None):
        # "auto" on a STREAM is adaptive (MaxSimTierController): start at
        # the always-certifying 3-pass tier, downshift when the batches'
        # diagnostics predict a cheaper tier certifies, re-escalate on
        # realized failures. Every tier is exact.
        self.device = resolve_device(device)
        _check_precision(precision)
        self._adaptive = screen_precision == "auto"
        self._ctrl = MaxSimTierController() if self._adaptive else None
        self.queries = _f32(queries, self.device)
        self.q_mask = _mask(q_mask, self.device)
        self.k = k
        self.precision = precision
        self.engine = engine
        self.screen_precision = resolve_maxsim_tier(screen_precision)
        q_n = self.queries.shape[0]
        self.state = (torch.full((q_n, k), -_INF, device=self.device),
                      torch.zeros((q_n, k), dtype=torch.int32,
                                  device=self.device))
        self._seen = 0

    def update(self, doc_tile, tile_mask, offset: int | None = None,
               n_valid: int | None = None) -> None:
        """Merge one (tile, Td, d) doc tile. `n_valid` < tile rows marks
        trailing padding rows invalid, for every engine."""
        if offset is None:
            offset = self._seen
        assert offset == self._seen, \
            "doc tiles must arrive in ascending contiguous offset order"
        doc_tile = _f32(doc_tile, self.device)
        tile_mask = _mask(tile_mask, self.device)
        n = doc_tile.shape[0] if n_valid is None else n_valid
        if n < doc_tile.shape[0]:
            # the screened branch has no n_docs cutoff: unmasked padding
            # rows would score for real and alias the next tile's doc ids
            tile_mask = tile_mask.clone()
            tile_mask[n:] = False
        engine = _maxsim_engine(self.engine, doc_tile.shape[0],
                                self.queries.shape[1], doc_tile.shape[-1],
                                self.device)
        run_s, run_i = self.state
        if engine == "screened":
            kk = min(self.k, n)
            if self._adaptive:
                tier_idx = self._ctrl.tier_idx
                ts, ti, diag = maxsim_topk_screened(
                    self.queries, self.q_mask, doc_tile, tile_mask, k=kk,
                    screen_precision=self._ctrl.tier_arg,
                    with_diagnostics=True, device=self.device)
                if diag is not None:
                    # the diag came with the ok certificate's host copy
                    self._ctrl.observe(diag, tier_idx, self.queries.shape[0])
            else:
                ts, ti = maxsim_topk_screened(
                    self.queries, self.q_mask, doc_tile, tile_mask, k=kk,
                    screen_precision=self.screen_precision,
                    device=self.device)
            ti = (ti + offset).to(torch.int32)
            md, mi = merge_topk(-run_s, run_i, -ts, ti, self.k)
            self.state = (-md, mi)
        else:
            self.state = _maxsim_tile_step(
                run_s, run_i, self.queries, self.q_mask, doc_tile, tile_mask,
                offset, offset + n, self.k, self.precision)
        self._seen += n

    @property
    def docs_seen(self) -> int:
        return self._seen

    @property
    def _tier_idx(self) -> int:
        """Current adaptive ladder level; 0 = "high". Always 0 when a
        fixed tier was requested."""
        return self._ctrl.tier_idx if self._adaptive else 0

    def force_state(self, state) -> None:
        """Backpressure sync (see ops.knn.StreamingKNN.force_state)."""
        state[0][0, 0].item()

    def state_arrays(self):
        """(scores, idx, seen) as host arrays: the streaming checkpoint,
        in the same layout as the JAX accumulator's."""
        return (self.state[0].cpu().numpy(), self.state[1].cpu().numpy(),
                self._seen)

    def restore(self, scores, idx, seen: int) -> None:
        """Resume from a checkpoint taken by `state_arrays` of either
        package (host arrays)."""
        q_n = self.queries.shape[0]
        scores = torch.tensor(np.asarray(scores, dtype=np.float32))
        idx = torch.tensor(np.asarray(idx, dtype=np.int32))
        assert tuple(scores.shape) == (q_n, self.k) == tuple(idx.shape)
        self.state = (scores.to(self.device), idx.to(self.device))
        self._seen = int(seen)

    def finalize(self):
        """(scores desc, doc indices) as numpy."""
        assert self._seen >= self.k, \
            f"saw only {self._seen} base docs but k={self.k}"
        return self.state[0].cpu().numpy(), self.state[1].cpu().numpy()


def maxsim_oracle(queries, q_mask, docs, d_mask, k):
    """float64 numpy reference for tests."""
    q = np.asarray(queries, dtype=np.float64)
    d = np.asarray(docs, dtype=np.float64)
    qm = np.asarray(q_mask, dtype=bool)
    dm = np.asarray(d_mask, dtype=bool)
    q_n = q.shape[0]
    d_n = d.shape[0]
    scores = np.zeros((q_n, d_n))
    for qi in range(q_n):
        for di in range(d_n):
            sims = q[qi] @ d[di].T  # (tq, td)
            sims[:, ~dm[di]] = -np.inf
            per_tok = sims.max(axis=1)
            per_tok[~qm[qi]] = 0.0
            scores[qi, di] = per_tok.sum()
    idx = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(scores, idx, axis=1), idx
