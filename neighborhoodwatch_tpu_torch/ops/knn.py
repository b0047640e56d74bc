"""Exact brute-force k-nearest-neighbor engines (counterpart of ops/knn.py).

- "exact": base tiles of pairwise fp32 distances, a stable per-tile top-k
  and a running merge; the full (Q, B) matrix never materializes.
- "screened": the fused screen kernel (ops/screen_kernel.py) keeps the 4
  smallest packed keys per lane bin, the merged candidates are re-ranked
  exactly in fp32, and a per-query certificate proves the result exact;
  failed queries are repaired (class A: the suspicious bins' members;
  class B: a full rescan; past the class-B budget the whole batch is
  recomputed exactly). The eps math is a line-for-line port of the JAX
  engine, and the TPU-measured constants (_BIN_FLAG_RATE, the merge
  widths, _gather_block) are kept as they are for parity.
- `screened_knn` is the host-repair form of "screened": the same screen,
  select and certificate, then every failed query rescanned exactly.
- "verified": the exact engine's tiles with the per-tile select of
  ops/verified_kernel.py (the hand-written csrc/verified_select.cu on the
  card: candidates, k best, count proof and per-row exact fallback in one
  launch) in place of the stable sort. It returns the exact engine's sets.
- "auto" picks, for CUDA tensors, "screened" when the base holds at least
  _SCREEN_MIN_BASE rows and "verified" below that, and "verified" is the
  fallback engine of the screened paths there, as on the TPU; on the CPU
  "auto" and the fallbacks are "exact", as in the JAX package off the TPU.
- precision ("default", "high", "highest") is the exact and verified
  engines' product precision (ops/distance.py); the screened engines
  re-rank in full fp32 whatever it is.
- The passes XLA fuses in the JAX package's jitted core are hand-written
  kernels on the card (ops/fused_core.py): the base preparation (F1), each
  tile's distance epilogue and mask (F2, on norms computed once per call)
  and the candidates' exact re-rank (F3); the merge's top-m runs on the
  verified select (K7). On the CPU their plain versions run, op by op.

Host syncs: the JAX engine's lazy `lax.cond` branches become Python `if`s
on host values. screened_knn_traced reads the class-A and class-B counts
in ONE device-to-host copy per call; StreamingKNN.update adds none.
"""

import math
import sys
from typing import NamedTuple

import numpy as np
import torch

from neighborhoodwatch_tpu_torch import resolve_device
from neighborhoodwatch_tpu_torch.ops import (
    fused_core, screen_kernel, verified_kernel,
)
from neighborhoodwatch_tpu_torch.ops.distance import (
    PRECISIONS, base_norms, query_operand, tile_distance,
)
from neighborhoodwatch_tpu_torch.ops.topk import merge_topk, smallest_k
from neighborhoodwatch_tpu_torch.utils.misc import cdiv, round_up
from neighborhoodwatch_tpu_torch.utils.profiling import count, recording, span

DEFAULT_TILE = 8192
ENGINES = ("exact", "verified", "screened", "auto")

# minimum base rows for the screened engine to pay off (2 mega-tiles)
_SCREEN_MIN_BASE = 2 * screen_kernel.MEGA

_INF = float("inf")


def _select_engine(engine: str, n_base: int | None,
                   device: torch.device) -> str:
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected one of "
                         f"{'/'.join(ENGINES)}")
    if engine != "auto":
        return engine
    if device.type != "cuda":
        return "exact"
    if n_base is not None and n_base >= _SCREEN_MIN_BASE:
        return "screened"
    return "verified"


def _fallback_engine(device: torch.device) -> str:
    """The scan engine of the screened paths' exact fallbacks: "verified"
    on the card (the JAX package's choice on the TPU), "exact" elsewhere."""
    return "verified" if device.type == "cuda" else "exact"


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)


def _check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; expected one of "
                         f"{'/'.join(PRECISIONS)}")


def _verified_smallest_k(d, k: int):
    """The verified engine's per-tile select (ops/verified_kernel.py):
    ((Q, k) ascending, (Q, k) int64 positions). A k the kernel cannot
    sort in shared memory takes the exact select."""
    if d.device.type == "cuda" and not verified_kernel.supports(d.shape[1],
                                                                k):
        return smallest_k(d, k)
    dist, pos, _ = verified_kernel.verified_select(d, k)
    return dist, pos


def _select(engine: str):
    return _verified_smallest_k if engine == "verified" else smallest_k


def _knn_scan(query, base, n_valid, base_offset, k: int, metric: str,
              tile_size: int, engine: str = "exact",
              precision: str = "highest", bn_row=None):
    """Scan base tiles with a running top-k. Pad-free: the last tile starts
    at B - tile_size (overlapping the previous one) and masks the rows the
    previous tile already covered. Rows >= n_valid are masked. `engine`
    "verified" selects each tile's top-k with the verified select. The
    query's and the base's norms are computed once per call (`bn_row`: the
    base's squared row norms, where the caller has them)."""
    q_count = query.shape[0]
    b_count = base.shape[0]
    assert b_count >= tile_size
    n_tiles = cdiv(b_count, tile_size)
    k_tile = min(k, tile_size)
    dev = query.device
    run_d = torch.full((q_count, k), _INF, device=dev)
    run_i = torch.zeros((q_count, k), dtype=torch.int32, device=dev)
    select = _select(engine)
    q, qn = query_operand(query, metric)
    bn = base_norms(base, metric) if bn_row is None else bn_row
    for t in range(n_tiles):
        start = min(t * tile_size, b_count - tile_size)
        fresh = t * tile_size - start
        d = tile_distance(q, qn, base[start:start + tile_size],
                          None if bn is None else bn[start:start + tile_size],
                          metric, precision, lo=fresh, hi=n_valid - start)
        td, ti = select(d, k_tile)
        ti = (ti + start + base_offset).to(torch.int32)
        run_d, run_i = merge_topk(run_d, run_i, td, ti, k)
    return run_d, run_i


def _knn_full(query, base, n_valid, base_offset, k: int, metric: str,
              engine: str = "exact", precision: str = "highest",
              bn_row=None):
    """Single-tile variant: full (Q, B) distance matrix + one top-k."""
    q, qn = query_operand(query, metric)
    d = tile_distance(q, qn, base, bn_row, metric, precision, hi=n_valid)
    dist, idx = _select(engine)(d, k)
    return dist, (idx + base_offset).to(torch.int32)


_EPILOGUE_FOR_METRIC = {"sqeuclidean": "l2", "euclidean": "l2",
                        "cosine": "rdot", "dot": "dot"}


def _acc_rel(dim: int) -> float:
    """Worst-case fp32 accumulation guard for one dot over `dim` terms,
    relative to ||q||·||b|| (dim·2^-24 in any add order; +16 for the
    epilogue's fp32 ops; 1.05 for second-order terms)."""
    return (dim + 16) * 2.0 ** -24 * 1.05


def _eps3_rel(dim: int) -> float:
    """Screening error bound of the 3-pass (bf16x3) screen, relative to the
    metric's screen scale: three dropped terms each <= 2^-16·||q||||b||,
    the fp32 accumulation and the packed-key quantization."""
    return 3.1 * 2.0 ** -16 + _acc_rel(dim) + screen_kernel.PACK_EPS_REL


def _gather_block(m: int, dim: int) -> int:
    """Re-rank gather block rows: 64, halved until the (block, m, dim) f32
    gather fits ~256 MB (value kept from the JAX engine for parity)."""
    block = 64
    while block > 8 and block * m * dim * 4 > (1 << 28):
        block //= 2
    return block


def _merge_width(k: int, passes: int, cap: int, lean: bool = False) -> int:
    """Passes-aware merge width m clamped to [k, cap]: the width must cover
    every candidate within eps of tau (the count certificate). The widths
    are the JAX engine's, kept for parity."""
    if passes >= 3:
        m = max(128, round_up(k + 28, 64))
    elif passes == 2:
        m = max(192 if lean else 256, round_up(k + 92 if lean else k + 156,
                                               64))
    else:
        m = max(256 if lean else 320, round_up(k + 156 if lean else k + 220,
                                               64))
    return min(max(m, k), cap)


class PreparedBase(NamedTuple):
    """Corpus-resident state for many query batches against one base: the
    base plus its screened-engine statistics and bf16 screen operand.
    Pass in place of `base` to `knn()`. Built by `prepare_base`."""
    base: torch.Tensor      # (B, D) f32
    bn_row: torch.Tensor    # (B,) f32 squared row norms
    stats: torch.Tensor     # (4,) f32 — compute_screen_stats layout
    bhi: torch.Tensor       # (B, D) bf16 — the screen's base operand


def _prepare_arrays(base):
    """(bn_row, stats, bhi). stats = [bn_max, babs_max, blo_max, ratio_max],
    every entry an UPPER bound for the certificate eps, so each computed
    norm carries the worst-case fp32 accumulation guard; non-finite rows
    are excluded (they never become candidates). F1 on the card, its plain
    version (row-chunked, op by op) on the CPU: ops/fused_core.py."""
    return fused_core.prepare_base(base)


def prepare_base(base, device=None) -> PreparedBase:
    """The corpus -> PreparedBase (see class doc); on the card in one pass
    over it (F1), on the CPU op by op."""
    dev = resolve_device(device)
    base = _as_tensor(base, dev)
    bn_row, stats, bhi = _prepare_arrays(base)
    return PreparedBase(base, bn_row, stats, bhi)


def compute_screen_stats(base, device=None):
    """The (4,) f32 certificate statistics of `base` (see _prepare_arrays)."""
    return prepare_base(base, device).stats


def _screen_err_bounds(query, base, passes: int, base_stats=None):
    """Per-query sound bound on |screen dot - exact dot| for the 1/2-pass
    screens. Returns (d_err, r_err, qabs): the absolute dot-error bound,
    the bound on the error of q.(b/||b||), and a guarded ||q||."""
    g = screen_kernel.norm_guard(query.shape[1])
    qn_row = (query * query).sum(1)
    qabs = torch.sqrt(qn_row) * g
    if base_stats is None:
        _, base_stats, _ = _prepare_arrays(base)
    babs_max, blo_max, ratio_max = base_stats[1], base_stats[2], base_stats[3]
    acc = _acc_rel(query.shape[1])
    d_err = qabs * (blo_max + acc * babs_max)
    r_err = qabs * (ratio_max + acc)
    qhi = screen_kernel.bf16_round(query)
    qlo = query - qhi                              # exact (Sterbenz)
    if passes == 1:
        qres = qlo                                 # drops qlo.bhi whole
    else:
        qres = qlo - screen_kernel.bf16_round(qlo)
    qres_abs = torch.sqrt((qres * qres).sum(1)) * g
    # ||bhi|| <= (1 + 2^-8) ||b||
    d_err = d_err + qres_abs * 1.004 * babs_max
    r_err = r_err + qres_abs * 1.004
    return d_err, r_err, qabs


def _smallest_k(d, k: int):
    """`smallest_k`'s selection (values ascending, ties by position, NaN
    after every other value): on the card the verified select (K7), which
    returns exactly that selection without sorting the row; on the CPU
    the stable sort. (`_verified_smallest_k`, the verified engine's
    select, runs K7's plain version on the CPU instead, whose proof
    counts its failed rows there.)"""
    if d.device.type == "cuda":
        return _verified_smallest_k(d.float().contiguous(), k)
    return smallest_k(d, k)


def _merge_select(merge_d, merge_i, m: int):
    """Exact smallest-m, values ascending, ties by original position (the
    order `lax.top_k` and a stable sort both give)."""
    sd, pos = _smallest_k(merge_d, m)
    return sd, torch.gather(merge_i, 1, pos)


def _exact_pair_dists(qb, base, ids, metric: str, block: int | None = None):
    """Exact fp32 distances of qb[t] against its own candidate rows
    base[ids[t]]: (T, dim), (B, dim), (T, M) -> (T, M). One definition
    shared by the select's re-rank and the suspicious-bin repair: F3 on
    the card (the rows read by id), on the CPU the gather and torch.bmm,
    `block` query rows at a time (ops/fused_core.py)."""
    return fused_core.rerank_rows(qb, base, ids, metric, block)


def _screened_select(query, base, cand_d, cand_i, k: int, m: int,
                     metric: str, passes: int, block: int = 512,
                     base_stats=None):
    """Top-M merge of screened candidates + exact fp32 re-rank + exactness
    certificate. Returns (dist, idx, ok, cert_merge, thresh)."""
    q_count, dim = query.shape
    keep = screen_kernel.KEEP
    lanes = screen_kernel.LANES
    d4 = cand_d.reshape(q_count, -1, keep, lanes)
    i4 = cand_i.reshape(q_count, -1, keep, lanes)
    m_last = d4[:, :, keep - 1, :]
    merge_d = d4[:, :, : keep - 1, :].reshape(q_count, -1)
    merge_i = i4[:, :, : keep - 1, :].reshape(q_count, -1)
    scr, idx_m = _merge_select(merge_d, merge_i, m)

    # ---- exact re-rank (on the CPU blocked: bounds the (block, m, dim)
    # gather) ----
    d_exact = _exact_pair_dists(query, base, idx_m, metric, block)
    # +inf screen values are masked bins, not candidates; NaN exact
    # distances are garbage corpus rows
    drop = torch.isinf(scr) | torch.isnan(d_exact)
    d_exact = torch.where(drop, _INF, d_exact)

    dist, selk = _smallest_k(d_exact, k)
    idx = torch.gather(idx_m, 1, selk)
    tau = dist[:, k - 1]

    # ---- certificate: tau to screen space, plus the sound eps ----
    pack = screen_kernel.PACK_EPS_REL
    g = screen_kernel.norm_guard(dim)
    qn_row = (query * query).sum(1) * g
    qn_abs = torch.sqrt(qn_row)
    if passes >= 3:
        eps_rel = _eps3_rel(dim)
        d_err = r_err = None
    else:
        d_err, r_err, _ = _screen_err_bounds(query, base, passes,
                                             base_stats=base_stats)
    acc = _acc_rel(dim)
    if metric in ("sqeuclidean", "euclidean"):
        bn_max = base_stats[0] if base_stats is not None \
            else (base * base).sum(1).max() * g
        tau_s = tau if metric == "sqeuclidean" else tau * tau
        scale = qn_row.max() + bn_max
        eps_s = (eps_rel + 3.0 * acc) * scale if passes >= 3 \
            else 2.0 * d_err + (pack + 3.0 * acc) * scale
    elif metric == "cosine":
        tau_s = (tau - 1.0) * qn_abs
        eps_s = ((eps_rel + 3.0 * acc) * qn_abs if passes >= 3
                 else r_err + (pack + 3.0 * acc) * qn_abs) \
            + torch.abs(tau - 1.0) * qn_abs * (g - 1.0)
    else:  # dot
        bn_max = base_stats[1] if base_stats is not None \
            else torch.sqrt((base * base).sum(1).max()) * g
        tau_s = tau - 1.0
        eps_s = (eps_rel + acc) * qn_abs * bn_max if passes >= 3 \
            else d_err + (pack + acc) * qn_abs * bn_max
    thresh = tau_s + eps_s

    cert_bins = m_last.amin(dim=(1, 2)) >= thresh
    c_all = (merge_d < thresh[:, None]).sum(1)
    c_sel = (scr < thresh[:, None]).sum(1)
    cert_merge = c_all == c_sel
    ok = cert_bins & cert_merge
    return dist, idx, ok, cert_merge, thresh


# adaptive-controller ladder: level 0 is the lean "auto" plan
SCREEN_TIER_AUTO_LADDER = ("auto", "medium", "high")


def advance_screen_tier(cur_idx: int, diag_idx: int, diag, q_rows: int,
                        n_rows: int, k: int) -> int:
    """One adaptive-tier step: given the repair diagnostics of a batch
    screened at ladder level `diag_idx`, return the (possibly escalated)
    level. Escalates when the whole-batch recompute fired or class-A/B
    volume passed half its Chernoff budget. Every tier is exact."""
    if diag_idx != cur_idx or cur_idx >= len(SCREEN_TIER_AUTO_LADDER) - 1:
        return cur_idx
    n_bin, n_full, escal = (int(x) for x in np.asarray(diag))
    tier, _ = resolve_screen_tier(SCREEN_TIER_AUTO_LADDER[diag_idx])
    passes = screen_kernel.PASSES[tier]
    sub = screen_kernel.pick_sub(n_rows, k, q_rows=q_rows)
    nb = _repair_budget(q_rows, None, sub, k)
    na = _chernoff_budget(q_rows, _BIN_FLAG_RATE[passes], k)
    if escal or n_full > nb // 2 or n_bin > na // 2:
        nxt = cur_idx + 1
        print(f"  [screen tier] escalating to "
              f"'{SCREEN_TIER_AUTO_LADDER[nxt]}' (observed repairs: "
              f"class-A {n_bin}/{na}, class-B {n_full}/{nb}, "
              f"tile-escalated {escal}) — exactness unaffected, repair "
              f"cost was threatening the budget", file=sys.stderr)
        return nxt
    return cur_idx


class ScreenTierController:
    """Adaptive screen-tier ladder state of StreamingKNN: escalate via
    `advance_screen_tier`, de-escalate one level after DOWN_AFTER
    consecutive clean batches at an elevated tier."""

    DOWN_AFTER = 16

    def __init__(self):
        self.tier_idx = 0
        self._streak = 0

    @property
    def tier_arg(self) -> str:
        return SCREEN_TIER_AUTO_LADDER[self.tier_idx]

    def observe(self, diag, diag_idx: int, q_rows: int, n_rows: int,
                k: int) -> None:
        """Fold one batch's (class-A, class-B, escalated) counts, taken at
        ladder level `diag_idx`, into the tier decision."""
        before = self.tier_idx
        self.tier_idx = advance_screen_tier(self.tier_idx, diag_idx, diag,
                                            q_rows, n_rows, k)
        if self.tier_idx != before or diag_idx != before:
            self._streak = 0
            return
        if self.tier_idx == 0:
            return
        n_bin, n_full, escal = (int(x) for x in np.asarray(diag))
        tier, _ = resolve_screen_tier(SCREEN_TIER_AUTO_LADDER[diag_idx])
        na = _chernoff_budget(q_rows, _BIN_FLAG_RATE[
            screen_kernel.PASSES[tier]], k)
        clean = not escal and n_full == 0 and n_bin <= na // 4
        self._streak = self._streak + 1 if clean else 0
        if self._streak >= self.DOWN_AFTER:
            self.tier_idx -= 1
            self._streak = 0
            print(f"  [screen tier] de-escalating to "
                  f"'{SCREEN_TIER_AUTO_LADDER[self.tier_idx]}' after "
                  f"{self.DOWN_AFTER} clean batches", file=sys.stderr)


def resolve_screen_tier(screen_precision: str) -> tuple[str, bool]:
    """Screen-precision request -> (tier, lean_plan); "auto" = the 1-pass
    tier with the lean merge plan."""
    if screen_precision == "auto":
        return "default", True
    return screen_precision, False


def _screen_plan(n_base: int, k: int, dim: int, sub_width: int,
                 passes: int = 3, lean: bool = False):
    """Static (cap, m, block) plan; cap < k means the screen cannot even
    represent k candidates and the caller must use another engine."""
    n_mega = -(-n_base // (screen_kernel.TB * sub_width))
    cap = n_mega * screen_kernel.LANES * (screen_kernel.KEEP - 1)
    m = _merge_width(k, passes, cap, lean=lean)
    return cap, m, _gather_block(m, dim)


def _chernoff_budget(q_count: int, rate: float, k: int = 100) -> int:
    """Smallest 128-row multiple whose Poisson tail at lambda =
    rate * Q * max(1, k/100)^2 is below 1e-9 (Chernoff), clamped to Q."""
    lam = rate * q_count * max(1.0, k / 100.0) ** 2
    nb = 128
    while nb < q_count and (
            nb <= lam
            or nb - lam - nb * math.log(nb / max(lam, 1e-9)) > -20.7):
        nb += 128
    return min(nb, q_count)


# per-query class-A (bin-flag) failure rates by MXU passes, with headroom
# (the JAX engine's values, kept for parity)
_BIN_FLAG_RATE = {1: 0.05, 2: 0.02, 3: 0.004}

# suspicious bins gathered per class-A repair row; more -> class B
REPAIR_BINS = 2


def _repair_budget(q_count: int, max_fallback: int | None,
                   sub_width: int | None = None, k: int = 100) -> int:
    """Class-B (full-rescan) row budget; None -> Chernoff sizing over the
    tier's residual full-rescan rate. Past it the whole batch is
    recomputed exactly (a perf cliff, never an exactness loss)."""
    if max_fallback is not None:
        return min(max_fallback, q_count)
    p = 0.002 if sub_width == 56 else 0.0065
    return _chernoff_budget(q_count, p, k)


def _first_rows(mask, n: int):
    """The first n row ids of `mask` in ascending order, lowest unflagged
    ids after the flagged ones (what `lax.top_k` over a 0/1 mask gives),
    without a host sync."""
    return torch.sort((~mask).to(torch.int8), dim=-1,
                      stable=True).indices[..., :n]


def screened_knn_traced(query, base, n_valid, base_offset, k: int,
                        metric: str, screen_precision: str = "auto",
                        max_fallback: int | None = None,
                        select_m: int | None = None,
                        base_stats=None, bn_row=None, bhi=None,
                        with_diagnostics: bool = False):
    """Screened kNN with certificate repair (tensors already on their
    device). Rows >= n_valid are masked; `base_offset` is added to the
    returned indices. With `with_diagnostics=True` a third output reports
    (class-A repairs, class-B repairs, whole-batch escalation 0/1) as
    Python ints — the signal the streaming tier controller consumes.

    One host sync per call reads the two repair counts; the repairs then
    run only when needed, as the JAX engine's `lax.cond`s do.

    Under a recording profiler (utils/profiling.py) the call is the span
    `knn.screened`, its stages the spans `knn.prepare`, `knn.screen`,
    `knn.select`, `knn.certify`, `knn.repair_a`, `knn.repair_b` and
    `knn.fallback` (or `knn.scan` where no screen runs), and the counters
    `knn.queries`, `knn.repair_a_rows`, `knn.repair_b_rows` (class-B rows
    rescanned within the budget) and `knn.fallback_rows` (the rows of a
    batch recomputed whole) take its diagnostics."""
    with span("knn.screened"):
        d, i, diag = _screened_knn(query, base, n_valid, k, metric,
                                   screen_precision, max_fallback, select_m,
                                   base_stats, bn_row, bhi)
        i = (i + base_offset).to(torch.int32)
    if recording():
        n_bin, n_full, whole = diag
        count("knn.queries", query.shape[0])
        count("knn.repair_a_rows", n_bin)
        count("knn.repair_b_rows", 0 if whole else n_full)
        count("knn.fallback_rows", query.shape[0] if whole else 0)
    return (d, i, diag) if with_diagnostics else (d, i)


def _screened_knn(query, base, n_valid, k: int, metric: str,
                  screen_precision: str, max_fallback, select_m, base_stats,
                  bn_row, bhi):
    """screened_knn_traced's (distances, indices before the offset,
    diagnostics)."""
    query = query.float()
    base = base.float()
    q_count, dim = query.shape
    n_base = base.shape[0]
    n_valid = int(n_valid)
    screen_precision, lean = resolve_screen_tier(screen_precision)
    passes = screen_kernel.PASSES[screen_precision]

    fb_engine = _fallback_engine(query.device)

    def _verified(q, n_rows: int):
        """Exact fallback for `q` on the fallback engine; the tile scales
        with a 16 MB (q rows x tile) distance-matrix budget. The base's
        norms are the prepared ones once they exist."""
        if n_base <= DEFAULT_TILE:
            return _knn_full(q, base, n_valid, 0, k, metric, fb_engine,
                             bn_row=bn_row)
        budget_rows = (1 << 24) // (4 * max(n_rows, 1))
        tile = max(DEFAULT_TILE, (budget_rows // 1024) * 1024)
        tile = min(tile, (n_base // 1024) * 1024 or DEFAULT_TILE)
        return _knn_scan(q, base, n_valid, 0, k, metric, tile, fb_engine,
                         bn_row=bn_row)

    sub_width = screen_kernel.pick_sub(n_base, k, q_rows=q_count)
    cap, m, block = _screen_plan(n_base, k, dim, sub_width, passes,
                                 lean=lean)
    if select_m is not None:
        m = min(max(select_m, k), cap)
        block = _gather_block(m, dim)
    if n_base < screen_kernel.MEGA or k > cap:
        with span("knn.scan"):
            d, i = _verified(query, q_count)
        return d, i, (0, 0, 0)

    if bn_row is None or base_stats is None or bhi is None:
        with span("knn.prepare"):
            bn_c, stats_c, bhi_c = _prepare_arrays(base)
        bn_row = bn_c if bn_row is None else bn_row
        base_stats = stats_c if base_stats is None else base_stats
        bhi = bhi_c if bhi is None else bhi
    with span("knn.screen"):
        cand_d, cand_i, _ = screen_kernel.screen_candidates(
            query, base, epilogue=_EPILOGUE_FOR_METRIC[metric],
            screen_precision=screen_precision, n_valid=n_valid,
            bn_row=bn_row, bhi=bhi, sub=sub_width)
    with span("knn.select"):
        dist, idx, ok, cert_merge, thresh = _screened_select(
            query, base, cand_d, cand_i, k, m, metric, passes, block=block,
            base_stats=base_stats)

    # ---- repair of certificate failures, two classes (see module doc) --
    lanes = screen_kernel.LANES
    keep = screen_kernel.KEEP
    mega_rows = screen_kernel.TB * sub_width
    bin_rows = mega_rows // lanes
    w = REPAIR_BINS * bin_rows
    blk = min(128, max(8, (1 << 28) // max(1, w * dim * 4)))
    blk = 1 << (blk.bit_length() - 1)
    na = _chernoff_budget(q_count, _BIN_FLAG_RATE[passes], k)
    nb = _repair_budget(q_count, max_fallback, sub_width, k)
    with span("knn.certify"):
        fail = ~ok
        m_last = cand_d.reshape(q_count, -1, keep, lanes)[:, :, keep - 1, :]
        sflat = (m_last < thresh[:, None, None]).reshape(q_count, -1)
        n_susp = sflat.sum(1)
        # a NaN thresh makes every comparison False, so cert_merge would
        # hold vacuously: such queries must take the class-B rescan
        binfix = fail & torch.isfinite(thresh) & cert_merge \
            & (n_susp <= REPAIR_BINS)
        rows_a = _first_rows(binfix, na)
        take_a = binfix[rows_a]
        # binfix queries past the class-A budget fall through to class B
        repaired_a = torch.zeros_like(binfix)
        repaired_a[rows_a] = take_a
        fullfix = fail & ~repaired_a
        # the one host sync of the call
        n_bin, n_full = torch.stack([binfix.sum(), fullfix.sum()]).tolist()

    if n_bin:
        with span("knn.repair_a"):
            flags = sflat[rows_a]                      # (na, n_mega*128)
            bins_a = _first_rows(flags, REPAIR_BINS)   # (na, S)
            mega_a = bins_a // lanes
            lane_a = bins_a % lanes
            p = torch.arange(bin_rows, device=query.device)
            rg = (mega_a[..., None] * mega_rows + p[None, None, :] * lanes
                  + lane_a[..., None]).reshape(na, w)
            valid = rg < n_valid
            rgc = torch.clamp_max(rg, n_base - 1)
            d = _exact_pair_dists(query[rows_a], base, rgc, metric, blk)
            d_bin = torch.where(valid & torch.isfinite(d), d, _INF)
            # dedup: a returned top-k entry inside a gathered bin already
            # has its exact distance in d_bin
            idx_a = idx[rows_a]
            dist_a = dist[rows_a]
            binid_k = (idx_a // mega_rows) * lanes + (idx_a % lanes)
            dup = (binid_k[:, :, None] == bins_a[:, None, :]).any(2)
            dist_a = torch.where(dup, _INF, dist_a)
            new_d, sel = _smallest_k(torch.cat([dist_a, d_bin], dim=1), k)
            new_i = torch.gather(
                torch.cat([idx_a, rgc.to(idx_a.dtype)], dim=1), 1, sel)
            ta = take_a[:, None]
            dist[rows_a] = torch.where(ta, new_d, dist[rows_a])
            idx[rows_a] = torch.where(ta, new_i, idx[rows_a])

    if n_full > nb:
        with span("knn.fallback"):
            dist, idx = _verified(query, q_count)
    elif n_full:
        with span("knn.repair_b"):
            rows = _first_rows(fullfix, nb)
            take = fullfix[rows][:, None]
            d_f, i_f = _verified(query[rows], nb)
            dist[rows] = torch.where(take, d_f, dist[rows])
            idx[rows] = torch.where(take, i_f.to(idx.dtype), idx[rows])
    return dist, idx, (n_bin, n_full, int(n_full > nb))


def screened_knn(query, base, k: int, metric: str = "sqeuclidean",
                 screen_precision: str = "auto", m: int | None = None,
                 base_offset: int = 0, device=None):
    """Exact kNN through the screen kernel, the certified re-rank and a
    host-side repair: every query whose certificate fails is rescanned by
    the exact engine and written back (the repair of screened_knn_traced
    without its class-A/B budgets). Returns (distances f32, indices int32)
    tensors of shape (Q, k) on `device` (None = "cuda"), indices +
    `base_offset`.

    A base below one mega-tile goes to the exact engine without a screen,
    a k the screen cannot hold (k > cap) to the fallback engine ("verified"
    on the card, as on the TPU); the failed rows' rescan runs on it too.
    `m` (the merge width) is clamped to [k, cap]. One host sync reads the
    failed rows."""
    dev = resolve_device(device)
    query = _as_tensor(query, dev)
    base = _as_tensor(base, dev)
    n_base = base.shape[0]
    assert k <= n_base, f"k={k} exceeds base row count {n_base}"
    screen_precision, lean = resolve_screen_tier(screen_precision)
    passes = screen_kernel.PASSES[screen_precision]
    sub_width = screen_kernel.pick_sub(n_base, k)
    cap, _, _ = _screen_plan(n_base, k, query.shape[1], sub_width, passes,
                             lean=lean)
    fb_engine = _fallback_engine(dev)
    if n_base < screen_kernel.MEGA or k > cap:
        return knn(query, base, k, metric=metric, base_offset=base_offset,
                   engine="exact" if n_base < screen_kernel.MEGA
                   else fb_engine, device=dev)
    bn_row, base_stats, bhi = _prepare_arrays(base)
    cand_d, cand_i, _ = screen_kernel.screen_candidates(
        query, base, n_rows=n_base, epilogue=_EPILOGUE_FOR_METRIC[metric],
        screen_precision=screen_precision, bn_row=bn_row, bhi=bhi,
        sub=sub_width)
    m = _merge_width(k, passes, cap, lean=lean) if m is None \
        else min(max(m, k), cap)
    dist, idx, ok, _, _ = _screened_select(
        query, base, cand_d, cand_i, k, m, metric, passes,
        block=_gather_block(m, query.shape[1]), base_stats=base_stats)
    bad = torch.nonzero(~ok).flatten()
    if len(bad):
        # n_base >= MEGA > DEFAULT_TILE: the rescan always scans tiles
        d_f, i_f = _knn_scan(query[bad], base, n_base, 0, k, metric,
                             DEFAULT_TILE, fb_engine, bn_row=bn_row)
        dist[bad] = d_f
        idx[bad] = i_f.to(idx.dtype)
    return dist, (idx + base_offset).to(torch.int32)


def knn(query, base, k: int, metric: str = "sqeuclidean",
        precision: str = "highest", tile_size: int | None = None,
        base_offset: int = 0, engine: str = "auto",
        screen_precision: str = "auto", select_m: int | None = None,
        device=None):
    """Exact k nearest neighbors of `query` rows among `base` rows.

    Returns (distances f32, indices int32) tensors of shape (Q, k) on
    `device` (None = "cuda"; raises without a card unless device="cpu"),
    distances ascending per row, indices global (+ `base_offset`).

    engine: "exact", "screened" (the fused screen kernel + certified fp32
    re-rank + repair), "verified" (the exact tiles with the verified
    select: candidates, count proof and per-row exact fallback, the
    hand-written kernel on the card) or "auto" (for CUDA tensors screened
    on bases of >= 2 mega-tiles and verified below; exact on the CPU).
    Every engine is exact. `precision` ("default": bf16 operands, "high":
    bf16x3, "highest": fp32) sets the exact and verified engines' products;
    the screened engine ignores it. `base` may be a PreparedBase (see
    prepare_base)."""
    dev = resolve_device(device)
    _check_precision(precision)
    query = _as_tensor(query, dev)
    prep = base if isinstance(base, PreparedBase) else None
    base = _as_tensor(prep.base if prep is not None else base, dev)
    n_base = base.shape[0]
    assert k <= n_base, f"k={k} exceeds base row count {n_base}"
    assert query.shape[1] == base.shape[1], \
        f"dimension mismatch: query {query.shape[1]} vs base {base.shape[1]}"
    engine = _select_engine(engine, n_base, dev)

    if engine == "screened":
        return screened_knn_traced(
            query, base, n_base, base_offset, k, metric, screen_precision,
            select_m=select_m,
            base_stats=None if prep is None else prep.stats,
            bn_row=None if prep is None else prep.bn_row,
            bhi=None if prep is None else prep.bhi)

    if tile_size is None:
        tile_size = DEFAULT_TILE
    if n_base <= tile_size:
        return _knn_full(query, base, n_base, base_offset, k, metric, engine,
                         precision)
    return _knn_scan(query, base, n_base, base_offset, k, metric, tile_size,
                     engine, precision)


class StreamingKNN:
    """Running top-k over base batches fed in ascending offset order; the
    (dist, idx) state lives on `device` and no partial results hit the
    filesystem."""

    # ladder level -> screen_precision arg ("auto" = lean 1-pass plan)
    _LADDER_ARGS = SCREEN_TIER_AUTO_LADDER

    def __init__(self, query, k: int, metric: str = "sqeuclidean",
                 precision: str = "highest", tile_size: int = DEFAULT_TILE,
                 engine: str = "auto", screen_precision: str = "auto",
                 device=None):
        self.device = resolve_device(device)
        _check_precision(precision)
        self.query = _as_tensor(query, self.device)
        self.k = k
        self.metric = metric
        self.precision = precision
        self.tile_size = tile_size
        self.engine = engine
        self.screen_precision = screen_precision
        q = self.query.shape[0]
        self.state = (torch.full((q, k), _INF, device=self.device),
                      torch.zeros((q, k), dtype=torch.int32,
                                  device=self.device))
        self._seen = 0
        # adaptive tier controller (screen_precision == "auto"): a batch's
        # diagnostics are folded in after the NEXT batch was screened, so
        # tier moves lag one batch exactly as in the JAX accumulator
        self._ctrl = ScreenTierController()
        self._pending_diag = None      # (diag, tier_idx, q_rows, n_rows)

    @property
    def _tier_idx(self) -> int:
        return self._ctrl.tier_idx

    def _harvest_diag(self) -> None:
        if self._pending_diag is None:
            return
        diag, tier_idx, q_rows, n_rows = self._pending_diag
        self._pending_diag = None
        self._ctrl.observe(diag, tier_idx, q_rows, n_rows, self.k)

    def update(self, base_batch, offset: int | None = None) -> None:
        if offset is None:
            offset = self._seen
        assert offset == self._seen, \
            "batches must arrive in ascending contiguous offset order"
        base_batch = _as_tensor(base_batch, self.device)
        n = base_batch.shape[0]
        eng = _select_engine(self.engine, n, self.device)
        if eng == "screened" and self.screen_precision == "auto":
            used_tier = self._ctrl.tier_idx
            d, i, diag = screened_knn_traced(
                self.query, base_batch, n, offset, min(self.k, n),
                self.metric, screen_precision=self._LADDER_ARGS[used_tier],
                with_diagnostics=True)
            self._harvest_diag()
            self._pending_diag = (diag, used_tier, self.query.shape[0], n)
        else:
            d, i = knn(self.query, base_batch, k=min(self.k, n),
                       metric=self.metric, precision=self.precision,
                       tile_size=self.tile_size, base_offset=offset,
                       engine=self.engine,
                       screen_precision=self.screen_precision,
                       device=self.device)
        self.state = merge_topk(self.state[0], self.state[1], d, i, self.k)
        self._seen += n

    @property
    def rows_seen(self) -> int:
        return self._seen

    def force_state(self, state) -> None:
        """Backpressure sync: read 4 bytes of the running state (one
        device-to-host copy), which waits for the work queued before it."""
        state[0][0, 0].item()

    def state_arrays(self):
        """(dist, idx, seen) as host arrays — the streaming checkpoint, in
        the same layout as the JAX accumulator's."""
        return (self.state[0].cpu().numpy(), self.state[1].cpu().numpy(),
                self._seen)

    def restore(self, dist, idx, seen: int) -> None:
        """Resume from a checkpoint taken by `state_arrays` of either
        package (host arrays)."""
        q = self.query.shape[0]
        dist = torch.tensor(np.asarray(dist, dtype=np.float32))
        idx = torch.tensor(np.asarray(idx, dtype=np.int32))
        assert tuple(dist.shape) == (q, self.k) == tuple(idx.shape)
        self.state = (dist.to(self.device), idx.to(self.device))
        self._seen = int(seen)

    def finalize(self):
        """(distances, indices) as numpy, ascending per row."""
        assert self._seen >= self.k, \
            f"saw only {self._seen} base rows but k={self.k}"
        return self.state[0].cpu().numpy(), self.state[1].cpu().numpy()
