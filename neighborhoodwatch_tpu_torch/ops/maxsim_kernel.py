"""Fused ColBERT MaxSim scoring + candidate screening (counterpart of
ops/maxsim_kernel.py).

score(q, doc) = sum over query tokens t of max over doc tokens s of
<q_t, d_s>. The screen computes every (query, doc) score from bf16 operand
pairs with fp32 accumulation in 1, 2 or 3 passes (qhi.dhi [+ qlo.dhi [+
qhi.dlo]]), negates it, packs the bits and the doc's position in its lane
bin into one sortable int32 key and keeps the KEEP smallest keys per lane
bin. A bin is (mega-tile of 8192 docs, doc % 128): it holds 64 docs and the
position of doc d in it is (d % 8192) // 128. ops/maxsim.py re-ranks the
merged candidates exactly and proves each query's result with the bin and
count certificates.

`maxsim_keys` is the one kernel entry: on CUDA tensors it launches the
hand-written Hopper kernel in csrc/maxsim_keys.cu (replacing the two Pallas
schedules `_kernel` and `_kernel_pipelined` of the JAX package), on CPU
tensors it runs `maxsim_keys_plain`, the plain PyTorch version of the same
function (same prepared operands, bins, packing and lowest-KEEP order).

The operand contract is prepared on the host side in torch
(`prepare_operands`): masked query tokens are zeroed (a zero token's max is
exactly the masked contribution, 0), masked doc tokens are replaced by the
doc's first valid token (a duplicate never changes a max), and only docs
with no valid token at all carry a bias (NEG_BIAS). The kernel relies on
it and masks nothing per token. Operands stay row-major, (Q, Tq, dim) and
(D, Td, dim): the kernel reads token s of 128 consecutive docs as a strided
tile, so the doc tensor is neither transposed nor padded to whole megas.

The source holds two variants of the kernel, and `pick_variant` chooses
between them by shape alone: "wgmma" (query tiles resident in shared
memory, doc tiles through TMA loads multicast across a cluster, wgmma
products, two warpgroups of 64 token rows per block) where the padded token
dim is 64 or 128, "mma" (mma.sync from a cp.async ring) for the rest.
Launches are counted per variant.
"""

import ctypes

import torch
import torch.nn.functional as F

from neighborhoodwatch_tpu_torch.ops import screen_kernel as _sk
from neighborhoodwatch_tpu_torch.ops.screen_kernel import (
    KEEP, LANES, PASSES, POS_MASK, PACK_EPS_REL, VARIANTS, _check,
    bf16_round, forced_variant, norm_guard,
)
from neighborhoodwatch_tpu_torch.utils.misc import cdiv, round_up

MEGA_DOCS = 8192                    # docs per mega-tile: 64 per lane bin
CAND_PER_MEGA = KEEP * LANES
MAX_QUERY_TOKENS = 32
NEG_BIAS = -1e30   # per-doc bias of empty docs (finite: no inf - inf NaNs)
_DIM_ALIGN = 16    # the kernel's k16 steps and 16-byte loads

__all__ = ["KEEP", "LANES", "PACK_EPS_REL", "MEGA_DOCS", "CAND_PER_MEGA",
           "NEG_BIAS", "bf16_round", "norm_guard", "maxsim_acc_rel",
           "maxsim_eps3_rel", "doc_cert_stats", "prepare_operands",
           "maxsim_keys", "maxsim_keys_plain", "screen_maxsim"]


def pick_variant(dimp: int) -> str:
    """The kernel variant for a padded token dim of `dimp` columns: "wgmma"
    needs whole 64-column chunks (128-byte swizzled tile rows) and query
    tiles that stay resident beside the ring, so dimp 64 or 128; every
    other multiple of 16 takes "mma". The choice depends on nothing but
    the shape: "wgmma" measured faster at every pass count.
    `forced_variant` (shared with ops/screen_kernel.py) overrides it for
    tests and timings."""
    return "wgmma" if dimp in (64, 128) else "mma"


def maxsim_acc_rel(dim: int) -> float:
    """Worst-case fp32 accumulation guard for one MaxSim dot + token sum,
    relative to the score scale: dim adds at 2^-24 in any order, +64 for the
    <= 32-term query-token sum and the epilogue, 1.05 for second-order
    terms. Shared by the 3-pass static bound and the 1/2-pass
    data-dependent eps."""
    return (dim + 64) * 2.0 ** -24 * 1.05


def maxsim_eps3_rel(dim: int) -> float:
    """Worst-case screening error of the 3-pass screen, relative to
    (sum_t ||q_t||) x max_s ||d_s||: three dropped bf16 residual
    cross-terms each <= 2^-16 per token pair, the fp32 accumulation and the
    packed-key quantization."""
    return 3.1 * 2.0 ** -16 + maxsim_acc_rel(dim) + PACK_EPS_REL


def doc_cert_stats(docs, d_mask, dim: int, dhi=None, need_dlo: bool = True):
    """Certificate doc statistics: (2,) f32 [d_max, dlo_max], guarded upper
    bounds on the largest valid-token norm and the largest bf16-residual
    norm. `dim` is the true token dim (padding zeros add exactly).
    need_dlo=False (the 3-pass tier, whose eps never reads dlo_max) skips
    the residual pass and stores 0."""
    g = norm_guard(dim)
    zero = torch.zeros((), device=docs.device)
    dn = torch.sqrt((docs * docs).sum(2))
    d_max = torch.where(d_mask, dn, zero).max() * g
    if not need_dlo:
        return torch.stack([d_max, torch.zeros_like(d_max)])
    if dhi is None:
        dhi = bf16_round(docs)
    res = docs - dhi.float()
    dlo_n = torch.sqrt((res * res).sum(2))
    dlo_max = torch.where(d_mask, dlo_n, zero).max() * g
    return torch.stack([d_max, dlo_max])


def prepare_operands(queries, q_mask, docs, d_mask, passes: int,
                     want_dlo_stat: bool = False):
    """The kernel's operand contract (see module doc): returns
    (qhi, qlo, dhi, dlo, bias, doc_stats) with bf16 (Q, Tq, dimp) and
    (D, Td, dimp) operands (qlo None below 2 passes, dlo None below 3),
    a (D,) f32 bias and the (2,) certificate statistics. dimp is dim
    rounded up to 16 with zero columns. hi images come from the integer
    bf16_round, lo = x - hi cast to bf16 (one more rounding, budgeted in
    the certificate eps)."""
    dim = queries.shape[2]
    dimp = round_up(dim, _DIM_ALIGN)
    queries = torch.where(q_mask[:, :, None], queries,
                          torch.zeros((), device=queries.device))
    first = torch.argmax(d_mask.to(torch.uint8), dim=1)
    first_tok = docs[torch.arange(docs.shape[0], device=docs.device), first]
    docs = torch.where(d_mask[:, :, None], docs, first_tok[:, None, :])
    bias = torch.where(d_mask.any(1), 0.0, NEG_BIAS).to(torch.float32)
    if dimp != dim:
        queries = F.pad(queries, (0, dimp - dim))
        docs = F.pad(docs, (0, dimp - dim))
    qhi_f = bf16_round(queries)
    dhi_f = bf16_round(docs)
    qhi = qhi_f.to(torch.bfloat16)
    dhi = dhi_f.to(torch.bfloat16)
    doc_stats = doc_cert_stats(docs, d_mask, dim, dhi=dhi_f,
                               need_dlo=passes < 3 or want_dlo_stat)
    qlo = (queries - qhi_f).to(torch.bfloat16) if passes >= 2 else None
    dlo = (docs - dhi_f).to(torch.bfloat16) if passes >= 3 else None
    return qhi, qlo, dhi, dlo, bias, doc_stats


def _pack_neg(score, pos):
    """score (.., docs) f32 -> packed key of the negated score: NaN loses
    (+inf) before the sign-adjusting bit trick, low bits carry `pos`."""
    neg = -score
    neg = torch.where(torch.isnan(neg),
                      torch.full((), float("inf"), device=neg.device), neg)
    bits = neg.contiguous().view(torch.int32)
    bits = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    return (bits & ~POS_MASK) | pos


def maxsim_keys_plain(qhi, qlo, dhi, dlo, bias, passes: int):
    """Plain PyTorch version of the MaxSim screen kernel, one mega-tile and
    one query chunk at a time. bf16 x bf16 products are exact in fp32, so
    the fp32 matmul of the widened operands differs from the kernel only in
    the accumulation order of each dot; the token sum runs in token order
    on both sides."""
    Q, Tq, dimp = qhi.shape
    D, Td = dhi.shape[:2]
    n_mega = cdiv(D, MEGA_DOCS)
    n_pos = MEGA_DOCS // LANES
    dev = qhi.device
    out = torch.empty((Q, n_mega * CAND_PER_MEGA), dtype=torch.int32,
                      device=dev)
    pos = torch.arange(n_pos, device=dev, dtype=torch.int32)
    pos = pos[:, None].expand(n_pos, LANES).reshape(1, -1)
    # bound the (chunk*Tq, MEGA_DOCS*Td) similarity tile at 2^28 elements
    q_chunk = max(1, (1 << 28) // (Tq * MEGA_DOCS * Td))
    for m in range(n_mega):
        lo, hi = m * MEGA_DOCS, min(D, (m + 1) * MEGA_DOCS)
        dh = torch.zeros((MEGA_DOCS, Td, dimp), device=dev)
        dh[: hi - lo] = dhi[lo:hi].float()
        dh = dh.reshape(-1, dimp)
        if passes >= 3:
            dl = torch.zeros((MEGA_DOCS, Td, dimp), device=dev)
            dl[: hi - lo] = dlo[lo:hi].float()
            dl = dl.reshape(-1, dimp)
        b = torch.full((MEGA_DOCS,), NEG_BIAS, device=dev)
        b[: hi - lo] = bias[lo:hi]
        for s in range(0, Q, q_chunk):
            qh = qhi[s:s + q_chunk].float().reshape(-1, dimp)
            n = qh.shape[0] // Tq
            sims = qh @ dh.T
            if passes >= 2:
                sims += qlo[s:s + q_chunk].float().reshape(-1, dimp) @ dh.T
            if passes >= 3:
                sims += qh @ dl.T
            # amax keeps NaN, like the kernel's max
            mx = sims.view(n, Tq, MEGA_DOCS, Td).amax(dim=3)
            del sims
            acc = mx[:, 0]
            for t in range(1, Tq):
                acc = acc + mx[:, t]
            keys = _pack_neg(acc + b, pos)
            # (n, pos, lane) -> lowest KEEP per lane (keys distinct per bin)
            low = torch.sort(keys.view(n, n_pos, LANES), dim=1) \
                .values[:, :KEEP]
            out[s:s + n, m * CAND_PER_MEGA:(m + 1) * CAND_PER_MEGA] = \
                low.reshape(n, -1)
    return out


def load_library():
    """Build (at first use) and load csrc/maxsim_keys.cu."""
    from neighborhoodwatch_tpu_torch.utils import cuda_build
    lib = cuda_build.load("maxsim_keys")
    if not getattr(lib, "_nw_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.maxsim_keys_launch.argtypes = [p, p, p, p, p, p,
                                           i, i, i, i, i, i, i, i, i, p]
        lib.maxsim_keys_launch.restype = i
        lib._nw_typed = True
    return lib


def maxsim_keys(qhi, qlo, dhi, dlo, bias, passes: int):
    """(Q, n_mega*512) int32 packed keys: out[q, mega*512 + t*128 + lane]
    is the t-th smallest key of bin (mega, lane), slab t=3 the certificate.

    qhi/qlo (Q, Tq, dimp) and dhi/dlo (D, Td, dimp) bf16 operands from
    `prepare_operands` (qlo only at passes >= 2, dlo only at passes 3),
    bias (D,) f32; Tq <= 32, dimp a multiple of 16. CPU tensors take the
    plain version; CUDA tensors launch the kernel variant `pick_variant`
    names (and count the launch, in all and per variant) or raise."""
    if passes not in (1, 2, 3):
        raise ValueError(f"passes={passes}")
    if qhi.dim() != 3 or dhi.dim() != 3:
        raise ValueError("qhi and dhi must be (rows, tokens, dim)")
    Q, Tq, dimp = qhi.shape
    D, Td = dhi.shape[:2]
    if not 1 <= Tq <= MAX_QUERY_TOKENS:
        raise ValueError(f"the MaxSim screen takes 1..{MAX_QUERY_TOKENS} "
                         f"query tokens, got {Tq}")
    if Td < 1 or dimp % _DIM_ALIGN:
        raise ValueError(f"Td={Td}, dim={dimp}: the token dim must be a "
                         f"multiple of {_DIM_ALIGN} (prepare_operands pads)")
    dev = qhi.device
    _check(qhi, "qhi", torch.bfloat16, (Q, Tq, dimp), dev)
    _check(dhi, "dhi", torch.bfloat16, (D, Td, dimp), dev)
    if passes >= 2:
        _check(qlo, "qlo", torch.bfloat16, (Q, Tq, dimp), dev)
    if passes >= 3:
        _check(dlo, "dlo", torch.bfloat16, (D, Td, dimp), dev)
    _check(bias, "bias", torch.float32, (D,), dev)
    if dev.type == "cpu":
        return maxsim_keys_plain(qhi, qlo, dhi, dlo, bias, passes)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    n_mega = cdiv(D, MEGA_DOCS)
    out = torch.empty((Q, n_mega * CAND_PER_MEGA), dtype=torch.int32,
                      device=dev)
    if Q == 0 or n_mega == 0:
        return out
    ops = [qhi, qlo if passes >= 2 else qhi, dhi, dlo if passes >= 3 else dhi]
    if any(t.data_ptr() % 16 for t in ops):
        raise ValueError("operands must be 16-byte aligned")
    variant = _sk._forced_variant or pick_variant(dimp)
    with torch.cuda.device(dev):
        err = load_library().maxsim_keys_launch(
            ops[0].data_ptr(), ops[1].data_ptr(), ops[2].data_ptr(),
            ops[3].data_ptr(), bias.data_ptr(), out.data_ptr(),
            Q, Tq, D, Td, dimp, n_mega, passes, VARIANTS.index(variant),
            _sk._forced_cluster,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"maxsim_keys kernel ({variant}) launch failed: "
                           f"error {err} (CUDA's, or 2xxxx from the tensor "
                           f"map encode)")
    maxsim_keys.launches += 1
    maxsim_keys.launches_by_variant[variant] += 1
    return out


maxsim_keys.launches = 0
maxsim_keys.launches_by_variant = {v: 0 for v in VARIANTS}


def decode_keys(keys):
    """packed keys -> (negated quantized score f32, global doc id int32).
    Column c of a query's keys is (mega c // 512, slab (c // 128) % 4,
    lane c % 128); the doc is mega*8192 + pos*128 + lane (it may lie past
    the corpus in the last mega: such slots carry the NEG_BIAS score)."""
    vbits = keys & ~POS_MASK
    vbits = vbits ^ ((vbits >> 31) & 0x7FFFFFFF)
    cand_neg = vbits.view(torch.float32)
    pos = keys & POS_MASK
    col = torch.arange(keys.shape[1], device=keys.device, dtype=torch.int32)
    cand_doc = (col // CAND_PER_MEGA) * MEGA_DOCS + pos * LANES + col % LANES
    return cand_neg, cand_doc


def screen_maxsim(queries, q_mask, docs, d_mask, *,
                  screen_precision: str = "medium",
                  pipelined: bool | None = None,
                  want_dlo_stat: bool = False):
    """Fused MaxSim screen: (Q, Tq, dim) x (D, Td, dim) f32 tensors with
    bool masks (already on their device) -> per-mega-tile candidate lists
    of (negated quantized score, doc id). The last KEEP-slab per mega is
    the certificate slab (4th-best score per 64-doc bin).

    Returns (cand_neg, cand_doc, n_mega, doc_stats); doc_stats is the (2,)
    f32 [d_max, dlo_max] certificate statistics, computed with the operand
    prep. At the 3-pass tier dlo_max is a 0 placeholder unless
    `want_dlo_stat` (needed for the adaptive-tier diagnostics).

    `screen_precision`: "high" = 3 passes, "medium" = 2 (exact q x bf16
    docs), "default" = 1 (plain bf16). The computed tiers' screening error
    is bounded per query by the certificate eps in ops/maxsim.py, so every
    tier stays exact end to end.

    `pipelined` is accepted and ignored: the JAX package's pipelined
    schedule differs from its plain one only in how the TPU grid overlaps
    the epilogue with the products and gives bit-identical keys; one CUDA
    kernel serves both."""
    del pipelined
    passes = PASSES[screen_precision]
    queries = queries.float()
    docs = docs.float()
    q_mask = q_mask.bool()
    d_mask = d_mask.bool()
    Tq, dim = queries.shape[1:]
    assert dim % LANES == 0 or dim <= LANES, \
        f"token dim {dim} must be <= 128 or a multiple of 128"
    assert Tq <= MAX_QUERY_TOKENS, \
        f"screened MaxSim supports <= 32 query tokens, got {Tq}"
    qhi, qlo, dhi, dlo, bias, doc_stats = prepare_operands(
        queries, q_mask, docs, d_mask, passes, want_dlo_stat)
    keys = maxsim_keys(qhi, qlo, dhi, dlo, bias, passes)
    cand_neg, cand_doc = decode_keys(keys)
    return cand_neg, cand_doc, cdiv(docs.shape[0], MEGA_DOCS), doc_stats


def candidates_agree(cand_a, cand_b, queries, q_mask, docs, d_mask):
    """Hold two screens' (cand_neg, cand_doc) outputs on the same inputs
    against each other, slot by slot: empty/bias/NaN slots (negated score
    >= 1e29) empty on both sides, every other decoded score within
    (PACK_EPS_REL + 4 maxsim_acc_rel(dim)) x (sum_t ||q_t|| x max_s ||d_s||)
    (two screens differ by the order of their fp32 sums and by one key
    quantum), and so doc ids may differ only between docs whose scores are
    that close. Returns (max abs score difference, slots whose ids differ);
    raises AssertionError on a miss."""
    na, da = cand_a
    nb, db = cand_b
    real = nb < 1e29
    if not torch.equal(na < 1e29, real):
        raise AssertionError("the two screens disagree on empty slots")
    q64 = torch.where(q_mask[:, :, None], queries, 0.0).double()
    d64 = torch.where(d_mask[:, :, None], docs, 0.0).double()
    d64 = torch.where(torch.isfinite(d64), d64, 0.0)
    scale = q64.norm(dim=2).sum(1) * d64.norm(dim=2).max()
    tol = (PACK_EPS_REL + 4 * maxsim_acc_rel(queries.shape[2])) \
        * scale[:, None]
    diff = torch.where(real, (na.double() - nb.double()).abs(),
                       torch.zeros_like(tol))
    if bool((diff > tol).any()):
        raise AssertionError(f"score beyond tolerance by "
                             f"{float((diff - tol).max())}")
    return float(diff.max()), int((real & (da != db)).sum())
