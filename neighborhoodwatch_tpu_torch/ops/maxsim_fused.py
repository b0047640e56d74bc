"""The MaxSim engines' compiled core: hand-written Hopper counterparts of
the fusions XLA makes of the JAX package's jitted MaxSim scoring, which
are not Pallas kernels but one pass each on the TPU.

  M1 `maxsim_dense` (csrc/maxsim_dense.cu): JAX `maxsim_scores`
     (ops/maxsim.py:33-57), the exact engine's tile: query passages
     (Q, Tq, dim) against docs (D, Td, dim) -> (Q, D) scores, a NaN score
     -1e30 (NEG), at precision "default", "high" or "highest".
  M2 `maxsim_pairs` (csrc/maxsim_pairs.cu): JAX `_maxsim_select`'s
     `refine` (:260-270) and `_bin_repair`'s `block_s` (:386-397): each
     query passage against its own candidate docs, read by id -> (B, M)
     fp32 scores, NaN kept, an id outside the docs NaN.

    score(p, e) = sum over valid query tokens t of
                  max over doc tokens s of (valid s ? <q_t, d_s> : NEG)

Each kernel has two variants (`VARIANTS`; the default in
`DEFAULT_VARIANT`; `forced_variant(name)` selects one for timings that
hold them against each other; nothing on the main path forces one):
  "split" csrc/maxsim_split.cuh: the fp32 products on the bf16 tensor
          cores as an exact bf16x6 split, the tensor cores' sums of x0 y0
          kept to chunks of 16 dims and promoted into fp32 registers with
          round-to-nearest adds, on the launch plan of `plan` (which sends
          a shape its error model or layout does not take to "ffma", with
          the reason, kept in `ffma_plans` and logged once a shape).
  "ffma"  csrc/maxsim_tile.cuh, the first kernels: fp32 FMA on the CUDA
          cores.
Both fold the max over doc tokens and the sum over query tokens into the
tile, so the (query tokens x doc tokens) similarity matrix is never
written; their sums run in another order than the plain versions', within
the MaxSim tolerance, and two launches of either give equal bits.
`error_bound` is the "split" dot's error model: at most dim 2^-24 of
sum_k |q_k d_k| wherever the plan admits it, the dot budget of
ops/maxsim_kernel.py:maxsim_acc_rel, so the certificate's `rerank_acc`
holds for both variants.

Each wrapper launches a kernel on CUDA tensors (and counts the launch, in
`launches` and per variant in `launches_by_variant`; `last_plan` is the
last plan made) or raises; on CPU tensors it runs the plain PyTorch
version beside it, which is the engines' op-by-op code as it was before
the kernels. Nothing is built at import: the kernels build at first use
(utils/cuda_build.py).
"""

import contextlib
import ctypes
import dataclasses
import logging

import torch

from neighborhoodwatch_tpu_torch.ops.distance import (
    PRECISIONS, bf16_operands, products,
)

NEG = -1e30
_NAN = float("nan")
# bounds the plain re-rank's gathered candidates (~256 MB)
_GATHER_BYTES = 1 << 28
# the device types whose tensors launch the kernels
_ON_CARD = ("cuda",)

VARIANTS = ("split", "ffma")
# each kernel's variant on CUDA tensors unless one is forced: the faster
# on the card at the main shapes (PERF.md)
DEFAULT_VARIANT = {"maxsim_dense": "split", "maxsim_pairs": "split"}
_forced_variant = None
_log = logging.getLogger(__name__)

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# each source's C functions, `<name>_<entry>`, and their arguments
_ARGTYPES = {
    "maxsim_dense": {
        "launch": [_P, _P, _P, _P, _P, _I, _I, _LL, _I, _I, _I, _P],
        "split_launch": [_P, _P, _P, _P, _P, _I, _I, _LL, _I, _I, _I, _I,
                         _I, _I, _I, _I, _P]},
    "maxsim_pairs": {
        "launch": [_P, _P, _P, _P, _P, _P, _I, _I, _LL, _I, _I, _I, _I, _P],
        "split_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _LL, _I, _I, _I,
                         _I, _I, _I, _I, _I, _P]},
}


@contextlib.contextmanager
def forced_variant(name: str):
    """Run CUDA tensors through `name` ("split" or "ffma") instead of each
    kernel's default (DEFAULT_VARIANT), for timings that hold them against
    each other. Under "split" the plan still sends the shapes it does not
    take to "ffma"."""
    global _forced_variant
    if name not in VARIANTS:
        raise ValueError(f"variant {name!r} not in {VARIANTS}")
    before = _forced_variant
    _forced_variant = name
    try:
        yield
    finally:
        _forced_variant = before


def _launcher(name: str, entry: str = "launch"):
    """Build (at first use) and load csrc/<name>.cu; its C function
    `<name>_<entry>`."""
    from neighborhoodwatch_tpu_torch.utils import cuda_build
    lib = cuda_build.load(name)
    if not getattr(lib, "_nw_typed", False):
        for e, argtypes in _ARGTYPES[name].items():
            fn = getattr(lib, f"{name}_{e}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib._nw_typed = True
    return getattr(lib, f"{name}_{entry}")


def load_libraries():
    """Build (at first use) and load the two sources."""
    for name in _ARGTYPES:
        _launcher(name)


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _raise_on(err: int, name: str, variant: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed ({variant}): "
                           f"CUDA error {err}")


def _scalar(value, like):
    return torch.full((), value, device=like.device, dtype=like.dtype)


def _on_card(t, name: str) -> bool:
    """False for CPU tensors (the plain version runs); True for a device
    whose tensors launch the kernel; any other device raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type not in _ON_CARD:
        raise ValueError(f"{name}: unsupported device {t.device}")
    return True


def _checked(name, queries, q_mask, docs, d_mask):
    """The four operands of a launch, contiguous, after the checks the
    kernels need: fp32 tokens and bool masks on one device, (P, T, dim)
    tokens with (P, T) masks, T and dim at least 1."""
    for t, what in ((queries, "queries"), (docs, "docs")):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {what} must be float32, got {t.dtype}")
    for t, what in ((q_mask, "q_mask"), (d_mask, "d_mask")):
        if t.dtype != torch.bool:
            raise TypeError(f"{name}: {what} must be bool, got {t.dtype}")
    dev = queries.device
    if any(t.device != dev for t in (q_mask, docs, d_mask)):
        raise ValueError(f"{name}: operands on {queries.device}, "
                         f"{q_mask.device}, {docs.device}, {d_mask.device}")
    if (queries.dim() != 3 or docs.dim() != 3
            or docs.shape[2] != queries.shape[2]
            or tuple(q_mask.shape) != tuple(queries.shape[:2])
            or tuple(d_mask.shape) != tuple(docs.shape[:2])
            or min(queries.shape[1], docs.shape[1], docs.shape[2]) < 1):
        raise ValueError(f"{name}: queries {tuple(queries.shape)} with mask "
                         f"{tuple(q_mask.shape)}, docs {tuple(docs.shape)} "
                         f"with mask {tuple(d_mask.shape)}")
    return (queries.contiguous(), q_mask.contiguous(), docs.contiguous(),
            d_mask.contiguous())


def _vec(dim: int, *tensors) -> int:
    """The kernels' 16-byte copies: dim % 4 == 0 and aligned rows."""
    return int(dim % 4 == 0 and all(t.data_ptr() % 16 == 0
                                    for t in tensors))


# ------------------------------------------------- the "split" plan
# (mirrors csrc/maxsim_split.cuh: its launchers recompute every field and
# refuse a plan they would not make)

SLOT_COLS = 32                # fp32 columns a ring slot
MAX_B_BYTES = 96 * 1024       # the resident query tiles
SMEM_BLOCK = 232448           # a block's shared memory at most
MAX_STAGES = 12
MAX_TQ, MAX_TD = 64, 64       # tokens a passage / a doc "split" takes
MAX_GRID_Y = 65535
WG_N = 64                     # M1's query-token columns a warpgroup
DENSE_COLS = 2 * WG_N         # M1's query-token columns a block


def slot_rows(pairs: bool) -> int:
    """Doc-token rows a ring slot: M1's 64 (both warpgroups read them),
    M2's 128 (64 a warpgroup)."""
    return 128 if pairs else 64


def error_bound(dim: int, kc: int, pieces: int) -> float:
    """The "split" dot's error bound, in units of 2^-24 sum_k |q_k d_k|
    (csrc/maxsim_split.cuh): the bf16x6 split's dropped terms (16.0625;
    none for bf16-valued operands, pieces = 1), a tensor-core chunk of kc
    dims of x0 y0 whose adds each truncate (2 kc), the five small products
    summed over the whole dim in the tensor cores (5 dim adds on terms
    under 2^-6 + 3 2^-14 of A: dim (10/64 + 30/16384)), and the
    round-to-nearest promotion, an add a chunk (the last one the small
    products')."""
    chunks = -(-dim // kc) * (1.0 + 1.0 / 65536)
    if pieces == 1:
        return 2.0 * kc + chunks
    return 16.0625 + 2.0 * kc + dim * (10.0 / 64 + 30.0 / 16384) + chunks


KC = 16                       # dims a tensor-core chunk (one k-step)


def chunk_for(dim: int, pieces: int) -> int:
    """The chunk "split" takes, KC, where the dim is whole k-steps and
    error_bound stays at or below dim (the dot budget of maxsim_acc_rel),
    else 0: the dim is not admitted (pieces 3 from 64, pieces 1 from
    48)."""
    return KC if dim % KC == 0 and error_bound(dim, KC, pieces) <= dim \
        else 0


def _pow2(x: int, lo: int) -> int:
    p = lo
    while p < x:
        p *= 2
    return p


def b_bytes(bc: int, dim: int, pieces: int) -> int:
    """The resident query tiles: pieces x 64-column tiles x bc rows of 128
    bytes."""
    return pieces * -(-dim // 64) * bc * 128


def _fixed_bytes(n: int, bc: int, dim: int, pieces: int) -> int:
    return (1024 + b_bytes(bc, dim, pieces) + 256 + 2 * 4 * n * 4 + bc
            + MAX_STAGES * 64)


def stages_for(pairs: bool, n: int, bc: int, dim: int, pieces: int) -> int:
    """Ring slots a block holds beside its query tiles (at most 12)."""
    return min(MAX_STAGES, (SMEM_BLOCK - _fixed_bytes(n, bc, dim, pieces))
               // (slot_rows(pairs) * SLOT_COLS * 4))


def smem_bytes(pairs: bool, n: int, bc: int, dim: int, pieces: int) -> int:
    return _fixed_bytes(n, bc, dim, pieces) + stages_for(
        pairs, n, bc, dim, pieces) * slot_rows(pairs) * SLOT_COLS * 4


@dataclasses.dataclass(frozen=True)
class Plan:
    """A launch of M1 or M2. "split": grid (x, y) of blocks (one an SM),
    `pieces` bf16 pieces an operand (3 for fp32 operands, 1 for
    bf16-valued ones), chunks of `kc` dims, passages padded to `tq_p`
    columns (M2: the wgmma's N), docs to `td_p` rows, `cand_block`
    candidates a block (M2), `smem_bytes` of dynamic shared memory, the
    dot's `error_bound` (units of 2^-24 sum |q d|). "ffma": the first kernel
    lays out its own launch; nothing planned (the numbers 0), for the
    reason given."""
    variant: str
    reason: str
    pieces: int
    kc: int
    tq_p: int
    td_p: int
    grid: tuple
    cand_block: int
    smem_bytes: int
    error_bound: float


def _ffma(reason: str, pieces: int) -> Plan:
    return Plan("ffma", reason, pieces, 0, 0, 0, (0, 0), 0, 0, 0.0)


def _fill(blocks_x: int, tiles: int, per_wave: int, min_tiles: int) -> int:
    """Blocks in y (1 to 16, each at least `min_tiles` tiles where there
    are) that fill the last wave best, the fewest among equals."""
    best, best_eff = 1, -1.0
    for gy in range(1, min(16, max(1, tiles // min_tiles)) + 1):
        total = blocks_x * gy
        eff = total / (-(-total // per_wave) * per_wave)
        if eff > best_eff + 1e-12:
            best, best_eff = gy, eff
    return best


def plan(kernel: str, q_n: int, tq: int, docs: int, td: int, dim: int,
         pieces: int, aligned: bool, sms: int, m: int = 0) -> Plan:
    """The "split" launch of M1 ("maxsim_dense": q_n passages of tq tokens
    against `docs` docs of td, at `pieces` 3 or 1) or M2 ("maxsim_pairs":
    q_n passages against m candidates each among `docs`, pieces 3) on a
    card of `sms` SMs, operands `aligned` to 16 bytes. "ffma" where the
    split's error model or layout does not take the shape, with the
    reason: no work, a passage or a doc over 64 tokens, a dim that is no
    multiple of the 16-dim k-step, a dim whose error_bound exceeds dim
    2^-24, query tiles over 96 KB, unaligned operands, a grid past CUDA's
    limits."""
    if kernel not in ("maxsim_dense", "maxsim_pairs"):
        raise ValueError(f"no launch plan for {kernel!r}")
    if pieces not in (1, 3) or (kernel == "maxsim_pairs" and pieces != 3):
        raise ValueError(f"{kernel}: pieces={pieces}")
    if sms < 1:
        raise ValueError(f"sms={sms}")
    pairs = kernel == "maxsim_pairs"
    if min(q_n, docs, m if pairs else 1) < 1:
        return _ffma("empty", pieces)
    if tq > MAX_TQ or td > MAX_TD:
        return _ffma("tokens", pieces)
    if dim % 16:
        return _ffma("dim", pieces)
    kc = chunk_for(dim, pieces)
    if kc == 0:
        return _ffma("error model", pieces)
    n = _pow2(tq, 16) if pairs else WG_N
    bc = n if pairs else DENSE_COLS
    if b_bytes(bc, dim, pieces) > MAX_B_BYTES or \
            stages_for(pairs, n, bc, dim, pieces) < 2:
        return _ffma("shared memory", pieces)
    if not aligned:
        return _ffma("unaligned", pieces)
    if docs > 2 ** 31 - 1 or q_n > 2 ** 31 - 1:
        return _ffma("grid", pieces)
    td_p = _pow2(td, 8)
    dpt = slot_rows(pairs) // td_p
    if pairs:
        tiles = -(-m // dpt)
        # a block splits its passage once: 32 tiles at least a block
        gy = _fill(q_n, tiles, sms, 32)
        cand_block = -(-tiles // gy) * dpt
        gy = -(-m // cand_block)
        if gy > MAX_GRID_Y:
            return _ffma("grid", pieces)
        grid, tq_p = (q_n, gy), n
    else:
        tq_p = _pow2(tq, 8)
        gx = -(-q_n // (DENSE_COLS // tq_p))
        tiles = -(-docs // dpt)
        grid, cand_block = (gx, _fill(gx, tiles, sms, 8)), 0
    return Plan("split", "", pieces, kc, tq_p, td_p, grid, cand_block,
                smem_bytes(pairs, n, bc, dim, pieces),
                error_bound(dim, kc, pieces))


_sms: dict = {}
_plans: dict = {}


def _sm_count(dev) -> int:
    """The device's SM count, asked once per device."""
    n = _sms.get(dev)
    if n is None:
        n = _sms[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return n


def _variant(wrapper) -> str:
    return _forced_variant or DEFAULT_VARIANT[wrapper.__name__]


def _planned(wrapper, dev, *shape) -> Plan:
    """plan() on this device, once per shape; a shape sent to "ffma" is
    kept in `wrapper.ffma_plans` and logged the first time."""
    kernel = wrapper.__name__
    key = (kernel, dev, *shape)
    pl = _plans.get(key)
    if pl is None:
        q_n, tq, docs, td, dim, pieces, aligned, m = shape
        pl = _plans[key] = plan(kernel, q_n, tq, docs, td, dim, pieces,
                                aligned, _sm_count(dev), m)
    if pl.variant == "ffma":
        if shape not in wrapper.ffma_plans:
            _log.info("%s: shape %s takes 'ffma' by the plan: %s", kernel,
                      shape, pl.reason)
        wrapper.ffma_plans[shape] = pl.reason
    wrapper.last_plan = pl
    return pl


def _count(wrapper, variant: str) -> None:
    wrapper.launches += 1
    wrapper.launches_by_variant[variant] += 1


# ---------------------------------------------------------------- M1


def maxsim_operands(queries, docs, precision: str):
    """fp32 operands whose fp32 token products are the products at
    `precision` (ops/distance.py:products): the inputs at "highest", their
    bf16 roundings at "default", the bf16 hi/lo split at "high" (dim
    becomes 3 dim). Products of bf16 values are exact in fp32."""
    if precision == "highest":
        return queries, docs
    a, b = bf16_operands(queries, docs, precision)
    return a.float(), b.float()


def maxsim_dense_plain(queries, q_mask, docs, d_mask,
                       precision: str = "highest"):
    """Dense MaxSim scores (Q, D) op by op: the token products at
    `precision` (a library product), then the doc mask, the max over doc
    tokens, the query mask and the sum; a NaN score is NEG."""
    q_n, tq = queries.shape[:2]
    d_n, td = docs.shape[:2]
    q2 = queries.reshape(q_n * tq, queries.shape[-1])
    d2 = docs.reshape(d_n * td, docs.shape[-1])
    sims = products(q2, d2, precision)                      # (Qt, D*Td)
    sims = torch.where(d_mask.reshape(1, d_n * td), sims, _scalar(NEG, sims))
    per_qtok = sims.view(q_n * tq, d_n, td).amax(dim=2)     # (Qt, D)
    per_qtok = torch.where(q_mask.reshape(q_n * tq, 1), per_qtok,
                           _scalar(0.0, sims))
    scores = per_qtok.view(q_n, tq, d_n).sum(dim=1)         # (Q, D)
    return torch.where(torch.isnan(scores), _scalar(NEG, sims), scores)


def maxsim_dense(queries, q_mask, docs, d_mask, precision: str = "highest"):
    """`maxsim_dense_plain`'s function: M1 on CUDA tensors (fp32 operands
    from `maxsim_operands`, one launch of the variant in force on its plan,
    no similarity matrix), the plain version on CPU tensors."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; must be one of "
                         f"{PRECISIONS}")
    if not _on_card(queries, "maxsim_dense"):
        return maxsim_dense_plain(queries, q_mask, docs, d_mask, precision)
    queries, q_mask, docs, d_mask = _checked("maxsim_dense", queries, q_mask,
                                             docs, d_mask)
    q, d = maxsim_operands(queries, docs, precision)
    (q_n, tq, _), (d_n, td, dim) = q.shape, d.shape
    dev = q.device
    out = torch.empty((q_n, d_n), device=dev)
    if out.numel() == 0:
        return out
    variant = _variant(maxsim_dense)
    if variant == "split":
        pieces = 3 if precision == "highest" else 1
        pl = _planned(maxsim_dense, dev, q_n, tq, d_n, td, dim, pieces,
                      _vec(dim, q, d) == 1, 0)
        variant = pl.variant
    with torch.cuda.device(dev):
        if variant == "split":
            err = _launcher("maxsim_dense", "split_launch")(
                q.data_ptr(), q_mask.data_ptr(), d.data_ptr(),
                d_mask.data_ptr(), out.data_ptr(), q_n, tq, d_n, td, dim,
                pl.pieces, pl.kc, pl.tq_p, pl.td_p, pl.grid[1],
                pl.smem_bytes, _stream(dev))
        else:
            err = _launcher("maxsim_dense")(
                q.data_ptr(), q_mask.data_ptr(), d.data_ptr(),
                d_mask.data_ptr(), out.data_ptr(), q_n, tq, d_n, td, dim,
                _vec(dim, q, d), _stream(dev))
    _raise_on(err, "maxsim_dense", variant)
    _count(maxsim_dense, variant)
    return out


maxsim_dense.launches = 0
maxsim_dense.launches_by_variant = {v: 0 for v in VARIANTS}
maxsim_dense.last_plan = None
maxsim_dense.ffma_plans = {}


# ---------------------------------------------------------------- M2


def gather_block(m: int, td: int, dim: int) -> int:
    """Query rows whose (rows, m, td, dim) fp32 gather stays within ~256
    MB: a power of two from 8 to 128."""
    blk = min(128, max(8, _GATHER_BYTES // max(1, m * td * dim * 4)))
    return 1 << (blk.bit_length() - 1)


def maxsim_pairs_plain(queries, q_mask, docs, d_mask, ids,
                       block: int | None = None):
    """Exact fp32 MaxSim of each query passage against its own candidate
    docs: (B, tq, dim), (B, tq), (N, td, dim), (N, td), ids (B, M) ->
    (B, M). The candidates are gathered `block` query rows at a time (None:
    `gather_block`); NaN scores stay NaN, an id outside [0, N) gives
    NaN."""
    b_n, m = ids.shape
    n, td, dim = docs.shape
    out = torch.full((b_n, m), _NAN, device=queries.device)
    if n == 0:
        return out
    step = max(1, block or gather_block(m, td, dim))
    for s in range(0, b_n, step):
        ib = ids[s:s + step].long()
        inside = (ib >= 0) & (ib < n)
        ib = torch.clamp(ib, 0, n - 1)
        qb, qmb = queries[s:s + step], q_mask[s:s + step]
        cb, cmb = docs[ib], d_mask[ib]             # (b, m, td, dim)
        sims = torch.einsum("btd,bmsd->btms", qb, cb)
        sims = torch.where(cmb[:, None, :, :], sims, _scalar(NEG, sims))
        per_tok = sims.amax(dim=3)                 # (b, tq, m)
        per_tok = torch.where(qmb[:, :, None], per_tok, _scalar(0.0, sims))
        out[s:s + step] = torch.where(inside, per_tok.sum(dim=1),
                                      _scalar(_NAN, sims))
    return out


def maxsim_pairs(queries, q_mask, docs, d_mask, ids,
                 block: int | None = None):
    """`maxsim_pairs_plain`'s function: M2 on CUDA tensors (one launch of
    the variant in force on its plan; the candidates read by id, never
    gathered, so `block` is not read), the plain version on CPU tensors
    (`block` bounds its gather)."""
    if not _on_card(queries, "maxsim_pairs"):
        return maxsim_pairs_plain(queries, q_mask, docs, d_mask, ids, block)
    queries, q_mask, docs, d_mask = _checked("maxsim_pairs", queries, q_mask,
                                             docs, d_mask)
    if ids.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"maxsim_pairs: ids must be int32 or int64, got "
                        f"{ids.dtype}")
    if ids.device != queries.device or ids.dim() != 2 \
            or ids.shape[0] != queries.shape[0]:
        raise ValueError(f"maxsim_pairs: ids {tuple(ids.shape)} on "
                         f"{ids.device} for queries "
                         f"{tuple(queries.shape)} on {queries.device}")
    ids = ids.to(torch.int64).contiguous()
    (b_n, tq, _), (n, td, dim) = queries.shape, docs.shape
    m = ids.shape[1]
    dev = queries.device
    out = torch.empty((b_n, m), device=dev)
    if out.numel() == 0:
        return out
    variant = _variant(maxsim_pairs)
    if variant == "split":
        pl = _planned(maxsim_pairs, dev, b_n, tq, n, td, dim, 3,
                      _vec(dim, queries, docs) == 1, m)
        variant = pl.variant
    with torch.cuda.device(dev):
        if variant == "split":
            err = _launcher("maxsim_pairs", "split_launch")(
                queries.data_ptr(), q_mask.data_ptr(), docs.data_ptr(),
                d_mask.data_ptr(), ids.data_ptr(), out.data_ptr(), b_n, tq,
                n, td, dim, m, pl.kc, pl.tq_p, pl.td_p, pl.cand_block,
                pl.smem_bytes, _stream(dev))
        else:
            err = _launcher("maxsim_pairs")(
                queries.data_ptr(), q_mask.data_ptr(), docs.data_ptr(),
                d_mask.data_ptr(), ids.data_ptr(), out.data_ptr(), b_n, tq,
                n, td, dim, m, _vec(dim, queries, docs), _stream(dev))
    _raise_on(err, "maxsim_pairs", variant)
    _count(maxsim_pairs, variant)
    return out


maxsim_pairs.launches = 0
maxsim_pairs.launches_by_variant = {v: 0 for v in VARIANTS}
maxsim_pairs.last_plan = None
maxsim_pairs.ffma_plans = {}


def reset_launches() -> None:
    """Set both wrappers' launch counts, in all and per variant, to 0, and
    forget the shapes the plan sent to "ffma"."""
    for wrapper in (maxsim_dense, maxsim_pairs):
        wrapper.launches = 0
        wrapper.launches_by_variant = {v: 0 for v in VARIANTS}
        wrapper.ffma_plans = {}
