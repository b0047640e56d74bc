"""The kNN engines' fused passes: hand-written Hopper counterparts of the
fusions XLA makes of the JAX package's jitted kNN core (ops/knn.py), which
are not Pallas kernels but single passes over HBM on the TPU.

  F1 `prepare_base` (csrc/prepare_base.cu): JAX `_prepare_arrays`
     (ops/knn.py:251): squared row norms, the bf16 screen operand and the
     certificate statistics in one read of the base. `sq_norms` launches
     the same kernel for the norms alone (the exact engines' base norms).
  F2 `distance_tile` (csrc/distance_tile.cu): the distance epilogue and
     validity mask of `pairwise_distance` inside JAX `_knn_scan`'s step
     (:137-146) and `_knn_full` (:154-163), on products that stay a library
     product (ops/distance.py:products).
  F3 `rerank_rows` (csrc/rerank_rows.cu): JAX `_exact_pair_dists` (:379)
     under `_screened_select`'s jit: each query's candidate rows read by
     id, fp32 distances, no gathered copy of the rows.
  F4 `split_distance` (csrc/split_distance.cu): the same step as F2 at
     precision "highest", product included: the fp32 products as an exact
     bf16x6 split on the tensor cores (the JAX package's "highest"), F2's
     epilogue and mask applied in the registers, each distance written
     once. It replaces the library's fp32 product and F2's pass over it
     wherever `split_plan` takes the shape (ops/distance.py:tile_distance
     asks); its error model is `split_error_bound` (csrc/split_distance.cu
     states it), within the dot budget of ops/knn.py:_acc_rel. A tile's
     pieces are cut once a tile, the query's once a call (`split_pieces`:
     a scan cuts them before its tiles and passes them to each).

Each wrapper launches its kernel on CUDA tensors (and counts the launch)
or raises; on CPU tensors it runs the plain PyTorch version beside it,
which is the engines' op-by-op code as it was before the kernels. Nothing
is built at import: the kernels build at first use (utils/cuda_build.py).

F3's variants (`VARIANTS`; `forced_variant(name)` selects one for timings
that hold them against each other; nothing on the main path forces one):
  "rowwise" the kernel, the default: a block a query and 64 of its
            candidates.
  "plain"   the plain version on CUDA tensors too.
Counts: `rerank_rows.launches` (the kernel), `.launches_by_variant`;
`split_distance.launches` (the product kernel),
`.split_launches` (the split pass), `.last_plan`, `.fp32_plans` (the
shapes the plan sent to the fp32 path, with the reason).
"""

import contextlib
import ctypes
import dataclasses
import logging

import torch

from neighborhoodwatch_tpu_torch.ops import screen_kernel

METRICS = ("sqeuclidean", "euclidean", "cosine", "dot")
_TILE_CODE = {"sqeuclidean": 0, "euclidean": 1, "cosine": 2, "dot": 2}
_RERANK_CODE = {"sqeuclidean": 0, "euclidean": 1, "cosine": 2, "dot": 3}

# bounds the plain versions' per-chunk temporaries (~0.5 GB)
_PREP_CHUNK_ELEMS = 1 << 27
# blocks of F1 an SM: eight warps a block, each a row at a time
_PREP_BLOCKS_PER_SM = 8

_INF = float("inf")


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# each source's C functions, `<name>_<entry>`, and their arguments
_ARGTYPES = {
    "prepare_base": {
        "launch": [_P, _LL, _I, _I, _I, _P, _P, _P, _P, ctypes.c_float, _I,
                   _P]},
    "distance_tile": {
        "launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]},
    "rerank_rows": {
        "launch": [_P, _P, _P, _P, _I, _I, _I, _LL, _I, _I, _P]},
    "split_distance": {
        "launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                   _P],
        "pieces_launch": [_P, _LL, _I, _I, _P, _P]},
}

VARIANTS = ("rowwise", "plain")
_forced_variant = None
_log = logging.getLogger(__name__)


@contextlib.contextmanager
def forced_variant(name: str):
    """Run F3 on CUDA tensors through `name` ("rowwise" or "plain") instead
    of its default, for timings that hold them against each other."""
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
    """Build (at first use) and load the four sources."""
    for name in _ARGTYPES:
        _launcher(name)


def _cuda_f32(t, name):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: on {t.device}, expected a CUDA device")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    return t.contiguous()


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


_sms: dict[torch.device, int] = {}


def _sm_count(device) -> int:
    n = _sms.get(device)
    if n is None:
        n = _sms[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


# ---------------------------------------------------------------- F1


def prepare_plain(base):
    """(bn_row, stats, bhi) op by op, in row chunks that keep the bf16
    rounding's temporaries small. stats = [bn_max, babs_max, blo_max,
    ratio_max], every entry an UPPER bound for the certificate eps (each
    computed norm carries the worst-case fp32 accumulation guard);
    non-finite rows are excluded (they never become candidates)."""
    n, dim = base.shape
    g = screen_kernel.norm_guard(dim)
    dev = base.device
    bn_row = torch.empty(n, device=dev)
    blo_n = torch.empty(n, device=dev)
    bhi = torch.empty((n, dim), dtype=torch.bfloat16, device=dev)
    step = max(1, _PREP_CHUNK_ELEMS // max(dim, 1))
    for s in range(0, n, step):
        x = base[s:s + step]
        bn_row[s:s + step] = (x * x).sum(1)
        hf = screen_kernel.bf16_round(x)
        bhi[s:s + step] = hf.to(torch.bfloat16)
        r = x - hf
        blo_n[s:s + step] = torch.sqrt((r * r).sum(1))
    finite = torch.isfinite(bn_row)
    zero = torch.zeros((), device=dev)
    bn_max = torch.where(finite, bn_row, zero).max() * g
    blo_max = torch.where(finite, blo_n, zero).max() * g
    ratio = blo_n * torch.rsqrt(torch.clamp_min(bn_row, 1e-30))
    ratio_max = torch.where(finite & (bn_row > 0.0), ratio, zero).max() * g
    stats = torch.stack([bn_max, torch.sqrt(bn_max), blo_max, ratio_max])
    return bn_row, stats, bhi


def sq_norms_plain(x):
    """(n,) squared row norms of (n, dim) fp32 rows, in row chunks."""
    n, dim = x.shape
    out = torch.empty(n, device=x.device)
    step = max(1, _PREP_CHUNK_ELEMS // max(dim, 1))
    for s in range(0, n, step):
        c = x[s:s + step]
        out[s:s + step] = (c * c).sum(1)
    return out


def _launch_prepare(x, bhi, maxima, stats):
    n, dim = x.shape
    dev = x.device
    bn_row = torch.empty(n, device=dev)
    vec = int(dim % 4 == 0 and x.data_ptr() % 16 == 0)
    grid = max(1, min(-(-n // 8), _sm_count(dev) * _PREP_BLOCKS_PER_SM))
    guard = screen_kernel.norm_guard(dim)
    ptr = (lambda t: None if t is None else t.data_ptr())
    with torch.cuda.device(dev):
        err = _launcher("prepare_base")(
            x.data_ptr(), n, dim, vec, int(bhi is not None),
            bn_row.data_ptr(), ptr(bhi), ptr(maxima), ptr(stats), guard,
            grid, _stream(dev))
    _raise_on(err, "prepare_base")
    prepare_base.launches += 1
    return bn_row


def prepare_base(base):
    """(bn_row (n,) f32, stats (4,) f32, bhi (n, dim) bf16) of an (n, dim)
    f32 base, as `prepare_plain` defines them. CUDA tensors launch F1 (one
    read of the base; no temporary beyond the outputs) or raise; CPU
    tensors take the plain version. On the card bhi equals the plain
    version's bit for bit; bn_row and the statistics differ from it only by
    the order of addition, which the statistics' guard covers."""
    if base.device.type == "cpu":
        return prepare_plain(base)
    x = _cuda_f32(base, "base")
    n, dim = x.shape
    bhi = torch.empty((n, dim), dtype=torch.bfloat16, device=x.device)
    maxima = torch.empty(3, dtype=torch.int32, device=x.device)
    stats = torch.empty(4, device=x.device)
    bn_row = _launch_prepare(x, bhi, maxima, stats)
    return bn_row, stats, bhi


def sq_norms(x):
    """(n,) f32 squared row norms of (n, dim) f32 rows: F1 without its bf16
    operand and statistics on CUDA tensors (the same sums as its bn_row,
    bit for bit), the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return sq_norms_plain(x)
    return _launch_prepare(_cuda_f32(x, "x"), None, None, None)


prepare_base.launches = 0


# ---------------------------------------------------------------- F2


def distance_tile_plain(dots, qn, bn, metric: str, lo: int = 0,
                        hi: int | None = None):
    """(Q, T) distances from f32 products `dots`: for (sq)euclidean from
    the squared norms qn (Q,) and bn (T,) as max((qn + bn) - 2 dots, 0)
    (sqrt for euclidean), else 1 - dots; non-finite distances and columns
    outside [lo, hi) are +inf."""
    if metric in ("sqeuclidean", "euclidean"):
        d = torch.clamp_min(qn[:, None] + bn[None, :] - 2.0 * dots, 0.0)
        if metric == "euclidean":
            d = torch.sqrt(d)
    else:
        d = 1.0 - dots
    d = torch.where(torch.isfinite(d), d, torch.full_like(d, _INF))
    t = dots.shape[1]
    hi = t if hi is None else hi
    if lo > 0 or hi < t:
        cols = torch.arange(t, device=dots.device)
        d = torch.where(((cols >= lo) & (cols < hi))[None, :], d, _INF)
    return d


def distance_tile(dots, qn, bn, metric: str, lo: int = 0,
                  hi: int | None = None):
    """`distance_tile_plain`'s function: F2 on CUDA tensors (bit for bit
    the plain version's for the same norms; one read of the products, one
    write), the plain version on CPU tensors. qn and bn are read only for
    the (sq)euclidean metrics."""
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}; must be one of "
                         f"{METRICS}")
    if dots.device.type == "cpu":
        return distance_tile_plain(dots, qn, bn, metric, lo, hi)
    dots = _cuda_f32(dots, "dots")
    q_rows, t = dots.shape
    hi = t if hi is None else int(hi)
    lo, hi = max(0, min(int(lo), t)), max(0, min(hi, t))
    l2 = metric in ("sqeuclidean", "euclidean")
    if l2:
        qn, bn = _cuda_f32(qn, "qn"), _cuda_f32(bn, "bn")
        if qn.shape != (q_rows,) or bn.shape != (t,):
            raise ValueError(f"norms {tuple(qn.shape)}, {tuple(bn.shape)} "
                             f"for a ({q_rows}, {t}) tile")
    out = torch.empty_like(dots)
    vec = int(t % 4 == 0 and dots.data_ptr() % 16 == 0
              and out.data_ptr() % 16 == 0)
    dev = dots.device
    with torch.cuda.device(dev):
        err = _launcher("distance_tile")(
            dots.data_ptr(), qn.data_ptr() if l2 else None,
            bn.data_ptr() if l2 else None, out.data_ptr(), q_rows, t, lo, hi,
            _TILE_CODE[metric], vec, _stream(dev))
    _raise_on(err, "distance_tile")
    distance_tile.launches += 1
    return out


distance_tile.launches = 0


# ---------------------------------------------------------------- F3


def rerank_plain(query, base, ids, metric: str, block: int | None = None):
    """Exact fp32 distances of query[t] against its own candidate rows
    base[ids[t]]: (T, dim), (B, dim), (T, M) -> (T, M). The rows are
    gathered `block` query rows at a time (all at once for None), which
    bounds the (block, M, dim) gather."""
    step = max(1, block or query.shape[0])
    out = torch.empty(ids.shape, device=query.device)
    for s in range(0, query.shape[0], step):
        qb = query[s:s + step]
        cb = base[ids[s:s + step].long()]
        dots = torch.bmm(cb, qb[:, :, None])[:, :, 0]
        if metric in ("sqeuclidean", "euclidean"):
            qn = (qb * qb).sum(1)
            cn = (cb * cb).sum(2)
            d = torch.clamp_min(qn[:, None] + cn - 2.0 * dots, 0.0)
            if metric == "euclidean":
                d = torch.sqrt(d)
        elif metric == "cosine":
            qn = torch.sqrt((qb * qb).sum(1))
            cn = torch.sqrt((cb * cb).sum(2))
            denom = torch.clamp_min(qn[:, None] * cn, 1e-30)
            d = 1.0 - dots / denom
        else:  # dot
            d = 1.0 - dots
        out[s:s + step] = d
    return out


def rerank_rows(query, base, ids, metric: str, block: int | None = None):
    """`rerank_plain`'s function: F3 on CUDA tensors (the candidate rows
    read by id, never gathered; fp32 products and norms with fp32
    accumulation; within the fp32 tolerance of the plain version, whose
    sums run in another order; an id outside the base gives NaN), the
    plain version on CPU tensors (`block` bounds its gather)."""
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}; must be one of "
                         f"{METRICS}")
    if query.device.type == "cpu":
        return rerank_plain(query, base, ids, metric, block)
    if _forced_variant == "plain":
        rerank_rows.launches_by_variant["plain"] += 1
        return rerank_plain(query, base, ids, metric, block)
    query, base = _cuda_f32(query, "query"), _cuda_f32(base, "base")
    q_rows, dim = query.shape
    if base.shape[1] != dim or ids.shape[0] != q_rows or ids.device != \
            query.device or base.device != query.device:
        raise ValueError(f"query {tuple(query.shape)}, base "
                         f"{tuple(base.shape)}, ids {tuple(ids.shape)} on "
                         f"{query.device}, {base.device}, {ids.device}")
    ids = ids.to(torch.int64).contiguous()
    m = ids.shape[1]
    n_base = base.shape[0]
    out = torch.empty((q_rows, m), device=query.device)
    dev = query.device
    vec = int(dim % 4 == 0 and base.data_ptr() % 16 == 0)
    with torch.cuda.device(dev):
        err = _launcher("rerank_rows")(
            query.data_ptr(), base.data_ptr(), ids.data_ptr(),
            out.data_ptr(), q_rows, m, dim, n_base, _RERANK_CODE[metric],
            vec, _stream(dev))
    _raise_on(err, "rerank_rows")
    rerank_rows.launches += 1
    rerank_rows.launches_by_variant["rowwise"] += 1
    return out


# ---------------------------------------------------------------- F4
# (mirrors csrc/split_distance.cu: its launcher recomputes the chunk and
# the shared memory and refuses a plan it would not make)

SPLIT_BLOCK = 128             # query rows and base rows a block
SPLIT_SLOT_COLS = 32          # columns a ring slot
SPLIT_CHUNKS = (128, 64, 32)  # the promotion chunks, longest first
SPLIT_SMEM = 1024 + 4 * 3 * 2 * SPLIT_BLOCK * 2 * SPLIT_SLOT_COLS + 16 * 4
# fewest query rows a launch takes, from SPLIT_WIDE_DIM dims and below:
# with fewer, the library's fp32 product and F2 were as fast or faster on
# the card (PERF.md)
SPLIT_WIDE_DIM = 1024
SPLIT_MIN_Q = 160
SPLIT_MIN_Q_NARROW = 1000
_SPLIT_CODE = {"sqeuclidean": 0, "euclidean": 1, "cosine": 2, "dot": 2}
_NAN = float("nan")           # any NaN keeps its high mantissa bits
_LOW16 = -65536               # 0xffff0000 as an int32


def split_error_bound(dim: int, kc: int) -> float:
    """F4's dot error bound in units of 2^-24 sum_k |q_k b_k|: the bf16x6
    split's model with three pieces (ops/maxsim_fused.py:error_bound, the
    one formula csrc/maxsim_split.cuh states): dropped terms 16.0625, a
    tensor-core chunk of kc dims of x0 y0 (2 kc), the five small products
    over the whole dim (dim (10/64 + 30/16384)), a promotion a chunk."""
    from neighborhoodwatch_tpu_torch.ops import maxsim_fused
    return maxsim_fused.error_bound(dim, kc, 3)


def split_chunk_for(dim: int) -> int:
    """The longest chunk of SPLIT_CHUNKS whose bound stays within dim
    2^-24, the fp32 dot's budget (ops/knn.py:_acc_rel), else 0: 128 at
    1,024 and 1,536 dims (442 and 527 units) and from 328, 64 from 176, 32
    from 100, none below (those dims keep the fp32 path)."""
    for kc in SPLIT_CHUNKS:
        if split_error_bound(dim, kc) <= dim:
            return kc
    return 0


def split_min_q(dim: int) -> int:
    """The fewest query rows F4 takes at `dim`: SPLIT_MIN_Q from
    SPLIT_WIDE_DIM dims, SPLIT_MIN_Q_NARROW below."""
    return SPLIT_MIN_Q if dim >= SPLIT_WIDE_DIM else SPLIT_MIN_Q_NARROW


def piece_ld(dim: int) -> int:
    """The row stride of the bf16 pieces: dim rounded up to 8 (16-byte
    rows, as TMA reads them)."""
    return -(-dim // 8) * 8


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """F4's launch, or the fp32 path with the reason."""
    route: str              # "split" or "fp32"
    reason: str             # why "fp32" ("" for "split")
    kc: int                 # dims a promotion chunk
    cluster: int            # blocks a cluster (the base boxes multicast)
    grid: int               # blocks
    smem_bytes: int
    bound: float            # split_error_bound(dim, kc)


def _fp32(reason: str) -> SplitPlan:
    return SplitPlan("fp32", reason, 0, 0, 0, 0, 0.0)


def split_plan(q_rows: int, t_rows: int, dim: int,
               aligned: bool = True) -> SplitPlan:
    """F4's launch for `q_rows` query rows against `t_rows` base rows of
    `dim` values, by rules of shape only: "split" where the error model
    admits the dim (split_chunk_for), the rows are whole 16-byte groups
    (dim % 4 == 0) at 16-byte aligned addresses (`aligned`), and the call
    has split_min_q(dim) query rows or more; else "fp32" with the reason
    ("empty", "dim", "unaligned", "rows", "size")."""
    if min(q_rows, t_rows, dim) < 0:
        raise ValueError(f"split_plan({q_rows}, {t_rows}, {dim}): nothing "
                         f"to plan")
    if q_rows == 0 or t_rows == 0:
        return _fp32("empty")
    kc = split_chunk_for(dim) if dim % 4 == 0 else 0
    if kc == 0:
        return _fp32("dim")
    if not aligned:
        return _fp32("unaligned")
    if q_rows < split_min_q(dim):
        return _fp32("rows")
    qb = -(-q_rows // SPLIT_BLOCK)
    cluster = 2 if qb >= 2 else 1
    grid = -(-qb // cluster) * cluster * -(-t_rows // SPLIT_BLOCK)
    if grid >= 2 ** 31:
        return _fp32("size")
    return SplitPlan("split", "", kc, cluster, grid, SPLIT_SMEM,
                     split_error_bound(dim, kc))


_split_plans: dict = {}


def _aligned16(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def planned_split(q, tile) -> SplitPlan | None:
    """`split_plan_for(q, tile)` on the card, None for tensors off it."""
    if q.device.type != "cuda":
        return None
    return split_plan_for(q, tile)


def split_plan_for(q, tile) -> SplitPlan:
    """split_plan for F4 on the prepared query rows `q` (Q, d) against the
    base rows `tile` (T, d), once per shape. A shape sent to the fp32 path
    is kept in `split_distance.fp32_plans` and logged the first time."""
    (q_rows, dim), t_rows = q.shape, tile.shape[0]
    aligned = (q.is_contiguous() and tile.is_contiguous()
               and _aligned16(q, tile))
    key = (q.device, q_rows, t_rows, dim, aligned)
    pl = _split_plans.get(key)
    if pl is None:
        pl = _split_plans[key] = split_plan(q_rows, t_rows, dim, aligned)
    if pl.route == "fp32":
        shape = (q_rows, t_rows, dim, aligned)
        if shape not in split_distance.fp32_plans:
            _log.info("split_distance: %s x %s rows of %s dims (aligned %s) "
                      "take the fp32 path by the plan: %s", *shape, pl.reason)
        split_distance.fp32_plans[shape] = pl.reason
    split_distance.last_plan = pl
    return pl


def split_pieces_plain(x):
    """The three pieces of fp32 rows x (n, dim), each (n, dim) fp32 holding
    bf16 values: a NaN made canonical, x0 = x with its low 16 bits cleared,
    x1 the same of x - x0, x2 the same of (x - x0) - x1; x0 + x1 + x2 == x
    for every finite x whose last bit lies at or above 2^-133."""
    x = torch.where(torch.isnan(x), torch.full_like(x, _NAN), x)

    def cut(v):
        return (v.view(torch.int32) & _LOW16).view(torch.float32)
    x0 = cut(x)
    r1 = x - x0
    x1 = cut(r1)
    return x0, x1, cut(r1 - x1)


def split_distance_plain(q, qn, tile, bn, metric: str, lo: int = 0,
                         hi: int | None = None, kc: int | None = None):
    """F4's function op by op in fp32: the pieces of q and tile
    (split_pieces_plain), x0 y0 summed a chunk of `kc` dims at a time
    (split_chunk_for(dim) by default) and added into an fp32 total, the
    five small products (order 2, then 1) over the whole dim added last,
    then `distance_tile_plain`. Products of pieces are exact in fp32; the
    sums run in the library's order, within split_error_bound."""
    dim = q.shape[1]
    kc = kc or split_chunk_for(dim)
    if kc <= 0:
        raise ValueError(f"split_distance: no chunk admits dim {dim}")
    a, b = split_pieces_plain(q.float()), split_pieces_plain(tile.float())
    dots = torch.zeros((q.shape[0], tile.shape[0]), device=q.device)
    for s in range(0, dim, kc):
        dots = dots + a[0][:, s:s + kc] @ b[0][:, s:s + kc].T
    small = a[2] @ b[0].T
    for i, j in ((1, 1), (0, 2), (1, 0), (0, 1)):
        small = small + a[i] @ b[j].T
    return distance_tile_plain(dots + small, qn, bn, metric, lo, hi)


def split_pieces(x):
    """(3, n, piece_ld(dim)) bf16 pieces of (n, dim) fp32 rows on the card:
    one launch of F4's split pass."""
    n, dim = x.shape
    ld = piece_ld(dim)
    out = torch.empty((3, n, ld), dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        err = _launcher("split_distance", "pieces_launch")(
            x.data_ptr(), n, dim, ld, out.data_ptr(), _stream(x.device))
    _raise_on(err, "split_distance (pieces)")
    split_distance.split_launches += 1
    return out


def split_distance(q, qn, tile, bn, metric: str, lo: int = 0,
                   hi: int | None = None, plan: SplitPlan | None = None,
                   q_pieces=None):
    """`split_distance_plain`'s function on the card: one launch of F4 on
    `plan` (planned_split's for q and tile, computed here if not given; a
    shape it sends to the fp32 path raises: ops/distance.py:tile_distance
    routes by the same plan). q: the prepared fp32 query rows (Q, d), qn /
    bn their and the tile's squared norms ((sq)euclidean only), tile (T,
    d) fp32. `q_pieces`: split_pieces(q), where the caller cuts them once
    for many tiles; else cut here. The tile's pieces are cut here (one
    pass). Within split_error_bound of the exact dot, not bit for bit the
    plain version's (another order of the sums); two launches give equal
    bits."""
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}; must be one of "
                         f"{METRICS}")
    q, tile = _cuda_f32(q, "q"), _cuda_f32(tile, "tile")
    pl = planned_split(q, tile) if plan is None else plan
    if pl is None or pl.route != "split":
        raise ValueError(f"split_distance: the plan sends {tuple(q.shape)} x "
                         f"{tuple(tile.shape)} to the fp32 path "
                         f"({pl and pl.reason})")
    (q_rows, dim), t = q.shape, tile.shape[0]
    if tile.shape[1] != dim or tile.device != q.device:
        raise ValueError(f"q {tuple(q.shape)} on {q.device}, tile "
                         f"{tuple(tile.shape)} on {tile.device}")
    hi = t if hi is None else int(hi)
    lo, hi = max(0, min(int(lo), t)), max(0, min(hi, t))
    l2 = metric in ("sqeuclidean", "euclidean")
    if l2:
        qn, bn = _cuda_f32(qn, "qn"), _cuda_f32(bn, "bn")
        if qn.shape != (q_rows,) or bn.shape != (t,):
            raise ValueError(f"norms {tuple(qn.shape)}, {tuple(bn.shape)} "
                             f"for a ({q_rows}, {t}) tile")
    qp = split_pieces(q) if q_pieces is None else q_pieces
    if qp.shape != (3, q_rows, piece_ld(dim)):
        raise ValueError(f"query pieces {tuple(qp.shape)} for q "
                         f"{tuple(q.shape)}")
    bp = split_pieces(tile)
    out = torch.empty((q_rows, t), device=q.device)
    dev = q.device
    with torch.cuda.device(dev):
        err = _launcher("split_distance")(
            qp.data_ptr(), bp.data_ptr(), qn.data_ptr() if l2 else None,
            bn.data_ptr() if l2 else None, out.data_ptr(), q_rows, t, dim,
            lo, hi, _SPLIT_CODE[metric], pl.kc, pl.cluster, pl.smem_bytes,
            _stream(dev))
    _raise_on(err, "split_distance")
    split_distance.launches += 1
    return out


def reset_launches() -> None:
    """Set every wrapper's launch counts to 0 (F3's per variant too) and
    forget the shapes F4's plan sent to fp32."""
    prepare_base.launches = 0
    distance_tile.launches = 0
    rerank_rows.launches = 0
    rerank_rows.launches_by_variant = {v: 0 for v in VARIANTS}
    split_distance.launches = 0
    split_distance.split_launches = 0
    split_distance.fp32_plans = {}
    split_distance.last_plan = None


reset_launches()
