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

Both kernels share csrc/maxsim_tile.cuh: fp32 products on the CUDA cores
with the max over doc tokens and the sum over query tokens folded into the
tile, so the (query tokens x doc tokens) similarity matrix is never
written. Their sums run in another order than the plain versions', within
the MaxSim tolerance; two launches give equal bits.

Each wrapper launches its kernel on CUDA tensors (and counts the launch)
or raises; on CPU tensors it runs the plain PyTorch version beside it,
which is the engines' op-by-op code as it was before the kernels. Nothing
is built at import: the kernels build at first use (utils/cuda_build.py).
"""

import ctypes

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

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# each source's C launch function, `<name>_launch`, and its arguments
_ARGTYPES = {
    "maxsim_dense": [_P, _P, _P, _P, _P, _I, _I, _LL, _I, _I, _I, _P],
    "maxsim_pairs": [_P, _P, _P, _P, _P, _P, _I, _I, _LL, _I, _I, _I, _I,
                     _P],
}


def _launcher(name: str):
    """Build (at first use) and load csrc/<name>.cu; its launch function."""
    from neighborhoodwatch_tpu_torch.utils import cuda_build
    lib = cuda_build.load(name)
    fn = getattr(lib, f"{name}_launch")
    if not getattr(lib, "_nw_typed", False):
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        lib._nw_typed = True
    return fn


def load_libraries():
    """Build (at first use) and load the two sources."""
    for name in _ARGTYPES:
        _launcher(name)


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


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
    from `maxsim_operands`, one launch, no similarity matrix), the plain
    version on CPU tensors."""
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
    with torch.cuda.device(dev):
        err = _launcher("maxsim_dense")(
            q.data_ptr(), q_mask.data_ptr(), d.data_ptr(), d_mask.data_ptr(),
            out.data_ptr(), q_n, tq, d_n, td, dim, _vec(dim, q, d),
            _stream(dev))
    _raise_on(err, "maxsim_dense")
    maxsim_dense.launches += 1
    return out


maxsim_dense.launches = 0


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
    """`maxsim_pairs_plain`'s function: M2 on CUDA tensors (one launch;
    the candidates read by id, never gathered, so `block` is not read), the
    plain version on CPU tensors (`block` bounds its gather)."""
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
    with torch.cuda.device(dev):
        err = _launcher("maxsim_pairs")(
            queries.data_ptr(), q_mask.data_ptr(), docs.data_ptr(),
            d_mask.data_ptr(), ids.data_ptr(), out.data_ptr(), b_n, tq, n,
            td, dim, m, _vec(dim, queries, docs), _stream(dev))
    _raise_on(err, "maxsim_pairs")
    maxsim_pairs.launches += 1
    return out


maxsim_pairs.launches = 0


def reset_launches() -> None:
    """Set both wrappers' launch counts to 0."""
    maxsim_dense.launches = 0
    maxsim_pairs.launches = 0
