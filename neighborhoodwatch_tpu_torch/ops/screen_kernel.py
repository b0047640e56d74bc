"""Fused distance + candidate screening for exact kNN (counterpart of
ops/screen_kernel.py).

The hot kernel of the screened engine. For every query and every base row
it computes the screen-space distance from a bf16 product with fp32
accumulation in 1, 2 or 3 passes (qhi.bhi [+ qlo.bhi [+ qhi.blo]]), packs
the distance's bits and the row's position in its lane bin into one
sortable int32 key (low POS_BITS mantissa bits replaced by the position),
and keeps the KEEP smallest keys per lane bin. A bin is (mega-tile, row %
128): a mega-tile holds TB*sub rows, so a bin holds sub*8 rows and the
position of row r in it is (r % mega_rows) // 128.

The KEEP-th minimum of a bin is the exactness certificate consumed by
ops/knn.py: if it lies beyond tau + eps, at most KEEP-1 bin members can be
true neighbors and all of them are candidates.

`screen_keys` is the one kernel entry: on CUDA tensors it launches the
hand-written Hopper kernel in csrc/screen_keys.cu (replacing the three
Pallas schedules `_kernel_fused`, `_kernel_pipelined` and `_kernel` of the
JAX package), on CPU tensors it runs `screen_keys_plain`, the vectorized
PyTorch version of the same function (same bf16 operands, same epilogues,
same bins, key packing and lowest-KEEP order).
"""

import ctypes

import torch

from neighborhoodwatch_tpu_torch.utils.misc import cdiv

LANES = 128
TB = 1024           # rows per sub-tile; sub counts megas in TB units
SUB_PER_MEGA = 28   # default sub-tiles per mega-tile -> 28,672 rows
MEGA = TB * SUB_PER_MEGA
KEEP = 4            # minima kept per lane bin (the last is the certificate)
CAND_PER_MEGA = KEEP * LANES

# base row count from which the wide (sub=56/112) mega-tiles are used
_BIG_BASE = 16 * TB * 56

# low mantissa bits of the fp32 distance replaced by the bin position
POS_BITS = 10
POS_MASK = (1 << POS_BITS) - 1
# relative screening error of the key quantization (folded into the
# certificate eps by ops/knn.py; 4x the 2^-13 worst-case floor)
PACK_EPS_REL = 2.0 ** -11

SCREEN_PRECISIONS = ("default", "medium", "high")
PASSES = {"default": 1, "medium": 2, "high": 3}
EPILOGUES = ("l2", "dot", "rdot")
_EPILOGUE_CODE = {"l2": 0, "dot": 1, "rdot": 2}


def pick_sub(n_rows: int, k: int | None = None,
             q_rows: int | None = None) -> int:
    """Sub-tiles (TB-row units) per mega-tile for a base of `n_rows`.

    Wider megas halve the candidate width the select merges, at the price
    of bigger bins (sub*8 rows) and so more certificate repairs as k grows:
    the widest tier (sub=112, 896-row bins) is used only for k <= 150 and
    query batches up to 24,576 rows; k unknown -> the safe 56."""
    if n_rows < _BIG_BASE:
        return SUB_PER_MEGA
    wide_ok = (k is not None and k <= 150
               and (q_rows is None or q_rows <= 24576))
    return 112 if wide_ok else 56


def norm_guard(dim: int) -> float:
    """Worst-case multiplicative guard for an fp32-computed Euclidean norm
    (or squared norm) over `dim` terms: the positive-term sum-of-squares
    error is <= (dim+1)*2^-24 relative in any add order; the 1.05 factor
    covers second-order terms and the guard multiply's own rounding.
    Every certificate-critical max-statistic enters the eps bound through
    this guard."""
    return 1.0 + (dim + 8) * 2.0 ** -24 * 1.05


def bf16_round(x):
    """Round-to-nearest-even bf16 image of f32 `x`, returned in f32 and
    computed with integer ops (bit-identical to the hardware conversion on
    every non-NaN value). NaNs pass through unchanged, payload included,
    so a garbage row's residual stays NaN and the screen excludes it.

    Carry in int32 without overflow: NaN lanes are zeroed before the add,
    and for every other value bits + 0x8000 stays inside int32 (positive
    finite/inf bits are <= 0x7F800000; negative ones only move towards
    zero). `>>` on int32 is arithmetic, so the lsb is masked with & 1."""
    xf = x.float()
    nan = torch.isnan(xf)
    bits = torch.where(nan, 0, xf.view(torch.int32))
    lsb = (bits >> 16) & 1
    rounded = (bits + 0x7FFF + lsb) & -65536        # 0xFFFF0000
    return torch.where(nan, xf, rounded.view(torch.float32))


def _decode_keys(keys, epilogue: str, mega_rows: int):
    """packed keys -> (quantized distance f32, exact global row id int32).
    Column c of a query's keys is (mega c // 512, slab (c // 128) % 4,
    lane c % 128); the row is mega*mega_rows + pos*128 + lane."""
    vbits = keys & ~POS_MASK
    if epilogue != "l2":
        neg = vbits >> 31
        vbits = vbits ^ (neg & 0x7FFFFFFF)
    cand_d = vbits.view(torch.float32)
    pos = keys & POS_MASK
    col = torch.arange(keys.shape[1], device=keys.device, dtype=torch.int32)
    mega_i = col // CAND_PER_MEGA
    lane = col % LANES
    cand_i = mega_i * mega_rows + pos * LANES + lane
    return cand_d, cand_i


def _screen_dist(acc, qn, bn, epilogue: str, passes: int):
    """Screen-space distance from the fp32 dot `acc` (Q, R), the query
    squared norms qn (Q, 1) and the base squared norms bn (1, R), +inf on
    padding rows. l2 at passes <= 2 is the fused form |qn + bn - 2acc|;
    at passes = 3 it is |max(qn + bn - 2acc, 0)| (NaN kept, so a NaN
    distance sorts past +inf). Signed epilogues map NaN to +inf."""
    inf = torch.tensor(float("inf"), device=acc.device)
    if epilogue == "l2":
        d = (qn + bn) - 2.0 * acc
        if passes >= 3:
            d = torch.where(d < 0, torch.zeros_like(d), d)
        return torch.abs(d)
    if epilogue == "dot":
        d = torch.where(torch.isinf(bn), inf, -acc)
    else:
        bnc = torch.where(torch.isnan(bn), bn, torch.clamp_min(bn, 1e-30))
        d = torch.where(torch.isinf(bn), inf, -acc * torch.rsqrt(bnc))
    return torch.where(torch.isnan(d), inf, d)


def _pack(d, epilogue: str, pos):
    bits = d.contiguous().view(torch.int32)
    if epilogue != "l2":
        neg = bits >> 31
        bits = bits ^ (neg & 0x7FFFFFFF)
    return (bits & ~POS_MASK) | pos


def screen_keys_plain(qhi, qlo, bhi, blo, qn, bn, mega_rows: int,
                      passes: int, epilogue: str):
    """Plain PyTorch version of the screen kernel, one mega-tile at a time.
    bf16 x bf16 products are exact in fp32, so the fp32 matmul of the
    widened operands differs from the kernel only in accumulation order."""
    Q = qhi.shape[0]
    B = bhi.shape[0]
    n_mega = cdiv(B, mega_rows)
    n_pos = mega_rows // LANES
    dev = qhi.device
    out = torch.empty((Q, n_mega * CAND_PER_MEGA), dtype=torch.int32,
                      device=dev)
    qh = qhi.float()
    ql = qlo.float() if passes >= 2 else None
    qn = qn.float()[:, None]
    pos = torch.arange(n_pos, device=dev, dtype=torch.int32)
    pos = pos[:, None].expand(n_pos, LANES).reshape(1, -1)
    for m in range(n_mega):
        lo, hi = m * mega_rows, min(B, (m + 1) * mega_rows)
        bh = torch.zeros((mega_rows, bhi.shape[1]), device=dev)
        bh[: hi - lo] = bhi[lo:hi].float()
        acc = qh @ bh.T
        if passes >= 2:
            acc = acc + ql @ bh.T
        if passes >= 3:
            bl = torch.zeros_like(bh)
            bl[: hi - lo] = blo[lo:hi].float()
            acc = acc + qh @ bl.T
        bnm = torch.full((1, mega_rows), float("inf"), device=dev)
        bnm[0, : hi - lo] = bn[lo:hi].float()
        keys = _pack(_screen_dist(acc, qn, bnm, epilogue, passes),
                     epilogue, pos)
        # (Q, pos, lane) -> lowest KEEP per lane (keys are distinct per bin)
        low = torch.sort(keys.view(Q, n_pos, LANES), dim=1).values[:, :KEEP]
        out[:, m * CAND_PER_MEGA:(m + 1) * CAND_PER_MEGA] = low.reshape(Q, -1)
    return out


def load_library():
    """Build (at first use) and load csrc/screen_keys.cu."""
    from neighborhoodwatch_tpu_torch.utils import cuda_build
    lib = cuda_build.load("screen_keys")
    if not getattr(lib, "_nw_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.screen_keys_launch.argtypes = [p, p, p, p, p, p, p,
                                           i, i, i, i, i, i, i, i, p]
        lib.screen_keys_launch.restype = i
        lib._nw_typed = True
    return lib


def _check(t, name, dtype, shape, device):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def screen_keys(qhi, qlo, bhi, blo, qn, bn, mega_rows: int, passes: int,
                epilogue: str):
    """(Q, n_mega*512) int32 packed keys: out[q, mega*512 + t*128 + lane]
    is the t-th smallest key of bin (mega, lane), slab t=3 the certificate.

    qhi/qlo (Q, D) and bhi/blo (B, D) bf16 operands (qlo only at passes
    >= 2, blo only at passes 3), qn (Q,) and bn (B,) f32 squared norms with
    +inf on masked base rows. CPU tensors take the plain version; CUDA
    tensors launch the kernel (and count the launch) or raise."""
    if passes not in (1, 2, 3) or epilogue not in EPILOGUES:
        raise ValueError(f"passes={passes} epilogue={epilogue!r}")
    if mega_rows % LANES or mega_rows // LANES > (1 << POS_BITS):
        raise ValueError(f"mega_rows={mega_rows}: positions exceed "
                         f"{POS_BITS} bits")
    Q, D = qhi.shape
    B = bhi.shape[0]
    if qhi.device.type == "cpu":
        return screen_keys_plain(qhi, qlo, bhi, blo, qn, bn, mega_rows,
                                 passes, epilogue)
    if qhi.device.type != "cuda":
        raise ValueError(f"unsupported device {qhi.device}")
    dev = qhi.device
    _check(qhi, "qhi", torch.bfloat16, (Q, D), dev)
    _check(bhi, "bhi", torch.bfloat16, (B, D), dev)
    if passes >= 2:
        _check(qlo, "qlo", torch.bfloat16, (Q, D), dev)
    if passes >= 3:
        _check(blo, "blo", torch.bfloat16, (B, D), dev)
    _check(qn, "qn", torch.float32, (Q,), dev)
    _check(bn, "bn", torch.float32, (B,), dev)
    n_mega = cdiv(B, mega_rows)
    out = torch.empty((Q, n_mega * CAND_PER_MEGA), dtype=torch.int32,
                      device=dev)
    if Q == 0 or n_mega == 0:
        return out
    ops = [qhi, qlo if passes >= 2 else qhi, bhi, blo if passes >= 3 else bhi]
    vec = int(D % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in ops))
    with torch.cuda.device(dev):
        err = load_library().screen_keys_launch(
            ops[0].data_ptr(), ops[1].data_ptr(), ops[2].data_ptr(),
            ops[3].data_ptr(), qn.data_ptr(), bn.data_ptr(), out.data_ptr(),
            Q, B, D, mega_rows, n_mega, passes, _EPILOGUE_CODE[epilogue],
            vec, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"screen_keys kernel launch failed: CUDA error "
                           f"{err}")
    screen_keys.launches += 1
    return out


screen_keys.launches = 0


def screen_candidates(q, base, *, n_rows: int | None = None,
                      epilogue: str = "l2", screen_precision: str = "high",
                      sub: int | None = None, n_valid=None, bn_row=None,
                      bhi=None):
    """Fused distance+screen: (Q, D) x (B, D) -> (Q, C) candidate
    (distance, global row) lists, C = KEEP*128 per (TB*sub)-row mega-tile.
    Returns (cand_d, cand_i, n_mega); the last KEEP-slab of each mega is
    the certificate slab.

    Rows at or past `n_rows` (default: all) or `n_valid` take +inf norms
    and never win a bin; the grid covers whole mega-tiles (virtual rows
    past B are masked inside the kernel, so the corpus is never padded).
    `bn_row` (precomputed squared norms) and `bhi` (= bf16(base)) skip the
    per-call corpus passes (ops.knn.prepare_base)."""
    assert screen_precision in SCREEN_PRECISIONS
    assert epilogue in EPILOGUES
    passes = PASSES[screen_precision]
    q = q.float()
    Q, D = q.shape
    B = base.shape[0] if n_rows is None else n_rows
    assert B <= base.shape[0]
    if sub is None:
        sub = pick_sub(B)
    assert sub * (TB // LANES) <= (1 << POS_BITS), \
        f"sub={sub} exceeds {POS_BITS}-bit positions"
    mega = TB * sub
    n_mega = cdiv(B, mega)
    b = base[:B]
    qn = (q * q).sum(1)
    bn = (bn_row[:B].float() if bn_row is not None
          else (b.float() * b.float()).sum(1))
    if n_valid is not None:
        rows = torch.arange(B, device=bn.device)
        bn = torch.where(rows < n_valid, bn,
                         torch.tensor(float("inf"), device=bn.device))
    bn = bn.contiguous()
    if bhi is None:
        bhi = bf16_round(b).to(torch.bfloat16)
    else:
        assert bhi.shape == base.shape, (bhi.shape, base.shape)
        bhi = bhi[:B]
    blo = ((b.float() - bhi.float()).to(torch.bfloat16)
           if passes >= 3 else None)
    qhi_f = bf16_round(q)
    qhi = qhi_f.to(torch.bfloat16)
    qlo = (q - qhi_f).to(torch.bfloat16) if passes >= 2 else None
    keys = screen_keys(qhi.contiguous(), qlo, bhi.contiguous(), blo, qn, bn,
                       mega, passes, epilogue)
    cand_d, cand_i = _decode_keys(keys, epilogue, mega)
    return cand_d, cand_i, n_mega
