"""The encoders' fused passes: hand-written Hopper counterparts of the
fusions XLA makes of the JAX package's jitted BERT forward
(models/bert_flax.py under e5_flax.py:44 and colbert_flax.py:139), which
are not Pallas kernels but single passes over HBM on the TPU.

  E1 `embed_layernorm` (csrc/embed_layernorm.cu): bert_flax.py:165-172,
     the three embedding gathers, their sum, `embeddings_ln` and the cast.
  E2 `add_layernorm` (csrc/add_layernorm.cu): bert_flax.py:145 and
     :151-153, the residual add in the activation dtype, LayerNorm in fp32
     and the cast back; twice a layer.
  E3 `masked_softmax` (csrc/masked_softmax.cu): bert_flax.py:118-130, the
     written-out attention's scale, -1e9 key mask, round to bf16 and fp32
     softmax between the two library products.

The decoder embedder's passes (models/decoder.py, a Mistral block; the JAX
package has no decoder, so their plain versions below are the reference
the kernels are held to), one source, csrc/decoder_passes.cu:
  D1 `add_rmsnorm`: the residual add in the activation dtype and the
     RMSNorm after it (fp32 statistics, fp32 weight, no mean, no bias);
     returns the new residual and the normed rows.
  D2 `rope`: the rotary embedding (rotate-half, fp32 cos / sin from a
     table) on q and k, in place in the fused q|k|v projection.
  D3 `swiglu`: silu(gate) * up over the fused gate|up projection.
Each has one kernel, which CUDA tensors launch (the plain version only
under forced_variant("plain"), for timings); their launches are counted
in `launches` and add, under a recording profiler, to the counters
`decoder.rmsnorm`, `decoder.rope` and `decoder.swiglu`
(utils/profiling.py).

Each wrapper launches a kernel on CUDA tensors (and counts the launch) or
raises: on a build or launch failure, a dtype outside bf16/fp16/fp32, a
width the kernels do not take. On CPU tensors it runs the plain PyTorch
version beside it, which is the encoder's op-by-op code of before.

E1 and E2 have one kernel each ("rowpass": csrc/row_pass.cuh, each row
loaded by its own lanes, one row a row group). E3 has two, which give the
same bits (`VARIANTS`; `forced_variant(name)` selects one for timings that
hold them against each other; nothing on the main path forces one):
  "staged"  E3's default, on the launch plan of `row_plan`: a grid of at
            most the blocks the card holds at once, each block a step of
            consecutive rows in several passes, a pass's rows loaded
            before the previous pass's arithmetic; on the card it was
            faster than "rowpass" at the shapes the encoders run. Rows it
            cannot take (a width not a multiple of 8, unaligned pointers)
            go to "rowpass" by the plan, counted there and logged once a
            shape.
  "rowpass" the first kernel.
  "plain"   the plain version on CUDA tensors too (E1-E3 and D1-D3).
E1 and E2 launch their kernel under "staged" and "rowpass" alike. Launches
are counted in all (`launches`) and per variant (`launches_by_variant`,
E1's and E2's under "rowpass"); the shapes E3's plan sent to "rowpass" are
in `masked_softmax.rowpass_plans`. Nothing is built at import: the kernels
build at first use (utils/cuda_build.py).
"""

import contextlib
import ctypes
import dataclasses
import logging
import math

import torch
import torch.nn.functional as F

from neighborhoodwatch_tpu_torch.utils.profiling import count

MASKED = -1e9                 # the written-out attention's key mask
MAX_WIDTH = 4096              # E1, E2: the widest row a kernel holds
MAX_SEQ = 512                 # E3: a row of T <= 512 keys in registers
LN_ATOL = 1e-5                # E1, E2 against their plain versions
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1, torch.float16: 2}

VARIANTS = ("staged", "rowpass", "plain")
_forced_variant = None
_log = logging.getLogger(__name__)

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
# each source's C functions, `<name>_<entry>`, and their arguments
_ARGTYPES = {
    "embed_layernorm": {
        "launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _LL, _I, _F, _P]},
    "add_layernorm": {
        "launch": [_P, _P, _P, _P, _P, _LL, _I, _I, _F, _P]},
    "masked_softmax": {
        "launch": [_P, _P, _P, _I, _I, _I, _I, _F, _P],
        "staged_launch": [_P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _P],
        "staged_resident": [_I, _I, _I]},
    "decoder_passes": {
        "add_rmsnorm": [_P, _P, _P, _P, _P, _LL, _I, _I, _F, _P],
        "rope": [_P, _LL, _I, _LL, _I, _I, _P, _P, _I, _P],
        "swiglu": [_P, _P, _LL, _I, _I, _P]},
}
# the device types whose tensors launch the kernels
_ON_CARD = ("cuda",)


@contextlib.contextmanager
def forced_variant(name: str):
    """Run CUDA tensors through `name` ("staged", "rowpass" or "plain")
    instead of E3's default ("staged"), for timings that hold them against
    each other. Under "staged" the plan still sends the rows it cannot take
    to "rowpass"; E1 and E2 launch their one kernel under either, D1-D3
    theirs under anything but "plain"."""
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
    for name, entries in _ARGTYPES.items():
        _launcher(name, next(iter(entries)))


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _launch(name: str, dev, *args, entry: str = "launch") -> None:
    """csrc/<name>.cu's `entry` on dev's current stream; raises on an
    error code."""
    with torch.cuda.device(dev):
        err = _launcher(name, entry)(*args, _stream(dev))
    if err != 0:
        what = "" if entry == "launch" else f" ({entry})"
        raise RuntimeError(f"{name} kernel launch failed{what}: CUDA error "
                           f"{err}")


def _route(wrapper, t):
    """The variant a tensor `t` takes: None for the plain version (CPU
    tensors, or CUDA tensors under forced_variant("plain"), counted), else
    the forced variant or "staged"; raises for any other device."""
    if t.device.type == "cpu":
        return None
    if t.device.type not in _ON_CARD:
        raise ValueError(f"{wrapper.__name__}: unsupported device "
                         f"{t.device}")
    if _forced_variant == "plain":
        wrapper.launches_by_variant["plain"] += 1
        return None
    return _forced_variant or "staged"


def _count(wrapper, variant: str) -> None:
    wrapper.launches += 1
    wrapper.launches_by_variant[variant] += 1


def _on_card(wrapper, t) -> bool:
    """Whether D1-D3 launch their kernel on `t`: CUDA tensors do unless
    forced_variant("plain") holds, CPU tensors take the plain version;
    raises for any other device."""
    if t.device.type == "cpu":
        return False
    if t.device.type not in _ON_CARD:
        raise ValueError(f"{wrapper.__name__}: unsupported device "
                         f"{t.device}")
    return _forced_variant != "plain"


# ------------------------------------------------------- E3's launch plan

THREADS = 256                 # a block of the row kernels
MAX_STAGED_ROWS = 2 ** 30     # "staged" counts rows in 32 bits


@dataclasses.dataclass(frozen=True)
class RowPlan:
    """A launch of E3. "staged": `grid` blocks (never more than the card
    holds at once), block i the `rows_per_step` consecutive rows from i x
    rows_per_step, in `passes` passes of the block's rows a pass; no
    dynamic shared memory. "rowpass": the first kernel, which lays out its
    own launch; nothing planned (the numbers 0), for the reason given."""
    variant: str            # "staged" or "rowpass"
    reason: str             # why "rowpass" ("" for "staged")
    lanes: int              # lanes a row
    passes: int
    rows_per_step: int      # rows of the flattened (B H T, T) logits
    grid: int


def row_lanes(width: int) -> int:
    """Lanes a row of T = `width` keys, as both of E3's kernels lay it
    out: a lane for 8 of the keys (4 to 64 lanes)."""
    for lanes in (4, 8, 16, 32):
        if width <= 8 * lanes:
            return lanes
    return 64


def pass_rows(width: int) -> int:
    """Rows a block of THREADS takes in one pass: THREADS / lanes."""
    return THREADS // row_lanes(width)


def row_plan(rows: int, width: int, aligned: bool, sms: int,
             resident) -> RowPlan:
    """E3's "staged" launch for the B H T rows of T = `width` keys on a
    card of `sms` SMs where `resident()` blocks of the kernel fit an SM
    (registers and threads; the occupancy query).

    "staged" where the rows take 16-byte loads (width % 8 == 0, `aligned`:
    logits and output 16-byte aligned, the mask 8) and there are fewer than
    MAX_STAGED_ROWS: the fewest passes that fit the rows into the blocks
    the card holds at once, and a block for each step of that many passes.
    Else "rowpass", with the reason."""
    if rows < 0 or width < 1 or sms < 1:
        raise ValueError(f"rows={rows}, width={width}, sms={sms}: nothing "
                         f"to plan")

    def rowpass(reason):
        return RowPlan("rowpass", reason, 0, 0, 0, 0)
    if rows == 0:
        return rowpass("empty")
    if rows >= MAX_STAGED_ROWS:
        return rowpass("rows")
    if width % 8:
        return rowpass("width")
    if not aligned:
        return rowpass("unaligned")
    held = int(resident())
    if held < 1:
        return rowpass("occupancy")
    per_pass = pass_rows(width)
    passes = -(-rows // (per_pass * sms * held))
    step = passes * per_pass
    return RowPlan("staged", "", row_lanes(width), passes, step,
                   -(-rows // step))


_sms: dict = {}
_resident_cache: dict = {}
_plans: dict = {}


def _sm_count(dev) -> int:
    """The device's SM count, asked once per device."""
    n = _sms.get(dev)
    if n is None:
        n = _sms[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return n


def _resident(dev, width, code) -> int:
    """Blocks of E3's "staged" kernel an SM holds: the C library's
    occupancy query, asked once per device, width and dtype (so a launch
    inside a graph capture asks nothing new)."""
    key = (dev, width, code)
    n = _resident_cache.get(key)
    if n is None:
        with torch.cuda.device(dev):
            n = _launcher("masked_softmax", "staged_resident")(width, code, 0)
        if n < 0:
            raise RuntimeError(f"masked_softmax occupancy query failed: "
                               f"CUDA error {-n}")
        _resident_cache[key] = n
    return n


def _aligned(*tensors, mask=None) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors) and \
        (mask is None or mask.data_ptr() % 8 == 0)


def _plan(dev, rows, width, dtype, aligned) -> RowPlan:
    """row_plan on this device, once per shape; a shape sent to "rowpass"
    is kept in `masked_softmax.rowpass_plans` and logged the first
    time."""
    key = (dev, rows, width, dtype, aligned)
    pl = _plans.get(key)
    if pl is None:
        code = _DTYPE_CODE[dtype]
        pl = _plans[key] = row_plan(
            rows, width, aligned, _sm_count(dev),
            lambda: _resident(dev, width, code))
    if pl.variant == "rowpass":
        shape = (rows, width, str(dtype).removeprefix("torch."), aligned)
        if shape not in masked_softmax.rowpass_plans:
            _log.info("masked_softmax: %s rows of %s (%s, aligned %s) take "
                      "'rowpass' by the plan: %s", *shape, pl.reason)
        masked_softmax.rowpass_plans[shape] = pl.reason
    masked_softmax.last_plan = pl
    return pl


def _activation(t, name):
    if t.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {t.dtype} not in "
                        f"{tuple(_DTYPE_CODE)}")
    return _DTYPE_CODE[t.dtype]


def _same_device(name, ref, *tensors):
    for t in tensors:
        if t.device != ref.device:
            raise ValueError(f"{name}: operands on {t.device} and "
                             f"{ref.device}")


def _f32_row(t, name, width):
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if t.dim() != 1 or t.shape[0] != width:
        raise ValueError(f"{name}: expected ({width},), got "
                         f"{tuple(t.shape)}")
    return t.contiguous()


def _width(name, width):
    if not 1 <= width <= MAX_WIDTH:
        raise ValueError(f"{name}: hidden width {width} outside 1 .. "
                         f"{MAX_WIDTH}")


# ---------------------------------------------------------------- E1


def embed_layernorm_plain(ids, word, position, token_type, weight, bias,
                          eps: float, dtype):
    """(B, T, H) embeddings of (B, T) token ids: word[ids] + position[t] +
    token_type[0] (fp32, in that order), LayerNorm in fp32, cast to
    `dtype`."""
    pos_ids = torch.arange(ids.shape[1], device=ids.device)
    emb = (F.embedding(ids, word) + F.embedding(pos_ids, position)[None]
           + F.embedding(torch.zeros_like(ids), token_type))
    return F.layer_norm(emb, (emb.shape[-1],), weight, bias, eps).to(dtype)


def embed_layernorm(ids, word, position, token_type, weight, bias,
                    eps: float, dtype):
    """`embed_layernorm_plain`'s function: E1 on CUDA tensors (one read of
    each gathered row, the sum bit for bit the plain version's, LayerNorm
    within one ulp of `dtype`; an id outside the table gives a row of NaN,
    with no host sync to check the ids), the plain version on CPU
    tensors."""
    if _route(embed_layernorm, ids) is None:
        return embed_layernorm_plain(ids, word, position, token_type, weight,
                                     bias, eps, dtype)
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"embed_layernorm: dtype {dtype} not in "
                        f"{tuple(_DTYPE_CODE)}")
    if ids.dtype != torch.int64 or ids.dim() != 2:
        raise TypeError(f"ids: expected (B, T) int64, got {ids.dtype} "
                        f"{tuple(ids.shape)}")
    _same_device("embed_layernorm", ids, word, position, token_type, weight,
                 bias)
    tables = []
    for t, name in ((word, "word"), (position, "position"),
                    (token_type, "token_type")):
        if t.dtype != torch.float32 or t.dim() != 2:
            raise TypeError(f"{name}: expected an fp32 table, got {t.dtype} "
                            f"{tuple(t.shape)}")
        tables.append(t.contiguous())
    word, position, token_type = tables
    b, seq = ids.shape
    h = word.shape[1]
    _width("embed_layernorm", h)
    if position.shape[1] != h or token_type.shape[1] != h:
        raise ValueError(f"tables of widths {h}, {position.shape[1]}, "
                         f"{token_type.shape[1]}")
    if seq < 1 or seq > position.shape[0]:
        raise ValueError(f"{seq} positions for a table of "
                         f"{position.shape[0]}")
    weight, bias = _f32_row(weight, "weight", h), _f32_row(bias, "bias", h)
    ids = ids.contiguous()
    out = torch.empty((b, seq, h), dtype=dtype, device=ids.device)
    _launch("embed_layernorm", ids.device, ids.data_ptr(), word.data_ptr(),
            position.data_ptr(), token_type[0].data_ptr(), weight.data_ptr(),
            bias.data_ptr(), out.data_ptr(), b, seq, h, word.shape[0],
            _DTYPE_CODE[dtype], float(eps))
    _count(embed_layernorm, "rowpass")
    return out


# ---------------------------------------------------------------- E2


def add_layernorm_plain(hidden, x, weight, bias, eps: float):
    """LayerNorm in fp32 of hidden + x (added in their dtype), cast back to
    that dtype."""
    return F.layer_norm((hidden + x).float(), (hidden.shape[-1],), weight,
                        bias, eps).to(hidden.dtype)


def add_layernorm(hidden, x, weight, bias, eps: float):
    """`add_layernorm_plain`'s function over the last dimension: E2 on CUDA
    tensors (the add bit for bit the plain version's, LayerNorm within one
    ulp of the activation dtype; a warp a row, no atomics), the plain
    version on CPU tensors."""
    if _route(add_layernorm, hidden) is None:
        return add_layernorm_plain(hidden, x, weight, bias, eps)
    code = _activation(hidden, "hidden")
    if x.dtype != hidden.dtype or x.shape != hidden.shape:
        raise ValueError(f"x: {x.dtype} {tuple(x.shape)} against hidden "
                         f"{hidden.dtype} {tuple(hidden.shape)}")
    _same_device("add_layernorm", hidden, x, weight, bias)
    h = hidden.shape[-1]
    _width("add_layernorm", h)
    weight, bias = _f32_row(weight, "weight", h), _f32_row(bias, "bias", h)
    hidden, x = hidden.contiguous(), x.contiguous()
    out = torch.empty_like(hidden)
    _launch("add_layernorm", hidden.device, hidden.data_ptr(), x.data_ptr(),
            weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
            hidden.numel() // h, h, code, float(eps))
    _count(add_layernorm, "rowpass")
    return out


# ---------------------------------------------------------------- E3


def masked_softmax_plain(logits, mask, head_dim: int):
    """(B, H, T, T) attention probabilities in the logits' dtype from the
    logits and the (B, T) bool key mask: the logits widened to fp32 and
    divided by sqrt(head_dim), masked keys set to -1e9, rounded to bf16
    and widened again under bf16 activations (as the reference rounds
    there only: bf16 keeps fp32's exponent range, so the mask survives),
    softmax in fp32, cast to the logits' dtype."""
    dt = logits.dtype
    scale = torch.full((), math.sqrt(head_dim), device=logits.device)
    x = logits.float() / scale             # a true division on any device
    x = torch.where(mask[:, None, None, :], x,
                    torch.full((), MASKED, device=logits.device))
    if dt == torch.bfloat16:
        x = x.to(dt).float()
    return torch.softmax(x, dim=-1).to(dt)


def masked_softmax(logits, mask, head_dim: int):
    """`masked_softmax_plain`'s function: E3 on CUDA tensors (a query row
    held in the registers of 4 to 64 lanes, one read of the logits and one
    write; within one ulp of the activation dtype; an all-masked row gives
    the uniform row; "staged" on its plan by default, or "rowpass"), the
    plain version on CPU tensors."""
    variant = _route(masked_softmax, logits)
    if variant is None:
        return masked_softmax_plain(logits, mask, head_dim)
    code = _activation(logits, "logits")
    if logits.dim() != 4 or logits.shape[2] != logits.shape[3]:
        raise ValueError(f"logits: expected (B, H, T, T), got "
                         f"{tuple(logits.shape)}")
    b, heads, seq, _ = logits.shape
    if not 1 <= seq <= MAX_SEQ:
        raise ValueError(f"masked_softmax: {seq} keys outside 1 .. "
                         f"{MAX_SEQ}")
    if mask.dtype not in (torch.bool, torch.uint8) \
            or tuple(mask.shape) != (b, seq):
        raise TypeError(f"mask: expected ({b}, {seq}) bool, got "
                        f"{mask.dtype} {tuple(mask.shape)}")
    _same_device("masked_softmax", logits, mask)
    logits, mask = logits.contiguous(), mask.contiguous()
    out = torch.empty_like(logits)
    dev = logits.device
    args = (logits.data_ptr(), mask.data_ptr(), out.data_ptr(), b, heads,
            seq, code, math.sqrt(head_dim))
    if variant == "staged":
        pl = _plan(dev, b * heads * seq, seq, logits.dtype,
                   _aligned(logits, out, mask=mask))
        variant = pl.variant
    if variant == "staged":
        _launch("masked_softmax", dev, *args, pl.grid, pl.passes, 0,
                entry="staged_launch")
    else:
        _launch("masked_softmax", dev, *args)
    _count(masked_softmax, variant)
    return out


# ------------------------------------------------------ D1-D3 (decoder)


def add_rmsnorm_plain(hidden, x, weight, eps: float):
    """(s, out): s = hidden + x in their dtype (hidden itself where x is
    None), out = s in fp32 times rsqrt(mean(s^2) + eps) times the fp32
    weight, cast to that dtype."""
    s = hidden if x is None else hidden + x
    f = s.float()
    r = torch.rsqrt(f.pow(2).mean(-1, keepdim=True) + eps)
    return s, (f * r * weight).to(hidden.dtype)


def add_rmsnorm(hidden, x, weight, eps: float):
    """`add_rmsnorm_plain`'s function over the last dimension: D1 on CUDA
    tensors (the add bit for bit the plain version's, the norm within one
    ulp of the activation dtype; one kernel, the residual written with the
    normed rows), the plain version on CPU tensors."""
    if not _on_card(add_rmsnorm, hidden):
        return add_rmsnorm_plain(hidden, x, weight, eps)
    code = _activation(hidden, "hidden")
    if x is not None and (x.dtype != hidden.dtype or x.shape != hidden.shape):
        raise ValueError(f"x: {x.dtype} {tuple(x.shape)} against hidden "
                         f"{hidden.dtype} {tuple(hidden.shape)}")
    _same_device("add_rmsnorm", hidden, weight,
                 *(() if x is None else (x,)))
    h = hidden.shape[-1]
    _width("add_rmsnorm", h)
    weight = _f32_row(weight, "weight", h)
    hidden = hidden.contiguous()
    out = torch.empty_like(hidden)
    if x is None:
        s, xp, sp = hidden, None, None
    else:
        x = x.contiguous()
        s = torch.empty_like(hidden)
        xp, sp = x.data_ptr(), s.data_ptr()
    _launch("decoder_passes", hidden.device, hidden.data_ptr(), xp,
            weight.data_ptr(), sp, out.data_ptr(), hidden.numel() // h, h,
            code, float(eps), entry="add_rmsnorm")
    add_rmsnorm.launches += 1
    count("decoder.rmsnorm", 1)
    return s, out


def rope_table(positions: int, head_dim: int, theta: float, device=None):
    """(cos, sin), each (positions, head_dim / 2) fp32: the angles
    position x theta^(-2i / head_dim), the frequencies worked out in
    float64 and rounded to fp32, their product and its cos / sin in fp32.
    Computed once; D2 and its plain version both read it."""
    half = head_dim // 2
    inv = (1.0 / theta ** (torch.arange(half, dtype=torch.float64) * 2
                           / head_dim)).float()
    ang = torch.arange(positions, dtype=torch.float32)[:, None] * inv[None]
    return ang.cos().to(device), ang.sin().to(device)


def rope_plain(x, heads: int, head_dim: int, cos, sin):
    """x (B, T, C) in place: each of its first `heads` heads of head_dim
    values, split into halves x1, x2, becomes (x1 c - x2 s, x2 c + x1 s)
    in fp32 (c, s the rows of cos / sin at the token's position), cast
    back to x's dtype. Returns x."""
    b, t, _ = x.shape
    d = head_dim // 2
    part = x[..., :heads * head_dim].view(b, t, heads, 2, d)
    f = part.float()
    c, s = cos[:t, None, :], sin[:t, None, :]
    y1 = f[..., 0, :] * c - f[..., 1, :] * s
    y2 = f[..., 1, :] * c + f[..., 0, :] * s
    part.copy_(torch.stack((y1, y2), dim=3).to(x.dtype))
    return x


def rope(x, heads: int, head_dim: int, cos, sin):
    """`rope_plain`'s function: D2 on CUDA tensors (bit for bit the plain
    version's: each product rounded to fp32 before the sum), the plain
    version on CPU tensors. x (B, T, C) with unit stride along C and rows
    of any stride; cos, sin fp32 (>= T, head_dim / 2)."""
    if not _on_card(rope, x):
        return rope_plain(x, heads, head_dim, cos, sin)
    code = _activation(x, "x")
    b, t, c = x.shape
    half = head_dim // 2
    if head_dim % 2 or heads * head_dim > c or x.stride(2) != 1 \
            or x.stride(0) != t * x.stride(1):
        raise ValueError(f"rope: {heads} heads of {head_dim} in rows of "
                         f"{c}, strides {x.stride()}")
    for tab, name in ((cos, "cos"), (sin, "sin")):
        if tab.dtype != torch.float32 or tab.dim() != 2 \
                or tab.shape[0] < t or tab.shape[1] != half \
                or not tab.is_contiguous():
            raise ValueError(f"{name}: expected contiguous fp32 (>= {t}, "
                             f"{half}), got {tab.dtype} {tuple(tab.shape)}")
    _same_device("rope", x, cos, sin)
    _launch("decoder_passes", x.device, x.data_ptr(), b * t, t, x.stride(1),
            heads, head_dim, cos.data_ptr(), sin.data_ptr(), code,
            entry="rope")
    rope.launches += 1
    count("decoder.rope", 1)
    return x


def swiglu_plain(gu):
    """(..., 2 I) -> (..., I): silu(g) * u in fp32 over g, u the two
    halves of the last dimension, cast to gu's dtype."""
    g, u = gu.float().chunk(2, dim=-1)
    return (F.silu(g) * u).to(gu.dtype)


def swiglu(gu):
    """`swiglu_plain`'s function: D3 on CUDA tensors (within one ulp of the
    activation dtype: the card's expf), the plain version on CPU
    tensors."""
    if not _on_card(swiglu, gu):
        return swiglu_plain(gu)
    code = _activation(gu, "gu")
    if gu.shape[-1] % 2:
        raise ValueError(f"swiglu: odd width {gu.shape[-1]}")
    inter = gu.shape[-1] // 2
    gu = gu.contiguous()
    out = torch.empty((*gu.shape[:-1], inter), dtype=gu.dtype,
                      device=gu.device)
    _launch("decoder_passes", gu.device, gu.data_ptr(), out.data_ptr(),
            gu.numel() // (2 * inter), inter, code, entry="swiglu")
    swiglu.launches += 1
    count("decoder.swiglu", 1)
    return out


def reset_launches() -> None:
    """Set every wrapper's launch counts to 0 and forget the shapes E3's
    plan sent to "rowpass"."""
    for w in (embed_layernorm, add_layernorm, masked_softmax):
        w.launches_by_variant = {v: 0 for v in VARIANTS}
    masked_softmax.rowpass_plans = {}
    masked_softmax.last_plan = None
    for w in (embed_layernorm, add_layernorm, masked_softmax, add_rmsnorm,
              rope, swiglu):
        w.launches = 0


reset_launches()


def outputs_agree(out, plain, atol: float = 0.0) -> float:
    """A kernel's output against its plain version's on the same inputs:
    NaN at the same places; elsewhere fp32 within 1e-5 abs (sums in another
    order), bf16 and fp16 within one ulp of the dtype at the larger of the
    two magnitudes (the fp32 values before the last rounding differ in
    their last bits only) plus `atol`. A LayerNorm's output near 0 is a
    cancellation of terms of order 1, whose fp32 rounding is absolute: E1
    and E2 are held with atol 1e-5, the fp32 tolerance. Returns the max abs
    difference; raises AssertionError beyond the tolerance."""
    if out.dtype != plain.dtype or out.shape != plain.shape:
        raise AssertionError(f"{out.dtype} {tuple(out.shape)} against "
                             f"{plain.dtype} {tuple(plain.shape)}")
    o, p = out.float(), plain.float()
    nan = torch.isnan(p)
    if not torch.equal(torch.isnan(o), nan):
        raise AssertionError("NaN at other places than the plain version's")
    o, p = o.masked_fill(nan, 0.0), p.masked_fill(nan, 0.0)
    diff = (o - p).abs()
    if out.dtype == torch.float32:
        tol = torch.full_like(diff, 1e-5)
    else:
        # the ulp from the fp32 exponent bits (exact; the card's exp2 and
        # log2 are not), at least that of the dtype's smallest normal
        mantissa = 7 if out.dtype == torch.bfloat16 else 10
        low = max(torch.finfo(out.dtype).smallest_normal, 2.0 ** -100)
        mag = torch.maximum(o.abs(), p.abs()).clamp_min(low)
        expo = (mag.view(torch.int32) >> 23) & 0xFF
        tol = ((expo - mantissa) << 23).view(torch.float32) + atol
    if bool((diff > tol).any()):
        raise AssertionError(f"beyond one ulp: max excess "
                             f"{float((diff - tol).max()):.3g}, max |d| "
                             f"{float(diff.max()):.3g}")
    return float(diff.max())
