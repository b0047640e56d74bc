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

Each wrapper launches a kernel on CUDA tensors (and counts the launch) or
raises: on a build or launch failure, a dtype outside bf16/fp16/fp32, a
width the kernels do not take. On CPU tensors it runs the plain PyTorch
version beside it, which is the encoder's op-by-op code of before.

Variants (`VARIANTS`; the default a kernel's in `DEFAULT_VARIANT`;
`forced_variant(name)` selects one for timings that hold them against
each other; nothing on the main path forces one):
  "rowpass" the first kernels (csrc/row_pass.cuh: each row loaded by its
            own lanes, one row a row group): E1's and E2's default.
  "staged"  E1, E2 and E3 on the launch plan of `row_plan`: a grid of at
            most the blocks the card holds at once, each block a step of
            consecutive rows in several passes; E1's steps run through the
            tokens position by position, its type-0, w, b and position
            rows staged in shared memory once a block (cp.async) and each
            group's next word row loaded while it normalizes this one;
            E2's w and b come into shared memory by one bulk copy a block
            (csrc/row_stream.cuh), E3 loads a pass's rows before the
            previous pass's arithmetic. Rows it cannot take (a width not a
            multiple of 8, unaligned pointers; for E1 also one full pass a
            block, "rowpass"'s own layout, as at nw's 64 x 32) go to
            "rowpass" by the plan, counted there and logged once a shape.
            E3's default: on the card it was faster than "rowpass" at
            the shapes the encoders run; E1's and E2's were not (E1's
            ran at parity at ck's 1 x 32, nw's 64 x 32 is "rowpass"'s
            by the plan).
  "plain"   the plain version on CUDA tensors too.
"staged" and "rowpass" give the same bits. Launches are counted in all
(`launches`: either kernel) and per variant (`launches_by_variant`); the
shapes the plan sent to "rowpass" are in `rowpass_plans`. Nothing is built
at import: the kernels build at first use (utils/cuda_build.py).
"""

import contextlib
import ctypes
import dataclasses
import logging
import math

import torch
import torch.nn.functional as F

MASKED = -1e9                 # the written-out attention's key mask
MAX_WIDTH = 4096              # E1, E2: the widest row a kernel holds
MAX_SEQ = 512                 # E3: a row of T <= 512 keys in registers
LN_ATOL = 1e-5                # E1, E2 against their plain versions
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1, torch.float16: 2}

VARIANTS = ("staged", "rowpass", "plain")
# each kernel's variant on CUDA tensors unless one is forced: the faster
# on the card at the encoders' shapes (PERF.md)
DEFAULT_VARIANT = {"embed_layernorm": "rowpass", "add_layernorm": "rowpass",
                   "masked_softmax": "staged"}
_forced_variant = None
_log = logging.getLogger(__name__)

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
# each source's C functions, `<name>_<entry>`, and their arguments
_ARGTYPES = {
    "embed_layernorm": {
        "launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _LL, _I, _F, _P],
        "staged_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _LL, _I,
                          _F, _I, _I, _I, _I, _P],
        "staged_resident": [_I, _I, _I]},
    "add_layernorm": {
        "launch": [_P, _P, _P, _P, _P, _LL, _I, _I, _F, _P],
        "staged_launch": [_P, _P, _P, _P, _P, _LL, _I, _I, _F, _I, _I, _I,
                          _P],
        "staged_resident": [_I, _I, _I]},
    "masked_softmax": {
        "launch": [_P, _P, _P, _I, _I, _I, _I, _F, _P],
        "staged_launch": [_P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _P],
        "staged_resident": [_I, _I, _I]},
}
# the device types whose tensors launch the kernels
_ON_CARD = ("cuda",)


@contextlib.contextmanager
def forced_variant(name: str):
    """Run CUDA tensors through `name` ("staged", "rowpass" or "plain")
    instead of each kernel's default (DEFAULT_VARIANT), for timings that
    hold them against each other. Under "staged" the plan still sends the
    rows it cannot take to "rowpass"."""
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
    """Build (at first use) and load the three sources."""
    for name in _ARGTYPES:
        _launcher(name)


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _launch(name: str, dev, *args, entry: str = "launch") -> None:
    """csrc/<name>.cu's `entry` on dev's current stream; raises on an
    error code."""
    with torch.cuda.device(dev):
        err = _launcher(name, entry)(*args, _stream(dev))
    if err != 0:
        what = "" if entry == "launch" else " (staged)"
        raise RuntimeError(f"{name} kernel launch failed{what}: CUDA error "
                           f"{err}")


def _route(wrapper, t):
    """The variant a tensor `t` takes: None for the plain version (CPU
    tensors, or CUDA tensors under forced_variant("plain"), counted), else
    the wrapper's default (DEFAULT_VARIANT) or the forced variant; raises
    for any other device."""
    if t.device.type == "cpu":
        return None
    if t.device.type not in _ON_CARD:
        raise ValueError(f"{wrapper.__name__}: unsupported device "
                         f"{t.device}")
    if _forced_variant == "plain":
        wrapper.launches_by_variant["plain"] += 1
        return None
    return _forced_variant or DEFAULT_VARIANT[wrapper.__name__]


def _count(wrapper, variant: str) -> None:
    wrapper.launches += 1
    wrapper.launches_by_variant[variant] += 1


# ------------------------------------------------------- the launch plan

THREADS = 256                 # a block of the row kernels
MAX_STAGED_ROWS = 2 ** 30     # "staged" counts rows in 32 bits
SMEM_LIMIT = 232448           # dynamic shared memory a block may use


@dataclasses.dataclass(frozen=True)
class RowPlan:
    """A launch of E1, E2 or E3. "staged": `grid` blocks (never more than
    the card holds at once), block i the `rows_per_step` consecutive rows
    from i x rows_per_step, in `passes` passes of the block's rows a pass
    (E1: of the position-major order, row r the token (r % B, r // B); a
    step touches at most `positions` positions); `smem_bytes` of dynamic
    shared memory a block. "rowpass": the first kernel, which lays out its
    own launch; nothing planned (the numbers 0), for the reason given."""
    variant: str            # "staged" or "rowpass"
    reason: str             # why "rowpass" ("" for "staged")
    lanes: int              # lanes a row
    passes: int
    rows_per_step: int      # E3: rows of the flattened (B H T, T) logits
    grid: int
    smem_bytes: int
    positions: int = 0      # E1: position rows a block stages


def row_lanes(kernel: str, width: int) -> int:
    """Lanes a row, as both variants lay it out: E1 and E2 a warp (four
    above 1,024 values), E3 a lane for 8 of the T keys (4 to 64 lanes)."""
    if kernel != "masked_softmax":
        return 32 if width <= 1024 else 128
    for lanes in (4, 8, 16, 32):
        if width <= 8 * lanes:
            return lanes
    return 64


def pass_rows(kernel: str, width: int) -> int:
    """Rows a block of THREADS takes in one pass: E1 and E2 a row a warp
    (or a four-warp group), E3 THREADS / lanes."""
    lanes = row_lanes(kernel, width)
    return THREADS // (max(32, lanes) if kernel != "masked_softmax"
                       else lanes)


def staged_positions(step: int, batch: int, seq: int) -> int:
    """E1: the position rows a step of `step` consecutive position-major
    rows touches at most, as the C launch function recomputes it: whole
    positions where step is a multiple of the batch, one where it divides
    the batch, else at most (step - 1) // batch + 2; never more than
    `seq`."""
    if step % batch == 0:
        p = step // batch
    elif batch % step == 0:
        p = 1
    else:
        p = (step - 1) // batch + 2
    return min(p, seq)


def staged_bytes(kernel: str, width: int, positions: int = 0) -> int:
    """Dynamic shared memory of a "staged" block, as the C launch functions
    recompute it: E1 the type-0, w, b and `positions` position rows in
    fp32, E2 w and b, E3 none."""
    if kernel == "embed_layernorm":
        return 4 * width * (3 + positions)
    return 8 * width if kernel == "add_layernorm" else 0


def row_plan(kernel: str, rows: int, width: int, aligned: bool, sms: int,
             resident, batch: int | None = None) -> RowPlan:
    """The "staged" launch of E1 ("embed_layernorm": the `rows` = `batch` x
    T tokens of `width` values), E2 ("add_layernorm": `rows` rows of
    `width` values) or E3 ("masked_softmax": the B H T rows of T = `width`
    keys) on a card of `sms` SMs where `resident(smem_bytes)` blocks of the
    kernel fit an SM (registers, threads and shared memory; the occupancy
    query).

    "staged" where the rows take 16-byte loads and the weights a bulk or
    async copy (width % 8 == 0, `aligned`: every pointer 16-byte aligned,
    E3's mask 8) and there are fewer than MAX_STAGED_ROWS: the fewest
    passes that fit the rows into the blocks the card holds at once, and a
    block for each step of that many passes (E1: where the rows fill less
    than a pass of every block, a step of fewer rows than a pass, so the
    rows spread over the SMs; the shared memory its positions take). Else
    "rowpass", with the reason."""
    if kernel not in ("embed_layernorm", "add_layernorm", "masked_softmax"):
        raise ValueError(f"no launch plan for {kernel!r}")
    if rows < 0 or width < 1 or sms < 1:
        raise ValueError(f"rows={rows}, width={width}, sms={sms}: nothing "
                         f"to plan")
    if kernel == "embed_layernorm" and (batch is None or batch < 1
                                        or rows % batch):
        raise ValueError(f"embed_layernorm: {rows} rows in batch rows of "
                         f"{batch}")

    rowpass = _rowpass_plan
    if rows == 0:
        return rowpass("empty")
    if rows >= MAX_STAGED_ROWS:
        return rowpass("rows")
    if width % 8:
        return rowpass("width")
    if not aligned:
        return rowpass("unaligned")
    if kernel == "embed_layernorm":
        pl = _embed_plan(rows, batch, width, sms, resident)
        if pl.passes == 1 and pl.rows_per_step == pass_rows(kernel, width):
            # a full pass a block, as "rowpass" lays the tokens out:
            # nothing prefetched, the staging only adds (PERF.md)
            return rowpass("one pass")
        return pl
    smem = staged_bytes(kernel, width)
    held = int(resident(smem))
    if held < 1:
        return rowpass("occupancy")
    per_pass = pass_rows(kernel, width)
    passes = -(-rows // (per_pass * sms * held))
    step = passes * per_pass
    return RowPlan("staged", "", row_lanes(kernel, width), passes, step,
                   -(-rows // step), smem)


def _rowpass_plan(reason: str) -> RowPlan:
    return RowPlan("rowpass", reason, 0, 0, 0, 0, 0)


def _embed_plan(rows, batch, width, sms, resident) -> RowPlan:
    """row_plan's E1 case: as E2's, but steps of fewer rows than a pass
    where the rows fill less than a pass of every block the card holds (a
    token a warp, over as many SMs as there are tokens; such a step a
    divisor of the batch), and shared memory for the positions a step
    touches; the card's blocks asked again at that size, the steps grown
    until the grid fits them. (row_plan sends a plan of one full pass a
    block, "rowpass"'s own layout, to "rowpass".)"""
    rowpass = _rowpass_plan
    per_pass, seq = pass_rows("embed_layernorm", width), rows // batch
    held = int(resident(staged_bytes("embed_layernorm", width, 1)))
    if held < 1:
        return rowpass("occupancy")
    cap = sms * held
    while True:
        if rows <= cap * per_pass:
            # one pass; the step rounded up to a divisor of the batch
            # within the pass (fewer blocks), so that it lies within one
            # position
            step = -(-rows // cap)
            step = next((d for d in range(step, min(batch, per_pass) + 1)
                         if batch % d == 0), step)
            passes = 1
        else:
            passes = -(-rows // (cap * per_pass))
            step = passes * per_pass
        grid = -(-rows // step)
        positions = staged_positions(step, batch, seq)
        smem = staged_bytes("embed_layernorm", width, positions)
        if smem > SMEM_LIMIT:
            return rowpass("smem")
        held = int(resident(smem))
        if held < 1:
            return rowpass("occupancy")
        if grid <= sms * held:
            return RowPlan("staged", "", row_lanes("embed_layernorm", width),
                           passes, step, grid, smem, positions)
        cap = sms * held          # < grid <= the last cap: steps grow


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


def _resident(kernel, dev, width, code, smem_bytes) -> int:
    """Blocks of the "staged" kernel an SM holds at `smem_bytes`: the C
    library's occupancy query, asked once per device, width, dtype and
    size (so a launch inside a graph capture asks nothing new)."""
    key = (kernel, dev, width, code, smem_bytes)
    n = _resident_cache.get(key)
    if n is None:
        with torch.cuda.device(dev):
            n = _launcher(kernel, "staged_resident")(width, code, smem_bytes)
        if n < 0:
            raise RuntimeError(f"{kernel} occupancy query failed: CUDA "
                               f"error {-n}")
        _resident_cache[key] = n
    return n


def _aligned(*tensors, mask=None) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors) and \
        (mask is None or mask.data_ptr() % 8 == 0)


def _plan(wrapper, dev, rows, width, dtype, aligned, batch=None) -> RowPlan:
    """row_plan on this device, once per shape; a shape sent to "rowpass"
    is kept in `wrapper.rowpass_plans` and logged the first time."""
    kernel = wrapper.__name__
    key = (kernel, dev, rows, width, dtype, aligned, batch)
    pl = _plans.get(key)
    if pl is None:
        code = _DTYPE_CODE[dtype]
        pl = _plans[key] = row_plan(
            kernel, rows, width, aligned, _sm_count(dev),
            lambda b: _resident(kernel, dev, width, code, b), batch)
    if pl.variant == "rowpass":
        shape = (rows, width, str(dtype).removeprefix("torch."), aligned)
        if shape not in wrapper.rowpass_plans:
            _log.info("%s: %s rows of %s (%s, aligned %s) take 'rowpass' "
                      "by the plan: %s", kernel, *shape, pl.reason)
        wrapper.rowpass_plans[shape] = pl.reason
    wrapper.last_plan = pl
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
    with no host sync to check the ids; "rowpass" by default, or
    "staged" on its plan), the plain version on CPU tensors."""
    variant = _route(embed_layernorm, ids)
    if variant is None:
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
    dev = ids.device
    args = (ids.data_ptr(), word.data_ptr(), position.data_ptr(),
            token_type[0].data_ptr(), weight.data_ptr(), bias.data_ptr(),
            out.data_ptr(), b, seq, h, word.shape[0], _DTYPE_CODE[dtype],
            float(eps))
    if variant == "staged":
        pl = _plan(embed_layernorm, dev, b * seq, h, dtype,
                   _aligned(word, position, token_type, weight, bias, out),
                   batch=b)
        variant = pl.variant
    if variant == "staged":
        _launch("embed_layernorm", dev, *args, pl.grid, pl.rows_per_step,
                pl.passes, pl.smem_bytes, entry="staged_launch")
    else:
        _launch("embed_layernorm", dev, *args)
    _count(embed_layernorm, variant)
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
    ulp of the activation dtype; a warp a row, no atomics; "rowpass" by
    default, or "staged" on its plan), the plain version on CPU tensors."""
    variant = _route(add_layernorm, hidden)
    if variant is None:
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
    rows, dev = hidden.numel() // h, hidden.device
    args = (hidden.data_ptr(), x.data_ptr(), weight.data_ptr(),
            bias.data_ptr(), out.data_ptr(), rows, h, code, float(eps))
    if variant == "staged":
        pl = _plan(add_layernorm, dev, rows, h, hidden.dtype,
                   _aligned(hidden, x, weight, bias, out))
        variant = pl.variant
    if variant == "staged":
        _launch("add_layernorm", dev, *args, pl.grid, pl.passes,
                pl.smem_bytes, entry="staged_launch")
    else:
        _launch("add_layernorm", dev, *args)
    _count(add_layernorm, variant)
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
        pl = _plan(masked_softmax, dev, b * heads * seq, seq, logits.dtype,
                   _aligned(logits, out, mask=mask))
        variant = pl.variant
    if variant == "staged":
        _launch("masked_softmax", dev, *args, pl.grid, pl.passes,
                pl.smem_bytes, entry="staged_launch")
    else:
        _launch("masked_softmax", dev, *args)
    _count(masked_softmax, variant)
    return out


def reset_launches() -> None:
    """Set every wrapper's launch counts to 0 and forget the shapes its
    plan sent to "rowpass"."""
    for w in (embed_layernorm, add_layernorm, masked_softmax):
        w.launches = 0
        w.launches_by_variant = {v: 0 for v in VARIANTS}
        w.rowpass_plans = {}
        w.last_plan = None


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
