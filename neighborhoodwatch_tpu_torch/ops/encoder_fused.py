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

Each wrapper launches its kernel on CUDA tensors (and counts the launch)
or raises: on a build or launch failure, a dtype outside bf16/fp16/fp32, a
width the kernel does not take. On CPU tensors it runs the plain PyTorch
version beside it, which is the encoder's op-by-op code of before.
`forced_variant("plain")` runs the plain version on CUDA tensors too, for
timings that hold the two against each other; nothing on the main path
uses it. Launches are counted in all (`launches`: the kernel's alone) and
per variant (`launches_by_variant`, "kernel" and "plain"). Nothing is
built at import: the kernels build at first use (utils/cuda_build.py).
"""

import contextlib
import ctypes
import math

import torch
import torch.nn.functional as F

MASKED = -1e9                 # the written-out attention's key mask
MAX_WIDTH = 4096              # E1, E2: the widest row a kernel holds
MAX_SEQ = 512                 # E3: a row of T <= 512 keys in registers
LN_ATOL = 1e-5                # E1, E2 against their plain versions
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1, torch.float16: 2}

VARIANTS = ("kernel", "plain")
_forced_variant = None

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
# each source's C launch function, `<name>_launch`, and its arguments
_ARGTYPES = {
    "embed_layernorm": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _LL, _I, _F,
                        _P],
    "add_layernorm": [_P, _P, _P, _P, _P, _LL, _I, _I, _F, _P],
    "masked_softmax": [_P, _P, _P, _I, _I, _I, _I, _F, _P],
}
# the device types whose tensors launch the kernels
_ON_CARD = ("cuda",)


@contextlib.contextmanager
def forced_variant(name: str):
    """Run CUDA tensors through `name` ("kernel" or "plain") instead of the
    default "kernel", for timings that hold the two against each other."""
    global _forced_variant
    if name not in VARIANTS:
        raise ValueError(f"variant {name!r} not in {VARIANTS}")
    before = _forced_variant
    _forced_variant = name
    try:
        yield
    finally:
        _forced_variant = before


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
    """Build (at first use) and load the three sources."""
    for name in _ARGTYPES:
        _launcher(name)


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _launch(name: str, dev, *args) -> None:
    """csrc/<name>.cu's launch on dev's current stream; raises on an
    error code."""
    with torch.cuda.device(dev):
        err = _launcher(name)(*args, _stream(dev))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _route(wrapper, t) -> bool:
    """True where `t` takes the kernel, False for the plain version (CPU
    tensors, or CUDA tensors under forced_variant("plain"), counted);
    raises for any other device."""
    if t.device.type == "cpu":
        return False
    if t.device.type not in _ON_CARD:
        raise ValueError(f"{wrapper.__name__}: unsupported device "
                         f"{t.device}")
    if _forced_variant == "plain":
        wrapper.launches_by_variant["plain"] += 1
        return False
    return True


def _count(wrapper) -> None:
    wrapper.launches += 1
    wrapper.launches_by_variant["kernel"] += 1


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
    if not _route(embed_layernorm, ids):
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
    _count(embed_layernorm)
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
    if not _route(add_layernorm, hidden):
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
    _count(add_layernorm)
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
    """`masked_softmax_plain`'s function: E3 on CUDA tensors (a warp a
    query row held in registers, one read of the logits and one write;
    within one ulp of the activation dtype; an all-masked row gives the
    uniform row), the plain version on CPU tensors."""
    if not _route(masked_softmax, logits):
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
    _launch("masked_softmax", logits.device, logits.data_ptr(),
            mask.data_ptr(), out.data_ptr(), b, heads, seq, code,
            math.sqrt(head_dim))
    _count(masked_softmax)
    return out


def reset_launches() -> None:
    """Set every wrapper's launch counts to 0."""
    for w in (embed_layernorm, add_layernorm, masked_softmax):
        w.launches = 0
        w.launches_by_variant = {v: 0 for v in VARIANTS}


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
