"""Masked softmax attention with segment ids for the BERT encoders
(counterpart of the fused attention of models/bert_flax.py:102-115).

Under the opt-in `BertConfig.attention_impl="flash"` the JAX package calls
JAX's library Pallas kernel `jax.experimental.pallas.ops.tpu.flash_attention`
(block_q = block_k = 128) with `SegmentIds(q=mask, kv=mask)`. Here
`masked_attention` is the one kernel entry: on CUDA tensors it launches the
hand-written Hopper kernel in csrc/masked_attention.cu, on CPU tensors it
runs `masked_attention_plain`, the plain PyTorch version of the same
function (the library's `mha_reference` with segment ids, p cast to v's
dtype before its product with v).

The source holds two variants, and `pick_variant` chooses between them by
shape alone: "wgmma" (TMA loads, wgmma products, a producer warp and two
consumer warpgroups, which take turns at the tensor cores at D = 128, one
persistent block per SM; 128-query items, 128-key tiles) for bf16 and fp16
at T % 128 == 0, "mma" (mma.sync from a cp.async ring, 64 x 64 tiles; an
fp32 SIMT form) for the rest.
Launches are counted in all and per variant.

Layout: q, k, v and the output are (B, T, H, D), the encoder's nn.Linear
outputs viewed per head, which the kernel reads in place with their strides
(the JAX call site swaps them to (B, H, T, D) around the library call and
back). seg (B, T) holds segment ids: a query sees the keys of its own
segment. The encoders pass the attention mask, valid tokens segment 1 and
padding segment 0, so a padding query attends to the padding keys where the
written-out attention masks keys only; pooling and the ColBERT head drop
those rows downstream.

The decoder embedder (models/decoder.py) calls the same entry in its mode:
`causal=True` (query i sees the keys j <= i only; key tiles past the
query tile's own are skipped) with grouped-query heads (k and v (B, T,
HKV, D), query head h reading K / V head h // (H // HKV)) and no segment
ids (`seg=None`: right padding, which causality alone keeps off the real
tokens). Its launches add, under a recording profiler, to the counters
`attn.causal_launches` and `attn.causal_launches.<variant>`, and
`attn.causal_tiles`, the (query tile, key tile) pairs of the variant's
own tile (128 x 128 "wgmma", 64 x 64 "mma") that the causal skip leaves,
B H n (n + 1) / 2 for n query tiles a head (utils/profiling.py; a graph
replay adds its captured launches' counts).
"""

import contextlib
import ctypes

import torch

from neighborhoodwatch_tpu_torch.utils.profiling import count

# the library's DEFAULT_MASK_VALUE: added to masked logits, kept finite
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
HEAD_DIMS = (64, 128)        # the kernel's instantiations
TILE = 64                    # the "mma" variant's query and key tile
WGMMA_TILE = 128             # the "wgmma" variant's
MAX_SEQ = 8192               # a row's segment ids live in shared memory
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1, torch.float16: 2}

VARIANTS = ("mma", "wgmma")
_forced_variant = None


def use_flash(config, seq: int, device="cpu") -> bool:
    """Whether a forward over `seq` positions on `device` takes the fused
    attention. The reference's gate (bert_flax._use_flash):
    `attention_impl="flash"`, a sequence of a multiple of 128 and a head
    dim of a multiple of 64. Its TPU-backend clause becomes the device: on
    the CPU the plain version runs every shape that gate admits; on CUDA
    the kernel runs, so the gate also asks for what the kernel takes (head
    dim in HEAD_DIMS, the config's dtype in bf16/fp16/fp32, seq up to
    MAX_SEQ) and sends the rest (head dim 192 or 256) to the written-out
    attention. Elsewhere the written-out attention runs, as in the
    reference."""
    if config.attention_impl != "flash":
        return False
    head_dim = config.hidden_size // config.num_heads
    if seq % 128 or head_dim % 64:
        return False
    if torch.device(device).type == "cpu":
        return True
    return (head_dim in HEAD_DIMS and seq <= MAX_SEQ
            and getattr(torch, config.dtype) in _DTYPE_CODE)


def pick_variant(T: int, D: int, dtype, aligned: bool) -> str:
    """The kernel variant for (B, T, H, D) operands of `dtype`: "wgmma"
    takes bf16 and fp16 (wgmma's fp32 inputs are TF32, which would break
    the fp32 tolerance), head dims in HEAD_DIMS, T % 128 == 0 and rows a
    TMA tensor map can describe (`aligned`: 16-byte aligned base and
    strides); everything else takes "mma"."""
    if (dtype in (torch.bfloat16, torch.float16) and D in HEAD_DIMS
            and T % WGMMA_TILE == 0 and aligned):
        return "wgmma"
    return "mma"


@contextlib.contextmanager
def forced_variant(name: str):
    """Launch `name` instead of the variant `pick_variant` would choose,
    for tests and timings that hold the two against each other. Forcing
    "wgmma" on a shape it cannot take makes the launch raise."""
    global _forced_variant
    if name not in VARIANTS:
        raise ValueError(f"variant {name!r} not in {VARIANTS}")
    before = _forced_variant
    _forced_variant = name
    try:
        yield
    finally:
        _forced_variant = before


def masked_attention_plain(q, k, v, seg, sm_scale: float,
                           causal: bool = False):
    """(B, T, H, D) attention of q over k, v (B, T, HKV, D; query head h
    reads K / V head h // (H // HKV)) with segment ids seg (B, T) or None
    (one segment): logits q.k in fp32 times `sm_scale`, plus MASK_VALUE
    where the two segments differ or, under `causal`, where the key comes
    after the query; softmax in fp32, the probabilities cast to v's dtype,
    their product with v in fp32, the output in q's dtype."""
    group = q.shape[2] // k.shape[2]
    if group > 1:
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)
    qf = q.float().transpose(1, 2)                       # (B, H, T, D)
    kf = k.float().transpose(1, 2)
    logits = (qf @ kf.transpose(2, 3)) * sm_scale
    b, t = q.shape[:2]
    seen = torch.ones((b, t, t), dtype=torch.bool, device=q.device) \
        if seg is None else seg[:, :, None] == seg[:, None, :]
    if causal:
        seen = seen & torch.ones((t, t), dtype=torch.bool,
                                 device=q.device).tril()
    logits = logits + torch.where(seen, 0.0, MASK_VALUE)[:, None]
    probs = torch.softmax(logits, dim=-1).to(v.dtype).float()
    ctx = probs @ v.float().transpose(1, 2)
    return ctx.transpose(1, 2).to(q.dtype).contiguous()


def outputs_agree(out, plain) -> float:
    """The kernel's output against the plain version's on the same inputs,
    every row: fp32 within 1e-5 abs (sums and exp in another order); bf16
    within 2 bf16 ulps of the row's largest |o| (the kernel rounds each
    unnormalized p to bf16, the plain version each normalized one, and
    each rounds its output once: a term's error is at most 2^-8 of its
    share of the sum); fp16 within 2 fp16 ulps of it, by the same argument
    at fp16's 10-bit mantissa (2^-11 a term). Returns the max abs
    difference; raises AssertionError beyond the tolerance or on a
    non-finite output."""
    o, p = out.float(), plain.float()
    if not bool(torch.isfinite(o).all()):
        raise AssertionError("non-finite attention output")
    diff = (o - p).abs()
    if out.dtype == torch.float32:
        tol = torch.full_like(diff, 1e-5)
    else:
        mantissa = 10 if out.dtype == torch.float16 else 7
        row = p.abs().amax(-1, keepdim=True).clamp_min(2.0 ** -126)
        tol = 2 * torch.exp2(torch.floor(torch.log2(row)) - mantissa)
    if bool((diff > tol).any()):
        raise AssertionError(f"attention output beyond tolerance: max "
                             f"excess {float((diff - tol).max()):.3g}")
    return float(diff.max())


def load_library():
    """Build (at first use) and load csrc/masked_attention.cu."""
    from neighborhoodwatch_tpu_torch.utils import cuda_build
    lib = cuda_build.load("masked_attention")
    if not getattr(lib, "_nw_typed", False):
        p, i, s = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.masked_attention_launch.argtypes = [p, p, p, p, p, i, i, i, i,
                                                i, s, s, s, s, s, s, s, s,
                                                s, i, i, i, i,
                                                ctypes.c_float, p]
        lib.masked_attention_launch.restype = i
        lib._nw_typed = True
    return lib


def _check_operand(t, name, q, heads=None):
    if t.dtype != q.dtype:
        raise TypeError(f"{name}: expected {q.dtype}, got {t.dtype}")
    want = tuple(q.shape) if heads is None else \
        (*q.shape[:2], heads, q.shape[3])
    if tuple(t.shape) != want:
        raise ValueError(f"{name}: expected shape {want}, got "
                         f"{tuple(t.shape)}")
    if t.device != q.device:
        raise ValueError(f"{name}: on {t.device}, expected {q.device}")
    # 16-byte cp.async rows: unit stride along D, every other stride and
    # the base address on 16-byte boundaries
    unit = 16 // t.element_size()
    if t.stride(3) != 1 or any(s % unit for s in t.stride()[:3]) \
            or t.data_ptr() % 16:
        raise ValueError(f"{name}: rows must be unit-stride along D and "
                         f"16-byte aligned, got strides {t.stride()}")


def masked_attention(q, k, v, seg, sm_scale: float, causal: bool = False):
    """(B, T, H, D) output of `masked_attention_plain`'s function.

    q (B, T, H, D), k, v (B, T, HKV, D) with H a multiple of HKV, bf16,
    fp16 or fp32 with unit stride along D; seg (B, T) int32, uint8 or bool,
    or None (one segment); under `causal` on the card, sm_scale > 0 (the
    "mma" variant masks a key past the query by a -inf score). CPU tensors
    take the plain version; CUDA tensors launch the kernel variant
    `pick_variant` names (and count the launch, in all and per variant,
    and the causal mode's counters) or raise, on a shape, dtype or layout the kernel does not take, a failed
    build or a failed launch."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q, k: expected (B, T, H, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    B, T, H, D = q.shape
    HKV = k.shape[2]
    if HKV < 1 or H % HKV:
        raise ValueError(f"{H} query heads over {HKV} K / V heads")
    if q.device.type == "cpu":
        return masked_attention_plain(q, k, v, seg, sm_scale, causal)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q: dtype {q.dtype} not in "
                        f"{tuple(_DTYPE_CODE)}")
    _check_operand(q, "q", q)
    _check_operand(k, "k", q, HKV)
    _check_operand(v, "v", q, HKV)
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if causal and not sm_scale > 0:
        raise ValueError(f"causal: scale {sm_scale} must be > 0")
    if T % TILE or T > MAX_SEQ:
        raise ValueError(f"sequence length {T}: must be a multiple of "
                         f"{TILE} up to {MAX_SEQ}")
    if seg is not None:
        if seg.dtype == torch.bool:
            seg = seg.view(torch.uint8)
        if seg.dtype not in (torch.uint8, torch.int32):
            raise TypeError(f"seg: expected int32, uint8 or bool, got "
                            f"{seg.dtype}")
        if tuple(seg.shape) != (B, T) or seg.device != q.device \
                or not seg.is_contiguous():
            raise ValueError(f"seg: expected a contiguous ({B}, {T}) tensor "
                             f"on {q.device}, got {tuple(seg.shape)} on "
                             f"{seg.device}")
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    if B == 0 or H == 0:
        return out
    # _check_operand holds every operand to what a tensor map describes
    variant = _forced_variant or pick_variant(T, D, q.dtype, True)
    dev = q.device
    with torch.cuda.device(dev):
        err = load_library().masked_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if seg is None else seg.data_ptr(), out.data_ptr(), B, T,
            H, HKV, D, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            1 if seg is None else seg.element_size(), int(causal),
            _DTYPE_CODE[q.dtype], VARIANTS.index(variant), sm_scale,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"masked_attention kernel ({variant}) launch "
                           f"failed: error {err} (CUDA's, or 2xxxx from the "
                           f"tensor map encode)")
    masked_attention.launches += 1
    masked_attention.launches_by_variant[variant] += 1
    if causal:
        count("attn.causal_launches", 1)
        count(f"attn.causal_launches.{variant}", 1)
        count("attn.causal_tiles", causal_tiles(B, T, H, variant))
    return out


def causal_tiles(B: int, T: int, H: int, variant: str) -> int:
    """(query tile, key tile) pairs of the variant's tile (128 "wgmma", 64
    "mma") that a causal launch over (B, T, H) computes: n (n + 1) / 2 a
    head for n = T / tile."""
    n = T // (WGMMA_TILE if variant == "wgmma" else TILE)
    return B * H * n * (n + 1) // 2


masked_attention.launches = 0
masked_attention.launches_by_variant = {v: 0 for v in VARIANTS}
