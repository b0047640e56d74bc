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

Layout: q, k, v and the output are (B, T, H, D), the encoder's nn.Linear
outputs viewed per head, which the kernel reads in place with their strides
(the JAX call site swaps them to (B, H, T, D) around the library call and
back). seg (B, T) holds segment ids: a query sees the keys of its own
segment. The encoders pass the attention mask, valid tokens segment 1 and
padding segment 0, so a padding query attends to the padding keys where the
written-out attention masks keys only; pooling and the ColBERT head drop
those rows downstream.
"""

import ctypes

import torch

# the library's DEFAULT_MASK_VALUE: added to masked logits, kept finite
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
HEAD_DIMS = (64, 128)        # the kernel's instantiations
TILE = 64                    # its query and key tile
MAX_SEQ = 8192               # a row's segment ids live in shared memory
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}


def use_flash(config, seq: int) -> bool:
    """The gate of bert_flax._use_flash: the fused attention runs for
    `attention_impl="flash"`, a sequence of a multiple of 128 and a head dim
    of a multiple of 64; elsewhere the written-out attention runs, as in the
    reference. The reference's TPU-backend clause becomes the tensors'
    device: CUDA tensors launch the kernel, CPU tensors run the plain
    version."""
    if config.attention_impl != "flash":
        return False
    head_dim = config.hidden_size // config.num_heads
    return seq % 128 == 0 and head_dim % 64 == 0


def masked_attention_plain(q, k, v, seg, sm_scale: float):
    """(B, T, H, D) attention of q over k, v with segment ids seg (B, T):
    logits q.k in fp32 times `sm_scale`, plus MASK_VALUE where the two
    segments differ, softmax in fp32, the probabilities cast to v's dtype,
    their product with v in fp32, the output in q's dtype."""
    qf = q.float().transpose(1, 2)                       # (B, H, T, D)
    kf = k.float().transpose(1, 2)
    logits = (qf @ kf.transpose(2, 3)) * sm_scale
    same = seg[:, :, None] == seg[:, None, :]
    logits = logits + torch.where(same, 0.0, MASK_VALUE)[:, None]
    probs = torch.softmax(logits, dim=-1).to(v.dtype).float()
    ctx = probs @ v.float().transpose(1, 2)
    return ctx.transpose(1, 2).to(q.dtype).contiguous()


def outputs_agree(out, plain) -> float:
    """The kernel's output against the plain version's on the same inputs,
    every row: fp32 within 1e-5 abs (sums and exp in another order); bf16
    within 2 bf16 ulps of the row's largest |o| (the kernel rounds each
    unnormalized p to bf16, the plain version each normalized one, and
    each rounds its output once: a term's error is at most 2^-8 of its
    share of the sum). Returns the max abs difference; raises
    AssertionError beyond the tolerance or on a non-finite output."""
    o, p = out.float(), plain.float()
    if not bool(torch.isfinite(o).all()):
        raise AssertionError("non-finite attention output")
    diff = (o - p).abs()
    if out.dtype == torch.float32:
        tol = torch.full_like(diff, 1e-5)
    else:
        row = p.abs().amax(-1, keepdim=True).clamp_min(2.0 ** -126)
        tol = 2 * torch.exp2(torch.floor(torch.log2(row)) - 7)
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
                                                s, s, s, s, s, s, s, s, s,
                                                i, i, ctypes.c_float, p]
        lib.masked_attention_launch.restype = i
        lib._nw_typed = True
    return lib


def _check_operand(t, name, q):
    if t.dtype != q.dtype:
        raise TypeError(f"{name}: expected {q.dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(q.shape):
        raise ValueError(f"{name}: expected shape {tuple(q.shape)}, got "
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


def masked_attention(q, k, v, seg, sm_scale: float):
    """(B, T, H, D) output of `masked_attention_plain`'s function.

    q, k, v (B, T, H, D) bf16 or fp32 with unit stride along D; seg (B, T)
    int32, uint8 or bool. CPU tensors take the plain version; CUDA tensors
    launch the kernel (and count the launch) or raise, on a shape, dtype or
    layout the kernel does not take, a failed build or a failed launch."""
    if q.dim() != 4:
        raise ValueError(f"q: expected (B, T, H, D), got {tuple(q.shape)}")
    B, T, H, D = q.shape
    if q.device.type == "cpu":
        return masked_attention_plain(q, k, v, seg, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q: dtype {q.dtype} not in "
                        f"{tuple(_DTYPE_CODE)}")
    _check_operand(q, "q", q)
    _check_operand(k, "k", q)
    _check_operand(v, "v", q)
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if T % TILE or T > MAX_SEQ:
        raise ValueError(f"sequence length {T}: must be a multiple of "
                         f"{TILE} up to {MAX_SEQ}")
    if seg.dtype == torch.bool:
        seg = seg.view(torch.uint8)
    if seg.dtype not in (torch.uint8, torch.int32):
        raise TypeError(f"seg: expected int32, uint8 or bool, got "
                        f"{seg.dtype}")
    if tuple(seg.shape) != (B, T) or seg.device != q.device \
            or not seg.is_contiguous():
        raise ValueError(f"seg: expected a contiguous ({B}, {T}) tensor on "
                         f"{q.device}, got {tuple(seg.shape)} on "
                         f"{seg.device}")
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    if B == 0 or H == 0:
        return out
    dev = q.device
    with torch.cuda.device(dev):
        err = load_library().masked_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
            out.data_ptr(), B, T, H, D, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], seg.element_size(), _DTYPE_CODE[q.dtype],
            sm_scale, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"masked_attention kernel launch failed: CUDA "
                           f"error {err}")
    masked_attention.launches += 1
    return out


masked_attention.launches = 0
