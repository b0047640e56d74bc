"""The decoder embedder's kernels on the card: D1-D3
(csrc/decoder_passes.cu via ops/encoder_fused.py: add_rmsnorm, rope,
swiglu) and K6's causal grouped-query mode (csrc/masked_attention.cu via
ops/attention_kernel.py) against their plain PyTorch versions, and the
decoder's captured forward against the float32 reference.

This file imports neither jax nor the JAX package, so it runs where the
card is and JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_port_cuda_decoder.py -q

Without a card its tests skip (the kernels have no CPU mode); the CPU
tests (tests/test_torch_port_decoder.py) hold the plain versions against
plain torch and the port's forward against the reference.

Tolerances: D1 and D3 within one ulp of the activation dtype
(encoder_fused.outputs_agree: the mean square and the card's rsqrtf /
expf round in other last bits), the residual D1 writes and D2 bit for
bit (the same fp32 operations in the same order); K6 as its segment mode
(attention_kernel.outputs_agree: 2 ulps of the row's largest |o| in bf16
and fp16, 1e-5 abs in fp32)."""

import math

import pytest
import torch

from neighborhoodwatch_tpu_torch.models import decoder as dec
from neighborhoodwatch_tpu_torch.ops import attention_kernel as ak
from neighborhoodwatch_tpu_torch.ops import encoder_fused as ef

DTYPES = [torch.bfloat16, torch.float16, torch.float32]


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from neighborhoodwatch_tpu_torch import resolve_device
    return resolve_device("cuda")


def _gen(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


def _bits(t):
    return t.contiguous().view(torch.uint8)


@pytest.mark.cuda
@pytest.mark.parametrize("first", [False, True])
@pytest.mark.parametrize("n", [256, 200, 1024, 4096])
@pytest.mark.parametrize("dtype", DTYPES)
def test_add_rmsnorm_matches_plain(cuda, dtype, n, first):
    g = _gen(n + first)
    hidden = (3 * torch.randn(3, 37, n, device="cuda", generator=g)).to(dtype)
    x = None if first else torch.randn(3, 37, n, device="cuda",
                                       generator=g).to(dtype)
    if x is not None:
        x[2, 5] = -hidden[2, 5]                 # a row that sums to zero
    w = 1 + 0.1 * torch.randn(n, device="cuda", generator=g)
    s, out = ef.add_rmsnorm(hidden, x, w, 1e-5)
    s2, out2 = ef.add_rmsnorm(hidden, x, w, 1e-5)
    torch.cuda.synchronize()
    assert torch.equal(_bits(out), _bits(out2))
    ps, pout = ef.add_rmsnorm_plain(hidden, x, w, 1e-5)
    assert torch.equal(_bits(s), _bits(ps))
    ef.outputs_agree(out, pout)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 64, 8, 2, 128), (3, 100, 4, 1, 64),
                                   (1, 512, 32, 8, 128), (2, 33, 3, 1, 10)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rope_matches_plain_bit_for_bit(cuda, dtype, shape):
    """(B, T, heads, kv heads, head_dim) over a fused q|k|v row: q and k
    rotated in place, v untouched; head_dim 10 takes single values."""
    b, t, h, kv, d = shape
    g = _gen(t * d)
    x = torch.randn(b, t, (h + 2 * kv) * d, device="cuda",
                    generator=g).to(dtype)
    cos, sin = ef.rope_table(4096, d, 10000.0, "cuda")
    got = ef.rope(x.clone(), h + kv, d, cos, sin)
    want = ef.rope_plain(x.clone(), h + kv, d, cos, sin)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(got[..., (h + kv) * d:]),
                       _bits(x[..., (h + kv) * d:]))


@pytest.mark.cuda
@pytest.mark.parametrize("inter", [14336, 512, 100, 7])
@pytest.mark.parametrize("dtype", DTYPES)
def test_swiglu_matches_plain(cuda, dtype, inter):
    g = _gen(inter)
    gu = (4 * torch.randn(5, 9, 2 * inter, device="cuda",
                          generator=g)).to(dtype)
    gu[0, 0, 0] = -200.0                        # exp(-g) overflows
    got = ef.swiglu(gu)
    ef.outputs_agree(got, ef.swiglu_plain(gu))


def _qkv(B, T, H, KV, D, dtype, seed):
    g = _gen(seed)
    qkv = torch.randn(B, T, (H + 2 * KV) * D, device="cuda",
                      generator=g).to(dtype)
    return (qkv[..., :H * D].view(B, T, H, D),
            qkv[..., H * D:(H + KV) * D].view(B, T, KV, D),
            qkv[..., (H + KV) * D:].view(B, T, KV, D))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["wgmma", "mma"])
@pytest.mark.parametrize("T", [128, 256, 512, 1024])
@pytest.mark.parametrize("heads", [(32, 8, 128), (8, 2, 64), (4, 4, 128)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_causal_gqa_matches_plain(cuda, dtype, heads, T, variant):
    """The decoder's call: q, k, v read in place from the fused projection,
    no segment ids, causal."""
    H, KV, D = heads
    q, k, v = _qkv(3, T, H, KV, D, dtype, T + H)
    scale = 1.0 / math.sqrt(D)
    with ak.forced_variant(variant):
        got = ak.masked_attention(q, k, v, None, scale, causal=True)
    ak.outputs_agree(got, ak.masked_attention_plain(q, k, v, None, scale,
                                                    causal=True))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["wgmma", "mma"])
@pytest.mark.parametrize("causal", [True, False])
def test_causal_with_segments_and_gqa_without(cuda, variant, causal):
    """Segment ids and causality together (a ragged mask, an all-padding
    row), and grouped-query heads in the segment mode alone."""
    B, T, H, KV, D = 4, 384, 8, 2, 128
    q, k, v = _qkv(B, T, H, KV, D, torch.bfloat16, 7)
    lengths = torch.tensor([T, 200, 1, 0], device="cuda")
    seg = torch.arange(T, device="cuda")[None] < lengths[:, None]
    with ak.forced_variant(variant):
        got = ak.masked_attention(q, k, v, seg, 0.09, causal=causal)
    ak.outputs_agree(got, ak.masked_attention_plain(q, k, v, seg, 0.09,
                                                    causal=causal))


@pytest.mark.cuda
@pytest.mark.parametrize("T", [64, 192])
@pytest.mark.parametrize("dtype", DTYPES)
def test_causal_mma_at_64_key_tiles(cuda, dtype, T):
    """T % 128 == 64 and fp32 take "mma" by the shape."""
    q, k, v = _qkv(2, T, 8, 2, 64, dtype, T)
    assert ak.pick_variant(T, 64, dtype, True) == "mma"
    got = ak.masked_attention(q, k, v, None, 0.125, causal=True)
    ak.outputs_agree(got, ak.masked_attention_plain(q, k, v, None, 0.125,
                                                    causal=True))


@pytest.mark.cuda
def test_gqa_checks_its_heads(cuda):
    q, k, v = _qkv(1, 128, 6, 4, 64, torch.bfloat16, 1)
    with pytest.raises(ValueError, match="heads"):
        ak.masked_attention(q, k, v, None, 0.1, causal=True)
    # the causal mode masks a key past the row by a -inf score
    q, k, v = _qkv(1, 128, 4, 2, 64, torch.bfloat16, 1)
    with pytest.raises(ValueError, match="scale"):
        ak.masked_attention(q, k, v, None, 0.0, causal=True)


TINY = dec.DecoderConfig(vocab_size=4000, hidden_size=512, num_layers=3,
                         num_heads=4, num_kv_heads=2, intermediate_size=1024)


@pytest.mark.cuda
def test_decoder_generator_on_the_card_matches_the_reference(cuda):
    """A small decoder (head dim 128) through E5EmbeddingGenerator on the
    card, captured graphs and all, against the float32 reference: within
    the fp8 control's gap by a factor of 4; the causal, RoPE, RMSNorm and
    SwiGLU counters at each replay."""
    from mistral_reference import embed_many, make_state
    from neighborhoodwatch_tpu_torch.models import e5
    from neighborhoodwatch_tpu_torch.utils import profiling
    cfg = dict(hidden_size=512, num_hidden_layers=3, num_attention_heads=4,
               num_key_value_heads=2, intermediate_size=1024,
               vocab_size=4000, rms_norm_eps=1e-5, rope_theta=10000.0)
    state = make_state(cfg, _gen(5), "cuda")
    name = dec.E5_MISTRAL
    old = dec.DECODER_CONFIGS[name]
    dec.DECODER_CONFIGS[name] = TINY
    try:
        gen = e5.E5EmbeddingGenerator(name, max_length=512, state=state,
                                      device="cuda")
        texts = [" ".join(f"w{j % 97}" for j in range(n))
                 for n in (5, 150, 70, 300, 1, 20)]
        gen.generate_embedding(texts)           # captures
        with torch.profiler.profile():
            got = gen.generate_embedding(texts)
            recs = profiling.records()["counters"]
    finally:
        dec.DECODER_CONFIGS[name] = old
    ids = [list(r[m.astype(bool)])
           for r, m in zip(*gen.tokenizer(texts, max_length=512))]
    want = embed_many(state, cfg, ids)
    ctl = embed_many(state, cfg, ids, fp8=True)
    gap = (torch.as_tensor(got, device="cuda") - want).norm(dim=1).max()
    ctl_gap = (ctl - want).norm(dim=1).min()
    assert float(gap) < float(ctl_gap) / 4, (float(gap), float(ctl_gap))
    assert recs["decoder.forwards"] == 1
    assert recs["attn.causal_launches"] == 3
    assert recs["attn.causal_launches.wgmma"] == 3
    # 64 rows at bucket 512: 4 query tiles of 128, 10 key tiles a head
    assert recs["attn.causal_tiles"] == 64 * 4 * 3 * 10
    assert recs["decoder.rmsnorm"] == 7 and recs["decoder.rope"] == 3
    assert recs["decoder.swiglu"] == 3
