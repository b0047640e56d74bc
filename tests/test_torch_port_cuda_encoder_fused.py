"""The encoders' fused kernels (ops/encoder_fused.py: E1
csrc/embed_layernorm.cu, E2 csrc/add_layernorm.cu, E3
csrc/masked_softmax.cu) against their plain PyTorch versions on the card,
and their launches in the encoders' captured forwards.

This file imports neither jax nor the JAX package, so it runs where the
card is and JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_port_cuda_encoder_fused.py -q

Without a card its tests skip (the kernels have no CPU mode); the CPU
tests (tests/test_torch_port_encoder_fused.py) hold the plain versions
against the JAX package.

Each kernel is held against its plain version in bf16, fp16 and fp32, at
hidden widths 384, 768, 1024 and 200 (not a multiple of 8: single-value
loads) and T in {1, 31, 32, 64, 128, 256, 300, 512}, on ragged masks
with an all-padding row; E1 and E2 also on rows wider than a warp holds
(1,030 and 4,096: four warps a row). E1 and E2 have one kernel each; E3
has two ("staged", the default, on the launch plan of
ops/encoder_fused.py:row_plan, and "rowpass"): every E3 case runs on
both, and "staged" equals "rowpass" bit for bit (where the plan sends a
shape to "rowpass", both are the same launch). Their own cases add
partial last steps, plans of many passes a block, unaligned views, bad
ids, and NaN and inf planted.
Tolerance (ops/encoder_fused.py:outputs_agree): one ulp
of the activation dtype in bf16 and fp16 (for E1 and E2 plus 1e-5 abs:
a LayerNorm output near 0 is a cancellation whose fp32 rounding is
absolute), 1e-5 abs in fp32; the sums and
the masked logits are the plain version's bit for bit, the means,
variances and softmax sums are taken in another order. Two launches on
the same inputs are equal bit for bit (no atomics)."""

import dataclasses

import numpy as np
import pytest
import torch

from neighborhoodwatch_tpu_torch.models import bert as tbert
from neighborhoodwatch_tpu_torch.models import graphed
from neighborhoodwatch_tpu_torch.ops import attention_kernel as ak
from neighborhoodwatch_tpu_torch.ops import encoder_fused as ef

DTYPES = [torch.bfloat16, torch.float16, torch.float32]
VARIANTS = ["staged", "rowpass"]
WIDTHS = [384, 768, 1024, 200]
# the tokenizer's buckets, 1, 31, and 300 (single values over two warps)
SEQS = [1, 31, 32, 64, 128, 256, 300, 512]
# E3's heads and head dim at each width: e5-small, bert-base, e5-large,
# and a head dim that is no power of 4
HEADS = {384: (12, 32), 768: (12, 64), 1024: (16, 64), 200: (4, 50)}


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from neighborhoodwatch_tpu_torch import resolve_device
    return resolve_device("cuda")


def _gen(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


def _mask(T, rows=4):
    """(rows, T) ragged key mask: T, about half, 1 and 0 valid tokens."""
    lengths = torch.tensor([T, T // 2 + 1, 1, 0][:rows], device="cuda")
    return torch.arange(T, device="cuda")[None, :] < lengths[:, None]


def _twice_equal(fn):
    a, b = fn(), fn()
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    return a


def _bits(t):
    return t.contiguous().view(torch.uint8)


def _on_variant(variant, fn):
    """`fn` twice under `variant` (equal bit for bit), and, for "staged",
    equal bit for bit to "rowpass" on the same inputs."""
    with ef.forced_variant(variant):
        got = _twice_equal(fn)
    if variant == "staged":
        with ef.forced_variant("rowpass"):
            other = fn()
        torch.cuda.synchronize()
        assert torch.equal(_bits(got), _bits(other))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("T", SEQS)
@pytest.mark.parametrize("H", WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_embed_layernorm_matches_plain(cuda, dtype, H, T):
    g = _gen(H + T)
    vocab = 1000
    ids = torch.randint(0, vocab, (4, T), device="cuda", generator=g)
    ids[3] = 0                                   # a padding row's ids
    word = torch.randn(vocab, H, device="cuda", generator=g) * 0.5
    pos = torch.randn(512, H, device="cuda", generator=g) * 0.5
    typ = torch.randn(2, H, device="cuda", generator=g) * 0.5
    w = 1 + 0.1 * torch.randn(H, device="cuda", generator=g)
    b = 0.1 * torch.randn(H, device="cuda", generator=g)
    args = (ids, word, pos, typ, w, b, 1e-12, dtype)
    got = _twice_equal(lambda: ef.embed_layernorm(*args))
    want = ef.embed_layernorm_plain(*args)
    ef.outputs_agree(got, want, ef.LN_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("H", [1030, 4096])
@pytest.mark.parametrize("dtype", DTYPES)
def test_wide_rows_match_plain(cuda, dtype, H):
    g = _gen(H)
    # 93 rows: the last block holds one of its two rows
    ids = torch.randint(0, 50, (3, 31), device="cuda", generator=g)
    tables = [0.5 * torch.randn(n, H, device="cuda", generator=g)
              for n in (50, 31, 2)]
    w = 1 + 0.1 * torch.randn(H, device="cuda", generator=g)
    b = 0.1 * torch.randn(H, device="cuda", generator=g)
    args = (ids, *tables, w, b, 1e-12, dtype)
    got = _twice_equal(lambda: ef.embed_layernorm(*args))
    ef.outputs_agree(got, ef.embed_layernorm_plain(*args), ef.LN_ATOL)
    hidden, x = (torch.randn(3, 31, H, device="cuda", generator=g).to(dtype)
                 for _ in range(2))
    got = _twice_equal(lambda: ef.add_layernorm(hidden, x, w, b, 1e-12))
    ef.outputs_agree(got, ef.add_layernorm_plain(hidden, x, w, b, 1e-12),
                     ef.LN_ATOL)


@pytest.mark.cuda
def test_embed_layernorm_bad_id_gives_nan(cuda):
    """An id outside the table reads nothing and writes a row of NaN; the
    other rows are unaffected."""
    g = _gen(3)
    ids = torch.randint(0, 100, (2, 8), device="cuda", generator=g)
    good = ids.clone()
    ids[0, 3], ids[1, 5] = -1, 100
    tables = [torch.randn(n, 64, device="cuda", generator=g)
              for n in (100, 512, 2)]
    w, b = torch.ones(64, device="cuda"), torch.zeros(64, device="cuda")
    got = _twice_equal(lambda: ef.embed_layernorm(
        ids, *tables, w, b, 1e-12, torch.bfloat16))
    want = ef.embed_layernorm_plain(good, *tables, w, b, 1e-12,
                                    torch.bfloat16)
    torch.cuda.synchronize()
    bad = torch.zeros(2, 8, dtype=torch.bool, device="cuda")
    bad[0, 3] = bad[1, 5] = True
    assert bool(torch.isnan(got[bad]).all())
    assert not bool(torch.isnan(got[~bad]).any())
    ef.outputs_agree(got[~bad], want[~bad], ef.LN_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("T", SEQS)
@pytest.mark.parametrize("H", WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_add_layernorm_matches_plain(cuda, dtype, H, T):
    g = _gen(2 * H + T)
    hidden = (3 * torch.randn(4, T, H, device="cuda", generator=g)).to(dtype)
    x = torch.randn(4, T, H, device="cuda", generator=g).to(dtype)
    x[3] = 0.0                                   # an all-zero residual
    w = 1 + 0.1 * torch.randn(H, device="cuda", generator=g)
    b = 0.1 * torch.randn(H, device="cuda", generator=g)
    got = _twice_equal(lambda: ef.add_layernorm(hidden, x, w, b, 1e-12))
    ef.outputs_agree(got, ef.add_layernorm_plain(hidden, x, w, b, 1e-12),
                     ef.LN_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("T", SEQS)
@pytest.mark.parametrize("H", WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_masked_softmax_matches_plain(cuda, dtype, H, T, variant):
    """Logits as the product gives them (q k^T in the activation dtype),
    ragged keys and an all-padding row: the all-masked rows come out
    uniform, never NaN."""
    heads, d = HEADS[H]
    g = _gen(3 * H + T)
    q = torch.randn(4, heads, T, d, device="cuda", generator=g).to(dtype)
    k = torch.randn(4, heads, T, d, device="cuda", generator=g).to(dtype)
    logits = q @ k.transpose(2, 3)
    mask = _mask(T)
    got = _on_variant(variant, lambda: ef.masked_softmax(logits, mask, d))
    ef.outputs_agree(got, ef.masked_softmax_plain(logits, mask, d))
    assert bool(torch.isfinite(got).all())
    uniform = torch.tensor(1.0 / T).to(dtype)
    assert bool((got[3].float().cpu() == uniform.float()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("B,heads,T", [(3, 5, 8), (3, 5, 16), (3, 5, 32),
                                       (3, 5, 64), (1, 3, 128), (1, 3, 300)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_masked_softmax_partial_blocks(cuda, dtype, B, heads, T, variant):
    """Row counts that leave the last block part full: rows of 4 to 16
    lanes share a warp, and the rows past the end join its shuffles with
    no values."""
    g = _gen(B * heads * T)
    logits = (4 * torch.randn(B, heads, T, T, device="cuda",
                              generator=g)).to(dtype)
    mask = _mask(T, rows=B)
    got = _on_variant(variant, lambda: ef.masked_softmax(logits, mask, 16))
    ef.outputs_agree(got, ef.masked_softmax_plain(logits, mask, 16))


@pytest.mark.cuda
@pytest.mark.parametrize("sms", [1, 2, 5, 17, 64, None])
@pytest.mark.parametrize("dtype", DTYPES)
def test_staged_passes_equal_rowpass(cuda, dtype, sms, monkeypatch):
    """Plans on a card of fewer SMs (so each block takes many passes: a
    few blocks at 1 SM, one pass a block on the card's own count) and rows
    no multiple of a step (a partial last step): E3 on "staged" equals
    "rowpass" bit for bit."""
    monkeypatch.setattr(ef, "_plans", {})
    if sms is not None:
        monkeypatch.setattr(ef, "_sm_count", lambda dev: sms)
    g = _gen(sms or 0)
    B, heads, T = 9, 12, 64                      # 6,912 rows of 64 keys
    logits = (4 * torch.randn(B, heads, T, T, device="cuda",
                              generator=g)).to(dtype)
    mask = _mask(T, rows=4).repeat(3, 1)[:B]
    got = _on_variant("staged", lambda: ef.masked_softmax(logits, mask, 64))
    pl = ef.masked_softmax.last_plan
    assert pl.variant == "staged"
    assert pl.passes > 1 or sms is None or sms > 17
    ef.outputs_agree(got, ef.masked_softmax_plain(logits, mask, 64))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_staged_unaligned_views_and_planted_values(cuda, dtype):
    """Views one element past an aligned start (single-value loads in E1
    and E2), rows holding NaN and inf (NaN rows out of E2, NaN or the
    plain version's values out of E3, at the same places), and all-masked
    rows: each against its plain version, E3's "staged" equal to "rowpass"
    bit for bit."""
    g = _gen(77)
    H = 1024
    base = torch.randn(2 * 300 * H + 1, device="cuda", generator=g).to(dtype)
    hidden, x = base[1:300 * H + 1].view(300, H), base[:300 * H].view(300, H)
    w = 1 + 0.1 * torch.randn(H, device="cuda", generator=g)
    b = 0.1 * torch.randn(H, device="cuda", generator=g)
    ef.reset_launches()
    # E1: a word table one element past an aligned start
    table = torch.randn(1000 * H + 1, device="cuda", generator=g)
    word = table[1:].view(1000, H)
    ids = torch.randint(0, 1000, (4, 100), device="cuda", generator=g)
    tables = (word, torch.randn(512, H, device="cuda", generator=g),
              torch.randn(2, H, device="cuda", generator=g))
    got = _twice_equal(lambda: ef.embed_layernorm(
        ids, *tables, w, b, 1e-12, dtype))
    ef.outputs_agree(got, ef.embed_layernorm_plain(
        ids, *tables, w, b, 1e-12, dtype), ef.LN_ATOL)
    got = _twice_equal(lambda: ef.add_layernorm(hidden, x, w, b, 1e-12))
    ef.outputs_agree(got, ef.add_layernorm_plain(hidden, x, w, b, 1e-12),
                     ef.LN_ATOL)
    # planted NaN and inf, aligned rows
    h2 = torch.randn(4000, H, device="cuda", generator=g).to(dtype)
    x2 = torch.randn(4000, H, device="cuda", generator=g).to(dtype)
    h2[5, 3], h2[77, 0], x2[1999, H - 1] = float("nan"), float("inf"), \
        float("-inf")
    got = _twice_equal(lambda: ef.add_layernorm(h2, x2, w, b, 1e-12))
    ef.outputs_agree(got, ef.add_layernorm_plain(h2, x2, w, b, 1e-12),
                     ef.LN_ATOL)
    T, heads = 128, 12
    logits = torch.randn(6, heads, T, T, device="cuda", generator=g).to(dtype)
    logits[0, 1, 2, 3] = float("nan")
    logits[1, 0, 5, 7] = float("inf")
    logits[2, 3, 9, 0] = float("-inf")
    mask = _mask(T, rows=4).repeat(2, 1)[:6]
    got = _on_variant("staged", lambda: ef.masked_softmax(logits, mask, 64))
    assert ef.masked_softmax.last_plan.variant == "staged"
    ef.outputs_agree(got, ef.masked_softmax_plain(logits, mask, 64))


def _small_encoder(impl, hidden=256, heads=4, layers=2):
    cfg = tbert.BertConfig(hidden_size=hidden, num_heads=heads,
                           num_layers=layers, intermediate_size=4 * hidden,
                           attention_impl=impl)
    enc = tbert.BertEncoder(cfg)
    tbert.init_params(enc, seed=11)
    return cfg, enc.to("cuda").eval()


def _counts():
    return [(w.launches, dict(w.launches_by_variant)) for w in
            (ef.embed_layernorm, ef.add_layernorm, ef.masked_softmax)]


@pytest.mark.cuda
@pytest.mark.parametrize("impl,T", [("auto", 32), ("auto", 128),
                                    ("flash", 128)])
def test_launches_per_replay(cuda, impl, T):
    """A replay of a captured forward counts E1 once, E2 twice a layer and
    E3 once a layer under "auto"; under "flash", where K6 runs, E3 never;
    the replay equals the eager forward bit for bit, and the eager forward
    with the plain chain within 2^-5 of the outputs' largest magnitude
    (E2's one-ulp roundings carried through two bf16 layers)."""
    cfg, enc = _small_encoder(impl)
    L = cfg.num_layers
    runner = graphed.GraphRunner(enc, "cuda", 4, name="small")
    rng = np.random.default_rng(T)
    ids = rng.integers(999, 30000, (8, T)).astype(np.int64)
    mask = (np.arange(T)[None, :] < rng.integers(1, T + 1, (8, 1))).astype(
        np.int32)
    mask[7] = 0                                  # a pad row
    first = runner(ids, mask)                    # captures
    ef.reset_launches()
    k6 = ak.masked_attention.launches
    got = runner(ids, mask)
    e3 = 0 if impl == "flash" else L
    assert _counts() == [(1, {"staged": 0, "rowpass": 1, "plain": 0}),
                         (2 * L, {"staged": 0, "rowpass": 2 * L,
                                  "plain": 0}),
                         (e3, {"staged": e3, "rowpass": 0, "plain": 0})]
    assert ak.masked_attention.launches - k6 == (L if impl == "flash" else 0)
    with graphed.forced_variant("eager"):
        eager = runner(ids, mask)
        with ef.forced_variant("staged"):
            staged = runner(ids, mask)
        with ef.forced_variant("rowpass"):
            rowpass = runner(ids, mask)
        with ef.forced_variant("plain"):
            plain = runner(ids, mask)
    torch.cuda.synchronize()
    assert torch.equal(got, first) and torch.equal(got, eager)
    assert torch.equal(got, staged) and torch.equal(got, rowpass)
    by = ef.add_layernorm.launches_by_variant
    assert by["plain"] == 2 * L and by["staged"] == 0
    assert ef.add_layernorm.launches == 8 * L
    keep = torch.from_numpy(mask.astype(bool)).to("cuda")
    diff = (got - plain).abs()[keep]
    assert float(diff.max()) <= 2.0 ** -5 * float(plain[keep].abs().max()), \
        float(diff.max())


@pytest.mark.cuda
def test_generators_launch_per_replay(cuda, monkeypatch):
    """The e5-small-v2 generator (published width, head dim 32, 12 layers)
    and the ColBERT generator (bert-base width, cut to 2 layers): a replay
    launches E1 1, E2 2 x layers, E3 layers; their graphs equal their eager
    forwards bit for bit."""
    from neighborhoodwatch_tpu_torch.models import colbert as tcolbert
    from neighborhoodwatch_tpu_torch.models.e5 import E5EmbeddingGenerator
    e5 = E5EmbeddingGenerator("intfloat/e5-small-v2", seed=3, device="cuda")
    col = tcolbert.ColbertEmbeddingGenerator(config=dataclasses.replace(
        tcolbert.COLBERT_BASE_CONFIG, num_layers=2), device="cuda", seed=2)
    texts = [" ".join(f"w{j}" for j in range(n)) for n in (30, 7, 19)]
    for gen, encode, L in ((e5, e5._encode, 12),
                           (col, col.encode_passages, 2)):
        encode(texts)                            # captures
        ef.reset_launches()
        got = encode(texts)
        assert [c[0] for c in _counts()] == [1, 2 * L, L]
        with graphed.forced_variant("eager"):
            want = encode(texts)
        if isinstance(got, tuple):
            assert got[1] == want[1]
            got, want = np.asarray(got[0]), np.asarray(want[0])
            assert np.array_equal(got, want)
        else:
            assert torch.equal(got, want)
