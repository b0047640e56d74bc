"""PyTorch port of the BERT encoders' fused attention (`attention_impl=
"flash"`) vs the JAX reference on the CPU.

The JAX package calls JAX's library Pallas kernel `flash_attention` with
segment ids (models/bert_flax.py:102-115) on a TPU backend only; here it
runs in interpret mode the way the JAX package's own tests run their
Pallas kernels (`pallas_call(..., interpret=True)`, patched into the
library module for the test: the kernel takes no `interpret` argument,
and the TPU interpret mode's thread-and-callback simulation has hung the
suite under parallel workers), and at the encoder level
`bert_flax._use_flash` is patched, in the test only, to drop its backend
clause. The port's `masked_attention` runs its plain version on
CPU tensors; the kernel itself is held against that plain version on the
card (tests/test_torch_port_cuda.py, chip_smoke.py phase 10).

Tolerances: fp32 within 1e-5 abs (same function, sums and exp in another
order); bf16 within 2e-2 abs (the output is rounded to bf16, ulp 2^-8 near
1, and the library rounds the unnormalized p to bf16 where the plain
version rounds the normalized one); fp16 within 4e-3 abs (the same at
fp16's ulp, 2^-9 for |o| in 2..4: two ulps). Every row is compared,
padding rows included: a padding query attends to the padding keys
(segment 0). On the card the port's gate also asks for a head dim the
kernel instantiates (64, 128); other head dims the reference's gate
admits take the written-out attention there, which only valid rows can
match."""

import dataclasses
import functools
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas.ops.tpu import flash_attention as jfa

from neighborhoodwatch_tpu.models import bert_flax, colbert_flax, e5_flax

from neighborhoodwatch_tpu_torch.models import bert as tbert
from neighborhoodwatch_tpu_torch.models import colbert as tcolbert
from neighborhoodwatch_tpu_torch.models import e5 as te5
from neighborhoodwatch_tpu_torch.ops import attention_kernel as tak

# head dim 64: the gate's smallest
NARROW = dict(hidden_size=128, num_layers=2, num_heads=2,
              intermediate_size=256)
E5_BASE = "intfloat/e5-base-v2"
ATOL = {"float32": 1e-5, "bfloat16": 2e-2, "float16": 4e-3}
DTYPES = {"float32": (np.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16)}


def _segments(T, lengths):
    """(len(lengths), T) int32 masks: row i valid up to lengths[i]; 0 is an
    all-padding row."""
    seg = np.zeros((len(lengths), T), np.int32)
    for i, n in enumerate(lengths):
        seg[i, :n] = 1
    return seg


class _InterpretedPallas(types.ModuleType):
    """`jax.experimental.pallas` with `pallas_call(..., interpret=True)`."""
    pallas_call = functools.partial(pl.pallas_call, interpret=True)

    def __getattr__(self, name):
        return getattr(pl, name)


@pytest.fixture()
def interpreted(monkeypatch):
    """The library kernel's pallas_call in interpret mode."""
    monkeypatch.setattr(jfa, "pl", _InterpretedPallas("pl"))


def _library(q, k, v, seg, sm_scale):
    """JAX's library kernel on (B, T, H, D) numpy operands (swapped to its
    (B, H, T, D) and back, as bert_flax does)."""
    sw = [jnp.swapaxes(jnp.asarray(x), 1, 2) for x in (q, k, v)]
    s = jnp.asarray(seg)
    out = jfa.flash_attention(*sw, segment_ids=jfa.SegmentIds(q=s, kv=s),
                              sm_scale=sm_scale)
    return np.asarray(jnp.swapaxes(out, 1, 2).astype(jnp.float32))


@pytest.fixture()
def flash_anywhere(monkeypatch, interpreted):
    """bert_flax's flash path on the CPU backend: its gate without the TPU
    clause, the library kernel in interpret mode; counts the library
    calls."""
    calls = []
    real = jfa.flash_attention

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    def gate(cfg, seq):
        head_dim = cfg.hidden_size // cfg.num_heads
        return (cfg.attention_impl == "flash" and seq % 128 == 0
                and head_dim % 64 == 0)
    monkeypatch.setattr(bert_flax, "_use_flash", gate)
    monkeypatch.setattr(jfa, "flash_attention", counted)
    return calls


@pytest.fixture()
def plain_calls(monkeypatch):
    """Counts the port's plain attention calls; the library loader raises,
    so a CPU tensor that reached the kernel path would fail the test."""
    calls = []
    real = tak.masked_attention_plain

    def counted(q, *args):
        calls.append(tuple(q.shape))
        return real(q, *args)

    def no_library():
        raise AssertionError("CPU tensors must not load the kernel")
    monkeypatch.setattr(tak, "masked_attention_plain", counted)
    monkeypatch.setattr(tak, "load_library", no_library)
    return calls


# ---------------------------------------------------------------- module

@pytest.mark.parametrize("T", [128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_attention_matches_library_kernel(T, dtype, plain_calls,
                                                 interpreted):
    """Ragged masks (valid lengths 1, 37, T - 1 and T, one all-padding
    row), H=2, D=64: every row of the port against JAX's library kernel."""
    B, H, D = 5, 2, 64
    rng = np.random.default_rng(T)
    ops = [rng.standard_normal((B, T, H, D)).astype(np.float32)
           for _ in range(3)]
    jdt, tdt = DTYPES[dtype]
    ops = [np.array(jnp.asarray(x).astype(jdt).astype(jnp.float32))
           for x in ops]                        # the same bf16 values
    seg = _segments(T, [1, 37, T - 1, T, 0])
    scale = 1.0 / math.sqrt(D)
    want = _library(*[x.astype(jdt) for x in ops], seg, scale)
    got = tak.masked_attention(
        *[torch.from_numpy(x).to(tdt) for x in ops],
        torch.from_numpy(seg), scale)
    assert got.dtype == tdt and got.shape == (B, T, H, D)
    assert plain_calls == [(B, T, H, D)]
    np.testing.assert_allclose(got.float().numpy(), want, atol=ATOL[dtype],
                               rtol=0)


def test_segments_do_not_mix():
    """A query's output depends on the values of its own segment only:
    new values for row 0's valid keys leave its padding queries' outputs
    unchanged, new padding values leave its valid queries' unchanged."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 128, 2, 64))
                                .astype(np.float32)) for _ in range(3))
    seg = torch.from_numpy(_segments(128, [37]))
    base = tak.masked_attention(q, k, v, seg, 0.125)
    for rows, other in ((slice(0, 37), slice(37, None)),
                        (slice(37, None), slice(0, 37))):
        v2 = v.clone()
        v2[0, rows] += 1.0
        out = tak.masked_attention(q, k, v2, seg, 0.125)
        assert torch.equal(out[0, other], base[0, other])
        assert not torch.equal(out[0, rows], base[0, rows])


def test_plain_version_masks_additively_like_mha_reference():
    """fp32 operands, segment ids other than 0/1: the plain version is the
    library's mha_reference (additive DEFAULT_MASK_VALUE) and the mask is
    the library's own constant."""
    assert tak.MASK_VALUE == jfa.DEFAULT_MASK_VALUE
    B, T, H, D = 2, 128, 3, 64
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((B, T, H, D)).astype(np.float32)
               for _ in range(3))
    seg = rng.integers(0, 4, (B, T)).astype(np.int32)
    sw = [jnp.swapaxes(jnp.asarray(x), 1, 2) for x in (q, k, v)]
    want = np.asarray(jnp.swapaxes(jfa.mha_reference(
        *sw, None, jfa.SegmentIds(q=jnp.asarray(seg), kv=jnp.asarray(seg)),
        sm_scale=0.125), 1, 2))
    got = tak.masked_attention_plain(
        *[torch.from_numpy(x) for x in (q, k, v)], torch.from_numpy(seg),
        0.125).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# ---------------------------------------------------------------- encoder

def _flax_params(cfg, seed):
    params = bert_flax.init_params(cfg, seed=seed)
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(x.shape)
        .astype(np.float32), params)


def _ids(seed, T, lengths):
    rng = np.random.default_rng(seed)
    mask = _segments(T, lengths)
    ids = rng.integers(999, 30522, mask.shape).astype(np.int32) * mask
    return ids, mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_encoder_matches_flax_flash_path(dtype, flash_anywhere,
                                               plain_calls):
    """A 2-layer BERT (head dim 64) at T=128 under "flash" in both
    packages, weights carried across: every position's hidden state (the
    padding rows took the same segment-0 attention on both sides) and the
    e5 pooled embedding."""
    jcfg = bert_flax.BertConfig(dtype=dtype, attention_impl="flash", **NARROW)
    tcfg = tbert.BertConfig(dtype=dtype, attention_impl="flash", **NARROW)
    params = _flax_params(jcfg, seed=8)
    ids, mask = _ids(9, 128, [128, 70, 1])
    jh = bert_flax.BertEncoder(jcfg).apply(params, jnp.asarray(ids),
                                           jnp.asarray(mask))
    want = np.asarray(bert_flax.mean_pool_normalize(jh, jnp.asarray(mask)))
    assert len(flash_anywhere) == 2
    model = tbert.BertEncoder(tcfg)
    model.load_state_dict(tbert.bert_state_from_flax(params["params"], tcfg))
    with torch.no_grad():
        th = model(torch.from_numpy(ids).long(), torch.from_numpy(mask))
        got = tbert.mean_pool_normalize(th, torch.from_numpy(mask)).numpy()
    assert plain_calls == [(3, 128, 2, 64)] * 2
    atol = ATOL[dtype]
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh),
                               atol=atol * (10 if dtype == "float32" else 5),
                               rtol=0)


# -------------------------------------------------------------- pipelines

def _long_texts(n, seed):
    """Texts of 70-120 hash tokens: bucket 128 at any max_length >= 128."""
    rng = np.random.default_rng(seed)
    return [" ".join(f"w{int(x)}" for x in rng.integers(0, 900, size=n_w))
            for n_w in rng.integers(68, 118, size=n)]


def test_e5_generator_flash_matches_flax(monkeypatch, flash_anywhere,
                                         plain_calls):
    """Both packages' e5 generators with "flash" on carried weights (a
    narrow 2-layer fp32 config in the e5-base-v2 entry of both config
    tables): the pooled, normalized embeddings of texts in bucket 128."""
    jcfg = bert_flax.BertConfig(dtype="float32", attention_impl="flash",
                                **NARROW)
    tcfg = tbert.BertConfig(dtype="float32", attention_impl="flash",
                            **NARROW)
    monkeypatch.setitem(bert_flax.E5_CONFIGS, E5_BASE, jcfg)
    monkeypatch.setitem(tbert.E5_CONFIGS, E5_BASE, tcfg)
    params = _flax_params(jcfg, seed=12)
    jg = e5_flax.E5FlaxEmbeddingGenerator(
        E5_BASE, params=jax.tree.map(jnp.asarray, params))
    tg = te5.E5EmbeddingGenerator(
        E5_BASE, state=tbert.bert_state_from_flax(params["params"], tcfg),
        device="cpu")
    texts = _long_texts(3, seed=2)
    want = np.asarray(jg.generate_embedding(texts))
    got = np.asarray(tg.generate_embedding(texts))
    assert flash_anywhere and all(s[2] == 128 for s in flash_anywhere)
    assert plain_calls == [(3, 128, 2, 64)] * 2
    assert got.shape == want.shape == (3, 128)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_colbert_generator_flash_matches_flax(flash_anywhere, plain_calls):
    """The ColBERT generator with the flash config on a narrow backbone
    (fp32): per-token embeddings of passages in bucket 128, on valid tokens
    (what encode_passages returns)."""
    jcfg = bert_flax.BertConfig(dtype="float32", attention_impl="flash",
                                **NARROW)
    tcfg = tbert.BertConfig(dtype="float32", attention_impl="flash",
                            **NARROW)
    model = colbert_flax.ColbertModel(jcfg)
    dummy = jnp.zeros((1, 16), dtype=jnp.int32)
    params = jax.tree.map(np.array, model.init(
        jax.random.PRNGKey(4), dummy, jnp.ones_like(dummy)))
    jgen = colbert_flax.ColbertFlaxEmbeddingGenerator(
        params=jax.tree.map(jnp.asarray, params), config=jcfg)
    tgen = tcolbert.ColbertEmbeddingGenerator(
        state=tcolbert.colbert_state_from_flax(params, tcfg), config=tcfg,
        device="cpu")
    texts = _long_texts(4, seed=3)
    je, jc = jgen.encode_passages(texts, batch_size=4)
    te, tc = tgen.encode_passages(texts, batch_size=4)
    assert flash_anywhere and plain_calls == [(4, 128, 2, 64)] * 2
    assert tc == jc and all(64 < c <= 128 for c in tc)
    assert te.shape == je.shape == (sum(jc), 128)
    np.testing.assert_allclose(te, je, atol=1e-5, rtol=0)


# ------------------------------------------------------- gate and routing

def test_use_flash_follows_the_reference_gate():
    cfg = tbert.BertConfig(attention_impl="flash", **NARROW)
    jcfg = bert_flax.BertConfig(attention_impl="flash", **NARROW)
    for seq in (64, 128, 220, 256, 384, 512):
        assert tak.use_flash(cfg, seq) == (seq % 128 == 0)
    small = tbert.E5_CONFIGS["intfloat/e5-small-v2"]   # head dim 32
    for c in (tbert.BertConfig(**NARROW),
              dataclasses.replace(small, attention_impl="flash"),
              dataclasses.replace(cfg, attention_impl="xla")):
        assert not tak.use_flash(c, 128)
    large = dataclasses.replace(tbert.E5_CONFIGS["intfloat/e5-large-v2"],
                                attention_impl="flash")
    assert tak.use_flash(large, 512) and not tak.use_flash(large, 32)
    assert bert_flax._use_flash(jcfg, 128) == (
        jax.default_backend() == "tpu")


@pytest.mark.parametrize("T,cfg", [
    (64, NARROW),                                   # sequence % 128 != 0
    (128, dict(NARROW, num_heads=4)),               # head dim 32
])
def test_flash_outside_the_gate_takes_the_written_out_path(T, cfg,
                                                           plain_calls):
    """Where the gate is false, "flash" runs the written-out attention:
    the same numbers as "auto", no plain or kernel call."""
    ids, mask = _ids(3, T, [T, T // 2])
    outs = []
    for impl in ("flash", "auto"):
        model = tbert.BertEncoder(tbert.BertConfig(
            dtype="float32", attention_impl=impl, **cfg))
        tbert.init_params(model, seed=1)
        with torch.no_grad():
            outs.append(model(torch.from_numpy(ids).long(),
                              torch.from_numpy(mask)))
    assert plain_calls == []
    assert torch.equal(outs[0], outs[1])


def test_flash_on_cpu_never_loads_the_kernel(plain_calls):
    """CPU tensors inside the gate: the plain version, no library load (the
    fixture's loader raises), no launch counted; valid rows agree with the
    written-out attention, which masks keys only."""
    before = tak.masked_attention.launches
    ids, mask = _ids(6, 128, [128, 90])
    outs = []
    for impl in ("flash", "auto"):
        model = tbert.BertEncoder(tbert.BertConfig(
            dtype="float32", attention_impl=impl, **NARROW))
        tbert.init_params(model, seed=2)
        with torch.no_grad():
            outs.append(model(torch.from_numpy(ids).long(),
                              torch.from_numpy(mask)))
    assert plain_calls == [(2, 128, 2, 64)] * 2
    assert tak.masked_attention.launches == before
    valid = torch.from_numpy(mask).bool()
    torch.testing.assert_close(outs[0][valid], outs[1][valid], atol=1e-5,
                               rtol=0)
    assert not torch.equal(outs[0][~valid], outs[1][~valid])


def test_wrapper_refuses_other_devices_and_unknown_impl_raises():
    q = torch.empty((1, 128, 2, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tak.masked_attention(q, q, q, torch.empty((1, 128), device="meta"),
                             0.125)
    with pytest.raises(ValueError, match="attention_impl"):
        tbert.BertEncoder(tbert.BertConfig(attention_impl="sdpa", **NARROW))


def test_masked_attention_fp16_matches_library_kernel(plain_calls,
                                                      interpreted):
    """float16 operands (the dtype the kernel gained with the gate's
    repair), ragged masks, H=2, D=64, T=128: every row of the port's plain
    version against JAX's library kernel."""
    B, T, H, D = 5, 128, 2, 64
    rng = np.random.default_rng(T)
    ops = [np.array(jnp.asarray(rng.standard_normal((B, T, H, D))
                                .astype(np.float32)).astype(jnp.float16)
                    .astype(jnp.float32)) for _ in range(3)]
    seg = _segments(T, [1, 37, T - 1, T, 0])
    want = _library(*[x.astype(jnp.float16) for x in ops], seg, 0.125)
    got = tak.masked_attention(
        *[torch.from_numpy(x).to(torch.float16) for x in ops],
        torch.from_numpy(seg), 0.125)
    assert got.dtype == torch.float16 and plain_calls == [(B, T, H, D)]
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=ATOL["float16"], rtol=0)


# head dims (hidden 768): 64 and 128 are the kernel's, 192 and 256 are not
@pytest.mark.parametrize("heads,dtype,on_card", [
    (12, "bfloat16", True), (12, "float16", True), (12, "float32", True),
    (6, "float16", True), (4, "bfloat16", False), (3, "float16", False),
    (24, "bfloat16", False),                    # head dim 32: neither gate
])
def test_gate_admits_on_the_card_only_what_the_kernel_takes(heads, dtype,
                                                            on_card):
    """The gate on the CPU is the reference's (sequence % 128, head dim %
    64); on a CUDA device (no card needed: the predicate alone) it also
    asks for what `masked_attention` takes there, so nothing it admits
    raises in the wrapper: head dim in HEAD_DIMS, a kernel dtype, the
    sequence a multiple of the tile up to MAX_SEQ."""
    cfg = tbert.BertConfig(hidden_size=768, num_heads=heads, dtype=dtype,
                           attention_impl="flash")
    head_dim = 768 // heads
    for seq in (64, 128, 256, 512, tak.MAX_SEQ, tak.MAX_SEQ + 128):
        ref = seq % 128 == 0 and head_dim % 64 == 0
        assert tak.use_flash(cfg, seq, "cpu") == ref
        assert tak.use_flash(cfg, seq, torch.device("cpu")) == ref
        card = tak.use_flash(cfg, seq, "cuda")
        assert card == tak.use_flash(cfg, seq, torch.device("cuda", 0))
        assert card == (ref and on_card and seq <= tak.MAX_SEQ)
        if card:
            assert head_dim in tak.HEAD_DIMS and seq % tak.TILE == 0
            assert getattr(torch, dtype) in tak._DTYPE_CODE
    off = dataclasses.replace(cfg, attention_impl="auto")
    assert not tak.use_flash(off, 128, "cpu")
    assert not tak.use_flash(off, 128, "cuda")


def _encoder_pair(kw, dtype, seed):
    jcfg = bert_flax.BertConfig(dtype=dtype, attention_impl="flash", **kw)
    tcfg = tbert.BertConfig(dtype=dtype, attention_impl="flash", **kw)
    params = _flax_params(jcfg, seed=seed)
    model = tbert.BertEncoder(tcfg)
    model.load_state_dict(tbert.bert_state_from_flax(params["params"], tcfg))
    return bert_flax.BertEncoder(jcfg), params, model


def test_flash_head_dim_192_follows_the_reference_on_cpu_and_card_path(
        flash_anywhere, plain_calls, monkeypatch):
    """Head dim 192 (hidden 384, 2 heads), fp32, weights carried: the
    reference's gate admits it, so on the CPU the port's plain version
    runs and every row matches the JAX package's flash path; on the card
    the port's gate sends it to the written-out attention, whose valid rows
    (the ones pooling reads) match too."""
    kw = dict(hidden_size=384, num_layers=2, num_heads=2,
              intermediate_size=256)
    jmodel, params, model = _encoder_pair(kw, "float32", seed=21)
    ids, mask = _ids(22, 128, [128, 70, 1])
    jh = np.asarray(jmodel.apply(params, jnp.asarray(ids),
                                 jnp.asarray(mask)))
    assert len(flash_anywhere) == 2
    assert not tak.use_flash(model.config, 128, "cuda")
    with torch.no_grad():
        th = model(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    assert plain_calls == [(3, 128, 2, 192)] * 2
    np.testing.assert_allclose(th.numpy(), jh, atol=1e-4, rtol=0)
    # the card's decision, taken here on CPU tensors
    monkeypatch.setattr(tbert, "use_flash",
                        lambda cfg, seq, device: tak.use_flash(cfg, seq,
                                                               "cuda"))
    with torch.no_grad():
        card = model(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    assert len(plain_calls) == 2
    valid = mask.astype(bool)
    np.testing.assert_allclose(card.numpy()[valid], jh[valid], atol=1e-4,
                               rtol=0)
    assert not np.allclose(card.numpy()[~valid], jh[~valid], atol=1e-2)


def test_flash_float16_encoder_matches_flax_flash_path(flash_anywhere,
                                                       plain_calls):
    """dtype="float16" under "flash" (the card now takes it: the gate
    admits it on both devices): a 2-layer BERT at T=128, weights carried,
    every position's hidden state and the pooled embedding against the JAX
    package's flash path. Tolerances: 2e-3 pooled, 1.6e-2 hidden (4 fp16
    ulps for |h| in 4..8; the two sides round the activations at other
    places)."""
    jmodel, params, model = _encoder_pair(NARROW, "float16", seed=8)
    ids, mask = _ids(9, 128, [128, 70, 1])
    jh = jmodel.apply(params, jnp.asarray(ids), jnp.asarray(mask))
    want = np.asarray(bert_flax.mean_pool_normalize(jh, jnp.asarray(mask)))
    assert tak.use_flash(model.config, 128, "cuda")
    with torch.no_grad():
        th = model(torch.from_numpy(ids).long(), torch.from_numpy(mask))
        got = tbert.mean_pool_normalize(th, torch.from_numpy(mask))
    assert model.layers[0].attention.query.weight.dtype == torch.float16
    assert plain_calls == [(3, 128, 2, 64)] * 2
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-3, rtol=0)
    np.testing.assert_allclose(th.float().numpy(),
                               np.asarray(jh).astype(np.float32),
                               atol=1.6e-2, rtol=0)


@pytest.mark.parametrize("T,D,dtype,aligned,want", [
    (128, 64, torch.bfloat16, True, "wgmma"),
    (512, 64, torch.float16, True, "wgmma"),
    (384, 128, torch.bfloat16, True, "wgmma"),
    (8192, 128, torch.float16, True, "wgmma"),
    (192, 64, torch.bfloat16, True, "mma"),         # T % 128 == 64
    (128, 64, torch.float32, True, "mma"),          # wgmma's fp32 is TF32
    (128, 128, torch.float32, True, "mma"),
    (256, 64, torch.bfloat16, False, "mma"),        # no tensor map
    (128, 192, torch.float16, True, "mma"),         # not instantiated
])
def test_pick_variant_follows_dtype_shape_and_alignment(T, D, dtype,
                                                        aligned, want):
    assert tak.pick_variant(T, D, dtype, aligned) == want


def test_forced_variant_refuses_unknown_names_and_restores(plain_calls):
    """An unknown name raises before anything is forced; forcing nests and
    restores; on CPU tensors a forced variant changes nothing (the plain
    version runs, no launch is counted)."""
    with pytest.raises(ValueError, match="variant"):
        with tak.forced_variant("sdpa"):
            pass
    assert tak._forced_variant is None
    before = dict(tak.masked_attention.launches_by_variant)
    q = torch.zeros((1, 128, 2, 64))
    seg = torch.ones((1, 128), dtype=torch.int32)
    with tak.forced_variant("mma"):
        assert tak._forced_variant == "mma"
        with tak.forced_variant("wgmma"):
            assert tak._forced_variant == "wgmma"
            tak.masked_attention(q, q, q, seg, 0.125)
        assert tak._forced_variant == "mma"
    assert tak._forced_variant is None
    assert plain_calls == [(1, 128, 2, 64)]
    assert tak.masked_attention.launches_by_variant == before
    assert tuple(before) == tak.VARIANTS

