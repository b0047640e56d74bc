"""The decoder embedder (models/decoder.py, e5-mistral-7b-instruct's
Mistral block) on the CPU at a tiny width, on seeded random weights: the
port's forward through E5EmbeddingGenerator against the plain float32
reference (tests/mistral_reference.py; the JAX package has no decoder),
K6's causal grouped-query plain version against written-out attention,
D1-D3's plain versions against plain torch, last-token pooling, the
prefix rules, the registry's 16th name, and the wrappers' launches on a
fake library (meta tensors stand for CUDA tensors, as in
test_torch_port_encoder_fused.py). The kernels themselves run only on the
card (tests/test_torch_port_cuda_decoder.py).

The tiny decoder: hidden 256, 4 layers, 8 heads over 2 KV heads (head
dim 32), intermediate 512, vocabulary 4,000 (the hash tokenizer's word
ids start at 999, so a vocabulary of 1,000 would give every word one
id)."""

import contextlib

import numpy as np
import pytest
import torch

from mistral_reference import embed_many, make_state
from neighborhoodwatch_tpu_torch.models import decoder as dec
from neighborhoodwatch_tpu_torch.models import e5, generators, registry
from neighborhoodwatch_tpu_torch.models.tokenizer import (
    HashTokenizer, token_buckets,
)
from neighborhoodwatch_tpu_torch.ops import attention_kernel as ak
from neighborhoodwatch_tpu_torch.ops import encoder_fused as ef
from neighborhoodwatch_tpu_torch.utils import profiling

REF_CFG = dict(hidden_size=256, num_hidden_layers=4, num_attention_heads=8,
               num_key_value_heads=2, intermediate_size=512,
               vocab_size=4000, rms_norm_eps=1e-5, rope_theta=10000.0)
TINY = dec.DecoderConfig(vocab_size=4000, hidden_size=256, num_layers=4,
                         num_heads=8, num_kv_heads=2, intermediate_size=512)
TEXTS = [" ".join(f"w{(7 * j + n) % 211}" for j in range(n))
         for n in (3, 60, 17, 130, 1, 45, 90)]


@pytest.fixture()
def tiny(monkeypatch):
    """e5-mistral's name on the tiny decoder; its seeded reference state."""
    monkeypatch.setitem(dec.DECODER_CONFIGS, dec.E5_MISTRAL, TINY)
    return make_state(REF_CFG, torch.Generator().manual_seed(11), "cpu")


def _generator(state, **kw):
    return e5.E5EmbeddingGenerator(dec.E5_MISTRAL, state=state,
                                   device="cpu", **kw)


def _ids(gen, texts):
    ids, mask = gen.tokenizer(texts, max_length=gen.max_length)
    return [list(r[m.astype(bool)]) for r, m in zip(ids, mask)]


def test_port_forward_matches_the_reference(tiny):
    """Ragged texts in one chunk (buckets of 64 and 256 over two calls):
    each embedding within 0.02 of the float32 reference in L2 (the port
    rounds every activation to bf16, whose 8 bits give ~0.006 here), and
    nearer the reference than a quarter of the fp8 control's gap (~0.09:
    e4m3 keeps 4 bits, so the control is 16x coarser)."""
    gen = _generator(tiny)
    got = np.stack(gen.generate_embedding(TEXTS))
    short = np.stack(gen.generate_embedding(TEXTS[:3]))
    want = embed_many(tiny, REF_CFG, _ids(gen, TEXTS))
    ctl = embed_many(tiny, REF_CFG, _ids(gen, TEXTS), fp8=True)
    gap = (torch.from_numpy(got) - want).norm(dim=1)
    ctl_gap = (ctl - want).norm(dim=1)
    assert float(gap.max()) < 0.02, gap
    assert float(gap.max()) < float(ctl_gap.min()) / 4, (gap, ctl_gap)
    assert float((torch.from_numpy(short) - want[:3]).norm(dim=1).max()) \
        < 0.02
    assert np.allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)
    assert gen.config is TINY and not gen.model.training
    assert sorted(gen.runner.graphs) == []          # the CPU runs op by op


def test_last_token_pooling_alone_and_in_a_ragged_chunk(tiny):
    """A text alone (bucket 64, 64 rows of which 63 are padding) and the
    same text among longer ones (bucket 256): causality keeps its real
    tokens off every later slot, so only the GEMMs' shapes differ; within
    2e-3 (a bf16 rounding or two in a unit vector)."""
    gen = _generator(tiny)
    alone = gen.generate_embedding([TEXTS[2]])[0]
    among = gen.generate_embedding(TEXTS)[2]
    assert np.abs(alone - among).max() < 2e-3
    ids, mask = gen.tokenizer(TEXTS, max_length=gen.max_length)
    assert ids.shape[1] == 256 and ids[2, mask[2].sum() - 1] == 2
    assert ids[2, 0] == 1 and (ids[2, mask[2].sum():] == 0).all()


def test_pooling_reads_the_last_real_row():
    hidden = torch.arange(2 * 5 * 3, dtype=torch.float32).view(2, 5, 3)
    mask = torch.tensor([[1, 1, 0, 0, 0], [0, 0, 0, 0, 0]])
    out = dec.last_token_normalize(hidden, mask)
    want = hidden[0, 1] / hidden[0, 1].norm()
    assert torch.allclose(out[0], want)
    assert torch.allclose(out[1], hidden[1, 0] / hidden[1, 0].norm())
    zero = dec.last_token_normalize(torch.zeros(1, 4, 3), mask[:1, :4])
    assert torch.equal(zero, torch.zeros(1, 3))


@pytest.mark.parametrize("heads,kv", [(8, 2), (4, 4), (6, 1)])
@pytest.mark.parametrize("T", [1, 7, 64])
def test_causal_gqa_plain_matches_written_out(heads, kv, T):
    """K6's plain version (the function the kernel is held to on the card)
    against attention written out in float64 with explicit loops over the
    query heads: within 1e-5 (fp32 sums in another order)."""
    g = torch.Generator().manual_seed(T + heads)
    q = torch.randn(2, T, heads, 16, generator=g)
    k = torch.randn(2, T, kv, 16, generator=g)
    v = torch.randn(2, T, kv, 16, generator=g)
    got = ak.masked_attention_plain(q, k, v, None, 0.25, causal=True)
    want = torch.empty(2, T, heads, 16, dtype=torch.float64)
    for h in range(heads):
        kh = h // (heads // kv)
        s = torch.einsum("bid,bjd->bij", q[:, :, h].double(),
                         k[:, :, kh].double()) * 0.25
        s = s.masked_fill(torch.ones(T, T, dtype=torch.bool).triu(1),
                          float("-inf"))
        want[:, :, h] = torch.softmax(s, -1) @ v[:, :, kh].double()
    assert torch.allclose(got.double(), want, atol=1e-5)
    # the CPU wrapper is the plain version
    assert torch.equal(ak.masked_attention(q, k, v, None, 0.25, causal=True),
                       got)


def test_causal_with_segments_masks_both():
    """Segment ids and causality together: a key is seen where both allow
    it; without causal, grouped-query heads alone."""
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(1, 6, h, 8, generator=g) for h in (4, 2, 2))
    seg = torch.tensor([[1, 1, 1, 0, 0, 0]])
    both = ak.masked_attention_plain(q, k, v, seg, 0.3, causal=True)
    for i in range(6):
        seen = [j for j in range(i + 1) if seg[0, j] == seg[0, i]]
        only = ak.masked_attention_plain(q[:, i:i + 1], k[:, seen],
                                         v[:, seen], None, 0.3)
        assert torch.allclose(both[:, i], only[:, 0], atol=1e-6)
    free = ak.masked_attention_plain(q, k, v, None, 0.3)
    rep = ak.masked_attention_plain(q, k.repeat_interleave(2, 2),
                                    v.repeat_interleave(2, 2), None, 0.3)
    assert torch.equal(free, rep)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.bfloat16, 2 ** -7)])
@pytest.mark.parametrize("first", [False, True])
def test_add_rmsnorm_plain(dtype, tol, first):
    """Against float64: the residual bit for bit the dtype's add, the norm
    within 1e-6 in fp32 and one bf16 rounding (2^-8 relative, 2^-7 abs at
    |out| < 2) in bf16."""
    g = torch.Generator().manual_seed(int(first))
    h = torch.randn(3, 5, 40, generator=g).to(dtype)
    x = None if first else torch.randn(3, 5, 40, generator=g).to(dtype)
    w = 1 + 0.1 * torch.randn(40, generator=g)
    s, out = ef.add_rmsnorm(h, x, w, 1e-5)
    assert torch.equal(s, h if first else h + x)
    f = s.double()
    want = f / torch.sqrt(f.pow(2).mean(-1, keepdim=True) + 1e-5) * w.double()
    assert out.dtype == dtype
    assert torch.allclose(out.double(), want, atol=tol, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rope_plain_is_a_rotation(dtype):
    """Each (x[i], x[i + d]) pair turned by position x theta^(-2i / D), as
    a complex product in float64; q and k heads only, v untouched; within
    one rounding of the dtype."""
    g = torch.Generator().manual_seed(5)
    b, t, heads, kv, D = 2, 9, 3, 1, 16
    x = torch.randn(b, t, (heads + 2 * kv) * D, generator=g).to(dtype)
    cos, sin = ef.rope_table(32, D, 10000.0)
    got = ef.rope(x.clone(), heads + kv, D, cos, sin)
    d = D // 2
    part = x[..., :(heads + kv) * D].double().view(b, t, heads + kv, 2, d)
    z = torch.complex(part[..., 0, :], part[..., 1, :])
    ang = torch.arange(t, dtype=torch.float64)[:, None] \
        * 10000.0 ** (-torch.arange(d, dtype=torch.float64) * 2 / D)
    z = z * torch.polar(torch.ones_like(ang), ang)[None, :, None]
    want = torch.stack((z.real, z.imag), 3).view(b, t, -1)
    tol = 1e-5 if dtype == torch.float32 else 2 ** -6
    assert torch.allclose(got[..., :(heads + kv) * D].double(), want,
                          atol=tol, rtol=0)
    assert torch.equal(got[..., (heads + kv) * D:],
                       x[..., (heads + kv) * D:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swiglu_plain(dtype):
    """silu(g) * u against float64, within one rounding of the dtype."""
    g = torch.Generator().manual_seed(6)
    gu = (3 * torch.randn(4, 2 * 24, generator=g)).to(dtype)
    got = ef.swiglu(gu)
    a, b = gu.double().chunk(2, -1)
    want = a / (1 + torch.exp(-a)) * b
    tol = 1e-5 if dtype == torch.float32 else 2 ** -8
    assert got.shape == (4, 24) and got.dtype == dtype
    assert torch.allclose(got.double(), want, rtol=tol, atol=1e-6)


def test_prefix_rules():
    """The e5-v2 models keep "query:" on every text; e5-mistral takes its
    card's instruction on queries and nothing on documents; the API models
    nothing."""
    for name in generators.E5_V2_MODELS:
        for kind in (None, "query", "document"):
            assert generators.text_prefix(name, kind) == "query:"
    m = dec.E5_MISTRAL
    assert generators.text_prefix(m, "query") == (
        "Instruct: Given a web search query, retrieve relevant passages "
        "that answer the query\nQuery: ")
    assert generators.text_prefix(m, "document") == ""
    assert generators.text_prefix(m) == ""
    assert generators.text_prefix("text-embedding-ada-002", "query") == ""


def test_instruction_reaches_queries_only(tiny):
    query = _generator(tiny, dataset_type="query")
    doc = _generator(tiny, dataset_type="document")
    (q,), = list(query._iter_chunks(["what is rope"]))
    (d,), = list(doc._iter_chunks(["what is rope"]))
    assert q == generators.MISTRAL_QUERY_PREFIX + "what is rope"
    assert d == "what is rope"
    assert not np.allclose(query.generate_embedding(["what is rope"])[0],
                           doc.generate_embedding(["what is rope"])[0])


def test_registry_sixteenth_name(tiny, monkeypatch):
    names = registry.get_valid_model_name_list()
    assert len(names) == 16 and names[-1] == dec.E5_MISTRAL
    assert registry.get_default_model_dimension_size(dec.E5_MISTRAL) == 4096
    assert registry.get_effective_embedding_size(dec.E5_MISTRAL, 256) == 4096
    monkeypatch.setattr(dec, "load_hf_weights", lambda name, cfg: None)
    gen = registry.get_embedding_generator_for_model(
        dec.E5_MISTRAL, dataset_type="query", device="cpu")
    assert isinstance(gen, e5.E5EmbeddingGenerator)
    assert gen.dataset_type == "query" and not gen.pretrained
    assert gen.max_length == 4096 and gen.dimensions == 4096
    assert gen.runner.max_graphs == len(token_buckets(4096, 64)) == 7
    assert "RANDOM INIT" in registry.local_weight_status(dec.E5_MISTRAL)


def test_decoder_tokenizer_and_limits(tiny):
    tok = HashTokenizer(vocab_size=32000, bos_id=1, eos_id=2, min_bucket=64)
    ids, mask = tok(["a b c", " ".join(["w"] * 5000)], max_length=4096)
    assert ids.shape == (2, 4096) and mask[1].sum() == 4096
    assert list(ids[0, :5]) == [1, ids[0, 1], ids[0, 2], ids[0, 3], 2]
    assert ids[1, -1] == 2 and ids[1, 0] == 1
    assert ((ids[:, 1:-1] >= 999) | (ids[:, 1:-1] <= 2)).all()
    ids, _ = tok(["x"], max_length=4096)
    assert ids.shape == (1, 64)
    with pytest.raises(ValueError, match="max_length"):
        _generator(tiny, max_length=100)
    assert _generator(tiny, max_length=128).max_length == 128


def test_state_must_match_the_modules(tiny):
    bad = dict(tiny)
    del bad["norm"]
    with pytest.raises(KeyError, match="norm"):
        dec.build_decoder(TINY, bad, 0, torch.device("cpu"))


def test_hf_checkpoint_layout_converts():
    """A MistralModel state_dict's names and split projections map onto
    the port's fused q|k|v and gate|up, rows in the published order."""
    model, _ = dec.build_decoder(TINY, None, 4, torch.device("cpu"), 64)
    sd = {"embed_tokens.weight": model.embed.weight,
          "norm.weight": model.norm.detach().to(torch.bfloat16)}
    q, kv = 256, 2 * 32
    for i, layer in enumerate(model.layers):
        p, a, m = f"layers.{i}.", f"layers.{i}.self_attn.", \
            f"layers.{i}.mlp."
        w = layer.qkv.weight
        sd.update({a + "q_proj.weight": w[:q], a + "k_proj.weight":
                   w[q:q + kv], a + "v_proj.weight": w[q + kv:],
                   a + "o_proj.weight": layer.o.weight,
                   m + "gate_proj.weight": layer.gate_up.weight[:512],
                   m + "up_proj.weight": layer.gate_up.weight[512:],
                   m + "down_proj.weight": layer.down.weight,
                   p + "input_layernorm.weight": layer.input_norm,
                   p + "post_attention_layernorm.weight": layer.post_norm})
    out = dec.convert_hf_state_dict(sd, TINY)
    mine = model.state_dict()
    assert set(out) == set(mine)
    for k, v in out.items():
        assert torch.equal(v.to(mine[k].dtype), mine[k]), k


def test_seeded_init_is_the_seeds():
    a, pre = dec.build_decoder(TINY, None, 4, torch.device("cpu"), 64)
    b, _ = dec.build_decoder(TINY, None, 4, torch.device("cpu"), 64)
    assert not pre
    for (n, x), (_, y) in zip(a.state_dict().items(),
                              b.state_dict().items()):
        assert torch.equal(x, y), n
        if n.endswith("norm"):
            assert torch.equal(x, torch.ones_like(x))
    assert 0.015 < float(a.layers[0].qkv.weight.float().std()) < 0.025


def test_forward_counts_itself_while_recording(tiny):
    gen = _generator(tiny)
    with torch.profiler.profile():
        gen.generate_embedding(TEXTS[:2])
        recs = profiling.records()["counters"]
    assert recs["decoder.forwards"] == 1
    # the CPU runs the plain versions: no kernel launched, none counted
    assert "attn.causal_launches" not in recs
    assert recs["graph.tokens"] == sum(len(i) for i in _ids(
        gen, TEXTS[:2])) and recs["graph.token_slots"] == 64 * 64


def test_a_capture_collects_its_counts():
    """Inside collected_counts() a count goes to the collection, recording
    or not; outside, only while recording."""
    with profiling.collected_counts() as got:
        profiling.count("decoder.rope", 2)
        profiling.count("decoder.rope", 1)
    assert got == {"decoder.rope": 3}
    with torch.profiler.profile():
        profiling.count("x", 1)
        with profiling.collected_counts() as inner:
            profiling.count("x", 5)
        assert profiling.records()["counters"]["x"] == 1
    assert inner == {"x": 5}


class _FakeLibrary:
    def __init__(self):
        self.calls = []

    def launcher(self, name, entry="launch"):
        def launch(*args):
            self.calls.append((name, entry, args))
            return 0
        return launch


@pytest.fixture()
def card(monkeypatch):
    """Meta tensors take the kernels' path, on a fake library."""
    lib = _FakeLibrary()
    monkeypatch.setattr(ef, "_ON_CARD", ("cuda", "meta"))
    monkeypatch.setattr(ef, "_launcher", lib.launcher)
    monkeypatch.setattr(ef, "_stream", lambda dev: 7)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    ef.reset_launches()
    return lib


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_card_tensors_launch_and_count(card, dtype):
    """Each pass launches its entry once with the shapes and dtype code the
    C interface takes, counted per wrapper and in the profiler counters
    (here through a capture's collection)."""
    code = {torch.bfloat16: 0, torch.float32: 1, torch.float16: 2}[dtype]
    h = torch.empty(2, 8, 64, dtype=dtype, device="meta")
    w = torch.empty(64, device="meta")
    qkv = torch.empty(2, 8, (4 + 2 * 2) * 16, dtype=dtype, device="meta")
    cos = torch.empty(32, 8, device="meta")
    gu = torch.empty(2, 8, 2 * 48, dtype=dtype, device="meta")
    with profiling.collected_counts() as counts:
        s, out = ef.add_rmsnorm(h, h, w, 1e-5)
        s1, out1 = ef.add_rmsnorm(h, None, w, 1e-5)
        assert ef.rope(qkv, 6, 16, cos, cos) is qkv
        act = ef.swiglu(gu)
    assert [c[:2] for c in card.calls] == [
        ("decoder_passes", "add_rmsnorm"), ("decoder_passes", "add_rmsnorm"),
        ("decoder_passes", "rope"), ("decoder_passes", "swiglu")]
    for (_, entry, args) in card.calls:
        assert len(args) == len(ef._ARGTYPES["decoder_passes"][entry])
        assert args[-1] == 7                     # the current stream
    a = card.calls[0][2]
    assert a[5:9] == (16, 64, code, 1e-5)
    assert card.calls[1][2][1] is None and card.calls[1][2][3] is None
    assert s1 is h and out.shape == h.shape and s.shape == h.shape
    assert card.calls[2][2][1:6] == (16, 8, 128, 6, 16)
    assert card.calls[2][2][8] == code
    assert card.calls[3][2][2:5] == (16, 48, code)
    assert act.shape == (2, 8, 48) and act.dtype == dtype
    assert counts == {"decoder.rmsnorm": 2, "decoder.rope": 1,
                      "decoder.swiglu": 1}
    assert ef.add_rmsnorm.launches == 2 and ef.rope.launches == 1
    assert ef.swiglu.launches == 1
    # one kernel each: forced "staged" launches it too, forced "plain"
    # runs the plain version and launches nothing
    with ef.forced_variant("staged"):
        ef.swiglu(gu)
    with ef.forced_variant("plain"):
        assert ef.swiglu(gu).shape == act.shape
    assert ef.swiglu.launches == 2 and len(card.calls) == 5


def test_card_tensors_refuse_what_the_kernels_do_not_take(card):
    h = torch.empty(2, 8, 64, dtype=torch.float64, device="meta")
    with pytest.raises(TypeError):
        ef.add_rmsnorm(h, None, torch.empty(64, device="meta"), 1e-5)
    x = torch.empty(2, 8, 64, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError):
        ef.add_rmsnorm(x, x[:, :4], torch.empty(64, device="meta"), 1e-5)
    with pytest.raises(ValueError):
        ef.rope(x, 5, 16, torch.empty(8, 8, device="meta"),
                torch.empty(8, 8, device="meta"))
    with pytest.raises(ValueError):
        ef.rope(x, 2, 16, torch.empty(4, 8, device="meta"),
                torch.empty(4, 8, device="meta"))
    with pytest.raises(ValueError):
        ef.swiglu(torch.empty(3, 5, dtype=torch.bfloat16, device="meta"))
    assert card.calls == []


def test_causal_tiles_count():
    assert ak.causal_tiles(64, 512, 32, "wgmma") == 64 * 32 * 10
    assert ak.causal_tiles(2, 192, 8, "mma") == 2 * 8 * 6
    assert ak.causal_tiles(1, 128, 1, "wgmma") == 1
