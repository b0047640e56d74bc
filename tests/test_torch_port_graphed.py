"""The encoders' compiled forward (models/graphed.py) on the CPU: the e5
generator with its tail padding and the ColBERT generator with its row
padding against the JAX package's generators on weights carried across,
padded against unpadded forwards, and the graph runner's bookkeeping
through a CPU stand-in for the CUDA graph.

The stand-in (StandInGraph) records, at capture, each forward of the
model as a closure that writes into the output the capture returned, and
replays the closures: every replay of a graph lands in one static buffer,
as on the card. It catches outputs that alias a later replay's, pad rows
that reach the output or the keep mask, graphs beyond the bound, a
capture error turned into zeros, and miscounted forwards and K6 launches.
Its replays compute exactly what the eager forward computes at the same
padded shape, so they are held to it bit for bit.

Tolerances: fp32 encoder outputs within 1e-5 abs (the tolerance of
tests/test_torch_port_nw.py and tests/test_torch_port_colbert.py: same
weights, sums in another order; a padded batch is summed in another
blocking than an unpadded one); token counts, passage splits and doc ids
identical."""

import contextlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import neighborhoodwatch_tpu.core.colbert_pipeline as jcp
from neighborhoodwatch_tpu.models import colbert_flax, e5_flax

import neighborhoodwatch_tpu_torch.core.colbert_pipeline as tcp
from neighborhoodwatch_tpu_torch.data import sources as tsources
from neighborhoodwatch_tpu_torch.models import bert as tbert
from neighborhoodwatch_tpu_torch.models import colbert as tcolbert
from neighborhoodwatch_tpu_torch.models import e5 as te5
from neighborhoodwatch_tpu_torch.models import graphed
from neighborhoodwatch_tpu_torch.models.tokenizer import token_buckets
from neighborhoodwatch_tpu_torch.ops import attention_kernel as tak

from tests.test_torch_port_colbert import SMALL, _flax_colbert
from tests.test_torch_port_nw import (  # noqa: F401 (e5_two_layers: a fixture)
    E5_SMALL, _texts, e5_two_layers,
)


def _generators(params, state, max_length=64):
    j = e5_flax.E5FlaxEmbeddingGenerator(
        E5_SMALL, max_length=max_length,
        params=jax.tree.map(jnp.asarray, params))
    t = te5.E5EmbeddingGenerator(E5_SMALL, max_length=max_length,
                                 state=state, device="cpu")
    return j, t


def _colbert_pair(seed=6):
    jcfg, _, params = _flax_colbert("float32", seed=seed)
    tcfg = tbert.BertConfig(dtype="float32", **SMALL)
    jgen = colbert_flax.ColbertFlaxEmbeddingGenerator(
        params=jax.tree.map(jnp.asarray, params), config=jcfg)
    tgen = tcolbert.ColbertEmbeddingGenerator(
        state=tcolbert.colbert_state_from_flax(params, tcfg), config=tcfg,
        device="cpu")
    return jgen, tgen


def _shapes(runner):
    """Record the (rows, bucket) shapes `runner.fn` is called with."""
    seen, fn = [], runner.fn

    def spy(ids, mask):
        seen.append(tuple(ids.shape))
        return fn(ids, mask)
    runner.fn = spy
    return seen


# ------------------------------------------------- against the reference

def test_e5_tail_padding_matches_jax(e5_two_layers):  # noqa: F811
    """64 + 37 sentences: the 37-row tail padded to 64 rows, as
    e5_flax.py pads it, its pad rows dropped; embeddings within 1e-5 of
    the JAX generator's, tokens counted alike, both chunks op by op on
    the CPU."""
    params, state = e5_two_layers
    jg, tg = _generators(params, state)
    shapes = _shapes(tg.runner)
    texts = _texts(101, seed=3)
    eager0 = graphed.GraphRunner.launches_by_variant["eager"]
    want = np.asarray(jg.generate_embedding(texts))
    got = np.asarray(tg.generate_embedding(texts))
    assert got.shape == want.shape == (101, 384)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert tg.tokens_seen == jg.tokens_seen > 0
    assert [r for r, _ in shapes] == [64, 64]
    assert graphed.GraphRunner.launches_by_variant["eager"] == eager0 + 2
    assert not tg.runner.graphs


@pytest.mark.parametrize("rows", [1, 5, 37, 63])
def test_padded_matches_unpadded(e5_two_layers, rows):  # noqa: F811
    """A ragged chunk padded to 64 rows against the same chunk's forward
    unpadded, within 1e-5 in fp32; the pad rows are not returned."""
    _, state = e5_two_layers
    gen = te5.E5EmbeddingGenerator(E5_SMALL, max_length=64, state=state,
                                   device="cpu")
    texts = _texts(rows, seed=rows)
    got = gen._encode(texts)
    ids, mask = gen.tokenizer(texts, max_length=64)
    with torch.no_grad():
        want = gen.runner.fn(torch.from_numpy(ids).long(),
                             torch.from_numpy(mask))
    assert got.shape == want.shape == (rows, 384)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def test_colbert_padded_matches_unpadded():
    """A 5-passage batch padded to 8 rows against its unpadded forward."""
    _, gen = _colbert_pair()
    texts = [f"Passage {i} about " + " ".join(f"w{j}" for j in range(i + 2))
             for i in range(5)]
    shapes = _shapes(gen._runner(64))
    emb, counts = gen.encode_passages(texts)
    assert shapes == [(8, 16)]
    ids, mask = gen.tokenizer(texts, max_length=gen.max_length)
    with torch.no_grad():
        full = gen.model(torch.from_numpy(ids).long(),
                         torch.from_numpy(mask)).numpy()
    want = np.concatenate([full[i][mask[i].astype(bool)] for i in range(5)])
    assert counts == [int(m.sum()) for m in mask]
    np.testing.assert_allclose(emb, want, atol=1e-5, rtol=0)


def _multi_sentence_rows(n, seed=0):
    """Rows of 1-70 sentences each: generate_embedding calls whose batches
    are full (64), ragged (5 -> 8, 6 -> 8) and single."""
    rng = np.random.default_rng(seed)
    rows = []
    for i, count in enumerate([1, 5, 70, 3, 64, 1, 9][:n]):
        sents = [f"Sentence {j} of row {i} about " + " ".join(
            f"w{int(x)}" for x in rng.integers(0, 900, size=1 + j % 11))
            + "." for j in range(count)]
        rows.append({"id": str(i), "text": " ".join(sents)})
    return tsources._ListDataset(rows, ["id", "text"])


@pytest.mark.parametrize("batch_size", [64, 3])
def test_colbert_row_padding_matches_jax(batch_size):
    """encode_passages with rows padded to a power of two (at most the
    batch size) against the JAX generator, which pads no rows: the same
    tokens (1e-5), counts and per-row doc split through the source loop."""
    jgen, tgen = _colbert_pair()
    rows = _multi_sentence_rows(7)
    texts = [s for r in rows for s in tsources.split_into_sentences(
        r["text"])]
    shapes = _shapes(tgen._runner(batch_size))
    je, jc = jgen.encode_passages(texts, batch_size=batch_size,
                                  max_in_flight=2)
    te, tc = tgen.encode_passages(texts, batch_size=batch_size,
                                  max_in_flight=2)
    assert tc == jc and te.shape == je.shape == (sum(jc), 128)
    np.testing.assert_allclose(te, je, atol=1e-5, rtol=0)
    assert {r for r, _ in shapes} <= set(graphed.row_counts(batch_size))
    assert len(shapes) == -(-len(texts) // batch_size)

    class Sink:
        def __init__(self):
            self.calls = []

        def stream_tokens_with_doc_ids(self, toks, ids):
            self.calls.append((toks, ids))

    sinks = {}
    total = 128 * 10_000
    for name, mod, gen in (("jax", jcp, jgen), ("torch", tcp, tgen)):
        sinks[name] = Sink()
        sinks[name].stats = mod.process_source_dataset(
            sinks[name], gen, rows, 128, total, "text", track_docs=True)
    assert sinks["torch"].stats == sinks["jax"].stats
    (tt_, ti_), = sinks["torch"].calls
    (jt_, ji_), = sinks["jax"].calls
    np.testing.assert_array_equal(ti_, ji_)
    np.testing.assert_allclose(tt_, jt_, atol=1e-5, rtol=0)


@pytest.mark.parametrize("n,want", [(1, 1), (2, 2), (3, 4), (5, 8), (8, 8),
                                    (33, 64), (64, 64)])
def test_padded_rows_power_of_two_bounded(n, want):
    assert graphed.padded_rows(n, 64) == want
    assert graphed.padded_rows(n, 3) == min(want, 3)


def test_graph_bounds():
    """e5: one graph a token bucket (6 at max_length 512); ColBERT: 7 row
    counts x 5 buckets (16/32/64/128/220) = 35 at batch size 64."""
    assert graphed.row_counts(64) == [1, 2, 4, 8, 16, 32, 64]
    assert graphed.row_counts(3) == [1, 2, 3]
    assert {graphed.padded_rows(n, 64) for n in range(1, 65)} == \
        set(graphed.row_counts(64))
    assert token_buckets(220) == [16, 32, 64, 128, 220]
    assert token_buckets(512) == [16, 32, 64, 128, 256, 512]
    cfg = tbert.BertConfig(dtype="float32", **SMALL)
    gen = tcolbert.ColbertEmbeddingGenerator(config=cfg, device="cpu")
    assert gen._runner(64).max_graphs == 35
    assert gen._runner(3).max_graphs == 15


# ------------------------------------------- the runner on a stand-in graph

class StandInGraph:
    """CPU stand-in for torch.cuda.CUDAGraph (see the module docstring)."""
    capturing = None
    fail_capture = fail_replay = False

    def __init__(self):
        self.ops = []

    def replay(self):
        if StandInGraph.fail_replay:
            raise RuntimeError("planted replay failure")
        for op in self.ops:
            op()


@contextlib.contextmanager
def _stand_in_capture(graph, pool=None):
    if StandInGraph.fail_capture:
        raise RuntimeError("planted capture failure")
    StandInGraph.capturing = graph
    try:
        yield
    finally:
        StandInGraph.capturing = None


class _Stream:
    def wait_stream(self, other):
        pass


def capturable(fn, k6_per_forward=0):
    """`fn` as a graph holds it: under a stand-in capture its output becomes
    the graph's static buffer, which each replay rewrites in place. Rows
    whose mask is all padding come out NaN, so a pad row that reaches an
    output shows. Each forward counts `k6_per_forward` K6 launches, as a
    flash forward's wrapper calls would."""
    def forward(ids, mask):
        out = fn(ids, mask).clone()
        out[mask.sum(1) == 0] = float("nan")
        return out

    def run(ids, mask):
        tak.masked_attention.launches += k6_per_forward
        tak.masked_attention.launches_by_variant["wgmma"] += k6_per_forward
        out = forward(ids, mask)
        graph = StandInGraph.capturing
        if graph is not None:
            graph.ops.append(lambda: out.copy_(forward(ids, mask)))
        return out
    return run


@pytest.fixture()
def stand_in(monkeypatch):
    """Route GraphRunner's graph path through StandInGraph on the CPU;
    returns a function that turns a runner's graphs on."""
    monkeypatch.setattr(StandInGraph, "fail_capture", False)
    monkeypatch.setattr(StandInGraph, "fail_replay", False)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", StandInGraph)
    monkeypatch.setattr(torch.cuda, "graph", _stand_in_capture)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.Tensor, "pin_memory", lambda self: self.clone())

    def on(runner, k6_per_forward=0):
        runner.graphed = True
        runner.fn = capturable(runner.fn, k6_per_forward)
        return runner
    return on


def _e5_pair(state):
    """Two e5 generators on one state: one on the stand-in graphs, one op
    by op."""
    return [te5.E5EmbeddingGenerator(E5_SMALL, max_length=64, state=state,
                                     device="cpu") for _ in range(2)]


def _eager_nan_rows(gen):
    gen.runner.fn = capturable(gen.runner.fn)
    return gen


@pytest.mark.parametrize("n", [128, 64 * 3 + 37])
def test_same_shape_chunks_do_not_alias(stand_in, e5_two_layers,  # noqa: F811
                                        n):
    """Chunks of one shape share one static buffer; each chunk's output is
    copied out before the next replay, so every row equals the eager
    forward's bit for bit, and no pad row (NaN in the stand-in) is
    returned."""
    graphed_gen, eager_gen = _e5_pair(e5_two_layers[1])
    stand_in(graphed_gen.runner)
    _eager_nan_rows(eager_gen)
    texts = _texts(n, seed=n)
    got = np.asarray(graphed_gen.generate_embedding(texts))
    want = np.asarray(eager_gen.generate_embedding(texts))
    assert got.shape == (n, 384) and np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)
    assert graphed_gen.runner.graphs and all(
        r == 64 for r, _ in graphed_gen.runner.graphs)


def test_pad_rows_never_reach_the_keep_mask(stand_in):
    """ColBERT on the stand-in graphs: batches of 1, 5 (padded to 8) and
    64 + 6 (padded to 8) passages give exactly the eager generator's
    tokens and counts; the pad rows' NaN never reaches the output."""
    cfg = tbert.BertConfig(dtype="float32", **SMALL)
    state = tcolbert.ColbertEmbeddingGenerator(
        config=cfg, device="cpu").model.state_dict()
    gens = [tcolbert.ColbertEmbeddingGenerator(config=cfg, state=state,
                                               device="cpu")
            for _ in range(2)]
    stand_in(gens[0]._runner(64))
    gens[1]._runner(64).fn = capturable(gens[1]._runner(64).fn)
    for n in (1, 5, 70):
        texts = [f"Passage {i} about " + " ".join(
            f"w{j}" for j in range(i % 13 + 1)) for i in range(n)]
        got, gc = gens[0].encode_passages(texts, max_in_flight=1)
        want, wc = gens[1].encode_passages(texts, max_in_flight=1)
        assert gc == wc and len(gc) == n and np.isfinite(got).all()
        np.testing.assert_array_equal(got, want)
    assert {r for r, _ in gens[0]._runner(64).graphs} == {1, 8, 64}


def test_graphs_beyond_the_bound_raise(stand_in):
    """A capture past max_graphs raises GraphError; the shapes already
    captured keep replaying."""
    runner = stand_in(graphed.GraphRunner(lambda ids, mask: ids * 2.0,
                                          "cpu", max_graphs=2))
    for T in (16, 32):
        ids = np.full((4, T), 3, np.int32)
        assert runner(ids, np.ones_like(ids)).shape == (4, T)
    with pytest.raises(graphed.GraphError, match="above the bound of 2"):
        runner(np.ones((4, 64), np.int32), np.ones((4, 64), np.int32))
    out = runner(np.full((4, 16), 5, np.int32), np.ones((4, 16), np.int32),
                 rows=3)
    assert out.shape == (3, 16) and bool((out == 10).all())


@pytest.mark.parametrize("where", ["capture", "replay"])
def test_graph_failures_raise_and_are_not_zero_filled(
        stand_in, e5_two_layers, where):  # noqa: F811
    """A failed capture or replay raises GraphError out of
    generate_embedding: no chunk becomes zeros and nothing runs eager;
    a failing tokenizer still zeroes its own chunk only."""
    gen = _e5_pair(e5_two_layers[1])[0]
    stand_in(gen.runner)
    texts = _texts(130)
    if where == "replay":
        gen.generate_embedding(texts[:10])          # captures the shape
    setattr(StandInGraph, f"fail_{where}", True)
    eager0 = graphed.GraphRunner.launches_by_variant["eager"]
    with pytest.raises(graphed.GraphError, match=where):
        gen.generate_embedding(texts)
    assert graphed.GraphRunner.launches_by_variant["eager"] == eager0
    setattr(StandInGraph, f"fail_{where}", False)
    tok = gen.tokenizer

    def poisoned(chunk, **kw):
        if any("POISON" in t for t in chunk):
            raise ValueError("planted tokenize failure")
        return tok(chunk, **kw)
    gen.tokenizer = poisoned
    texts[70] = "POISON"
    got = np.asarray(gen.generate_embedding(texts))
    zero = ~got.any(axis=1)
    np.testing.assert_array_equal(np.nonzero(zero)[0], np.arange(64, 128))


@pytest.mark.parametrize("k6", [0, 3])
def test_counts_by_variant_and_k6_per_replay(
        stand_in, e5_two_layers, k6):  # noqa: F811
    """GraphRunner counts forwards by variant and captures; a graph holds
    the K6 launches its capture recorded and adds them at each replay,
    while the warm-up forwards' launches stay counted."""
    gen = _e5_pair(e5_two_layers[1])[0]
    stand_in(gen.runner, k6_per_forward=k6)
    n0, by0 = graphed.GraphRunner.launches, \
        dict(graphed.GraphRunner.launches_by_variant)
    caps0, k0 = graphed.GraphRunner.captures, tak.masked_attention.launches
    w0 = tak.masked_attention.launches_by_variant["wgmma"]
    texts = _texts(64 * 4 + 10)
    gen.generate_embedding(texts)                   # 5 chunks, one bucket
    buckets = len(gen.runner.graphs)
    assert graphed.GraphRunner.captures == caps0 + buckets
    by = graphed.GraphRunner.launches_by_variant
    assert by["graph"] == by0["graph"] + 5 and by["eager"] == by0["eager"]
    assert graphed.GraphRunner.launches == n0 + 5
    want_k6 = k6 * (5 + graphed.WARMUP * buckets)
    assert tak.masked_attention.launches == k0 + want_k6
    assert tak.masked_attention.launches_by_variant["wgmma"] == w0 + want_k6
    for g in gen.runner.graphs.values():
        # K6, then E1-E3, whose CPU forwards run their plain versions
        assert g.held == [(k6, {"mma": 0, "wgmma": k6})] + \
            [(0, {"staged": 0, "rowpass": 0, "plain": 0})] * 3
    with graphed.forced_variant("eager"):
        gen.generate_embedding(texts[:64])
    assert by["eager"] == by0["eager"] + 1
    assert tak.masked_attention.launches == k0 + want_k6 + k6
    with pytest.raises(ValueError):
        with graphed.forced_variant("jit"):
            pass
