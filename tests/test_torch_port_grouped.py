"""Length-grouped forwards of the e5-v2 encoders (models/e5.py:
`E5EmbeddingGenerator._grouped`) on the CPU, op by op and on the stand-in
CUDA graphs of tests/test_torch_port_graphed.py: a call's rows come back
in the caller's order, each within 1e-5 of the text's forward alone
(fp32, the tolerance of tests/test_torch_port_graphed.py); a call issues
ceil(n / 64) forwards with no more token slots than sorting the call by
length and cutting 64-row chunks; calls of at most 64 texts or of one
bucket issue exactly the in-order chunks; a failed tokenize zeroes its
64-text unit, a failed forward its own rows, a GraphError raises; the
counters `e5.forwards` and `e5.promoted_rows`; the decoder embedder keeps
its in-order chunks."""

import dataclasses

import numpy as np
import pytest
import torch

from neighborhoodwatch_tpu_torch.models import bert as tbert
from neighborhoodwatch_tpu_torch.models import decoder as dec
from neighborhoodwatch_tpu_torch.models import e5 as te5
from neighborhoodwatch_tpu_torch.models import graphed
from neighborhoodwatch_tpu_torch.models.tokenizer import token_buckets
from neighborhoodwatch_tpu_torch.utils import profiling

from tests.test_torch_port_decoder import TINY, tiny  # noqa: F401 (fixture)
from tests.test_torch_port_graphed import (  # noqa: F401 (stand_in)
    StandInGraph, stand_in,
)

E5_SMALL = "intfloat/e5-small-v2"
CHUNK = 64


class Forwards(list):
    """A generator's runner that records each forward it is handed, as
    (ids, mask, rows) host arrays, and raises a planted RuntimeError at
    the forwards numbered in `fail`."""

    def __init__(self, runner, fail=()):
        super().__init__()
        self.runner, self.fail = runner, set(fail)

    def __call__(self, ids, mask, rows=None):
        self.append((ids.copy(), mask.copy(), rows))
        if len(self) - 1 in self.fail:
            raise RuntimeError("planted forward failure")
        return self.runner(ids, mask, rows)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the forwards here are small, and a pool per
    test process oversubscribes the cores when files run in parallel."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture()
def small(monkeypatch):
    """e5-small-v2's width cut to one layer in fp32; a seeded state."""
    monkeypatch.setitem(tbert.E5_CONFIGS, E5_SMALL, dataclasses.replace(
        tbert.E5_CONFIGS[E5_SMALL], num_layers=1, dtype="float32"))
    return te5.E5EmbeddingGenerator(E5_SMALL, max_length=64, seed=5,
                                    device="cpu").model.state_dict()


def _generator(state, stand_in_on=None, max_length=64, fail=()):
    gen = te5.E5EmbeddingGenerator(E5_SMALL, max_length=max_length,
                                   state=state, device="cpu")
    gen.alone = gen.runner.fn
    if stand_in_on is not None:
        stand_in_on(gen.runner)
    gen.forwards = gen.runner = Forwards(gen.runner, fail)
    return gen


def _texts(n, seed=0, median=12.0, sigma=0.9, most=60):
    """`n` distinct texts of log-normal word counts in 1 .. `most` (a word
    is a token; with "query:", [CLS] and [SEP] a text is 4 more)."""
    rng = np.random.default_rng(seed)
    words = np.clip(np.rint(rng.lognormal(np.log(median), sigma, n)), 1,
                    most).astype(int)
    return [f"t{i} " + " ".join(f"w{int(x)}" for x in
                                rng.integers(0, 900, size=w - 1))
            for i, w in enumerate(words)]


def _alone(gen, texts):
    """Each text's forward at its own bucket, unpadded: the texts of one
    bucket in one batch, whose rows do not mix."""
    own = _bucket(gen, _tokens(gen, texts))
    out = np.empty((len(texts), 384), np.float32)
    for b in np.unique(own):
        rows = np.flatnonzero(own == b)
        ids, mask = gen.tokenizer(["query:" + texts[r] for r in rows],
                                  max_length=gen.max_length)
        assert ids.shape[1] == b
        with torch.no_grad():
            out[rows] = gen.alone(torch.from_numpy(ids).long(),
                                  torch.from_numpy(mask)).numpy()
    return out


def _tokens(gen, texts):
    return np.array([int(gen.tokenizer(["query:" + t],
                                       max_length=gen.max_length)[1].sum())
                     for t in texts])


def _bucket(gen, tokens):
    return gen.buckets[np.searchsorted(gen.buckets, tokens)]


def _chunked_slots(buckets):
    """Token slots of 64-row forwards over `buckets` taken in that order,
    each at its largest bucket."""
    return sum(CHUNK * int(buckets[i:i + CHUNK].max())
               for i in range(0, len(buckets), CHUNK))


def _variant(request, name):
    return request.getfixturevalue("stand_in") if name == "graph" else None


@pytest.mark.parametrize("variant", ["eager", "graph"])
@pytest.mark.parametrize("n", [1, 64, 65, 130, 1000])
def test_rows_come_back_in_the_callers_order(small, request, variant, n):
    """Mixed lengths over buckets 16, 32 and 64: each row within 1e-5 of
    its text's forward at its own bucket, which a one-text call also
    matches; every forward 64 rows, ceil(n / 64) of them."""
    gen = _generator(small, _variant(request, variant))
    texts = _texts(n, seed=n)
    by0 = dict(graphed.GraphRunner.launches_by_variant)
    got = np.asarray(gen.generate_embedding(texts))
    want = _alone(gen, texts)
    assert got.shape == (n, 384) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert len(gen.forwards) == -(-n // CHUNK)
    assert all(ids.shape[0] == CHUNK for ids, _, _ in gen.forwards)
    by = graphed.GraphRunner.launches_by_variant
    kind = "graph" if variant == "graph" else "eager"
    assert by[kind] - by0[kind] == len(gen.forwards)
    one = np.asarray(gen.generate_embedding(texts[-1]))
    np.testing.assert_allclose(one[0], want[-1], atol=1e-5, rtol=0)


@pytest.mark.parametrize("n,median,sigma,max_length", [
    (1, 20, 0.5, 512), (64, 20, 0.5, 512), (65, 30, 0.8, 512),
    (130, 12, 1.0, 512), (1000, 20, 0.5, 512), (1024, 180, 0.4, 512),
    (3000, 12, 0.9, 64)])
def test_forwards_slots_and_counters(small, n, median, sigma, max_length):
    """A call issues ceil(n / 64) forwards; its token slots are no more
    than sorting the call by length and cutting 64-row chunks gives, and
    as few as any packing into that many forwards (the sort cut from the
    longest down); no row runs below its bucket; under a profiler
    `e5.forwards` counts the forwards and `e5.promoted_rows` the rows
    above their own bucket. The forward is replaced by zeros."""
    gen = _generator(small, max_length=max_length)
    gen.forwards.runner.fn = lambda ids, mask: torch.zeros(ids.shape[0], 384)
    texts = _texts(n, seed=n, median=median, sigma=sigma,
                   most=max_length - 4)
    own = _bucket(gen, _tokens(gen, texts))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        gen.generate_embedding(texts)
    counters = profiling.records()["counters"]
    slots = sum(ids.size for ids, _, _ in gen.forwards)
    assert len(gen.forwards) == -(-n // CHUNK)
    assert slots <= _chunked_slots(np.sort(own))
    assert slots == _chunked_slots(np.sort(own)[::-1])
    promoted = 0
    for ids, mask, rows in gen.forwards:
        lengths = mask[:rows].sum(1)
        assert (lengths > 0).all() and not mask[rows:].any()
        assert (_bucket(gen, lengths) <= ids.shape[1]).all()
        promoted += int((_bucket(gen, lengths) < ids.shape[1]).sum())
    assert counters["e5.forwards"] == len(gen.forwards)
    assert counters["e5.promoted_rows"] == promoted
    assert counters["graph.token_slots"] == slots
    assert counters["graph.tokens"] == sum(
        int(m.sum()) for _, m, _ in gen.forwards)


def _one_bucket(n, words):
    return [f"t{i} " + " ".join(f"w{i * 7 + j}" for j in range(words - 1))
            for i in range(n)]


@pytest.mark.parametrize("variant", ["eager", "graph"])
@pytest.mark.parametrize("case", ["one", "ragged", "full", "bucket 16",
                                  "bucket 32"])
def test_where_nothing_changes(small, request, variant, case):
    """A call of at most 64 texts, or of one bucket, issues the in-order
    chunks' forwards (the same rows, order and bucket) and returns their
    embeddings bit for bit."""
    texts = {"one": _texts(1, seed=3), "ragged": _texts(37, seed=4),
             "full": _texts(64, seed=5), "bucket 16": _one_bucket(200, 9),
             "bucket 32": _one_bucket(64 * 3, 20)}[case]
    grouped = _generator(small, _variant(request, variant))
    in_order = _generator(small, _variant(request, variant))
    got = np.asarray(grouped.generate_embedding(texts))
    want = np.asarray(in_order._in_order(texts))
    np.testing.assert_array_equal(got, want)
    assert len(grouped.forwards) == len(in_order.forwards) > 0
    for (gi, gm, gr), (wi, wm, wr) in zip(grouped.forwards,
                                          in_order.forwards):
        assert gr == wr and gi.shape == wi.shape
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gm, wm)


@pytest.mark.parametrize("variant", ["eager", "graph"])
def test_a_failed_tokenize_zeroes_its_unit_only(small, request, variant):
    """The second 64-text unit's tokenizing fails: its rows are zeros and
    never queued; every other row as in a call without the failure."""
    gen = _generator(small, _variant(request, variant))
    texts = _texts(200, seed=7)
    want = np.asarray(gen.generate_embedding(texts))
    tok = gen.tokenizer

    def poisoned(unit, **kw):
        if any("POISON" in t for t in unit):
            raise ValueError("planted tokenize failure")
        return tok(unit, **kw)
    gen.tokenizer = poisoned
    texts[70] = "POISON"
    del gen.forwards[:]
    got = np.asarray(gen.generate_embedding(texts))
    zero = ~got.any(axis=1)
    np.testing.assert_array_equal(np.nonzero(zero)[0], np.arange(64, 128))
    keep = ~zero
    np.testing.assert_allclose(got[keep], want[keep], atol=1e-5, rtol=0)
    assert len(gen.forwards) == -(-136 // CHUNK)
    assert sum(r for _, _, r in gen.forwards) == 136


@pytest.mark.parametrize("variant", ["eager", "graph"])
@pytest.mark.parametrize("which", ["first", "last"])
def test_a_failed_forward_zeroes_its_rows_only(small, request, variant,
                                               which):
    """A forward that raises an ordinary exception (the first, a full
    group; the last, the flush's) gives zero vectors for exactly the rows
    it held; the others as in a call without the failure."""
    texts = _texts(200, seed=8)
    want = np.asarray(_generator(small).generate_embedding(texts))
    fail = 0 if which == "first" else -(-len(texts) // CHUNK) - 1
    gen = _generator(small, _variant(request, variant), fail=[fail])
    got = np.asarray(gen.generate_embedding(texts))
    ids, mask, rows = gen.forwards[fail]
    index = {}
    for i, t in enumerate(texts):
        a, m = gen.tokenizer(["query:" + t], max_length=gen.max_length)
        index[tuple(a[0, :m.sum()])] = i
    held = sorted(index[tuple(ids[r, :mask[r].sum()])] for r in range(rows))
    zero = ~got.any(axis=1)
    np.testing.assert_array_equal(np.nonzero(zero)[0], held)
    np.testing.assert_allclose(got[~zero], want[~zero], atol=1e-5, rtol=0)


@pytest.mark.parametrize("where", ["capture", "replay"])
def test_a_graph_error_raises_and_nothing_runs_eager(small, stand_in, where):
    """A capture that fails at the flush's forward (bucket 64, first met
    there), or a replay that fails, raises GraphError out of
    generate_embedding: no row turns into zeros and nothing runs eager."""
    gen = _generator(small, stand_in)
    short = _one_bucket(100, 9)                    # bucket 16
    texts = short + [_one_bucket(1, 50)[0].replace("t0", "long")]
    gen.generate_embedding(short if where == "capture" else texts)
    assert len(gen.forwards.runner.graphs) == (1 if where == "capture"
                                               else 2)
    setattr(StandInGraph, f"fail_{where}", True)
    eager0 = graphed.GraphRunner.launches_by_variant["eager"]
    with pytest.raises(graphed.GraphError, match=where):
        gen.generate_embedding(texts)
    assert graphed.GraphRunner.launches_by_variant["eager"] == eager0


def test_the_decoder_keeps_its_in_order_chunks(tiny):  # noqa: F811
    """e5-mistral's generator (the tiny decoder) over 150 texts of mixed
    lengths: one forward a 64-text chunk in arrival order, each at the
    bucket of its longest text; no grouping counter."""
    gen = te5.E5EmbeddingGenerator(dec.E5_MISTRAL, state=tiny,
                                   device="cpu")
    gen.forwards = gen.runner = Forwards(gen.runner)
    texts = _texts(150, seed=9, median=30, most=200)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        out = gen.generate_embedding(texts)
    assert len(out) == 150 and gen.config is TINY
    assert len(gen.forwards) == 3
    for c, (ids, mask, rows) in enumerate(gen.forwards):
        chunk = texts[c * CHUNK:(c + 1) * CHUNK]
        want_ids, want_mask = gen.tokenizer(chunk, max_length=gen.max_length)
        assert rows == len(chunk) and ids.shape == (CHUNK, want_ids.shape[1])
        assert want_ids.shape[1] in token_buckets(gen.max_length, 64)
        np.testing.assert_array_equal(ids[:rows], want_ids)
        np.testing.assert_array_equal(mask[:rows], want_mask)
    counters = profiling.records()["counters"]
    assert "e5.forwards" not in counters
    assert "e5.promoted_rows" not in counters
