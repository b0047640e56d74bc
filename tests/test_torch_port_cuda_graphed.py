"""The encoders' captured CUDA graphs (models/graphed.py) on the card: the
e5 and ColBERT generators' graphed forwards against their eager forwards
at the same padded shapes, bit for bit, at chip_smoke.py phase 14's
shapes (published widths, depth cut to 2 layers), replays in an order
other than their captures', K6's launches counted per replay under
attention_impl="flash", and no stream synchronization before the
readback.

This file imports neither jax nor the JAX package, so it runs where the
card is and JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_port_cuda_graphed.py -q

Without a card its tests skip (a CUDA graph has no CPU mode); the CPU
tests (tests/test_torch_port_graphed.py) hold the generators against the
JAX package and the runner's bookkeeping against a stand-in graph."""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from neighborhoodwatch_tpu_torch.models import bert as tbert
from neighborhoodwatch_tpu_torch.models import colbert as tcolbert
from neighborhoodwatch_tpu_torch.models import graphed
from neighborhoodwatch_tpu_torch.models.e5 import E5EmbeddingGenerator

E5_LARGE = "intfloat/e5-large-v2"


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph has no CPU mode)")
    return torch.device("cuda")


def bucket_texts(n, T, seed):
    """n texts of hash tokens whose longest row is exactly T tokens (CLS and
    SEP included): the tokenizer's bucket T; the others T/2 + 1 .. T."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(T // 2 + 1, T + 1, size=n)
    lengths[0] = T
    return [" ".join(f"w{j}" for j in rng.integers(0, 5000, size=L - 2))
            for L in lengths]


@contextlib.contextmanager
def no_sync_before_readback():
    """torch.cuda.set_sync_debug_mode("error") around the region, lifted
    only inside Tensor.cpu (the generators' readback): any other call that
    synchronizes the stream raises."""
    real = torch.Tensor.cpu

    def cpu(self, *a, **kw):
        torch.cuda.set_sync_debug_mode(0)
        try:
            return real(self, *a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("error")
    torch.Tensor.cpu = cpu
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)
        torch.Tensor.cpu = real


def _e5(monkeypatch, impl="auto", layers=2):
    """e5-large-v2 at its published width, cut to `layers`, bf16, seeded
    random weights, with attention_impl `impl`."""
    monkeypatch.setitem(tbert.E5_CONFIGS, E5_LARGE, dataclasses.replace(
        tbert.E5_CONFIGS[E5_LARGE], num_layers=layers, attention_impl=impl))
    return E5EmbeddingGenerator(E5_LARGE, seed=7, device="cuda")


def _eager(gen, fn, *a):
    with graphed.forced_variant("eager"):
        return fn(*a)


@pytest.mark.cuda
@pytest.mark.parametrize("bucket,n", [(32, 64), (128, 64), (512, 64),
                                      (128, 37)])
def test_e5_graph_matches_eager_bit_for_bit(cuda, monkeypatch, bucket, n):
    """e5-large's width at (64, 32), (64, 128), (64, 512) and a 37-row
    tail padded to 64: the replay equals the eager forward at the padded
    shape bit for bit; padded against unpadded within 2e-2 (bf16
    activations: cuBLAS tiles a 37-row product otherwise, so bf16 rounds
    at other places; unit-norm 1024-d outputs)."""
    gen = _e5(monkeypatch)
    texts = bucket_texts(n, bucket, seed=bucket + n)
    got = gen._encode(texts)
    again = gen._encode(texts)
    want = _eager(gen, gen._encode, texts)
    assert got.shape == (n, 1024) and list(gen.runner.graphs) == \
        [(64, bucket)]
    assert torch.equal(got, want) and torch.equal(again, want)
    ids, mask = gen.tokenizer(texts, max_length=512)
    with torch.no_grad():
        ids_d = torch.from_numpy(ids).to(cuda, torch.long)
        mask_d = torch.from_numpy(mask).to(cuda)
        unpadded = gen.runner.fn(ids_d, mask_d)
    torch.testing.assert_close(got, unpadded, atol=2e-2, rtol=0)


@pytest.mark.cuda
def test_colbert_graph_matches_eager_bit_for_bit(cuda):
    """The ColBERT generator (bert-base width, 2 layers, bf16, seeded
    random weights) at (1, 32), a 5-row batch padded to 8 at bucket 64 and
    bucket 220: passages, tokens and counts equal to the eager forwards'
    bit for bit, one graph per (rows, bucket)."""
    cfg = dataclasses.replace(tcolbert.COLBERT_BASE_CONFIG, num_layers=2)
    gen = tcolbert.ColbertEmbeddingGenerator(config=cfg, device="cuda",
                                             seed=2)
    cases = [bucket_texts(1, 32, 1), bucket_texts(5, 64, 2),
             bucket_texts(3, 220, 3)]
    for texts in cases:
        got = gen.encode_passages(texts)
        want = _eager(gen, gen.encode_passages, texts)
        assert got[1] == want[1] and len(got[1]) == len(texts)
        assert np.array_equal(got[0], want[0])
    assert sorted(gen.runners[64].graphs) == [(1, 32), (4, 220), (8, 64)]


@pytest.mark.cuda
def test_replays_in_another_order_than_captured(cuda, monkeypatch):
    """Shapes captured in one order and replayed in others, two same-shape
    chunks in one call, and interleaved calls: every output equals the
    eager forward's bit for bit (no replay overwrites an output still
    held, no graph reads another's inputs)."""
    gen = _e5(monkeypatch)
    sets = {T: bucket_texts(64, T, seed=T) for T in (32, 128, 512)}
    want = {T: _eager(gen, gen._encode, t) for T, t in sets.items()}
    first = {T: gen._encode(sets[T]) for T in (32, 128, 512)}
    assert list(gen.runner.graphs) == [(64, 32), (64, 128), (64, 512)]
    for T in (512, 32, 128, 32, 512):
        assert torch.equal(gen._encode(sets[T]), want[T])
    for T in first:
        assert torch.equal(first[T], want[T])
    two = sets[32] + bucket_texts(64, 32, seed=99)
    both = np.asarray(gen.generate_embedding(two))
    eager = np.asarray(_eager(gen, gen.generate_embedding, two))
    assert np.array_equal(both, eager) and not np.array_equal(both[:64],
                                                              both[64:])


@pytest.mark.cuda
@pytest.mark.parametrize("bucket", [128, 256, 512])
def test_flash_launches_counted_per_replay(cuda, monkeypatch, bucket):
    """The e5-large flash config: a replay adds one "wgmma" K6 launch a
    layer to masked_attention's counts (the capture's own launches taken
    back out, the warm-up forwards' kept), and bucket 64, outside the
    gate, none; graph and eager forwards equal bit for bit."""
    from neighborhoodwatch_tpu_torch.ops import attention_kernel as ak
    gen = _e5(monkeypatch, impl="flash", layers=3)
    texts = bucket_texts(64, bucket, seed=bucket)
    before = dict(ak.masked_attention.launches_by_variant)
    got = gen._encode(texts)
    torch.cuda.synchronize()
    after = dict(ak.masked_attention.launches_by_variant)
    assert after["wgmma"] - before["wgmma"] == 3 * (graphed.WARMUP + 1)
    held = gen.runner.graphs[(64, bucket)].held
    assert held.launches[0] == (3, {"mma": 0, "wgmma": 3})
    for _ in range(2):
        n0 = ak.masked_attention.launches
        assert torch.equal(gen._encode(texts), got)
        assert ak.masked_attention.launches == n0 + 3
    n0 = ak.masked_attention.launches
    assert torch.equal(_eager(gen, gen._encode, texts), got)
    assert ak.masked_attention.launches == n0 + 3
    gen.max_length = 64
    n0 = ak.masked_attention.launches
    gen._encode(bucket_texts(64, 128, seed=5))
    assert ak.masked_attention.launches == n0


@pytest.mark.cuda
def test_launch_loops_do_not_synchronize(cuda, monkeypatch):
    """Once each shape is captured, generate_embedding and
    encode_passages launch every chunk with no stream synchronization
    before the readback (set_sync_debug_mode("error") raises on one); the
    eager variant's blocking copies do raise there."""
    gen = _e5(monkeypatch)
    texts = bucket_texts(64 * 3 + 37, 32, seed=4)
    want = np.asarray(gen.generate_embedding(texts))
    with no_sync_before_readback():
        got = np.asarray(gen.generate_embedding(texts))
    assert np.array_equal(got, want)
    with no_sync_before_readback(), graphed.forced_variant("eager"):
        with pytest.raises(RuntimeError, match="synchroniz"):
            gen._encode(texts[:64])
    cfg = dataclasses.replace(tcolbert.COLBERT_BASE_CONFIG, num_layers=2)
    col = tcolbert.ColbertEmbeddingGenerator(config=cfg, device="cuda")
    passages = bucket_texts(70, 32, seed=6)
    want = col.encode_passages(passages)
    with no_sync_before_readback():
        got = col.encode_passages(passages)
    assert got[1] == want[1] and np.array_equal(got[0], want[0])


@pytest.mark.cuda
def test_capture_failure_raises_and_is_not_zero_filled(cuda, monkeypatch):
    """A forward that cannot be captured (it reads a value back to the
    host) makes generate_embedding raise GraphError; no chunk turns into
    zero vectors and nothing runs eager instead."""
    gen = _e5(monkeypatch)
    real = gen.runner.fn

    def reads_back(ids, mask):
        out = real(ids, mask)
        return out * float(out.abs().max())
    gen.runner.fn = reads_back
    eager0 = graphed.GraphRunner.launches_by_variant["eager"]
    with pytest.raises(graphed.GraphError, match="capture"):
        gen.generate_embedding(bucket_texts(10, 32, seed=8))
    assert graphed.GraphRunner.launches_by_variant["eager"] == eager0
    assert not gen.runner.graphs
