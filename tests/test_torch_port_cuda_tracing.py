"""The port's spans (utils/profiling.py) on the card: the device seconds of
`knn.screen` against the screen kernel's time in the profiler's own trace,
and a CUDA graph captured under a recording profiler replaying bit for bit
what a graph captured without one gives.

This file imports neither jax nor the JAX package, so it runs where the
card is and JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_port_cuda_tracing.py -q

Without a card its tests skip (CUDA events and graphs have no CPU mode);
tests/test_torch_port_tracing.py holds the spans and counters on the
CPU."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from neighborhoodwatch_tpu_torch.models import bert as tbert
from neighborhoodwatch_tpu_torch.models.e5 import E5EmbeddingGenerator
from neighborhoodwatch_tpu_torch.ops import knn as tknn
from neighborhoodwatch_tpu_torch.utils import profiling

E5_LARGE = "intfloat/e5-large-v2"


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA events and graphs have no "
                    "CPU mode)")
    return torch.device("cuda")


def _profiled():
    return torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])


@pytest.mark.cuda
def test_screen_span_device_seconds_match_the_kernel(cuda, tmp_path):
    """10,000 x 990,000 x 1536 (dbpedia's shape), isotropic rows on a
    prepared base: the events around `knn.screen` read the screen kernel's
    trace time within 5% (the span also holds the keys' decode)."""
    g = torch.Generator(device=cuda).manual_seed(20)
    base = torch.randn(990_000, 1536, device=cuda, generator=g)
    q = torch.randn(10_000, 1536, device=cuda, generator=g)
    prep = tknn.prepare_base(base, device=cuda)
    tknn.knn(q, prep, 100, device=cuda)             # loads every kernel
    torch.cuda.synchronize()
    with _profiled() as prof:
        d, i = tknn.knn(q, prep, 100, device=cuda)
        torch.cuda.synchronize()
    rec = profiling.records()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        kernels = [e for e in json.load(f)["traceEvents"]
                   if e.get("ph") == "X" and e.get("cat") == "kernel"
                   and "screen_keys" in e["name"]]
    assert len(kernels) == 1
    kernel_s = kernels[0]["dur"] * 1e-6
    span = rec["spans"]["knn.screen"]
    assert span["count"] == 1
    assert abs(span["device_s"] - kernel_s) <= 0.05 * kernel_s, \
        (span["device_s"], kernel_s)
    assert rec["counters"]["knn.queries"] == 10_000
    for name in ("knn.screened", "knn.select", "knn.certify"):
        assert rec["spans"][name]["device_s"] > 0


@pytest.mark.cuda
def test_graph_captured_while_recording_replays_bit_for_bit(cuda,
                                                            monkeypatch):
    """e5-large-v2's width cut to 2 layers, bf16: a generator whose graph
    is captured under a recording profiler gives, recording and not, the
    same bits as one captured without a profiler."""
    monkeypatch.setitem(tbert.E5_CONFIGS, E5_LARGE, dataclasses.replace(
        tbert.E5_CONFIGS[E5_LARGE], num_layers=2))
    rng = np.random.default_rng(4)
    lengths = rng.integers(40, 120, size=100)
    lengths[[0, 64]] = 110           # both chunks at bucket 128
    texts = [" ".join(f"w{j}" for j in rng.integers(0, 5000, size=n))
             for n in lengths]
    traced = E5EmbeddingGenerator(E5_LARGE, seed=7, device=cuda)
    with _profiled():
        first = np.stack(traced.generate_embedding(texts))
    rec = profiling.records()
    again = np.stack(traced.generate_embedding(texts))
    plain = E5EmbeddingGenerator(E5_LARGE, seed=7, device=cuda)
    want = np.stack(plain.generate_embedding(texts))
    assert np.array_equal(first, want) and np.array_equal(again, want)
    spans = rec["spans"]
    assert spans["graph.capture"]["count"] == 1
    assert spans["graph.replay"]["count"] == 2
    assert spans["graph.launch"]["count"] == 2
    assert spans["graph.replay"]["device_s"] > 0
    assert spans["graph.launch"]["host_s"] < spans["graph.replay"]["host_s"]
    assert rec["counters"]["graph.token_slots"] == 2 * 64 * 128
