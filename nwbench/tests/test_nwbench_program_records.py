"""The readers of the program's own spans and counters (`pad_share`,
`encode_host_ms`, `fallback_ms`, `screened_ms`) on synthetic records, on
the other driver and on a program without records; and `pad_share` of one
call of each text mix, through the port's tokenizer and graph runner,
against the count taken from the call's word counts and the buckets."""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from nwbench import harness, program_records
from nwbench.reference import hash_tokenizer

from conftest import SEED

ON_CARD = SimpleNamespace(kernels=[("k", 1e-3)])
SPANS = {"knn.screened": (4, 3.2, 3.0), "knn.prepare": (4, 0.01, 0.02),
         "knn.screen": (4, 0.2, 0.21), "knn.select": (4, 0.05, 0.03),
         "knn.certify": (4, 0.4, 0.002), "knn.repair_a": (2, 0.01, 0.012),
         "knn.fallback": (3, 2.0, 2.4), "knn.repair_b": (1, 0.1, 0.16),
         "e5.chunk": (157, 0.5, 0.5), "e5.tokenize": (157, 0.2, 0.01),
         "graph.launch": (157, 0.186, 0.5)}
COUNTERS = {"graph.tokens": 250, "graph.token_slots": 1000,
            "knn.queries": 40}


def _records(device=True):
    return {"spans": {n: {"count": c, "host_s": h,
                          "device_s": d if device else None}
                      for n, (c, h, d) in SPANS.items()},
            "counters": dict(COUNTERS)}


@pytest.fixture
def program(monkeypatch):
    """Set what the program's records() returns."""
    from neighborhoodwatch_tpu_torch.utils import profiling

    def set_records(value):
        monkeypatch.setattr(profiling, "records", lambda: value)
    return set_records


def _rec(driver, trace=ON_CARD):
    return {"driver": driver, "trace": trace}


WANT = {"pad_share": ("encode", 75.0),
        "encode_host_ms": ("encode", 2.0),
        "fallback_ms": ("knn", 1e3 * (2.4 + 0.16) / 4),
        "screened_ms": ("knn", 1e3 * (0.21 + 0.03 + 0.012) / 4)}


@pytest.mark.parametrize("metric", sorted(WANT))
def test_a_reader_on_synthetic_records(program, metric):
    driver, want = WANT[metric]
    other = "knn" if driver == "encode" else "encode"
    mod = harness.reader(metric)
    program(_records())
    assert mod.read(_rec(driver)) == pytest.approx(want, rel=1e-12)
    if metric == "encode_host_ms":     # eager forwards: no launch span
        recs = _records()
        del recs["spans"]["graph.launch"]
        program(recs)
        assert mod.read(_rec(driver)) == pytest.approx(1e3 * 0.5 / 157)
    assert mod.read(_rec(other)) is None
    # no device trace (a run off the card): nothing read
    assert mod.read(_rec(driver, SimpleNamespace(kernels=[]))) is None
    # the split metric finds the same reader
    if driver == "encode":
        assert harness.reader(metric + ".passages").__file__ == mod.__file__
    program({"spans": {}, "counters": {}})
    assert mod.read(_rec(driver)) is None


def test_knn_readers_need_device_seconds_and_a_call(program):
    program(_records(device=False))
    for metric in ("fallback_ms", "screened_ms"):
        assert harness.reader(metric).read(_rec("knn")) is None
    recs = _records()
    del recs["spans"]["knn.fallback"], recs["spans"]["knn.repair_b"]
    program(recs)
    assert harness.reader("fallback_ms").read(_rec("knn")) == 0.0
    del recs["spans"]["knn.screened"]
    assert harness.reader("screened_ms").read(_rec("knn")) is None


def test_a_program_without_records_reads_nothing(monkeypatch):
    """The parent's program keeps no records: every reader returns None,
    and none raises."""
    from neighborhoodwatch_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "records")
    assert program_records.records() is None
    for metric, (driver, _) in WANT.items():
        assert harness.reader(metric).read(_rec(driver)) is None


def _counted(words, extra, chunk=64, max_length=512):
    """(real tokens, token slots) of a call whose texts have `words` words
    each: chunks of `chunk` texts, each padded to `chunk` rows and to the
    bucket (16, 32, ... doubling, capped at max_length) of its longest
    text."""
    tokens = np.minimum(np.asarray(words) + extra, max_length)
    slots = 0
    for i in range(0, len(tokens), chunk):
        longest = int(tokens[i:i + chunk].max())
        bucket = 16
        while bucket < longest:
            bucket *= 2
        slots += chunk * min(bucket, max_length)
    return int(tokens.sum()), slots


@pytest.mark.parametrize("mix_name", ["sentences", "passages"])
def test_pad_share_equals_the_count_of_the_texts(monkeypatch, mix_name):
    """One call of the mix for one seed through the port's generator (its
    hash tokenizer, chunking and graph runner; the forward replaced by
    zeros, which the counters do not read)."""
    from neighborhoodwatch_tpu_torch.models import bert as tbert
    from neighborhoodwatch_tpu_torch.models.e5 import E5EmbeddingGenerator
    from neighborhoodwatch_tpu_torch.utils import profiling
    cfg = harness.load_json("configs", "e5-large-v2")
    mix = harness.load_json("traffic", mix_name)
    name = "intfloat/e5-small-v2"
    monkeypatch.setitem(tbert.E5_CONFIGS, name, dataclasses.replace(
        tbert.E5_CONFIGS[name], num_layers=1))
    gen = E5EmbeddingGenerator(name, state=None, device="cpu")
    assert gen.tokenizer.is_hashed
    gen.runner.fn = lambda ids, mask: torch.zeros(ids.shape[0], 384)
    texts, words = harness.load_module("traffic", mix["generator"]).make(
        mix, SEED).call(0)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        gen.generate_embedding(texts)
    extra = len(hash_tokenizer.token_ids(cfg["prefix"], cfg["vocab_size"]))
    tokens, slots = _counted(words, extra)
    assert profiling.records()["counters"] == {"graph.tokens": tokens,
                                               "graph.token_slots": slots}
    got = harness.reader("pad_share").read(_rec("encode"))
    assert got == pytest.approx(100.0 * (1.0 - tokens / slots), abs=1e-9)
