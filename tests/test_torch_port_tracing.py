"""The port's spans and counters (utils/profiling.py) on the CPU: nothing
recorded and no record_function entered without a profiler; under
torch.profiler, the screened kNN engine's stage spans on each of its
paths with counters equal to its diagnostics, the spans in the exported
Chrome trace around the call's ATen ops, the e5 generator's padding
counted by hand, and each profiler session's records its own.

The card's side (device seconds against the trace's kernels, a graph
captured under a recording profiler) is in
tests/test_torch_port_cuda_tracing.py.
"""

import dataclasses
import json

import pytest
import torch

from neighborhoodwatch_tpu_torch.models import bert as tbert
from neighborhoodwatch_tpu_torch.models.e5 import E5EmbeddingGenerator
from neighborhoodwatch_tpu_torch.models.tokenizer import token_buckets
from neighborhoodwatch_tpu_torch.ops import knn as tknn
from neighborhoodwatch_tpu_torch.utils import profiling

from tests.test_torch_port_engine import MEGA, _data, _plant_one_bin

E5_SMALL = "intfloat/e5-small-v2"
STAGES = {"knn.screened", "knn.prepare", "knn.screen", "knn.select",
          "knn.certify"}


@pytest.fixture(autouse=True)
def no_records():
    """Each test starts with no records of another test's sessions."""
    profiling._REC.clear()


def _profiled():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _planted(path):
    """(q, b, k, keyword arguments, diagnostics) of the planted inputs of
    tests/test_torch_port_engine.py that take each path of the engine."""
    bins = tknn.REPAIR_BINS + 1
    if path == "certified":
        q, b = _data(4, MEGA, 32, seed=41)
        return q, b, 5, {}, (0, 0, 0)
    if path == "class_a":
        q, b = _data(4, MEGA, 32, seed=41)
        _plant_one_bin(q, b, 0, 7)
        return q, b, 5, {}, (1, 0, 0)
    if path == "class_b":
        q, b = _data(3, MEGA, 32, seed=43)
        for bin_j in range(bins):
            _plant_one_bin(q, b, 0, bin_j + 3)
            b[[bin_j + 3 + j * 128 for j in range(5)]] += 0.01 * bin_j
        return q, b, 4 * bins, {}, (0, 1, 0)
    if path == "whole_batch":
        q, b = _data(3, MEGA, 32, seed=53)
        for qi in (0, 2):
            for bin_j in range(bins):
                start = qi + bin_j * 7 + 3
                _plant_one_bin(q, b, qi, start)
                b[[start + j * 128 for j in range(5)]] += 0.01 * bin_j
        return q, b, 4 * bins, {"max_fallback": 1}, (0, 2, 1)
    assert path == "scan"                  # a base under one mega-tile
    q, b = _data(4, MEGA - 1, 32, seed=41)
    return q, b, 5, {}, (0, 0, 0)


def _screened(q, b, k, **kw):
    return tknn.screened_knn_traced(
        torch.from_numpy(q), torch.from_numpy(b), b.shape[0], 0, k,
        "sqeuclidean", "default", with_diagnostics=True, **kw)


def test_no_profiler_no_record_function_and_no_records(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("entered while no profiler records")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    assert not profiling.recording()
    with profiling.span("x"):
        pass
    assert profiling.span("x") is profiling.span("y")
    profiling.count("x", 3)
    q, b, k, kw, want = _planted("class_a")
    assert _screened(q, b, k, **kw)[2] == want
    assert profiling.records() == {"spans": {}, "counters": {}}


@pytest.mark.parametrize("path", ["certified", "class_a", "class_b",
                                  "whole_batch", "scan"])
def test_each_path_records_its_stages(path):
    """One call a path: the stage spans its diagnostics name, once each,
    and counters equal to the diagnostics; a path that scans the base
    counts its "highest" tiles by route (on the CPU all on the fp32
    product: the one tile of a class-B repair or the whole batch over a
    mega-tile's rows, the two of the base under one); on the CPU no device
    seconds."""
    q, b, k, kw, want = _planted(path)
    with _profiled():
        d, i, diag = _screened(q, b, k, **kw)
    assert diag == want
    n_bin, n_full, whole = diag
    rec = profiling.records()
    if path == "scan":
        stages = {"knn.screened", "knn.scan"}
    else:
        stages = STAGES | {name for name, on in (
            ("knn.repair_a", n_bin), ("knn.repair_b", n_full and not whole),
            ("knn.fallback", whole)) if on}
    assert set(rec["spans"]) == stages
    for s in rec["spans"].values():
        assert s["count"] == 1 and s["host_s"] > 0 and s["device_s"] is None
    scanned = path in ("class_b", "whole_batch", "scan")
    tiles = {"dist.fp32_tiles": 2 if path == "scan" else 1} if scanned \
        else {}
    assert rec["counters"] == {
        "knn.queries": q.shape[0], "knn.repair_a_rows": n_bin,
        "knn.repair_b_rows": 0 if whole else n_full,
        "knn.fallback_rows": q.shape[0] if whole else 0, **tiles}
    # the same answer as an untraced call
    d2, i2, _ = _screened(q, b, k, **kw)
    assert torch.equal(d, d2) and torch.equal(i, i2)


def test_spans_sit_in_the_chrome_trace_around_their_ops(tmp_path):
    q, b, k, kw, _ = _planted("class_a")
    with _profiled() as prof:
        _screened(q, b, k, **kw)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    spans = {e["name"]: e for e in events
             if e.get("cat") == "user_annotation"
             and e["name"].startswith("knn.")}
    assert set(spans) == STAGES | {"knn.repair_a"}
    ops = [e for e in events if e.get("cat") == "cpu_op"
           and e["name"].startswith("aten::")]
    outer = spans["knn.screened"]
    for name, s in spans.items():
        inside = [o for o in ops if s["ts"] <= o["ts"]
                  and o["ts"] + o["dur"] <= s["ts"] + s["dur"]]
        assert inside, f"no ATen op inside {name}"
        assert outer["ts"] <= s["ts"] \
            and s["ts"] + s["dur"] <= outer["ts"] + outer["dur"]


def _words(n):
    return " ".join(f"w{j}" for j in range(n))


def test_e5_padding_counted_by_hand(monkeypatch):
    """70 texts: a unit of 64 whose texts have 10 words (bucket 16) but
    one of 40 (bucket 64), then a unit of 6 texts of 3 words (bucket 16).
    Each text is its words, the prefix "query:" (2 tokens), [CLS] and
    [SEP]. Grouped by bucket, the first 64 rows of bucket 16 make one
    forward; the flush puts the 40-word text and the 5 rows of bucket 16
    left into one forward at bucket 64 (5 rows promoted). Each forward
    computes 64 rows x its bucket."""
    monkeypatch.setitem(tbert.E5_CONFIGS, E5_SMALL, dataclasses.replace(
        tbert.E5_CONFIGS[E5_SMALL], num_layers=1))
    gen = E5EmbeddingGenerator(E5_SMALL, seed=3, device="cpu")
    assert gen.tokenizer.is_hashed
    lengths = [10] * 63 + [40] + [3] * 6
    texts = [_words(n) for n in lengths]
    seen = gen.tokens_seen
    with _profiled():
        out = gen.generate_embedding(texts)
    assert len(out) == 70
    tokens = [n + 4 for n in lengths]
    bucket = [min(t for t in token_buckets(512) if t >= n) for n in tokens]
    assert sorted(set(bucket)) == [16, 64]
    rec = profiling.records()
    assert rec["counters"] == {"graph.tokens": sum(tokens),
                               "graph.token_slots": 64 * (16 + 64),
                               "e5.forwards": 2, "e5.promoted_rows": 5}
    assert gen.tokens_seen - seen == sum(tokens)
    spans = rec["spans"]
    assert {n: s["count"] for n, s in spans.items()} == \
        {"e5.chunk": 2, "e5.tokenize": 2, "e5.readback": 1}
    assert spans["e5.tokenize"]["host_s"] < spans["e5.chunk"]["host_s"]


def test_a_second_session_starts_with_empty_records():
    with _profiled():
        with profiling.span("first"):
            profiling.count("n", 2)
    first = profiling.records()
    assert set(first["spans"]) == {"first"} and first["counters"] == {"n": 2}
    # read again after the session: the same records
    assert profiling.records() == first
    with _profiled():
        assert profiling.recording()
        profiling.count("n", 5)
        with profiling.span("second"):
            pass
        assert set(profiling.records()["spans"]) == {"second"}
    second = profiling.records()
    assert set(second["spans"]) == {"second"}
    assert second["counters"] == {"n": 5}
    # an untraced stretch with spans in it, then a third session
    with profiling.span("untraced"):
        pass
    assert profiling.records() == second
    with _profiled():
        with profiling.span("third"):
            pass
    assert set(profiling.records()["spans"]) == {"third"}
