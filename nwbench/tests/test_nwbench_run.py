"""A whole run of each cell, at a small size on the CPU with the look for
a card skipped: the result line's schema, the per-layer readers, the
control and the faults of the timed path, which `correct` has to catch."""

import json
import os
import subprocess
import sys

import pytest
import torch

from nwbench import harness
from nwbench.reference import knn as ref

from conftest import ROOT

CELLS = ["dbpedia.knn-crowded", "e5l.knn-crowded", "e5l.encode-sentences",
         "e5l.encode-passages"]


def _schema(result, traced):
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert isinstance(result["correct"], bool)
    assert result["attempted"] > 0 and result["failed"] == 0
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"}
    json.dumps(result)
    if traced:
        assert {"busy_s", "window_s"} <= set(result["device"])
        bd = result["breakdown"]
        assert set(bd) == {"device_ops", "idle_gaps"}
        assert all(len(x) <= 10 for x in bd.values())


@pytest.mark.parametrize("name", CELLS)
def test_a_run_is_correct_and_well_formed(cpu_run, name):
    result, checks, _ = cpu_run(name)
    _schema(result, False)
    cell = harness.load_json("workloads", name)
    assert set(result["metrics"]) == set(cell["end_to_end"]) | {"setup_s"}
    assert result["correct"], checks
    assert set(checks) == set(cell["limits"])


@pytest.mark.parametrize("name", ["dbpedia.knn-crowded",
                                  "e5l.encode-passages"])
def test_a_traced_run(cpu_run, name):
    result, _, _ = cpu_run(name, traced=True)
    _schema(result, True)
    assert result["correct"]
    # the CPU has no device trace: no reader finds a device number, and
    # none reports a share of zero in its place
    assert result["metrics"] == {}
    assert result["device"]["busy_s"] == 0


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(cpu_run, name):
    """The reference one precision down (TF32 products for kNN, fp8 for
    the encoder) in the program's place fails a limit."""
    _, checks, driver = cpu_run(name)
    control = driver.check(control=True)
    assert not harness.judge(control, driver.run.cell["limits"]), control


def _knn_fault(monkeypatch, kind):
    from neighborhoodwatch_tpu_torch.ops import knn as engine
    real = engine.knn

    def broken(q, base, k, **kw):
        d, i = real(q, base, k, **kw)
        if kind == "half":             # half of the batch left out
            h = q.shape[0] // 2
            d, i = d.clone(), i.clone()
            d[h:], i[h:] = d[:q.shape[0] - h], i[:q.shape[0] - h]
        else:                          # an answer altered where produced
            i = i.clone()
            i[:, -1] = (i[:, -1] + 1) % base.shape[0]
        return d, i
    monkeypatch.setattr(engine, "knn", broken)


def _encode_fault(monkeypatch, kind):
    from neighborhoodwatch_tpu_torch.models import e5
    real = e5.E5EmbeddingGenerator.generate_embedding

    def broken(self, texts, *a, **kw):
        if kind == "half":             # half of the batch left out
            h = (len(texts) + 1) // 2
            done = real(self, texts[:h], *a, **kw)
            return done + done[:len(texts) - h]
        done = real(self, texts, *a, **kw)
        return done[1:] + done[:1]     # each answer its neighbour's
    monkeypatch.setattr(e5.E5EmbeddingGenerator, "generate_embedding",
                        broken)


@pytest.mark.parametrize("fault", ["half", "altered"])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(cpu_run, monkeypatch, name,
                                            fault):
    """Each fault these cells can have (a step returning its state
    unchanged and a lost exchange between chips do not apply: no cell
    trains or spans chips)."""
    if "knn" in name:
        _knn_fault(monkeypatch, fault)
    else:
        _encode_fault(monkeypatch, fault)
    result, checks, _ = cpu_run(name)
    assert not result["correct"], checks


def test_end_to_end_metrics_are_named_by_the_cell(cpu_run):
    """A cell names its metrics and the kind each is: a later cell can
    report a kind under a name of its own with no change of code."""
    def edit(cell):
        cell["end_to_end"] = {"x_pairs_per_s": "pairs_per_s",
                              "x_call_p95_ms": "call_p95_ms"}
    result, _, driver = cpu_run("e5l.knn-crowded", cell_edit=edit)
    m = result["metrics"]
    assert set(m) == {"x_pairs_per_s", "x_call_p95_ms", "setup_s"}
    assert m["x_pairs_per_s"]["unit"] == "Gpair/s" and \
        m["x_pairs_per_s"]["value"] > 0
    assert m["x_call_p95_ms"]["value"] >= 1e3 * min(driver.latencies)


def test_the_ragged_last_chunk_is_checked(cpu_run, monkeypatch):
    """A call of 70 texts is a chunk of 64 and a ragged chunk of 6, padded
    to 64 rows by the generator: answers altered in the ragged chunk alone
    fail the check, even where the random sample is a single text."""
    from neighborhoodwatch_tpu_torch.models import e5
    real = e5.E5EmbeddingGenerator.generate_embedding

    def broken(self, texts, *a, **kw):
        done = real(self, texts, *a, **kw)
        return done[:64] + done[65:] + done[64:65]
    monkeypatch.setattr(e5.E5EmbeddingGenerator, "generate_embedding",
                        broken)

    def one_sample(cell):
        cell["check_sample"] = 1

    def calls_of_70(mix):
        mix["texts_per_call"] = 70
    result, checks, _ = cpu_run("e5l.encode-sentences",
                                cell_edit=one_sample, mix_edit=calls_of_70)
    assert not result["correct"], checks


def test_no_card_no_result():
    """Without a CUDA card the command fails and prints no result."""
    proc = subprocess.run(
        [sys.executable, "-m", "nwbench.run", "--workload",
         "dbpedia.knn-crowded", "--seed", str(2 ** 31 + 3), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""}, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


@pytest.mark.cuda
def test_control_and_program_on_the_card():
    """On the card at a middle size (100,000 x 1536 base, 1,000 queries):
    the program's answers pass the dbpedia cell's limits, the TF32
    control's do not."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from neighborhoodwatch_tpu_torch.ops import knn as engine
    from nwbench.traffic import vectors
    mix = harness.load_json("traffic", "knn-crowded")
    limits = harness.load_json("workloads", "dbpedia.knn-crowded")["limits"]
    t = vectors.make(mix, 5, "cuda", n_base=100_000, n_query=1000, dim=1536)
    base, q = t.base(), t.queries(0)
    d, i = engine.knn(q, base, 100, engine="auto")
    assert harness.judge(ref.judge(q, base, d, i.long(), 100), limits)
    cd, ci = ref.tf32_knn(q, base, 100)
    assert not harness.judge(ref.judge(q, base, cd, ci, 100), limits)
