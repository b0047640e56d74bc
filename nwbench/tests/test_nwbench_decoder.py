"""The decoder embedder's cell (`e5m.encode-passages`) at a tiny width on
the CPU: its yardstick's arithmetic, the plain reference and its fp8
control, the new readers on synthetic records, and whole runs through the
harness (correct, traced, the control and a broken timed path)."""

import copy
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from nwbench import decoder_yardstick as dy
from nwbench import harness
from nwbench.reference import mistral

from conftest import SEED

CELL = "e5m.encode-passages"
TINY = dict(hidden_size=256, num_hidden_layers=4, num_attention_heads=8,
            num_key_value_heads=2, intermediate_size=512, vocab_size=4000)


def test_flops_and_bytes_at_e5_mistral_widths():
    cfg = harness.load_cell(CELL)[1]
    assert dy.linear_flops_per_token(cfg) == 2 * 32 * (
        4096 * 6144 + 4096 * 4096 + 3 * 4096 * 14336)
    assert abs(dy.linear_flops_per_token(cfg) / 1e9 - 13.96) < 0.01
    # 2 x 4096 x L (L + 1) a layer
    assert dy.causal_attn_flops(cfg, 10) == 32 * 2 * 4096 * 10 * 11
    assert dy.text_flops(cfg, [3, 5]) == 8 * dy.linear_flops_per_token(
        cfg) + dy.causal_attn_flops(cfg, 3) + dy.causal_attn_flops(cfg, 5)
    # about 5.5 MB a slot of the three passes
    per_slot = dy.pass_bytes(cfg, 64, 512) / (64 * 512)
    assert 5.4e6 < per_slot < 5.7e6
    assert dy.causal_attn_bound_s(cfg, 64, 512) == pytest.approx(
        64 * 32 * 32 * 4 * 128 * 512 * 513 / 2 / 989e12)
    assert [dy.bucket(t, 4096) for t in (1, 64, 65, 442, 5000)] == \
        [64, 64, 128, 512, 4096]


def _tiny_cfg():
    cfg = copy.deepcopy(harness.load_cell(CELL)[1])
    cfg.update(TINY)
    return cfg


def test_the_fp8_control_misses_where_the_reference_agrees_with_itself():
    cfg = _tiny_cfg()
    state = mistral.make_state(cfg, torch.Generator().manual_seed(2), "cpu")
    texts = [[1, *range(1000, 1000 + n), 2] for n in (5, 40, 120)]
    want = mistral.embed_many(state, cfg, texts)
    one = mistral.embed(state, cfg, texts[1])
    assert torch.allclose(one, want[1], atol=1e-6)
    ctl = mistral.embed_many(state, cfg, texts, fp8=True)
    gaps = (ctl - want).norm(dim=1)
    assert float(gaps.min()) > 0.02, gaps       # the tiny cell's limit
    assert torch.allclose(want.norm(dim=1), torch.ones(3))
    for k, v in state.items():
        want_dtype = torch.float32 if k.endswith("norm") else torch.bfloat16
        assert v.dtype == want_dtype, k


ON_CARD = SimpleNamespace(kernels=[("k", 1e-3)])


def _rec(counters, trace=ON_CARD, driver="encode_decoder"):
    cfg = harness.load_cell(CELL)[1]
    return {"driver": driver, "config": cfg, "counters": counters,
            "trace": trace, "window_s": 8.0}


class _Trace:
    kernels = [("k", 1.0)]

    def __init__(self, attn, passes):
        self.times = {"masked_attention": attn, "add_rmsnorm_kernel":
                      passes / 2, "swiglu_kernel": passes / 2}

    def kernel_seconds(self, pred):
        return sum(s for n, s in self.times.items() if pred(n))


@pytest.fixture
def program(monkeypatch):
    from neighborhoodwatch_tpu_torch.utils import profiling

    def set_records(value):
        monkeypatch.setattr(profiling, "records", lambda: value)
    return set_records


def test_the_readers_on_synthetic_records(program):
    cfg = harness.load_cell(CELL)[1]
    fwd = [(64, 512)] * 3 + [(64, 256)]
    c = {"tokens": np.array([200, 300]), "calls": 1, "forwards": fwd}
    program({"spans": {}, "counters": {
        "attn.causal_launches": 32 * 4, "decoder.forwards": 4,
        "graph.tokens": 250, "graph.token_slots": 1000}})
    tr = _Trace(attn=0.5, passes=0.25)
    rd = harness.reader
    assert rd("decoder_pad_share").read(_rec(c, tr)) == pytest.approx(75.0)
    bound = sum(dy.causal_attn_bound_s(cfg, r, t) for r, t in fwd)
    assert rd("attn_causal_roofline").read(_rec(c, tr)) == pytest.approx(
        100 * bound / 0.5)
    pb = sum(dy.pass_bound_s(cfg, r, t) for r, t in fwd)
    assert rd("decoder_pass_roofline").read(_rec(c, tr)) == pytest.approx(
        100 * pb / 0.25)
    assert rd("decoder_mfu").read(_rec(c, tr)) == pytest.approx(
        100 * dy.text_flops(cfg, [200, 300]) / (8.0 * 989e12))
    assert rd("idle_share.e5m").__file__.endswith("idle_share.py")
    # one causal launch a layer a forward, or nothing is read
    program({"spans": {}, "counters": {"attn.causal_launches": 32 * 3}})
    assert rd("attn_causal_roofline").read(_rec(c, tr)) is None
    assert rd("decoder_pass_roofline").read(_rec(c, tr)) is None
    # another driver, no device trace, a program without records: nothing
    for name in ("decoder_pad_share", "attn_causal_roofline",
                 "decoder_pass_roofline", "decoder_mfu"):
        assert rd(name).read(_rec(c, tr, driver="encode")) is None
        assert rd(name).read(_rec(c, SimpleNamespace(kernels=[]))) is None
    program(None)
    for name in ("decoder_pad_share", "attn_causal_roofline",
                 "decoder_pass_roofline"):
        assert rd(name).read(_rec(c, tr)) is None


def test_the_host_reader_on_synthetic_records(program):
    """decoder_host_ms: e5.chunk's host time less graph.launch's, per
    chunk, of this driver's run alone."""
    c = {"tokens": np.array([200]), "calls": 1, "forwards": [(64, 512)]}
    rd = harness.reader("decoder_host_ms")
    program({"counters": {}, "spans": {
        "e5.chunk": {"count": 4, "host_s": 0.030, "device_s": 0.0},
        "graph.launch": {"count": 4, "host_s": 0.010, "device_s": 0.0}}})
    assert rd.read(_rec(c)) == pytest.approx(5.0)
    assert rd.read(_rec(c, driver="encode")) is None
    program({"counters": {}, "spans": {
        "e5.chunk": {"count": 2, "host_s": 0.008, "device_s": 0.0}}})
    assert rd.read(_rec(c)) == pytest.approx(4.0)
    program({"counters": {}, "spans": {}})
    assert rd.read(_rec(c)) is None
    program(None)
    assert rd.read(_rec(c)) is None


def _small(monkeypatch):
    from neighborhoodwatch_tpu_torch.models import decoder as dec
    monkeypatch.setitem(dec.DECODER_CONFIGS, dec.E5_MISTRAL,
                        dec.DecoderConfig(vocab_size=4000, hidden_size=256,
                                          num_layers=4, num_heads=8,
                                          num_kv_heads=2,
                                          intermediate_size=512))
    cell, config, mix = (copy.deepcopy(x) for x in harness.load_cell(CELL))
    config.update(TINY)
    mix.update(texts_per_call=70, words_median=30, words_max=120)
    cell["check_sample"] = 8
    # the tiny decoder on the CPU reads ~0.006 (bf16), the control ~0.09
    cell["limits"] = {"emb_gap": 0.02}
    return cell, config, mix


def _run(cell, config, mix, traced=False):
    return harness.run_cell(CELL, cell, config, mix, SEED, 0.2, traced,
                            "cpu", time.perf_counter())


def test_a_run_is_correct_and_the_control_is_not(monkeypatch):
    cell, config, mix = _small(monkeypatch)
    result, checks, driver = _run(cell, config, mix)
    assert result["correct"], checks
    assert set(result["metrics"]) == {"encode_tokens_per_s", "setup_s"}
    assert result["attempted"] > 0 and result["failed"] == 0
    # two chunks a call, the second ragged (6 rows padded to 64)
    fwd = driver.counters()["forwards"]
    assert len(fwd) == 2 * driver.calls and {r for r, _ in fwd} == {64}
    control = driver.check(control=True)
    assert not harness.judge(control, cell["limits"]), control


def test_a_traced_run_reads_nothing_off_the_card(monkeypatch):
    cell, config, mix = _small(monkeypatch)
    result, _, _ = _run(cell, config, mix, traced=True)
    assert result["correct"] and result["metrics"] == {}


@pytest.mark.parametrize("fault", ["half", "altered", "ragged"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    from neighborhoodwatch_tpu_torch.models import e5
    real = e5.E5EmbeddingGenerator.generate_embedding

    def broken(self, texts, *a, **kw):
        if fault == "half":
            h = (len(texts) + 1) // 2
            done = real(self, texts[:h], *a, **kw)
            return done + done[:len(texts) - h]
        done = real(self, texts, *a, **kw)
        if fault == "altered":
            return done[1:] + done[:1]
        return done[:64] + done[65:] + done[64:65]   # the ragged chunk
    monkeypatch.setattr(e5.E5EmbeddingGenerator, "generate_embedding",
                        broken)
    cell, config, mix = _small(monkeypatch)
    cell["check_sample"] = 1
    result, checks, _ = _run(cell, config, mix)
    assert not result["correct"], checks
