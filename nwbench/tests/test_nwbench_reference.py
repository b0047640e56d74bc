"""The plain references against brute force and against independent
implementations, at toy sizes."""

import numpy as np
import pytest
import torch

from nwbench.reference import bert, hash_tokenizer
from nwbench.reference import knn as ref


def _unit(rng, n, d):
    x = rng.standard_normal((n, d))
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _brute(q, b, k):
    d = ((q[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    order = np.argsort(d, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(d, order, 1), order


def test_exact_kth_and_pair_distances_match_brute_force():
    rng = np.random.default_rng(0)
    q, b = _unit(rng, 20, 16), _unit(rng, 3000, 16)
    d, i = _brute(q, b, 7)
    qt, bt = torch.from_numpy(q).float(), torch.from_numpy(b).float()
    kth = ref.exact_kth(qt, bt, 7, block_rows=700)
    np.testing.assert_allclose(kth.numpy(), d[:, -1], rtol=0, atol=1e-6)
    pd = ref.pair_distances(qt, bt, torch.from_numpy(i))
    np.testing.assert_allclose(pd.numpy(), d, rtol=0, atol=1e-6)


def test_judge_exact_answer_and_faults():
    rng = np.random.default_rng(1)
    q, b = _unit(rng, 30, 32), _unit(rng, 4000, 32)
    qt, bt = torch.from_numpy(q).float(), torch.from_numpy(b).float()
    d, i = _brute(qt.double().numpy(), bt.double().numpy(), 10)
    d, i = torch.from_numpy(d).float(), torch.from_numpy(i)
    good = ref.judge(qt, bt, d, i, 10)
    assert good["bad_rows"] == 0
    assert good["dist_err"] < 1e-6 and good["excess"] < 1e-6
    wrong = i.clone()
    wrong[:, -1] = (wrong[:, -1] + 1) % 4000          # an altered answer
    bad = ref.judge(qt, bt, d, wrong, 10)
    assert bad["dist_err"] > 1e-3 and bad["excess"] > 1e-3
    dup = i.clone()
    dup[0, 1] = dup[0, 0]
    assert ref.judge(qt, bt, d, dup, 10)["bad_rows"] == 1
    order = d.clone()
    order[2] = order[2].flip(0)
    assert ref.judge(qt, bt, order, i, 10)["bad_rows"] == 1


def test_round_tf32():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, 1.0 + 2 ** -12,
                      -(1.0 + 3 * 2 ** -11), 3.0])
    want = torch.tensor([1.0, 1.0 + 4 * 2 ** -11, 1.0, -(1.0 + 4 * 2 ** -11),
                         3.0])
    assert torch.equal(ref.round_tf32(x), want)


def test_tf32_control_is_a_near_miss():
    rng = np.random.default_rng(2)
    q, b = _unit(rng, 40, 256), _unit(rng, 20000, 256)
    qt, bt = torch.from_numpy(q).float(), torch.from_numpy(b).float()
    d, i = ref.tf32_knn(qt, bt, 10, block_rows=5000)
    numbers = ref.judge(qt, bt, d, i, 10)
    assert numbers["bad_rows"] == 0
    assert 1e-6 < numbers["dist_err"] < 1e-3


def test_hash_tokenizer_is_the_ports():
    from neighborhoodwatch_tpu_torch.models.tokenizer import HashTokenizer
    texts = ["query:alpha beta, Gamma!", "query:" + " ".join(["w"] * 600)]
    ids, mask = HashTokenizer()(texts, max_length=512)
    for row, m, t in zip(ids, mask, texts):
        assert list(row[m.astype(bool)]) == hash_tokenizer.token_ids(
            t, 30522, 512)


@pytest.fixture
def tiny_bert():
    cfg = {"hidden_size": 32, "intermediate_size": 64,
           "num_hidden_layers": 2, "num_attention_heads": 4,
           "vocab_size": 30522, "max_position_embeddings": 64,
           "type_vocab_size": 2, "layer_norm_eps": 1e-12}
    state = bert.make_state(cfg, torch.Generator().manual_seed(5), "cpu")
    return cfg, state


def test_bert_reference_matches_the_ports_float32_encoder(tiny_bert):
    """An independent BERT (the port's module in float32 with erf GELU)
    on the same weights."""
    from neighborhoodwatch_tpu_torch.models.bert import (
        BertConfig, BertEncoder, mean_pool_normalize)
    cfg, state = tiny_bert
    port = BertEncoder(BertConfig(
        hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
        max_position_embeddings=64, dtype="float32", gelu="exact"))
    port.load_state_dict({k: v.float() for k, v in state.items()})
    ids = hash_tokenizer.token_ids("query:one two three four", 30522)
    t = torch.tensor([ids])
    with torch.no_grad():
        want = mean_pool_normalize(port(t, torch.ones_like(t)),
                                   torch.ones_like(t))[0]
    got = bert.embed(state, cfg, ids)
    assert float((got - want).norm()) < 1e-5
    assert abs(float(got.norm()) - 1.0) < 1e-6


def test_bert_fp8_control_departs(tiny_bert):
    cfg, state = tiny_bert
    ids = hash_tokenizer.token_ids("query:one two three four five", 30522)
    gap = float((bert.embed(state, cfg, ids, fp8=True)
                 - bert.embed(state, cfg, ids)).norm())
    assert 2e-4 < gap < 1.0


def test_make_state_types_and_seed(tiny_bert):
    cfg, state = tiny_bert
    again = bert.make_state(cfg, torch.Generator().manual_seed(5), "cpu")
    assert all(torch.equal(state[k], again[k]) for k in state)
    assert state["layers.0.attention.query.weight"].dtype == torch.bfloat16
    assert state["word_embeddings.weight"].dtype == torch.float32
    w = state["layers.1.output.weight"].float()
    assert abs(float(w.std()) - 0.02) < 0.002
    # no bias and no layer norm is the identity
    biases = torch.cat([v.float() for k, v in state.items()
                        if k.endswith(".bias") and "_ln" not in k])
    assert state["layers.0.intermediate.bias"].dtype == torch.bfloat16
    assert abs(float(biases.std()) - 0.02) < 0.004
    ln_w = torch.cat([v for k, v in state.items()
                      if k.endswith("_ln.weight")])
    ln_b = torch.cat([v for k, v in state.items() if k.endswith("_ln.bias")])
    assert ln_w.dtype == torch.float32
    assert abs(float(ln_w.mean()) - 1.0) < 0.02
    assert abs(float(ln_w.std()) - 0.1) < 0.02
    assert abs(float(ln_b.std()) - 0.02) < 0.004


@pytest.mark.parametrize("part", ["intermediate.bias", "attention.out.bias",
                                  "attention_ln.weight", "output_ln.bias"])
def test_the_reference_reads_biases_and_layer_norms(tiny_bert, part):
    """A bias add or a layer norm's affine dropped in every layer moves the
    embedding far above float32's rounding (at e5-large's widths by 0.07 to
    0.7, above the encoder cells' limits)."""
    cfg, state = tiny_bert
    ids = hash_tokenizer.token_ids("query:one two three four", 30522)
    want = bert.embed(state, cfg, ids)
    broken = dict(state)
    for key in state:
        if key.startswith("layers.") and key.endswith(part):
            broken[key] = torch.ones_like(state[key]) \
                if part.endswith("weight") else torch.zeros_like(state[key])
    assert float((bert.embed(broken, cfg, ids) - want).norm()) > 1e-4
