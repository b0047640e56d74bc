"""The traffic generators: the same seed gives the same inputs, and the
inputs have the statistics their mixes state."""

import math

import numpy as np
import pytest
import torch

from nwbench import harness
from nwbench.traffic import texts, vectors


def _vectors(mix, seed, n_base=20000, n_query=500, dim=256):
    return vectors.make(mix, seed, "cpu", n_base=n_base, n_query=n_query,
                        dim=dim)


ISOTROPIC = {"generator": "vectors", "common_cos": 0.0}


@pytest.mark.parametrize("traffic", ["isotropic", "knn-crowded"])
def test_vectors_deterministic_per_seed(traffic):
    if traffic == "isotropic":
        mix = dict(ISOTROPIC)
    else:
        mix = harness.load_json("traffic", traffic)
        mix["clusters"] = 100
    a, b, c = (_vectors(mix, s) for s in (2 ** 31 + 5, 2 ** 31 + 5, 7))
    assert torch.equal(a.base(), b.base())
    assert torch.equal(a.queries(3), b.queries(3))
    assert not torch.equal(a.queries(3), a.queries(4))
    assert not torch.equal(a.base(), c.base())
    norms = a.base().norm(dim=1)
    assert torch.allclose(norms, torch.ones_like(norms), atol=1e-5)


def test_isotropic_cosines_centre_on_zero():
    t = _vectors(ISOTROPIC, 11)
    cos = t.queries(0) @ t.base().T
    assert abs(float(cos.mean())) < 2e-3
    assert abs(float(cos.std()) - 1 / math.sqrt(256)) < 3e-3


def test_crowded_cosines_match_the_mix():
    mix = harness.load_json("traffic", "knn-crowded")
    mix["clusters"] = 100
    t = _vectors(mix, 11)
    base, q = t.base(), t.queries(0)
    cos = base[:2000] @ base[:2000].T
    same = t.base_labels[:2000, None] == t.base_labels[None, :2000]
    off = ~torch.eye(2000, dtype=torch.bool)
    assert abs(float(cos[same & off].mean()) - mix["cluster_cos"]) < 0.01
    assert abs(float(cos[~same].mean()) - mix["common_cos"]) < 0.01
    # queries come from the same clusters: each has a base row near it
    assert float((q @ base.T).max(1).values.min()) > mix["cluster_cos"] - 0.05


def test_zipf_sizes():
    sizes = vectors.zipf_sizes(1_000_000, 20000, 1.0)
    assert sum(sizes) == 1_000_000
    assert sizes == sorted(sizes, reverse=True)
    harmonic = sum(1 / r for r in range(1, 20001))
    assert abs(sizes[0] - 1_000_000 / harmonic) <= 1


@pytest.mark.parametrize("traffic", ["sentences", "passages"])
def test_texts_deterministic_and_lengths(traffic):
    mix = harness.load_json("traffic", traffic)
    a, b = texts.make(mix, 2 ** 31 + 5), texts.make(mix, 2 ** 31 + 5)
    ta, wa = a.call(2)
    tb, wb = b.call(2)
    assert ta == tb and np.array_equal(wa, wb)
    assert a.call(3)[0] != ta
    assert len(ta) == mix["texts_per_call"]
    assert [len(t.split()) for t in ta] == list(wa)
    assert wa.min() >= mix["words_min"] and wa.max() <= mix["words_max"]
    assert abs(np.median(wa) - mix["words_median"]) \
        <= 0.08 * mix["words_median"]
    sigma = np.std(np.log(wa))
    assert abs(sigma - mix["words_sigma"]) < 0.05


def test_vocabulary_zipf_reuse():
    mix = harness.load_json("traffic", "sentences")
    t = texts.make(mix, 1)
    words = " ".join(t.call(0)[0]).split()
    counts = np.sort(np.unique(words, return_counts=True)[1])[::-1]
    # Zipf(1): the top word about 1 / H(50,000) ~ 9% of all words
    assert 0.07 < counts[0] / len(words) < 0.11
    assert len(set(t.vocab)) == mix["vocab"]


def test_buckets_in_use():
    sent = harness.load_json("traffic", "sentences")
    pas = harness.load_json("traffic", "passages")
    # 64 sentences: the longest reaches bucket 64 or 128; the 16-text
    # tail of a 10,000-text call sometimes stays at 32
    assert texts.buckets_in_use(sent, 64, 4) == [32, 64, 128]
    assert texts.buckets_in_use(pas, 64, 4) == [256, 512]


def test_warm_texts_fill_their_buckets():
    mix = harness.load_json("traffic", "sentences")
    t = texts.make(mix, 3)
    warm = t.warm_texts([32, 64, 128], 64, 4)
    assert len(warm) == 3 * 64
    for i, b in enumerate((32, 64, 128)):
        lens = [len(s.split()) + 4 for s in warm[i * 64:(i + 1) * 64]]
        assert max(lens) == b and min(lens) > 0
