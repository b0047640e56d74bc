"""The generator of text traffic: calls of `texts_per_call` texts, each a
run of words separated by spaces.

A mix's parameters:
  words_median, words_sigma  log-normal law of a text's length in words,
                             rounded, clipped to [words_min, words_max];
  vocab, zipf                a synthetic vocabulary of `vocab` distinct
                             lowercase words (the same for every seed),
                             each word drawn by its rank under Zipf(zipf).
A word is one token of the port's tokenizers, so a text of n words is
n + `extra` tokens, `extra` counting [CLS], [SEP] and any prefix the
model puts before each text.
"""

import math

import numpy as np

from nwbench import seeds

_VOCAB_SEED = 20240611
_LETTERS = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", dtype=np.uint8)


def vocabulary(n: int) -> np.ndarray:
    """`n` distinct lowercase words of 3 to 10 letters, fixed."""
    rng = np.random.default_rng(_VOCAB_SEED)
    words, seen = [], set()
    while len(words) < n:
        lengths = rng.integers(3, 11, size=n)
        letters = _LETTERS[rng.integers(0, 26, size=(n, 10))]
        for row, ln in zip(letters, lengths):
            w = row[:ln].tobytes().decode()
            if w not in seen:
                seen.add(w)
                words.append(w)
                if len(words) == n:
                    break
    return np.array(words, dtype=object)


def _length_cdf(mix: dict, words: float) -> float:
    """P(a text has at most `words` words)."""
    lo, hi = mix["words_min"], mix["words_max"]
    if words < lo:
        return 0.0
    if words >= hi:
        return 1.0
    z = (math.log(math.floor(words) + 0.5) - math.log(mix["words_median"])) \
        / mix["words_sigma"]
    return 0.5 * (1.0 + math.erf(z / math.sqrt(2.0)))


def buckets_in_use(mix: dict, chunk: int, extra: int,
                   max_length: int = 512, floor: float = 1e-9) -> list:
    """The token buckets (16, 32, ... doubling, capped at max_length) in
    which the longest text of a chunk of `chunk` texts, or of the ragged
    last chunk of a call, falls with a chance above `floor`."""
    sizes = {chunk}
    if mix["texts_per_call"] % chunk:
        sizes.add(mix["texts_per_call"] % chunk)
    buckets, lo = [], 0
    b = 16
    while True:
        b = min(b, max_length)
        hi_words = b - extra
        lo_words = lo - extra
        p = max(_length_cdf(mix, hi_words) ** n - _length_cdf(mix, lo_words)
                ** n for n in sizes)
        if p > floor:
            buckets.append(b)
        if b >= max_length:
            return buckets
        lo, b = b, b * 2


class TextTraffic:
    def __init__(self, mix: dict, seed: int):
        self.mix = mix
        self.seed = seed
        self.vocab = vocabulary(int(mix["vocab"]))
        w = 1.0 / np.arange(1, len(self.vocab) + 1) ** float(mix["zipf"])
        self.cdf = np.cumsum(w) / w.sum()

    def lengths(self, rng, n: int) -> np.ndarray:
        m = self.mix
        x = rng.lognormal(math.log(m["words_median"]), m["words_sigma"], n)
        return np.clip(np.rint(x), m["words_min"], m["words_max"]).astype(
            np.int64)

    def texts_of_lengths(self, rng, lengths) -> list:
        ranks = np.searchsorted(self.cdf, rng.random(int(lengths.sum())),
                                side="right")
        words = self.vocab[np.minimum(ranks, len(self.vocab) - 1)]
        ends = np.cumsum(lengths)
        return [" ".join(words[e - n:e]) for e, n in zip(ends, lengths)]

    def call(self, index: int, tag: int = seeds.TEXT):
        """(texts, words per text) of call number `index`."""
        rng = seeds.numpy_rng(self.seed, tag, index)
        n = self.lengths(rng, int(self.mix["texts_per_call"]))
        return self.texts_of_lengths(rng, n), n

    def warm_texts(self, buckets, chunk: int, extra: int) -> list:
        """One chunk of `chunk` texts for each bucket, its longest text
        filling the bucket."""
        rng = seeds.numpy_rng(self.seed, seeds.WARM)
        out = []
        for b in buckets:
            n = self.lengths(rng, chunk)
            n = np.minimum(n, b - extra)
            n[0] = b - extra
            out += self.texts_of_lengths(rng, n)
        return out


def make(mix: dict, seed: int) -> TextTraffic:
    return TextTraffic(mix, seed)
