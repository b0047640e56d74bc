"""Tokenizer front-end for the encoders (counterpart of models/tokenizer.py).

Uses a locally cached HuggingFace fast tokenizer when available; in
zero-egress environments it falls back to a deterministic hash tokenizer
(stable word -> id mapping into the BERT vocab range) so the full pipeline
remains runnable and testable without network access. The fallback is
flagged `is_hashed=True` — embeddings from it are pipeline-valid but not
semantically meaningful.
"""

import re
import hashlib

import numpy as np

CLS_ID = 101
SEP_ID = 102
PAD_ID = 0
# hash ids land in [999, vocab); low ids are reserved/special in BERT vocabs
_HASH_FLOOR = 999

_WORD_RE = re.compile(r"[A-Za-z0-9]+|[^\sA-Za-z0-9]")


class HashTokenizer:
    """Deterministic, dependency-free tokenizer fallback.

    Word ids are memoized: real text vocabulary is Zipfian, so the
    blake2s digest runs once per DISTINCT word instead of once per token.
    The cache is capped to bound memory on adversarial all-distinct
    streams (ids stay deterministic either way — the cache only skips
    recomputing the digest)."""

    is_hashed = True
    _CACHE_CAP = 1 << 20

    def __init__(self, vocab_size: int = 30522):
        self.vocab_size = vocab_size
        self._cache: dict = {}

    def _word_id(self, word: str) -> int:
        cached = self._cache.get(word)
        if cached is not None:
            return cached
        digest = hashlib.blake2s(word.lower().encode(), digest_size=4).digest()
        span = self.vocab_size - _HASH_FLOOR
        wid = _HASH_FLOOR + int.from_bytes(digest, "little") % span
        if len(self._cache) < self._CACHE_CAP:
            self._cache[word] = wid
        return wid

    def __call__(self, texts, max_length: int = 512, insert_after_cls=None):
        # reserve one slot for the marker (mirrors HFTokenizer) so _insert
        # never displaces the trailing [SEP] of a full row
        budget = max_length - (1 if insert_after_cls is not None else 0)
        ids_rows, mask_rows = [], []
        for text in texts:
            words = _WORD_RE.findall(text)[: budget - 2]
            ids = [CLS_ID] + [self._word_id(w) for w in words] + [SEP_ID]
            ids_rows.append(ids)
            mask_rows.append([1] * len(ids))
        ids_rows, mask_rows = _insert(ids_rows, mask_rows,
                                      insert_after_cls, max_length)
        return _pad(ids_rows, mask_rows, max_length)


class HFTokenizer:
    is_hashed = False

    def __init__(self, tok):
        self._tok = tok

    def __call__(self, texts, max_length: int = 512, insert_after_cls=None):
        budget = max_length - (1 if insert_after_cls is not None else 0)
        enc = self._tok(list(texts), truncation=True, max_length=budget)
        ids_rows, mask_rows = _insert(enc["input_ids"], enc["attention_mask"],
                                      insert_after_cls, max_length)
        return _pad(ids_rows, mask_rows, max_length)


def _insert(ids_rows, mask_rows, token_id, max_length):
    """Insert a marker token right after [CLS] (colbert-ai's DocTokenizer
    "[D]" convention), keeping the attention mask aligned."""
    if token_id is None:
        return ids_rows, mask_rows
    ids_rows = [row[:1] + [token_id] + row[1:max_length - 1] for row in ids_rows]
    mask_rows = [row[:1] + [1] + row[1:max_length - 1] for row in mask_rows]
    return ids_rows, mask_rows


def _pad(ids_rows, mask_rows, max_length):
    """Pad to the smallest power-of-two bucket (>=16) covering the batch —
    a bounded set of batch shapes, the same buckets as the JAX package."""
    longest = max(len(r) for r in ids_rows)
    bucket = 16
    while bucket < longest and bucket < max_length:
        bucket *= 2
    bucket = min(bucket, max_length)
    n = len(ids_rows)
    ids = np.full((n, bucket), PAD_ID, dtype=np.int32)
    mask = np.zeros((n, bucket), dtype=np.int32)
    for i, (r, m) in enumerate(zip(ids_rows, mask_rows)):
        r = r[:bucket]
        ids[i, :len(r)] = r
        mask[i, :len(r)] = m[:len(r)]
    return ids, mask


def load_tokenizer(model_name: str, quiet: bool = False):
    """Local HF tokenizer if cached, else the hash fallback."""
    try:
        from transformers.utils import hub as _hub
        if not _hub.try_to_load_from_cache(model_name, "tokenizer_config.json"):
            raise FileNotFoundError(f"{model_name} tokenizer not in local HF cache")
        from transformers import AutoTokenizer
        tok = AutoTokenizer.from_pretrained(model_name, local_files_only=True)
        return HFTokenizer(tok)
    except Exception:
        if not quiet:
            print(f"   [warn] no local tokenizer for {model_name}; "
                  f"using deterministic hash tokenizer")
        return HashTokenizer()
