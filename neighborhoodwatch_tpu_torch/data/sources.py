"""Source datasets of the text pipelines (counterpart of data/sources.py;
the part the `ck` entry point needs).

Streams HuggingFace datasets (squad questions for queries, wikipedia
20220301.en text for base) or a hermetic synthetic source, and splits rows
into sentences with a dependency-free regex sentencizer (the reference
requires spaCy's "sentencizer" pipe, generate_dataset.py:18-19,36-42). The
synthetic source gives byte-identical text to the JAX package's for the
same seed. The `nw` sentence-embedding pipeline (process_dataset and the
two-phase base selection) is not ported yet.
"""

import os
import re

import numpy as np

from neighborhoodwatch_tpu_torch.utils.naming import (
    BASE_CONFIG, BASE_DATASET, QUERY_DATASET,
)

# Candidate soft break: sentence-final punct, whitespace, then an
# uppercase/digit/quote opener. Hard break: a blank line (paragraph).
_SOFT_BREAK_RE = re.compile(r"(?<=[.!?…])[\s\n]+(?=[A-Z0-9\"'(])")
_HARD_BREAK_RE = re.compile(r"\n{2,}")
_LAST_TOKEN_RE = re.compile(r"(\S+)$")

# Titles/abbreviations that never end a sentence when followed by ".".
# The reference's spaCy blank-en sentencizer (generate_dataset.py:18-19,
# 36-42) gets the same effect from the English tokenizer's exception
# table: "Dr." / "e.g." stay single tokens, and its rule-based
# Sentencizer only breaks on bare punctuation tokens.
_ABBREVIATIONS = frozenset("""
    dr mr mrs ms prof gen rep sen gov pres capt col sgt lt cmdr adm maj
    rev fr hon st jr sr messrs mmes msgr
    vs etc al cf ca approx est min max dept univ assn bros inc ltd co corp
    fig figs no nos vol vols pp sec chap ops
    jan feb mar apr jun jul aug sep sept oct nov dec
    mon tue tues wed thu thurs fri sat sun
""".split())


def _breaks_sentence(prefix: str) -> bool:
    """Should a candidate soft break after `prefix` split the sentence?"""
    m = _LAST_TOKEN_RE.search(prefix)
    if not m:
        return True
    tok = m.group(1)
    if not tok.endswith("."):        # '!', '?', '…' always end a sentence
        return True
    if re.fullmatch(r"[A-Za-z]\.", tok):          # initials: "J. K. Rowling"
        return False
    if re.fullmatch(r"(?:[A-Za-z]\.){2,}", tok):  # acronyms: "U.S.", "e.g."
        return False
    word = tok.rstrip(".").rsplit(".", 1)[-1].lstrip("(\"'").lower()
    return word not in _ABBREVIATIONS


def split_into_sentences(text) -> list[str]:
    """Dependency-free sentencizer (reference: spaCy's rule-based
    `sentencizer` pipe over blank-en tokenization, generate_dataset.py:
    36-42). Splits after sentence-final punctuation followed by an
    upper/digit/quote opener, vetoing known abbreviations, single-letter
    initials, and dotted acronyms — the cases spaCy's tokenizer exception
    table keeps glued."""
    if isinstance(text, dict) and "text" in text:
        text = text["text"]
    sents: list[str] = []
    for block in _HARD_BREAK_RE.split(text):
        start = 0
        for m in _SOFT_BREAK_RE.finditer(block):
            if _breaks_sentence(block[start:m.start()]):
                sents.append(block[start:m.start()])
                start = m.end()
        sents.append(block[start:])
    return [s.strip() for s in sents if s and s.strip()]


def check_dataset_exists_remote() -> bool:
    """Verify the wikipedia config exists on the HF hub
    (reference: nw_utils.py:18-23). Returns False when offline."""
    try:
        from datasets import get_dataset_config_names
        configs = get_dataset_config_names(BASE_DATASET, trust_remote_code=True)
        return BASE_CONFIG in configs
    except Exception as e:
        print(f"   [warn] could not reach HF hub ({e})")
        return False


class _ListDataset:
    """Minimal iterable-of-dicts dataset with .column_names/.filter."""

    def __init__(self, rows, column_names):
        self.rows = list(rows)
        self.column_names = list(column_names)

    def __iter__(self):
        return iter(self.rows)

    def __len__(self):
        return len(self.rows)

    def filter(self, fn):
        return _ListDataset([r for r in self.rows if fn(r)], self.column_names)


def synthetic_dataset(kind: str, rows: int, seed: int = 0) -> _ListDataset:
    """Hermetic stand-in for squad/wikipedia when offline."""
    rng = np.random.default_rng(seed + (0 if kind == "query" else 1))
    column = "question" if kind == "query" else "text"
    titles = [f"Topic {i}" for i in range(max(rows // 5, 1))]
    out = []
    for i in range(rows):
        words = " ".join(f"w{int(x)}" for x in rng.integers(0, 5000, size=12))
        out.append({"id": str(i), "title": titles[i % len(titles)],
                    column: f"Sentence about {words}."})
    return _ListDataset(out, ["id", "title", column])


def load_query_source(synthetic_rows: int | None = None):
    """squad train split (reference: generate_dataset.py:270) or synthetic."""
    if synthetic_rows is not None:
        return synthetic_dataset("query", synthetic_rows)
    import datasets
    return datasets.load_dataset(QUERY_DATASET, cache_dir=".cache",
                                 trust_remote_code=True)["train"]


def load_base_source(synthetic_rows: int | None = None):
    """wikipedia 20220301.en train split (reference:
    generate_dataset.py:306-310) or synthetic."""
    if synthetic_rows is not None:
        return synthetic_dataset("document", synthetic_rows)
    import datasets
    return datasets.load_dataset(BASE_DATASET, BASE_CONFIG, cache_dir=".cache",
                                 trust_remote_code=True, split="train")


def _valid_parquet(filename: str) -> bool:
    """Resume guard: treat truncated/footerless parquet as absent instead of
    silently reusing it. Non-destructive: ParquetStreamer writes to a
    `.inprogress` temp and renames atomically on close, so an unreadable file
    at the final path can only be a foreign/legacy artifact — warn and let
    the regenerating writer's atomic os.replace supersede it."""
    if not os.path.exists(filename):
        return False
    try:
        import pyarrow.parquet as pq
        pq.read_schema(filename)
        return True
    except Exception:
        print(f"   [warn] {filename} exists but is unreadable; regenerating")
        return False
