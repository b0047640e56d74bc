"""Source dataset pipeline: text -> sentences -> embeddings -> parquet
(counterpart of data/sources.py).

Capability parity with reference generate_dataset.py:101-367: streams
HuggingFace datasets (squad questions for queries, wikipedia 20220301.en
text for base) or a hermetic synthetic source, splits rows into sentences,
batches sentences (batch=10000), embeds, skips zero embeddings, and
streams metadata + `embedding_{i}` float32 scalar columns to parquet with
resume-by-artifact. The synthetic source gives byte-identical text to the
JAX package's for the same seed.

Differences by design (the JAX package's, kept):
- sentence splitting is a dependency-free regex sentencizer (the reference
  requires spaCy's "sentencizer" pipe, generate_dataset.py:18-19,36-42);
- the two-phase base selection (titles overlapping the query set first,
  then the remainder, generate_dataset.py:317-362) builds ONE title mask
  (`_split_dataset_by_title`: a pyarrow `is_in` over the arrow-backed
  title column of an HF dataset) instead of a per-row Python lambda over
  fork pools;
- every local encoder is built on an explicit `device` (None = "cuda").
"""

import os
import re
import time

import numpy as np

from neighborhoodwatch_tpu_torch.io.parquet_io import ParquetStreamer
from neighborhoodwatch_tpu_torch.models.registry import (
    get_embedding_generator_for_model,
)
from neighborhoodwatch_tpu_torch.utils.misc import is_zero_embedding
from neighborhoodwatch_tpu_torch.utils.naming import (
    BASE_CONFIG, BASE_DATASET, QUERY_DATASET, get_full_filename,
    get_source_base_dataset_filename, get_source_query_dataset_filename,
)

SENTENCE_BATCH_SIZE = 10_000  # reference generate_dataset.py:112

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


def get_batch_embeddings_from_generator(text_list, generator, dataset_type=None):
    """Chunked embedding with zero-vector fallback accounting
    (reference: generate_dataset.py:45-91). Cohere needs input_type."""
    assert dataset_type in ("query", "document", None)
    from neighborhoodwatch_tpu_torch.models.generators import (
        CohereEmbeddingV3Generator,
    )

    kwargs = {}
    if isinstance(generator, CohereEmbeddingV3Generator):
        kwargs["input_type"] = ("search_query" if dataset_type == "query"
                                else "search_document")
    return generator.generate_embedding(text_list, **kwargs)


def get_embeddings_from_map(text_map, generator, dataset_type=None):
    """Embed a [(key, [sentences])] map preserving grouping
    (reference: generate_dataset.py:94-98). Zero embeddings are counted
    once, downstream in process_dataset."""
    flattened = [s for _, sentences in text_map for s in sentences]
    embeddings = get_batch_embeddings_from_generator(flattened, generator,
                                                     dataset_type)
    it = iter(embeddings)
    return [(key, [next(it) for _ in sentences]) for key, sentences in text_map]


def process_dataset(dataset_type, streamer, dataset, row_count,
                    embedding_column, model_name, output_dimension=None,
                    output_dtype=None, generator=None, device=None):
    """Stream rows: sentencize, embed in SENTENCE_BATCH_SIZE batches, skip
    zero embeddings, write metadata + embedding columns until `row_count`
    embeddings are produced (reference: generate_dataset.py:101-189).
    Returns (embeddings written, zero embeddings skipped).

    `dataset` is any iterable of dict rows exposing `.column_names`; a
    generator is built for `model_name` on `device` when none is given."""
    if generator is None:
        generator = get_embedding_generator_for_model(
            model_name=model_name, output_dimension=output_dimension,
            dataset_type=dataset_type, output_dtype=output_dtype,
            device=device)
    assert generator is not None

    column_names = list(dataset.column_names)
    embedding_counter = 0
    skipped_cnt = 0
    pending_rows: list[dict] = []
    pending_sentences: list[list[str]] = []
    pending_count = 0

    def flush() -> bool:
        """Embed pending sentences; returns True when row_count reached."""
        nonlocal embedding_counter, skipped_cnt
        nonlocal pending_rows, pending_sentences, pending_count
        if not pending_rows:
            return embedding_counter >= row_count
        text_map = list(enumerate(pending_sentences))
        tuples = get_embeddings_from_map(text_map, generator, dataset_type)
        meta_rows, embedding_rows = [], []
        done = False
        for index, embedding_list in tuples:
            row = pending_rows[index]
            for idx, embedding in enumerate(embedding_list):
                if is_zero_embedding(embedding):
                    skipped_cnt += 1
                    continue
                meta = []
                for column in column_names:
                    if column == "title":
                        meta.append(str(row[column]).replace("_", " "))
                    elif column == embedding_column:
                        meta.append(pending_sentences[index][idx])
                    else:
                        meta.append(row[column])
                meta_rows.append(meta)
                embedding_rows.append(embedding)
                embedding_counter += 1
                if embedding_counter >= row_count:
                    done = True
                    break
            if done:
                break
        if meta_rows:
            streamer.stream_to_parquet(meta_rows, embedding_rows)
        pending_rows, pending_sentences, pending_count = [], [], 0
        return done

    t0 = time.perf_counter()
    tok0 = getattr(generator, "tokens_seen", None)

    def _report():
        # pipeline-level embedding throughput (tokenize + encode + write),
        # printed per generation section
        wall = time.perf_counter() - t0
        if tok0 is not None and wall > 0:
            toks = generator.tokens_seen - tok0
            if toks:
                print(f"   embedding pipeline: {toks} tokens in "
                      f"{wall:.1f}s = {toks / wall / 1e6:.3f} Mtok/s "
                      f"({embedding_counter / wall:.0f} embeddings/s)")

    for row in dataset:
        sentences = split_into_sentences(row[embedding_column])
        pending_rows.append(row)
        pending_sentences.append(sentences)
        pending_count += len(sentences)
        if pending_count >= min(SENTENCE_BATCH_SIZE, row_count):
            if flush():
                _report()
                return embedding_counter, skipped_cnt
    flush()
    _report()
    return embedding_counter, skipped_cnt


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


def generate_query_dataset(data_dir, model_name, row_count,
                           output_dimension=None, output_dtype=None,
                           source=None, generator=None, device=None):
    """(reference: generate_dataset.py:264-285) — resume-by-artifact."""
    filename = get_source_query_dataset_filename(
        data_dir, model_name, row_count, output_dimension, output_dtype)
    if _valid_parquet(filename):
        print(f"file {filename} already exists")
        return filename
    dataset = source if source is not None else load_query_source()
    # the with-block publishes ONLY on success: an undersized parquet at
    # the final path would pass the resume guard
    with ParquetStreamer(filename, dataset.column_names) as streamer:
        processed, skipped = process_dataset("query", streamer, dataset,
                                             row_count, "question", model_name,
                                             output_dimension, output_dtype,
                                             generator=generator,
                                             device=device)
        assert processed == row_count, \
            f"Expected {row_count} rows, got {processed} rows."
    print(f"   processed {processed} non-zero embeddings, skipped {skipped} zero embeddings")
    return filename


def _filter_dataset_by_title(dataset, query_titles, keep_in: bool):
    """One side of `_split_dataset_by_title`: the rows whose title is in
    `query_titles` (keep_in) or those whose title is not."""
    kept, dropped = _split_dataset_by_title(dataset, query_titles)
    return kept if keep_in else dropped


def _split_dataset_by_title(dataset, query_titles):
    """(title-in-set view, title-not-in-set view), from ONE normalize +
    set-lookup pass over the corpus; both views keep the source's row
    order.

    Arrow-backed HF datasets expose the title column directly, so one
    vectorized `replace_substring` + `is_in` pass builds the boolean mask
    and `select` keeps each side lazy (an index mapping, not a copy).
    Plain iterables (synthetic/_ListDataset sources) take two `.filter`
    passes."""
    try:
        title_col = dataset.data.column("title")     # HF datasets.Dataset
        # a select()/shuffle()/filter() view keeps the FULL backing table
        # in .data plus an _indices mapping: read the view's titles
        # through the mapping, not the raw column
        indices = getattr(dataset, "_indices", None)
        if indices is not None:
            import pyarrow.compute as _pc
            title_col = _pc.take(title_col, indices.column(0))
    except AttributeError:
        return (dataset.filter(
                    lambda r: r["title"].replace("_", " ") in query_titles),
                dataset.filter(
                    lambda r: r["title"].replace("_", " ")
                    not in query_titles))

    import pyarrow as pa
    import pyarrow.compute as pc
    norm = pc.replace_substring(pc.cast(title_col, pa.string()), "_", " ")
    mask = pc.is_in(norm, options=pc.SetLookupOptions(
        value_set=pa.array(sorted(query_titles), type=pa.string()),
        skip_nulls=True)).to_numpy(zero_copy_only=False)
    return (dataset.select(np.nonzero(mask)[0]),
            dataset.select(np.nonzero(~mask)[0]))


def generate_base_dataset(data_dir, model_name, query_vector_filename,
                          row_count, output_dimension=None, output_dtype=None,
                          source=None, generator=None, device=None):
    """Two-phase base selection: rows whose title appears in the query set
    first, then the remainder until `row_count`
    (reference: generate_dataset.py:288-367)."""
    import pyarrow.parquet as pq
    import pyarrow.compute as pc

    filename = get_source_base_dataset_filename(
        data_dir, model_name, row_count, output_dimension, output_dtype)
    if _valid_parquet(filename):
        print(f"file {filename} already exists")
        return filename

    query_table = pq.read_table(get_full_filename(data_dir, query_vector_filename),
                                columns=["title"])
    query_titles = set(pc.unique(query_table.column("title")).to_pylist())

    dataset = source if source is not None else load_base_source()
    print("-- filtering base dataset (single title-set pass, both phases)")
    in_set, out_set = _split_dataset_by_title(dataset, query_titles)

    if generator is None:
        # ONE generator for both phases (both embed "document" rows)
        generator = get_embedding_generator_for_model(
            model_name=model_name, output_dimension=output_dimension,
            dataset_type="document", output_dtype=output_dtype,
            device=device)

    # publish only on success (cf. generate_query_dataset)
    with ParquetStreamer(filename, dataset.column_names) as streamer:
        processed = 0
        skipped = 0
        print("-- base dataset phase 1 (title in query set)")
        if len(in_set) > 0:
            processed, skipped = process_dataset("document", streamer, in_set,
                                                 row_count, "text", model_name,
                                                 output_dimension, output_dtype,
                                                 generator=generator)
            assert processed <= row_count

        if row_count > processed:
            print("-- base dataset phase 2 (title not in query set)")
            p2, s2 = process_dataset("document", streamer, out_set,
                                     row_count - processed, "text", model_name,
                                     output_dimension, output_dtype,
                                     generator=generator)
            processed += p2
            skipped += s2
            assert processed == row_count, \
                f"Expected {row_count} rows, got {processed} rows."

    print(f"   processed {processed} non-zero embeddings, skipped {skipped} zero embeddings")
    return filename
