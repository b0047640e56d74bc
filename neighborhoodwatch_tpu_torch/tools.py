"""Operator tooling: parquet inspection / ETL and hdf5 hygiene (`nw-tools`;
counterpart of tools.py, every command).

A re-design of the reference's L0 ad-hoc DuckDB scripts
(reference: read_with_duckdb.py, validate_with_duckdb.py,
split_with_duckdb.py, split_with_duckdb_streaming.py,
sort_with_duckdb_streaming.py, hdf5_dupe_detector.py) as one importable,
testable CLI. DuckDB is replaced with pyarrow streaming (no extra native
dependency; pyarrow is already the pipeline's IO layer), and every command
is an out-of-core batch loop so 10M+-row files never fully materialize.

Commands:
    inspect        schema + row count + head of a parquet file
                   (reference: read_with_duckdb.py)
    validate       row/column/null/zero-embedding stats of an embedding
                   parquet (reference: validate_with_duckdb.py)
    split          list-column `embedding` -> `embedding_{i}` float32 scalar
                   columns, streamed (reference: split_with_duckdb.py:10-24,
                   split_with_duckdb_streaming.py:19-62)
    sort           external merge sort of a parquet by key columns, streamed
                   (reference: sort_with_duckdb_streaming.py:20-59)
    hdf5-dupes     duplicate-row report for hdf5 train/test groups
                   (reference: hdf5_dupe_detector.py:7-49)
    ifvec          count/dim/head of an fvec|ivec file
                   (reference: misc/ifvec_reader.py:6-37)
    knn            exact kNN over existing fvec corpora (beyond reference),
                   streamed into the running top-k on `--device` (default
                   cuda: raises without a card unless `--device cpu`)
    recall         recall@k of ANN results vs exported ground truth, with
                   optional tie-forgiveness at the k-th distance (beyond
                   reference — the downstream consumer's metric, computed
                   against the exported artifacts directly)
"""

import argparse
import json
import os
import sys
import tempfile

import numpy as np


# ---------------------------------------------------------------------------
# inspect / validate
# ---------------------------------------------------------------------------

def inspect_parquet(filename: str, head: int = 5, out=None) -> dict:
    out = out or sys.stdout
    import pyarrow.parquet as pq

    pf = pq.ParquetFile(filename)
    schema = pf.schema_arrow
    info = {
        "file": filename,
        "rows": pf.metadata.num_rows,
        "row_groups": pf.metadata.num_row_groups,
        "columns": len(schema),
        "size_bytes": os.path.getsize(filename),
    }
    print(json.dumps(info), file=out)
    for field in schema:
        print(f"  {field.name}: {field.type}", file=out)
    if head > 0 and pf.metadata.num_rows > 0:
        batch = next(pf.iter_batches(batch_size=head))
        cols = batch.column_names
        shown = cols if len(cols) <= 8 else cols[:8]
        for row in range(batch.num_rows):
            vals = {c: batch.column(c)[row].as_py() for c in shown}
            print(f"  row {row}: "
                  + ", ".join(f"{k}={_short(v)}" for k, v in vals.items()),
                  file=out)
    return info


def _short(v, width: int = 40):
    s = str(v)
    return s if len(s) <= width else s[: width - 3] + "..."


def validate_parquet(filename: str, batch_size: int = 65536,
                     out=None) -> dict:
    """Null counts per column + zero-embedding rows over the streamed file
    (the zero-vector test mirrors nw_utils.py:52-53's skip predicate)."""
    import pyarrow.parquet as pq
    from neighborhoodwatch_tpu_torch.io.parquet_io import embedding_column_names

    out = out or sys.stdout
    pf = pq.ParquetFile(filename)
    # matches token_embedding_{i} too — ck token files are the other
    # schema this pipeline writes, and a hardcoded "embedding_" prefix
    # silently skipped their zero-row scan
    emb_cols = embedding_column_names(pf.schema_arrow)
    nulls: dict[str, int] = {f.name: 0 for f in pf.schema_arrow}
    zero_rows = 0
    rows = 0
    for batch in pf.iter_batches(batch_size=batch_size):
        rows += batch.num_rows
        for name in batch.column_names:
            nulls[name] += batch.column(name).null_count
        if emb_cols:
            mat = np.column_stack(
                [batch.column(c).to_numpy(zero_copy_only=False)
                 for c in emb_cols])
            zero_rows += int(np.sum(~np.any(mat != 0.0, axis=1)))
    report = {
        "file": filename,
        "rows": rows,
        "embedding_columns": len(emb_cols),
        "null_cells": int(sum(nulls.values())),
        "zero_embedding_rows": zero_rows,
    }
    print(json.dumps(report), file=out)
    worst = {k: v for k, v in nulls.items() if v}
    if worst:
        print(f"  columns with nulls: {worst}", file=out)
    return report


# ---------------------------------------------------------------------------
# split: list column -> embedding_{i} scalar columns
# ---------------------------------------------------------------------------

def split_embedding_column(src: str, dst: str, column: str = "embedding",
                           batch_size: int = 8192) -> int:
    """Rewrite a parquet whose `column` holds fixed-length float lists into
    the pipeline's `embedding_{i}` float32 scalar-column schema
    (reference: split_with_duckdb_streaming.py:19-62; the scalar schema is
    what generate_dataset.py:229-235 streams and cu_knn consumes)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    pf = pq.ParquetFile(src)
    writer = None
    rows = 0
    try:
        for batch in pf.iter_batches(batch_size=batch_size):
            names = batch.column_names
            assert column in names, \
                f"{src} has no column {column!r} (columns: {names})"
            emb = batch.column(column)
            # vectorized list flatten: to_pylist() creates batch*dim Python
            # float objects per batch (~19B allocations over a 10M-row
            # file); flatten() is one C++ pass
            import pyarrow.compute as pc
            lens = pc.list_value_length(emb).to_numpy(zero_copy_only=False)
            assert len(lens) and lens.min() == lens.max(), \
                f"column {column!r} rows are not fixed-length lists"
            mat = np.asarray(emb.flatten().to_numpy(zero_copy_only=False),
                             dtype=np.float32).reshape(len(emb), int(lens[0]))
            arrays, fields = [], []
            for name in names:
                if name == column:
                    continue
                arrays.append(batch.column(name))
                fields.append(pa.field(name, batch.schema.field(name).type))
            for i in range(mat.shape[1]):
                arrays.append(pa.array(mat[:, i], type=pa.float32()))
                fields.append(pa.field(f"embedding_{i}", pa.float32()))
            table = pa.Table.from_arrays(arrays, schema=pa.schema(fields))
            if writer is None:
                # PLAIN encoding: ~all-distinct floats dictionary-encode
                # to +50% size and 5-10x slower decode (the same setting
                # as ParquetStreamer)
                writer = pq.ParquetWriter(dst, table.schema,
                                          use_dictionary=False)
            writer.write_table(table)
            rows += batch.num_rows
        if writer is None:
            # zero-row source: still produce a valid dst (the embedding
            # width is unknowable without data, so the schema is the
            # source's minus the list column) instead of silently writing
            # nothing and handing the next stage a FileNotFoundError
            schema = pa.schema([f for f in pf.schema_arrow
                                if f.name != column])
            pq.write_table(schema.empty_table(), dst)
    finally:
        if writer is not None:
            writer.close()
    return rows


# ---------------------------------------------------------------------------
# sort: external merge sort, bounded memory
# ---------------------------------------------------------------------------

def sort_parquet(src: str, dst: str, keys: list[str],
                 batch_size: int = 100_000, tmp_dir: str | None = None) -> int:
    """Out-of-core stable sort by `keys`: sorted runs are spilled to parquet,
    then k-way merged with batched prefix splices over the runs' key
    columns (bounded memory, unlike an in-RAM table sort; reference:
    sort_with_duckdb_streaming.py achieves the same with duckdb's native
    external sorter — `_merge_runs` is its arrow/numpy equivalent)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    pf = pq.ParquetFile(src)
    for key in keys:
        assert key in pf.schema_arrow.names, \
            f"{src} has no sort key column {key!r}"

    run_dir = tempfile.mkdtemp(prefix="nw_sort_", dir=tmp_dir)
    runs: list[str] = []
    try:
        for batch in pf.iter_batches(batch_size=batch_size):
            table = pa.Table.from_batches([batch])
            table = table.sort_by([(k, "ascending") for k in keys])
            path = os.path.join(run_dir, f"run{len(runs)}.parquet")
            # PLAIN: spills are decoded right back (and the single-run
            # path os.replace's one straight to dst)
            pq.write_table(table, path, use_dictionary=False)
            runs.append(path)

        if not runs:
            pq.write_table(pf.schema_arrow.empty_table(), dst)
            return 0
        if len(runs) == 1:
            os.replace(runs[0], dst)
            return pq.ParquetFile(dst).metadata.num_rows

        return _merge_runs(runs, dst, keys, batch_size)
    finally:
        for path in runs:
            if os.path.exists(path) and os.path.abspath(path) != \
                    os.path.abspath(dst):
                os.unlink(path)
        if os.path.isdir(run_dir):
            try:
                os.rmdir(run_dir)
            except OSError:
                pass


def _sort_key_arrays(batch_or_table, keys) -> list[np.ndarray]:
    """Expand each key column into a (null_class int8, value) array pair
    forming a TOTAL lexicographic order even with NaN/null keys: floats'
    NaN (and nulls, which to_numpy surfaces as NaN) and strings' None get
    class 1 with a neutral value, so they sort last — matching arrow's
    sort_by placement — and the vectorized comparisons never see a NaN or
    None."""
    out: list[np.ndarray] = []
    for k in keys:
        a = batch_or_table.column(k).to_numpy(zero_copy_only=False)
        if a.dtype.kind == "f":
            bad = np.isnan(a)
            out.append(bad.astype(np.int8))
            out.append(np.where(bad, 0.0, a))
        elif a.dtype == object:
            bad = np.array([x is None for x in a], dtype=bool)
            vals = a.copy()
            vals[bad] = ""
            out.append(bad.astype(np.int8))
            out.append(vals)
        else:
            out.append(np.zeros(len(a), np.int8))
            out.append(a)
    return out


class _RunCursor:
    """Batched reader over one sorted run, exposing whole-prefix cuts.

    The merge never touches individual rows: it slices off every row with
    key <= a bound in one vectorized comparison over the batch's key
    columns (the reference delegates the same job to duckdb's native
    external sorter, sort_with_duckdb_streaming.py:20-59; a per-row
    `.as_py()` heap merge measured ~100x slower at splice scale).
    Key comparisons run on `_sort_key_arrays`' total-order expansion."""

    def __init__(self, path: str, keys: list[str], batch_size: int):
        import pyarrow.parquet as pq
        self._iter = pq.ParquetFile(path).iter_batches(batch_size=batch_size)
        self._keys = keys
        self._batch = None
        self._karrs: list[np.ndarray] = []
        self._advance_batch()

    def _advance_batch(self):
        self._batch = next(self._iter, None)
        if self._batch is not None and self._batch.num_rows == 0:
            self._advance_batch()
            return
        if self._batch is not None:
            self._karrs = _sort_key_arrays(self._batch, self._keys)

    @property
    def exhausted(self) -> bool:
        return self._batch is None

    def last_key(self):
        return tuple(a[-1] for a in self._karrs)

    def _compare_mask(self, bound, strict: bool):
        """Vectorized lexicographic key < bound (or <=), built
        least-significant first."""
        acc = np.full(len(self._karrs[0]), not strict, dtype=bool)
        for arr, b in zip(reversed(self._karrs), reversed(bound)):
            acc = (arr < b) | ((arr == b) & acc)
        return acc

    def cut_below(self, bound):
        """Slice off every row with key strictly < `bound`. Such rows can
        only live in the CURRENT batch (any later batch starts >= this
        batch's last key >= bound), so this is bounded by one batch."""
        lt = self._compare_mask(bound, strict=True)
        cut = int(np.count_nonzero(lt))     # sorted run -> lt is a prefix
        if cut == 0:
            return None
        part = self._batch.slice(0, cut)
        self._consume(cut)
        return part

    def emit_equal(self, bound, write):
        """Stream every row with key == `bound` (possibly crossing many
        batches — a low-cardinality key can repeat for millions of rows)
        directly to `write`, one batch slice at a time, without ever
        accumulating them. Returns rows written."""
        rows = 0
        while not self.exhausted:
            le = self._compare_mask(bound, strict=False)
            cut = int(np.count_nonzero(le))
            if cut == 0:
                break
            write(self._batch.slice(0, cut))
            rows += cut
            last = cut >= self._batch.num_rows
            self._consume(cut)
            if not last:
                break
        return rows

    def _consume(self, cut: int):
        if cut >= self._batch.num_rows:
            self._advance_batch()
        else:
            self._batch = self._batch.slice(cut)
            self._karrs = [a[cut:] for a in self._karrs]


def _merge_runs(runs: list[str], dst: str, keys: list[str],
                batch_size: int) -> int:
    """K-way merge of sorted runs on batched arrow key columns, in two
    phases per round with bound = the smallest last-key among the active
    run batches:

    1. every row with key STRICTLY below the bound (confined to current
       batches, so at most runs x batch_size rows) is spliced and
       re-sorted once with a stable np.lexsort;
    2. rows EQUAL to the bound are streamed run-by-run in run-index order
       directly to the writer — all equal keys, so concatenation in run
       order IS the stable order, and a low-cardinality key (millions of
       rows sharing one value) never accumulates in memory.

    Equal keys keep run order (runs are file-order batches), so the
    result is a stable sort of the source."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    cursors = [_RunCursor(p, keys, batch_size) for p in runs]
    writer = None
    rows = 0

    def write(batch_or_table):
        nonlocal writer, rows
        if writer is None:
            # PLAIN like ParquetStreamer/split: the primary inputs are
            # embedding parquets, where dictionary pages cost +50% size
            # and 5-10x slower decode
            writer = pq.ParquetWriter(dst, batch_or_table.schema,
                                      use_dictionary=False)
        if isinstance(batch_or_table, pa.RecordBatch):
            writer.write_batch(batch_or_table)
        else:
            writer.write_table(batch_or_table)
        rows += batch_or_table.num_rows

    try:
        while True:
            active = [c for c in cursors if not c.exhausted]
            if not active:
                break
            bound = min(c.last_key() for c in active)
            parts = []
            for c in cursors:          # index order == stable tie order
                if not c.exhausted:
                    part = c.cut_below(bound)
                    if part is not None:
                        parts.append(part)
            if parts:
                table = pa.Table.from_batches(parts)
                karrs = _sort_key_arrays(table, keys)
                order = np.lexsort(tuple(reversed(karrs)))
                if not np.array_equal(order, np.arange(len(order))):
                    table = table.take(order)
                write(table)
            for c in cursors:          # equal keys: run order == stable
                if not c.exhausted:
                    c.emit_equal(bound, write)
        if writer is None:  # all runs empty
            pq.write_table(pa.Table.from_batches(
                [], schema=pq.ParquetFile(runs[0]).schema_arrow), dst)
    finally:
        if writer is not None:
            writer.close()
    return rows


# ---------------------------------------------------------------------------
# hdf5 duplicate detector
# ---------------------------------------------------------------------------

def hdf5_duplicates(filename: str, groups=("train", "test"),
                    out=None) -> dict:
    """Per-group duplicate-row counts via np.unique(axis=0)
    (reference: hdf5_dupe_detector.py:7-49)."""
    import h5py

    out = out or sys.stdout
    report: dict[str, dict] = {}
    with h5py.File(filename, "r") as f:
        for group in groups:
            if group not in f:
                report[group] = {"present": False}
                continue
            data = np.asarray(f[group])
            _, counts = np.unique(data, axis=0, return_counts=True)
            dupes = int(np.sum(counts > 1))
            extra = int(np.sum(counts[counts > 1] - 1))
            report[group] = {
                "present": True,
                "rows": int(data.shape[0]),
                "duplicated_vectors": dupes,
                "redundant_rows": extra,
            }
    print(json.dumps({"file": filename, **report}), file=out)
    return report


def inspect_ifvec(filename: str, head: int = 3, out=None) -> dict:
    """Count/dim/head/value-stats of an fvec or ivec file (the operator
    equivalent of the reference's standalone misc/ifvec_reader.py:6-37,
    reading through the same codec the pipeline writes with)."""
    from neighborhoodwatch_tpu_torch.io import fvec as fv

    out = out or sys.stdout
    dirname = os.path.dirname(filename) or "."
    basename = os.path.basename(filename)
    is_ivec = filename.endswith(".ivec") or ".ivec" in basename
    count = fv.count_vectors(dirname, basename)
    rows = [fv.get_nth_vector(dirname, basename, n)
            for n in range(min(head, count))]
    dim = len(rows[0]) if rows else 0
    sample = np.asarray(rows, dtype=np.int32 if is_ivec else np.float32)
    report = {
        "file": filename,
        "kind": "ivec" if is_ivec else "fvec",
        "vectors": count,
        "dim": dim,
        "head": sample[:head].tolist(),
    }
    if not is_ivec and len(sample):
        report["head_norms"] = np.linalg.norm(sample, axis=1).round(4).tolist()
    print(json.dumps(report), file=out)
    return report


def knn_over_fvec(query_file: str, base_file: str, k: int,
                  metric: str = "sqeuclidean", engine: str = "auto",
                  batch_rows: int = 500_000, out_dir: str | None = None,
                  out=None, device=None) -> tuple[str, str]:
    """Exact kNN directly over existing fvec corpora: streams the base
    file out of core into the running top-k on `device` (None = "cuda")
    and writes indices.ivec + distances.fvec next to the inputs.

    The operator path for corpora that already live in fvec form —
    the reference can only search vectors it generated itself."""
    from neighborhoodwatch_tpu_torch.io import fvec as fv
    from neighborhoodwatch_tpu_torch.ops.knn import StreamingKNN

    out = out or sys.stdout
    queries = fv.read_vectors(query_file)
    acc = StreamingKNN(queries, k=k, metric=metric, engine=engine,
                       device=device)
    n_base = fv.count_vectors(os.path.dirname(base_file) or ".",
                              os.path.basename(base_file))
    for offset, batch in fv.iter_vector_batches(base_file, batch_rows):
        acc.update(batch, offset)
    dist, idx = acc.finalize()

    out_dir = out_dir or (os.path.dirname(base_file) or ".")
    stem = os.path.splitext(os.path.basename(query_file))[0]
    idx_file = f"{out_dir}/{stem}_k{k}_indices.ivec"
    dist_file = f"{out_dir}/{stem}_k{k}_distances.fvec"
    fv.write_vectors(idx_file, idx.astype(np.int32), "i")
    fv.write_vectors(dist_file, dist, "f")
    print(json.dumps({"queries": len(queries), "base": n_base, "k": k,
                      "metric": metric, "indices": idx_file,
                      "distances": dist_file}), file=out)
    return idx_file, dist_file


def _load_matrix(filename: str, dataset: str, kind: str) -> np.ndarray:
    """(n, k) matrix from an .ivec(s)/.fvec(s) file or an hdf5 dataset —
    the neighbor/distance formats this pipeline exports (io/fvec.py,
    io/hdf5_io.py; reference formats parquet_to_format.py:71-89,322-348)
    plus the texmex-standard plural extensions external ANN tools write.

    The extension must be recognized, and indices must actually be an
    int format: the fvec codec sniffs payload dtype from the extension,
    and int32 index bits parsed as float32 yield denormals that astype
    to all-zero indices — a plausible near-zero recall with no error."""
    out_dtype = np.int64 if kind == "indices" else np.float64
    if filename.endswith((".h5", ".hdf5")):
        import h5py
        with h5py.File(filename, "r") as f:
            assert dataset in f, \
                f"{filename} has no dataset {dataset!r} (has: {list(f)})"
            return np.asarray(f[dataset], dtype=out_dtype)
    is_ivec = filename.endswith((".ivec", ".ivecs"))
    if not is_ivec and not filename.endswith((".fvec", ".fvecs")):
        raise ValueError(
            f"{filename}: unrecognized extension for a {kind} file; "
            f"expected .ivec(s)/.fvec(s) or .h5/.hdf5")
    if kind == "indices" and not is_ivec:
        raise ValueError(f"{filename}: neighbor indices must be an "
                         f".ivec(s) or hdf5 file, not float vectors")
    from neighborhoodwatch_tpu_torch.io import fvec as fv
    return np.asarray(fv.read_vectors(filename), dtype=out_dtype)


def recall_report(truth_file: str, candidate_file: str, k: int | None = None,
                  truth_distances: str | None = None,
                  dataset: str = "neighbors",
                  distances_dataset: str = "distances", out=None) -> dict:
    """recall@k of an ANN result against exact ground truth — the metric
    every downstream consumer of these datasets (ann-benchmarks style
    harnesses) computes; closing the loop inside the toolbox means the
    operator never re-implements it against the binary formats.

    Plain recall is per-query |cand[:k] ∩ truth[:k]| / k. With
    `truth_distances` (the exported distances fvec/hdf5), ties at the k-th
    distance are forgiven: an ANN that returned a DIFFERENT tied neighbor
    at the boundary is not penalized — matches are counted as strict-set
    hits plus tied hits capped at the remaining slots. Without
    tie-awareness, exact engines that break ties differently (lowest-index
    here, arbitrary in many ANN libraries) cap measured recall below 1.0
    on duplicate-heavy corpora through no fault of the index.

    Forgiveness only covers ties VISIBLE in the exported truth row: a tie
    group truncated at the row's last column may extend to ids the export
    never recorded, so equally-correct answers beyond it still score as
    misses. Rows in that situation (k-th distance == last exported
    distance at k < width) are counted in `boundary_tie_truncated` —
    regenerate the ground truth with a larger k to resolve them."""
    out = out or sys.stdout
    truth = _load_matrix(truth_file, dataset, "indices")
    cand = _load_matrix(candidate_file, dataset, "indices")
    assert truth.ndim == 2 and cand.ndim == 2, (truth.shape, cand.shape)
    assert truth.shape[0] == cand.shape[0], \
        f"query-count mismatch: truth {truth.shape[0]} vs candidate " \
        f"{cand.shape[0]} rows"
    if k is None:
        k = min(truth.shape[1], cand.shape[1])
    assert 0 < k <= truth.shape[1] and k <= cand.shape[1], \
        f"k={k} exceeds a file's width (truth {truth.shape[1]}, " \
        f"candidate {cand.shape[1]})"

    tdist = None
    if truth_distances is not None:
        tdist = _load_matrix(truth_distances, distances_dataset, "values")
        assert tdist.shape == truth.shape, \
            f"distances shape {tdist.shape} != neighbors shape {truth.shape}"
        # a NaN k-th distance makes both the < and == masks all-False and
        # silently scores a perfect candidate 0.0 — reject up front
        assert np.isfinite(tdist[:, :k]).all(), \
            f"{truth_distances} has non-finite distances within k={k}"

    n = truth.shape[0]
    assert (truth >= 0).all(), f"{truth_file} has negative neighbor ids"
    # vectorized row-wise set intersection (no per-row Python loop
    # on an O(n) path): offset every row's ids into a
    # disjoint range so one global isin answers all rows at once;
    # duplicate candidate ids collapse in the global unique. Negative
    # candidate ids (-1 "not found" padding in many ANN libraries) are
    # collapsed to one sentinel BEFORE offsetting — offset, they would
    # alias into the previous row's id range and could score as hits.
    stride = np.int64(max(int(truth.max()), int(cand.max()), 0) + 1)
    row_off = np.arange(n, dtype=np.int64)[:, None] * stride
    cand_ids = np.unique(np.where(cand[:, :k] < 0, np.int64(-1),
                                  cand[:, :k] + row_off))
    hits = np.isin(truth[:, :k] + row_off, cand_ids)
    tie_truncated = 0
    if tdist is None:
        per_query = hits.sum(axis=1) / k
    else:
        # tie-forgiving: hits strictly inside the k-th distance count
        # directly; candidates matching a TIED truth entry (== k-th
        # distance, anywhere in the exported row) fill the leftover slots
        bound = tdist[:, k - 1][:, None]
        strict = tdist[:, :k] < bound
        tied_full = tdist == bound                      # whole row, == only
        tied_hits = np.isin(truth + row_off, cand_ids) & tied_full
        s_hits = (hits & strict).sum(axis=1)
        slots = k - strict.sum(axis=1)
        per_query = (s_hits + np.minimum(tied_hits.sum(axis=1), slots)) / k
        if truth.shape[1] > k:
            tie_truncated = int((tdist[:, -1] == bound[:, 0]).sum())

    report = {
        "truth": truth_file,
        "candidate": candidate_file,
        "queries": int(n),
        "k": int(k),
        "tie_aware": tdist is not None,
        "recall": float(per_query.mean()),
        "min_recall": float(per_query.min()),
        "p5_recall": float(np.percentile(per_query, 5)),
        "perfect_queries": int((per_query == 1.0).sum()),
        "boundary_tie_truncated": tie_truncated,
    }
    print(json.dumps(report), file=out)
    return report


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="nw-tools",
        description="NeighborhoodWatch operator tooling, PyTorch/CUDA "
                    "edition (parquet ETL + hdf5 hygiene)")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("inspect", help="schema/rows/head of a parquet file")
    p.add_argument("file")
    p.add_argument("--head", type=int, default=5)

    p = sub.add_parser("validate", help="null/zero-embedding stats")
    p.add_argument("file")

    p = sub.add_parser("split", help="list column -> embedding_{i} scalars")
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("--column", default="embedding")
    p.add_argument("--batch-size", type=int, default=8192)

    p = sub.add_parser("sort", help="external merge sort by key columns")
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("--keys", nargs="+", required=True)
    p.add_argument("--batch-size", type=int, default=100_000)

    p = sub.add_parser("hdf5-dupes", help="duplicate rows in hdf5 groups")
    p.add_argument("file")
    p.add_argument("--groups", nargs="+", default=["train", "test"])

    p = sub.add_parser("ifvec", help="count/dim/head of an fvec|ivec file")
    p.add_argument("file")
    p.add_argument("--head", type=int, default=3)

    p = sub.add_parser("knn", help="exact kNN over existing fvec files")
    p.add_argument("query_fvec")
    p.add_argument("base_fvec")
    p.add_argument("-k", type=int, default=100)
    p.add_argument("--metric", default="sqeuclidean",
                   choices=["sqeuclidean", "euclidean", "cosine", "dot"])
    p.add_argument("--engine", default="auto",
                   choices=["auto", "exact", "verified", "screened"])
    p.add_argument("--batch-rows", type=int, default=500_000)
    p.add_argument("--out-dir", default=None)
    p.add_argument("--device", default=None,
                   help="torch device of the kNN (default: cuda; raises "
                        "without a card unless 'cpu' is asked for)")

    p = sub.add_parser("recall", help="recall@k of ANN results vs ground "
                                      "truth (ivec or hdf5)")
    p.add_argument("truth", help="ground-truth neighbors (.ivec/.h5)")
    p.add_argument("candidate", help="ANN result neighbors (.ivec/.h5)")
    p.add_argument("-k", type=int, default=None,
                   help="default: min of the two widths")
    p.add_argument("--truth-distances", default=None,
                   help="ground-truth distances (.fvec/.h5) enabling "
                        "tie-forgiving recall at the k-th distance "
                        "(forgives only ties visible in the exported "
                        "truth row)")
    p.add_argument("--dataset", default="neighbors",
                   help="hdf5 dataset name for neighbor inputs")
    p.add_argument("--distances-dataset", default="distances",
                   help="hdf5 dataset name for --truth-distances")

    args = parser.parse_args(argv)
    if args.cmd == "inspect":
        inspect_parquet(args.file, head=args.head)
    elif args.cmd == "validate":
        validate_parquet(args.file)
    elif args.cmd == "split":
        rows = split_embedding_column(args.src, args.dst, column=args.column,
                                      batch_size=args.batch_size)
        print(json.dumps({"rows": rows, "dst": args.dst}))
    elif args.cmd == "sort":
        rows = sort_parquet(args.src, args.dst, keys=args.keys,
                            batch_size=args.batch_size)
        print(json.dumps({"rows": rows, "dst": args.dst}))
    elif args.cmd == "hdf5-dupes":
        hdf5_duplicates(args.file, groups=tuple(args.groups))
    elif args.cmd == "ifvec":
        inspect_ifvec(args.file, head=args.head)
    elif args.cmd == "recall":
        recall_report(args.truth, args.candidate, k=args.k,
                      truth_distances=args.truth_distances,
                      dataset=args.dataset,
                      distances_dataset=args.distances_dataset)
    elif args.cmd == "knn":
        knn_over_fvec(args.query_fvec, args.base_fvec, k=args.k,
                      metric=args.metric, engine=args.engine,
                      batch_rows=args.batch_rows, out_dir=args.out_dir,
                      device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
