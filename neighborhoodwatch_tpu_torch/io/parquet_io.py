"""Parquet I/O: embedding-table streaming writer and vectorized readers.

Schema contract (reference: generate_dataset.py:219-261): source metadata
columns followed by scalar float32 columns `embedding_0..embedding_{d-1}`
(or `token_embedding_i` for the ColBERT path). Scalar columns — not list
columns — so files are directly consumable by the same downstream tools.
"""

from __future__ import annotations

import os
import re
import glob

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pyarrow.dataset as pads

from neighborhoodwatch_tpu_torch.utils.naming import get_full_filename


class ParquetStreamer:
    """Incremental ParquetWriter over (metadata, embeddings) row batches
    (reference: generate_dataset.py:219-261).

    Dictionary encoding is disabled: embedding floats are ~all-distinct, so
    a dictionary per page costs ~+50% file size over PLAIN and a 5-10x
    slower decode (measured on the 10M x 1536 bench corpus) for zero
    compression win.

    Writes go to `<filename>.inprogress` and move to the final path with an
    atomic os.replace on close, so a file at the final path is always a
    complete parquet: resume guards never see (and never have to delete) a
    footerless half-write, and a concurrent run probing the same data_dir
    cannot destroy this writer's in-flight output."""

    def __init__(self, filename: str, columns: list[str]):
        self.filename = filename
        self._tmp = filename + ".inprogress"
        self.columns = list(columns)
        self.writer = None
        print(f"Initiated streaming to file {self.filename}")

    def stream_to_parquet(self, meta_array, embedding_array) -> None:
        meta_array = np.array(meta_array)
        embedding_array = np.asarray(embedding_array, dtype=np.float32)
        columns_list = [pd.DataFrame(meta_array, columns=self.columns)]
        for i in range(embedding_array.shape[1]):
            columns_list.append(
                pd.DataFrame(embedding_array[:, i], columns=[f"embedding_{i}"]))
        df = pd.concat(columns_list, axis=1)
        table = pa.Table.from_pandas(df)
        if self.writer is None:
            self.writer = pq.ParquetWriter(self._tmp, table.schema,
                                           use_dictionary=False)
        self.writer.write_table(table)

    def close(self) -> None:
        """Finalize and atomically publish. Idempotent (a second close is
        a no-op, not a crash on the already-renamed tmp)."""
        if self.writer is not None:
            self.writer.close()
            self.writer = None
            os.replace(self._tmp, self.filename)
            print(f"Finished streaming to {self.filename}")

    def abort(self) -> None:
        """Discard the in-progress file WITHOUT publishing: a partial
        stream must never reach the final path, where its valid footer
        would make the resume guards reuse it as complete."""
        if self.writer is not None:
            self.writer.close()
            self.writer = None
            if os.path.exists(self._tmp):
                os.remove(self._tmp)
            print(f"Aborted streaming to {self.filename} "
                  f"(partial output discarded)")

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        # publishing on exception would hand the resume guards a
        # truncated-but-footered parquet they'd silently reuse
        if exc_type is None:
            self.close()
        else:
            self.abort()


def embedding_column_names(table_or_schema) -> list[str]:
    """The embedding_{i} (or token_embedding_{i}) columns in index order."""
    names = (table_or_schema.schema.names
             if hasattr(table_or_schema, "schema") else table_or_schema.names)
    pat = re.compile(r"^(?:token_)?embedding_(\d+)$")
    matches = [(int(m.group(1)), n) for n in names if (m := pat.match(n))]
    matches.sort()
    return [n for _, n in matches]


def table_to_matrix(table: pa.Table, columns: list[str] | None = None) -> np.ndarray:
    """Zero-ish-copy conversion of scalar float columns to a (n, d) float32
    C-order matrix — the counterpart of the reference's
    arrow->cuDF->dlpack->cupy chain (reference: cu_knn.py:206-211)."""
    if columns is None:
        columns = embedding_column_names(table)
    n = table.num_rows
    d = len(columns)
    out = np.empty((n, d), dtype=np.float32)
    for j, name in enumerate(columns):
        col = table.column(name)
        out[:, j] = col.to_numpy(zero_copy_only=False)
    return out


def table_to_colmajor(table: pa.Table, columns: list[str] | None = None) -> np.ndarray:
    """Arrow scalar-column table -> (d, n) float32 C-order matrix (i.e. the
    embedding matrix TRANSPOSED), touching every byte exactly once with
    sequential writes.

    This is the hot host-side conversion: arrow's columnar buffers are
    already (d, n)-shaped, so filling (n, d) directly costs a strided
    scatter per column — measured ~20-30s per 100k x 384 batch on a
    memory-starved host vs ~1-2s for this layout. Callers transpose on
    the device instead."""
    if columns is None:
        columns = embedding_column_names(table)
    n = table.num_rows
    out = np.empty((len(columns), n), dtype=np.float32)
    name_to_j = {c: j for j, c in enumerate(columns)}
    sel = table.select(columns)
    row = 0
    for rb in sel.to_batches():
        nb = rb.num_rows
        for name, col in zip(sel.schema.names, rb.columns):
            j = name_to_j[name]
            out[j, row:row + nb] = col.to_numpy(zero_copy_only=False)
        row += nb
    return out


def read_embeddings_colmajor(data_dir: str, filename: str,
                             count: int | None = None,
                             dimensions: int | None = None) -> np.ndarray:
    """Load an embeddings parquet as a HOST (d, n) float32 matrix (the
    embedding matrix transposed, sequential writes only). Callers stream
    column slices to the device and transpose there — this is how the table
    path keeps bases larger than HBM in host RAM (reference semantics:
    cu_knn.py:205-211 keeps the arrow table on host and copies per batch).

    Row groups stream straight into the preallocated output: a whole-table
    pq.read_table would hold the full corpus TWICE (arrow buffers + the
    matrix — ~122 GB at the 10M x 1536 target) on exactly the host this
    path exists to protect."""
    full = get_full_filename(data_dir, filename)
    pf = pq.ParquetFile(full)
    columns = embedding_column_names(pf.schema_arrow)
    _check_reader_dims(columns, dimensions, filename)
    n = pf.metadata.num_rows if count is None else min(count, pf.metadata.num_rows)
    out = np.empty((len(columns), n), dtype=np.float32)
    name_to_j = {c: j for j, c in enumerate(columns)}
    row = 0
    for rb in pf.iter_batches(batch_size=65536, columns=columns):
        nb = min(rb.num_rows, n - row)
        if nb <= 0:
            break
        for name, col in zip(rb.schema.names, rb.columns):
            out[name_to_j[name], row:row + nb] = \
                col.to_numpy(zero_copy_only=False)[:nb]
        row += nb
    pf.close()
    assert row == n, f"expected {n} rows, read {row} from {filename}"
    return out


def _check_reader_dims(columns, dimensions, filename) -> None:
    """ONE reader-side width check shared by the embedding readers. The
    readers don't know the model, so the 8x allowance (binary-packed
    voyage stores 8 dims per float32 column) is model-agnostic here; the
    model-aware strict check (utils.misc.output_dimension_validity_check)
    runs at the export boundary, where the model name is in scope."""
    if dimensions is not None:
        assert len(columns) == dimensions or dimensions == 8 * len(columns), \
            (f"Expected {dimensions} embedding columns, got {len(columns)} "
             f"in {filename}")


def read_embeddings(data_dir: str, filename: str, count: int | None = None,
                    dimensions: int | None = None) -> np.ndarray:
    """Load the embedding matrix from an embeddings parquet file
    (reference: cu_knn.py:132-148 prep_table + process_batches select)."""
    full = get_full_filename(data_dir, filename)
    schema = pq.read_schema(full)
    columns = embedding_column_names(schema)
    _check_reader_dims(columns, dimensions, filename)
    table = pq.read_table(full, columns=columns)
    if count is not None:
        table = table.slice(0, count)
    return table_to_matrix(table, columns)


def iter_embedding_batches(data_dir: str, filename: str, batch_size: int,
                           count: int | None = None, layout: str = "row",
                           columns: list[str] | None = None,
                           start_row: int = 0):
    """Stream (offset, matrix) batches out-of-core via pyarrow.dataset —
    the reference's cu_knn_ds streaming path (cu_knn_ds.py:181-239).

    layout="row" yields (n, d); layout="col" yields the TRANSPOSED (d, n)
    matrix built with sequential writes only (see table_to_colmajor) for
    callers that relayout on device. `columns` overrides the embedding_{i}
    regex inference (e.g. ColBERT token_embedding_{i} exports).
    `start_row` skips whole row groups below it (resume; the first yield
    may still start earlier when a row group straddles the boundary)."""
    assert layout in ("row", "col")
    to_mat = table_to_matrix if layout == "row" else table_to_colmajor
    rows_of = (lambda m: m.shape[0]) if layout == "row" \
        else (lambda m: m.shape[1])
    full = get_full_filename(data_dir, filename)
    if columns is None:
        schema = pq.read_schema(full)
        columns = embedding_column_names(schema)
    offset = 0
    pending = []
    pending_rows = 0
    # the scanner's batch_size is the size it MATERIALIZES per scan task,
    # and its default batch_readahead keeps ~16 of them in flight — passing
    # a multi-GB target straight through put ~16 x batch_size rows (100+ GB
    # at 1M x 1536) in RAM before the first yield. Keep scanner batches
    # small; `pending` below aggregates them to the caller's batch_size.
    scan_rows = min(batch_size, 65536)
    if start_row > 0:
        # resume path: skip whole row groups below start_row at the READER
        # (scanning from row 0 re-decoded every covered batch on the weak
        # host just to discard it). Yields may still begin
        # before start_row (a straddling row group); callers trim.
        pf = pq.ParquetFile(full)
        md = pf.metadata
        sel, acc_rows = [], 0
        for g in range(md.num_row_groups):
            rows = md.row_group(g).num_rows
            if acc_rows + rows > start_row:
                if not sel:
                    offset = acc_rows
                sel.append(g)
            acc_rows += rows
        if not sel:
            return
        rb_iter = pf.iter_batches(batch_size=scan_rows, columns=columns,
                                  row_groups=sel)
    else:
        ds = pads.dataset(full, format="parquet")
        rb_iter = ds.to_batches(columns=columns, batch_size=scan_rows,
                                batch_readahead=2, fragment_readahead=1)
    for rb in rb_iter:
        pending.append(rb)
        pending_rows += rb.num_rows
        while pending_rows >= batch_size:
            tbl = pa.Table.from_batches(pending)
            head = tbl.slice(0, batch_size)
            rest = tbl.slice(batch_size)
            mat = to_mat(head, columns)
            n_rows = rows_of(mat)
            if count is not None and offset + n_rows >= count:
                # stop AT count: the old `>` test kept decoding the rest
                # of the file when count was an exact batch multiple and
                # then yielded a zero-width batch that crashed the kNN
                # fold
                keep = count - offset
                if keep:
                    mat = mat[:keep] if layout == "row" else mat[:, :keep]
                    yield offset, mat
                return
            yield offset, mat
            offset += n_rows
            pending = rest.to_batches() if rest.num_rows else []
            pending_rows = rest.num_rows
    if pending_rows:
        tbl = pa.Table.from_batches(pending)
        mat = to_mat(tbl, columns)
        n_rows = rows_of(mat)
        if count is not None and offset + n_rows > count:
            keep = count - offset
            mat = mat[:keep] if layout == "row" else mat[:, :keep]
        if rows_of(mat):
            yield offset, mat


def read_and_extract(data_dir, input_parquet, rowcount, dimensions,
                     column_names=None) -> pd.DataFrame:
    """Reference-compatible export reader (parquet_to_format.py:92-108):
    returns a DataFrame of the embedding columns, first `rowcount` rows."""
    full = get_full_filename(data_dir, input_parquet)
    table = pq.read_table(full)
    table = table.slice(0, rowcount)
    if column_names is None:
        column_names = [f"embedding_{i}" for i in range(dimensions)]
    # keep only the embedding columns (drops bookkeeping columns such as
    # doc_id from the maxsim pipeline), preserving embedding order
    keep = [n for n in column_names if n in table.schema.names]
    assert keep, f"none of the expected embedding columns in {full}"
    return table.select(keep).to_pandas()


def read_parquet_to_dataframe(data_dir, filename) -> pd.DataFrame:
    full = get_full_filename(data_dir, filename)
    return pq.read_table(full).to_pandas()


def parquet_row_count(data_dir, filename) -> int:
    full = get_full_filename(data_dir, filename)
    return pq.ParquetFile(full).metadata.num_rows


def write_matrix_to_parquet(filename: str, matrix: np.ndarray,
                            prefix: str = "", chunk_size: int = 100_000) -> None:
    """Stream a (n, k) matrix to parquet in row chunks with stringified
    column names 0..k-1 — the schema the partial kNN results use
    (reference: cu_knn.py:26-51, 278-285). Written PLAIN to
    `<filename>.inprogress` and published with an atomic rename, so a file
    at the final path is always complete."""
    matrix = np.asarray(matrix)
    names = [f"{prefix}{i}" for i in range(matrix.shape[1])]
    arrays = [pa.array(matrix[:, i]) for i in range(matrix.shape[1])]
    table = pa.table(dict(zip(names, arrays)))
    tmp = filename + ".inprogress"
    with pq.ParquetWriter(tmp, table.schema, use_dictionary=False) as writer:
        for start in range(0, matrix.shape[0], chunk_size):
            writer.write_table(table.slice(start, chunk_size))
    os.replace(tmp, filename)


def count_partial_files(partial_dir: str) -> int:
    """Count indices{i}.parquet partial files (reference: merge.py:15-27)."""
    pattern = re.compile(rf"{re.escape(partial_dir)}/indices(\d+)\.parquet")
    files = sorted(glob.glob(f"{partial_dir}/indices*.parquet"))
    return sum(1 for f in files if pattern.match(f))
