"""Partial top-k result merging on the device (counterpart of
core/merge.py).

All partial (distance, index) lists for a query-row batch are stacked and
reduced with one stable selection over the concatenated candidates
(ops/topk.merge_topk_many). Partial files are produced in ascending
base-offset order, so the stable selection keeps lowest-index tie-breaks.
"""

import math

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import torch

from neighborhoodwatch_tpu_torch import resolve_device

from neighborhoodwatch_tpu_torch.io.parquet_io import count_partial_files
from neighborhoodwatch_tpu_torch.ops.topk import merge_topk_many, check_monotonic
from neighborhoodwatch_tpu_torch.utils.naming import (
    get_partial_indices_filename, get_partial_distances_filename,
)

DEFAULT_ROW_BATCH = 10_000_000  # reference merge.py:46


def _strip_rownum(table: pa.Table) -> pa.Table:
    idx = table.schema.get_field_index("RowNum")
    if idx != -1:
        table = table.remove_column(idx)
    return table


def _aligned_chunks(parquet_file, batch_size, dtype):
    """Stream a parquet file as matrices of EXACTLY batch_size rows (last
    one smaller). iter_batches' batch_size is only an upper bound (row-group
    boundaries yield short batches), so chunks are re-packed here to keep
    all partial-file streams aligned."""
    buf, have = [], 0
    for rb in parquet_file.iter_batches(batch_size=batch_size):
        buf.append(rb)
        have += rb.num_rows
        while have >= batch_size:
            tbl = pa.Table.from_batches(buf)
            head, rest = tbl.slice(0, batch_size), tbl.slice(batch_size)
            yield _to_matrix(_strip_rownum(head), dtype)
            buf = rest.to_batches() if rest.num_rows else []
            have = rest.num_rows
    if have:
        yield _to_matrix(_strip_rownum(pa.Table.from_batches(buf)), dtype)


def _to_matrix(table: pa.Table, dtype) -> np.ndarray:
    cols = [table.column(i).to_numpy(zero_copy_only=False)
            for i in range(table.num_columns)]
    return np.stack(cols, axis=1).astype(dtype, copy=False)


def _matrix_table(mat: np.ndarray) -> pa.Table:
    return pa.table({str(j): pa.array(mat[:, j]) for j in range(mat.shape[1])})


def merge_indices_and_distances(data_dir: str, k: int = 100,
                                row_batch_size: int = DEFAULT_ROW_BATCH,
                                device=None) -> None:
    """Merge partial/indices{i}.parquet + distances{i}.parquet into
    partial/final_{indices,distances}.parquet (reference: merge.py:39-114).

    No-op when there are no partial files (the streaming pipeline writes
    finals directly). The selection runs on `device` (None = "cuda")."""
    dev = resolve_device(device)
    file_count = count_partial_files(f"{data_dir}/partial")
    if file_count == 0:
        return

    n_rows = pq.ParquetFile(get_partial_indices_filename(data_dir, 0)).metadata.num_rows
    assert n_rows > 0, \
        (f"partial file 0 ({get_partial_indices_filename(data_dir, 0)}) is "
         f"empty — a crashed producer left a zero-row partial; delete the "
         f"partial directory and rerun the kNN phase")
    batch_size = min(row_batch_size, n_rows)
    batch_count = math.ceil(n_rows / batch_size)

    # ONE streaming pass per partial file. iter_batches yields aligned
    # batch_size row chunks, so peak memory is files x batch_size x k.
    idx_files = [pq.ParquetFile(get_partial_indices_filename(data_dir, i))
                 for i in range(file_count)]
    dist_files = [pq.ParquetFile(get_partial_distances_filename(data_dir, i))
                  for i in range(file_count)]
    # every partial must cover the same query rows as file 0 UP FRONT: a
    # stale larger file from a prior bigger-Q run whose extras align to
    # whole batch_size chunks would pass the per-batch shape assert and
    # its tail rows would be silently dropped; a shorter one would surface
    # as an opaque StopIteration
    for i, (fi, fd) in enumerate(zip(idx_files, dist_files)):
        assert fi.metadata.num_rows == n_rows and \
            fd.metadata.num_rows == n_rows, \
            (f"partial file {i} has {fi.metadata.num_rows} index / "
             f"{fd.metadata.num_rows} distance rows, expected {n_rows} "
             f"(stale partials from a different run? clean the partial "
             f"directory and rerun)")
    idx_writer = None
    dist_writer = None
    try:
        idx_iters = [_aligned_chunks(f, batch_size, np.int32)
                     for f in idx_files]
        dist_iters = [_aligned_chunks(f, batch_size, np.float32)
                      for f in dist_files]
        for _ in range(batch_count):
            idxs = [next(it) for it in idx_iters]
            dists = [next(it) for it in dist_iters]
            assert len({m.shape for m in idxs}) == 1, \
                "partial index files disagree on row-batch shape"
            stack_d = np.stack(dists)  # (F, rows, k_partial)
            stack_i = np.stack(idxs)
            k_out = min(k, stack_d.shape[0] * stack_d.shape[2])
            d, ix = merge_topk_many(torch.from_numpy(stack_d).to(dev),
                                    torch.from_numpy(stack_i).to(dev), k_out)
            d, ix = d.cpu().numpy(), ix.cpu().numpy()
            assert check_monotonic(d), "merged distances not monotonically nondecreasing"

            idx_table = _matrix_table(ix)
            dist_table = _matrix_table(d)
            if idx_writer is None:
                # PLAIN like every other writer here: mostly-distinct
                # float distances / int indices dictionary-encode to +50%
                # size and 5-10x slower decode, and the streaming path
                # writes the SAME logical finals PLAIN via
                # write_matrix_to_parquet
                idx_writer = pq.ParquetWriter(
                    get_partial_indices_filename(data_dir, -1),
                    idx_table.schema, use_dictionary=False)
                dist_writer = pq.ParquetWriter(
                    get_partial_distances_filename(data_dir, -1),
                    dist_table.schema, use_dictionary=False)
            idx_writer.write_table(idx_table)
            dist_writer.write_table(dist_table)
    finally:
        if idx_writer is not None:
            idx_writer.close()
        if dist_writer is not None:
            dist_writer.close()
        for f in idx_files + dist_files:
            f.close()
