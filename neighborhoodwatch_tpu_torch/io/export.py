"""Export orchestrator: parquet -> fvec/ivec/hdf5 ground-truth files.

Capability parity with the reference's generate_output_files
(parquet_to_format.py:111-319): produces the 4 fvec/ivec files plus the
hdf5 file with train/test/neighbors/distances groups, idempotent via
empty-file checks, and reports counts/dims read back from the written
files. Writing is vectorized (io/fvec.py) instead of per-row struct packing.
"""

import os

from neighborhoodwatch_tpu_torch.io import fvec
from neighborhoodwatch_tpu_torch.io.hdf5_io import (
    hdf5_group_exists, write_hdf5, write_hdf5_slab,
)
from neighborhoodwatch_tpu_torch.io.parquet_io import (
    iter_embedding_batches, read_and_extract, read_parquet_to_dataframe,
)
from neighborhoodwatch_tpu_torch.utils.naming import (
    get_full_filename, get_hdf5_filename, get_ivec_fvec_filenames,
)

# base exports above this row count stream parquet batches instead of
# materializing the full (n, d) matrix (10M x 1536 would be 61GB of host
# memory in the reference's whole-DataFrame approach)
STREAMING_ROWS = 262_144


def is_empty_file(filename: str) -> bool:
    """(reference: parquet_to_format.py:111-112)"""
    return not os.path.exists(filename) or os.path.getsize(filename) == 0


def _needs(data_dir, out_file, output_hdf5, hdf5_file, group):
    """(need_fvec, need_hdf5) — probed BEFORE reading the input parquet:
    on an idempotent rerun with both artifacts complete, the exporters
    must not decode a multi-GB parquet just to print 'already exists'."""
    need_fvec = is_empty_file(out_file)
    if not need_fvec:
        print(f"File {out_file} already exists")
    need_h5 = output_hdf5 and not hdf5_group_exists(data_dir, hdf5_file, group)
    return need_fvec, need_h5


def generate_query_vectors_fvec(data_dir, model_name, input_parquet, query_count,
                                dimensions, query_vectors_fvec_file,
                                output_hdf5=True, column_names=None, hdf5_file=None,
                                output_dtype=None):
    need_fvec, need_h5 = _needs(data_dir, query_vectors_fvec_file,
                                output_hdf5, hdf5_file, "test")
    if not (need_fvec or need_h5):
        return
    df = read_and_extract(data_dir, input_parquet, query_count, dimensions, column_names)
    if need_fvec:
        fvec.write_ivec_fvec_from_dataframe(
            data_dir, model_name, query_vectors_fvec_file, df, "f", dimensions)
    if output_hdf5:
        write_hdf5(data_dir, model_name, df, hdf5_file, "test", output_dtype)


def generate_base_vectors_fvec(data_dir, model_name, input_parquet, base_count,
                               dimensions, base_vectors_fvec_file,
                               output_hdf5=True, column_names=None, hdf5_file=None,
                               output_dtype=None):
    if base_count > STREAMING_ROWS:
        return _generate_base_vectors_streaming(
            data_dir, model_name, input_parquet, base_count, dimensions,
            base_vectors_fvec_file, output_hdf5, column_names, hdf5_file,
            output_dtype)
    need_fvec, need_h5 = _needs(data_dir, base_vectors_fvec_file,
                                output_hdf5, hdf5_file, "train")
    if not (need_fvec or need_h5):
        return
    df = read_and_extract(data_dir, input_parquet, base_count, dimensions, column_names)
    if need_fvec:
        fvec.write_ivec_fvec_from_dataframe(
            data_dir, model_name, base_vectors_fvec_file, df, "f", dimensions)
    if output_hdf5:
        write_hdf5(data_dir, model_name, df, hdf5_file, "train", output_dtype)


def _generate_base_vectors_streaming(data_dir, model_name, input_parquet,
                                     base_count, dimensions,
                                     base_vectors_fvec_file,
                                     output_hdf5, column_names, hdf5_file,
                                     output_dtype,
                                     batch_rows: int = 131_072):
    """Out-of-core base export: parquet batches append to the fvec file
    and fill a preallocated hdf5 dataset slab by slab."""
    full_fvec = get_full_filename(data_dir, base_vectors_fvec_file)
    # crash-safe completeness: batches append into a ".streaming" temp,
    # atomically renamed after the LAST batch — so a non-empty final fvec
    # is always complete, never a silently truncated artifact of a killed
    # export (the fvec analog of write_hdf5_slab's "_streaming" marker).
    # A stale temp from a killed run is overwritten at offset 0.
    tmp_fvec = full_fvec + ".streaming"
    # probe BOTH artifacts before any parquet decode, like _needs does for
    # the non-streaming exporters — a completed idempotent rerun used to
    # decode the first multi-GB batch just to learn there was nothing to
    # do
    need_fvec = is_empty_file(full_fvec)
    if not need_fvec:
        print(f"File {base_vectors_fvec_file} already exists")
    hdf5_live = output_hdf5 and not hdf5_group_exists(data_dir, hdf5_file,
                                                      "train")
    if not (need_fvec or hdf5_live):
        return
    # clamp to the rows that actually exist: with a short source parquet
    # the hdf5 slab's total_rows was never reached, its "_streaming"
    # incompleteness marker never cleared, and every rerun re-streamed
    # the whole export forever (the compute paths clamp the
    # same way)
    from neighborhoodwatch_tpu_torch.io.parquet_io import parquet_row_count
    total = min(base_count, parquet_row_count(data_dir, input_parquet))
    if total < base_count:
        print(f"  [warn] {input_parquet} holds only {total} rows; "
              f"exporting {total} (requested {base_count})")
    for offset, mat in iter_embedding_batches(data_dir, input_parquet,
                                              batch_size=batch_rows,
                                              count=total,
                                              columns=column_names):
        # the non-streaming path enforces this through
        # write_ivec_fvec_from_dataframe's dimension validity check; a
        # width mismatch here would silently export files contradicting
        # the `_<dims>_` in their own names. Model-aware:
        # binary-packed voyage stores 8 dims per column (a plain ==
        # rejected exports the non-streaming path accepts)
        from neighborhoodwatch_tpu_torch.utils.misc import (
            output_dimension_validity_check,
        )
        assert output_dimension_validity_check(model_name, dimensions,
                                               mat.shape[1]), \
            (f"{input_parquet} embedding width {mat.shape[1]} != configured "
             f"dimensions {dimensions}")
        if need_fvec:
            if offset == 0:
                fvec.write_vectors(tmp_fvec, mat, "f")
            else:
                fvec.append_vectors(tmp_fvec, mat, "f")
        if hdf5_live:
            hdf5_live = write_hdf5_slab(data_dir, model_name, mat, hdf5_file,
                                        "train", total, offset,
                                        output_dtype)
        if not need_fvec and not hdf5_live:
            break
    if need_fvec and os.path.exists(tmp_fvec):
        os.replace(tmp_fvec, full_fvec)


def generate_indices_ivec(data_dir, model_name, input_parquet, k,
                          indices_ivec_file, output_hdf5=True, hdf5_file=None):
    need_fvec, need_h5 = _needs(data_dir, indices_ivec_file,
                                output_hdf5, hdf5_file, "neighbors")
    if not (need_fvec or need_h5):
        return
    df = read_parquet_to_dataframe(data_dir, input_parquet)
    if need_fvec:
        fvec.write_ivec_fvec_from_dataframe(
            data_dir, model_name, indices_ivec_file, df, "i", k)
    if output_hdf5:
        write_hdf5(data_dir, model_name, df, hdf5_file, "neighbors")


def generate_distances_fvec(data_dir, model_name, input_parquet, k,
                            distances_fvec_file, output_hdf5=True, hdf5_file=None):
    need_fvec, need_h5 = _needs(data_dir, distances_fvec_file,
                                output_hdf5, hdf5_file, "distances")
    if not (need_fvec or need_h5):
        return
    df = read_parquet_to_dataframe(data_dir, input_parquet)
    if need_fvec:
        fvec.write_ivec_fvec_from_dataframe(
            data_dir, model_name, distances_fvec_file, df, "f", k)
    if output_hdf5:
        write_hdf5(data_dir, model_name, df, hdf5_file, "distances")


def generate_output_files(data_dir, model_name, dimensions, base_vectors_parquet,
                          query_vectors_parquet, base_count, query_count,
                          final_indices_parquet, final_distances_parquet, k,
                          output_hdf5=True, column_names=None, output_dtype=None):
    """Produce and report the 4 fvec/ivec files + hdf5
    (reference: parquet_to_format.py:213-319)."""
    (query_vector_fvec_file, base_vector_fvec_file,
     indices_ivec_file, distances_fvec_file) = get_ivec_fvec_filenames(
        data_dir, model_name, dimensions, base_count, query_count, k, output_dtype)
    hdf5_filename = get_hdf5_filename(
        data_dir, model_name, dimensions, base_count, query_count, k, output_dtype)

    generate_query_vectors_fvec(data_dir, model_name, query_vectors_parquet,
                                query_count, dimensions, query_vector_fvec_file,
                                output_hdf5, column_names, hdf5_filename,
                                output_dtype)
    _report(data_dir, query_vector_fvec_file, "query vector")

    generate_base_vectors_fvec(data_dir, model_name, base_vectors_parquet,
                               base_count, dimensions, base_vector_fvec_file,
                               output_hdf5, column_names, hdf5_filename,
                               output_dtype)
    _report(data_dir, base_vector_fvec_file, "base vector")

    generate_indices_ivec(data_dir, model_name, final_indices_parquet, k,
                          indices_ivec_file, output_hdf5, hdf5_filename)
    _report(data_dir, indices_ivec_file, "indices")

    generate_distances_fvec(data_dir, model_name, final_distances_parquet, k,
                            distances_fvec_file, output_hdf5, hdf5_filename)
    _report(data_dir, distances_fvec_file, "distances")

    return (query_vector_fvec_file, base_vector_fvec_file,
            indices_ivec_file, distances_fvec_file)


def export_maxsim_doc_maps(data_dir, model_name, dimensions,
                           query_vectors_parquet, base_vectors_parquet,
                           base_count, query_count, k,
                           output_hdf5=True, output_dtype=None):
    """MaxSim-mode artifact completion: the `ck --maxsim` hdf5/fvec exports
    hold flat token rows in `test`/`train` while `neighbors`/`distances`
    are per query *passage*; without the token->passage map a consumer
    could not reconstruct passages from the artifacts alone. This writes
    the maps as first-class artifacts:

    - `<stem>_{query,base}_doc_ids_<n>.ivec`: one 1-d int vector per token
      row (row-aligned with the token fvec files);
    - hdf5 datasets `test_doc_ids`/`train_doc_ids` of shape
      (n_tokens, 1) int32, row-aligned with the `test`/`train` groups, plus
      semantics attrs on `neighbors`/`distances` (`maxsim=1`, neighbors =
      base passage ids, distances = negated MaxSim scores).

    Returns (n_query_docs, n_base_docs) and asserts artifact coherence:
    `neighbors` has one row per query passage and every neighbor id is a
    valid base passage id."""
    import numpy as np
    import pyarrow.parquet as pq

    from neighborhoodwatch_tpu_torch.utils.naming import (
        get_doc_id_map_filenames,
    )

    q_map_file, b_map_file = get_doc_id_map_filenames(
        data_dir, model_name, dimensions, base_count, query_count)
    hdf5_filename = get_hdf5_filename(data_dir, model_name, dimensions,
                                      base_count, query_count, k,
                                      output_dtype)
    n_docs = {}
    for parquet, out, group in (
            (query_vectors_parquet, q_map_file, "test_doc_ids"),
            (base_vectors_parquet, b_map_file, "train_doc_ids")):
        table = pq.read_table(get_full_filename(data_dir, parquet),
                              columns=["doc_id"])
        ids = table.column("doc_id").to_numpy().astype(np.int32)
        n_docs[group] = int(ids.max()) + 1 if len(ids) else 0
        if is_empty_file(out):
            fvec.write_vectors(out, ids[:, None], "i")
        else:
            print(f"File {out} already exists")
        if output_hdf5:
            write_hdf5(data_dir, model_name, ids[:, None], hdf5_filename,
                       group)
        _report(data_dir, out, f"{group.split('_')[0]} doc-id map")

    n_q_docs = n_docs["test_doc_ids"]
    n_b_docs = n_docs["train_doc_ids"]
    if output_hdf5:
        import h5py
        with h5py.File(get_full_filename(data_dir, hdf5_filename), "a") as f:
            f.attrs["maxsim"] = 1
            if "neighbors" in f:
                f["neighbors"].attrs["semantics"] = "base_passage_ids"
                assert f["neighbors"].shape[0] == n_q_docs, \
                    (f"neighbors rows {f['neighbors'].shape[0]} != query "
                     f"passage count {n_q_docs}")
                assert int(np.max(f["neighbors"])) < n_b_docs, \
                    "neighbor id exceeds base passage count"
            if "distances" in f:
                f["distances"].attrs["semantics"] = "negated_maxsim_scores"
                assert f["distances"].shape[0] == n_q_docs
    return n_q_docs, n_b_docs


def _report(data_dir, filename, label):
    full = get_full_filename(data_dir, filename)
    count = fvec.count_vectors(data_dir, filename)
    dim = len(fvec.get_first_vector(data_dir, filename)) if count else 0
    print(f"  {full}: {label} count={count}, width={dim}")
