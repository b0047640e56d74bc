"""Output-tree path and file naming scheme.

Byte-identical naming contract with the reference implementation
(reference: neighborhoodwatch/nw_utils.py:62-154) so that downstream ANN
benchmark consumers find files at identical paths:

    <data_dir>/<model_prefix>/q{Q}_b{B}_k{K}/
        <model>_<dim>[_<dtype>]_query_vector_data_<Q>.parquet
        <model>_<dim>[_<dtype>]_base_vector_data_<B>.parquet
        partial/indices{i}.parquet, partial/distances{i}.parquet
        partial/final_indices.parquet, partial/final_distances.parquet
        <model>_<dim>[_<dtype>]_query_vectors_<Q>.fvec
        <model>_<dim>[_<dtype>]_base_vectors_<B>.fvec
        <model>_<dim>[_<dtype>]_indices_b<B>_q<Q>_k<K>.ivec
        <model>_<dim>[_<dtype>]_distances_b<B>_q<Q>_k<K>.fvec
        <model>_<dim>[_<dtype>]_base_<B>_query_<Q>_k<K>.hdf5
"""

import os


def get_full_filename(data_dir: str, filename: str) -> str:
    """Prefix `filename` with `data_dir` unless already prefixed
    (reference: nw_utils.py:26-30)."""
    if not filename.startswith(data_dir):
        return f"{data_dir}/{filename}"
    return filename


def get_model_prefix(model_name: str | None) -> str:
    """Filesystem-safe model prefix (reference: nw_utils.py:33-38)."""
    if model_name:
        return model_name.replace("/", "_")
    return "text-embedding-ada-002"


def get_model_data_homedir(output_homedir, model_name, query_count, base_count, k):
    """Per-run output directory (reference: nw_utils.py:62-64)."""
    model_prefix = get_model_prefix(model_name)
    return f"{output_homedir}/{model_prefix}/q{query_count}_b{base_count}_k{k}"


def setup_model_output_folder(output_homedir, model_name, query_count, base_count, k):
    """Create the output tree incl. partial/ (reference: nw_utils.py:67-73)."""
    data_dir = get_model_data_homedir(output_homedir, model_name, query_count, base_count, k)
    partial_data_dir = f"{data_dir}/partial"
    os.makedirs(partial_data_dir, exist_ok=True)
    return data_dir


def _vector_data_base(model_name, row_count, kind, output_dimension=None, output_dtype=None):
    safe = model_name.replace("/", "_")
    if output_dtype is not None:
        return f"{safe}_{output_dimension}_{output_dtype}_{kind}_vector_data_{row_count}"
    return f"{safe}_{output_dimension}_{kind}_vector_data_{row_count}"


def get_source_query_dataset_filename(homedir, model_name, row_count,
                                      output_dimension=None, output_dtype=None):
    """Query embeddings parquet path (reference: nw_utils.py:76-82)."""
    base = _vector_data_base(model_name, row_count, "query", output_dimension, output_dtype)
    return f"{homedir}/{base}.parquet"


def get_source_base_dataset_filename(homedir, model_name, row_count,
                                     output_dimension=None, output_dtype=None):
    """Base embeddings parquet path (reference: nw_utils.py:85-91)."""
    base = _vector_data_base(model_name, row_count, "base", output_dimension, output_dtype)
    return f"{homedir}/{base}.parquet"


def get_partial_indices_filename(homedir: str, partial_set_cnt: int) -> str:
    """Partial / final indices parquet; sentinel -1 selects the merged final
    file (reference: nw_utils.py:94-99)."""
    if partial_set_cnt == -1:
        return f"{homedir}/partial/final_indices.parquet"
    return f"{homedir}/partial/indices{partial_set_cnt}.parquet"


def get_partial_distances_filename(homedir: str, partial_set_cnt: int) -> str:
    """Partial / final distances parquet (reference: nw_utils.py:102-107)."""
    if partial_set_cnt == -1:
        return f"{homedir}/partial/final_distances.parquet"
    return f"{homedir}/partial/distances{partial_set_cnt}.parquet"


def get_ivec_fvec_filenames(homedir, model_name, dimensions, base_count,
                            query_count, k, output_dtype=None):
    """The 4 export filenames (reference: nw_utils.py:110-139)."""
    safe = model_name.replace("/", "_")
    if output_dtype is not None:
        stem = f"{safe}_{dimensions}_{output_dtype}"
    else:
        stem = f"{safe}_{dimensions}"
    query_vector_fvec = f"{stem}_query_vectors_{query_count}.fvec"
    base_vector_fvec = f"{stem}_base_vectors_{base_count}.fvec"
    indices_ivec = f"{stem}_indices_b{base_count}_q{query_count}_k{k}.ivec"
    distances_fvec = f"{stem}_distances_b{base_count}_q{query_count}_k{k}.fvec"
    return (get_full_filename(homedir, query_vector_fvec),
            get_full_filename(homedir, base_vector_fvec),
            get_full_filename(homedir, indices_ivec),
            get_full_filename(homedir, distances_fvec))


def get_hdf5_filename(homedir, model_name, dimensions, base_count,
                      query_count, k, output_dtype=None):
    """hdf5 export filename (reference: nw_utils.py:142-154)."""
    safe = model_name.replace("/", "_")
    if output_dtype is not None:
        stem = f"{safe}_{dimensions}_{output_dtype}_base_{base_count}_query_{query_count}_k{k}"
    else:
        stem = f"{safe}_{dimensions}_base_{base_count}_query_{query_count}_k{k}"
    return get_full_filename(homedir, f"{stem}.hdf5")
