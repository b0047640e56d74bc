"""fvec / ivec binary codecs (numpy; counterpart of io/fvec.py without its
optional native C++ engine).

Byte layout (little-endian), per vector: int32 dim | dim * 4-byte payload
(float32 for fvec, int32 for ivec). Reading and writing go through one
numpy buffer view, byte-identical to a per-row struct loop.
"""

import os
import struct

import numpy as np

from neighborhoodwatch_tpu_torch.utils.naming import get_full_filename


def _type_char_for(filename: str) -> str:
    # ".ivecs" is the texmex-standard plural spelling external tools write
    return "i" if filename.endswith(("ivec", "ivecs")) else "f"


def _payload_dtype(type_char: str) -> np.dtype:
    return np.dtype("<i4") if type_char == "i" else np.dtype("<f4")


def _rows_buffer(data: np.ndarray, type_char: str) -> np.ndarray:
    n, dim = data.shape
    data = np.ascontiguousarray(data.astype(_payload_dtype(type_char),
                                            copy=False))
    buf = np.empty((n, dim + 1), dtype=np.dtype("<i4"))
    buf[:, 0] = np.int32(dim)
    # reinterpret the payload as raw int32 words: one contiguous write
    buf[:, 1:] = data.view(np.dtype("<i4"))
    return buf


def write_vectors(filename: str, data: np.ndarray,
                  type_char: str | None = None) -> None:
    """Write a (n, dim) array as fvec/ivec."""
    data = np.asarray(data)
    assert data.ndim == 2, f"expected (n, dim) array, got shape {data.shape}"
    if type_char is None:
        type_char = _type_char_for(filename)
    with open(filename, "wb") as f:
        _rows_buffer(data, type_char).tofile(f)


def append_vectors(filename: str, data: np.ndarray,
                   type_char: str | None = None) -> None:
    """Append rows to an existing fvec/ivec file (streamed export)."""
    data = np.asarray(data)
    if type_char is None:
        type_char = _type_char_for(filename)
    with open(filename, "ab") as f:
        _rows_buffer(data, type_char).tofile(f)


def read_vectors(filename: str, dtype=None) -> np.ndarray:
    """Read a whole fvec/ivec file into a (n, dim) array (all rows must
    share one dimension, as in every file this package writes)."""
    payload_dtype = _payload_dtype(_type_char_for(filename))
    size = os.path.getsize(filename)
    if size == 0:
        return np.empty((0, 0), dtype=payload_dtype)
    with open(filename, "rb") as f:
        dim = struct.unpack("<i", f.read(4))[0]
        f.seek(0)
        row_bytes = 4 * (dim + 1)
        assert size % row_bytes == 0, \
            f"{filename}: size {size} not a multiple of row bytes {row_bytes}"
        n = size // row_bytes
        raw = np.fromfile(f, dtype=np.dtype("<i4"), count=n * (dim + 1))
    raw = raw.reshape(n, dim + 1)
    assert (raw[:, 0] == dim).all(), f"{filename}: inconsistent per-row dims"
    out = raw[:, 1:].view(payload_dtype)
    return out.astype(dtype) if dtype is not None else out


def read_selected(filename: str, row_ids) -> np.ndarray:
    """Read only `row_ids` (any order, duplicates allowed) with one
    sequential chunked scan: memory stays O(selected + chunk)."""
    row_ids = np.asarray(row_ids, dtype=np.int64)
    uniq, inverse = np.unique(row_ids, return_inverse=True)
    payload_dtype = _payload_dtype(_type_char_for(filename))
    size = os.path.getsize(filename)
    with open(filename, "rb") as f:
        dim = struct.unpack("<i", f.read(4))[0]
        row_bytes = 4 * (dim + 1)
        n = size // row_bytes
        assert uniq.size == 0 or (0 <= uniq[0] and uniq[-1] < n), \
            f"row id out of range for {filename} ({n} rows)"
        out = np.empty((uniq.size, dim), dtype=payload_dtype)
        chunk_rows = max(1, (64 << 20) // row_bytes)
        got = 0
        for start in range(0, n, chunk_rows):
            lo = np.searchsorted(uniq, start)
            hi = np.searchsorted(uniq, min(start + chunk_rows, n))
            if lo == hi:
                continue
            f.seek(start * row_bytes)
            count = min(chunk_rows, n - start)
            raw = np.fromfile(f, dtype=np.dtype("<i4"),
                              count=count * (dim + 1)).reshape(count, dim + 1)
            sel = raw[uniq[lo:hi] - start]
            assert (sel[:, 0] == dim).all(), \
                f"{filename}: inconsistent per-row dims in selected rows"
            out[lo:hi] = sel[:, 1:].view(payload_dtype)
            got += hi - lo
            if got == uniq.size:
                break
    return out[inverse].reshape(*row_ids.shape, dim)


def count_vectors(data_dir: str, filename: str) -> int:
    """Number of vectors in the file."""
    full_filename = get_full_filename(data_dir, filename)
    size = os.path.getsize(full_filename)
    if size == 0:
        return 0
    with open(full_filename, "rb") as f:
        dim = struct.unpack("<i", f.read(4))[0]
    row_bytes = 4 * (dim + 1)
    if size % row_bytes == 0:
        return size // row_bytes
    # heterogeneous dims: sequential scan
    count = 0
    with open(full_filename, "rb") as f:
        while True:
            hdr = f.read(4)
            if not hdr:
                break
            dim = struct.unpack("<i", hdr)[0]
            f.seek(4 * dim, 1)
            count += 1
    return count


def get_nth_vector(data_dir: str, filename: str, n: int):
    """Random-access single-vector read, returned as a tuple."""
    full_filename = get_full_filename(data_dir, filename)
    format_char = _type_char_for(full_filename)
    with open(full_filename, "rb") as f:
        dimension = struct.unpack("<i", f.read(4))[0]
        f.seek(int(4 * n * (1 + dimension)), 1)
        assert os.path.getsize(full_filename) >= f.tell() + 4 * dimension, \
            "file size is less than expected"
        return struct.unpack("<" + format_char * dimension,
                             f.read(4 * dimension))


def get_first_vector(data_dir: str, filename: str):
    return get_nth_vector(data_dir, filename, 0)


def write_ivec_fvec_from_dataframe(data_dir, model_name, filename, df,
                                   type_char, num_columns) -> None:
    """DataFrame-input writer: a trailing RowNum column is dropped and the
    width checked against the model's dimension contract."""
    from neighborhoodwatch_tpu_torch.utils.misc import (
        output_dimension_validity_check,
    )

    full_filename = get_full_filename(data_dir, filename)
    values = df.values
    if values.shape[1] == num_columns + 1:
        values = values[:, :-1]  # trailing RowNum column
    assert output_dimension_validity_check(model_name, num_columns,
                                           values.shape[1]), \
        (f"Expected {num_columns} values, got {values.shape[1]} for model "
         f"{model_name} [filename: {filename}]")
    write_vectors(full_filename, values, type_char)
