"""HDF5 ground-truth file writer.

Group layout identical to the reference (parquet_to_format.py:322-348):
one file holding datasets `train` (base vectors), `test` (query vectors),
`neighbors` (indices), `distances`, with append-mode group-level no-op for
resume, plus the Voyage output_dtype mapping and `encoding` attrs.

h5py is imported where a file is touched, so the rest of the export path
(fvec/ivec) runs on machines without it.
"""

import os

import numpy as np

from neighborhoodwatch_tpu_torch.utils.naming import get_full_filename


def write_hdf5(data_dir, model_name, data, filename, group, output_dtype=None):
    """Write one group. `data` may be a numpy array or DataFrame.

    No-op if the group already exists (resume idempotency,
    reference: parquet_to_format.py:325-327)."""
    import h5py
    if hasattr(data, "values"):
        data = data.values
    data = np.asarray(data)
    full_filename = get_full_filename(data_dir, filename)
    with h5py.File(full_filename, "a") as f:
        if group in f:
            print(f"Group '{group}' already exists in file '{full_filename}'")
            return
        if output_dtype is None:
            f.create_dataset(group, data=data)
            return
        # Only Voyage models support non-float output dtypes
        # (reference: parquet_to_format.py:329-348).
        assert model_name.startswith("voyage")
        if output_dtype == "float":
            t = np.float32
        elif output_dtype in ("int8", "binary"):
            t = np.int8
        elif output_dtype in ("uint8", "ubinary"):
            t = np.uint8
        else:
            raise ValueError(f"unsupported output_dtype: {output_dtype}")
        ds = f.create_dataset(group, data=data, dtype=t)
        if output_dtype == "binary":
            ds.attrs["encoding"] = "binary_int8"
        elif output_dtype == "ubinary":
            ds.attrs["encoding"] = "binary_uint8"


def _voyage_dtype(model_name, output_dtype):
    assert model_name.startswith("voyage")
    if output_dtype == "float":
        return np.float32, None
    if output_dtype in ("int8", "binary"):
        return np.int8, ("binary_int8" if output_dtype == "binary" else None)
    if output_dtype in ("uint8", "ubinary"):
        return np.uint8, ("binary_uint8" if output_dtype == "ubinary" else None)
    raise ValueError(f"unsupported output_dtype: {output_dtype}")


def write_hdf5_slab(data_dir, model_name, batch, filename, group,
                    total_rows, offset, output_dtype=None) -> bool:
    """Streamed variant of write_hdf5: creates the (total_rows, dim)
    dataset on the first slab and fills `batch` at `offset`, so 10M-row
    exports never hold the full matrix in host memory. Returns False
    (no-op) if the group already existed before this export began."""
    import h5py
    batch = np.asarray(batch.values if hasattr(batch, "values") else batch)
    full_filename = get_full_filename(data_dir, filename)
    with h5py.File(full_filename, "a") as f:
        ds = f.get(group)
        if ds is not None:
            if ds.attrs.get("_streaming") != 1:
                print(f"Group '{group}' already exists in file "
                      f"'{full_filename}'")
                return False
            if offset == 0:
                # leftover marker from a crashed export: the dataset is
                # partially filled, not complete — restart from scratch
                # rather than silently keeping zero rows past the crash
                print(f"Group '{group}' is an incomplete streamed export "
                      f"in '{full_filename}'; recreating")
                del f[group]
                ds = None
            # else: resuming export continues filling the open stream
        if ds is None:
            if output_dtype is None:
                t, enc = batch.dtype, None
            else:
                t, enc = _voyage_dtype(model_name, output_dtype)
            ds = f.create_dataset(group, shape=(total_rows, batch.shape[1]),
                                  dtype=t)
            ds.attrs["_streaming"] = 1
            if enc:
                ds.attrs["encoding"] = enc
        ds[offset:offset + len(batch)] = batch
        if offset + len(batch) >= total_rows:
            del ds.attrs["_streaming"]     # complete: future runs no-op
    return True


def hdf5_group_exists(data_dir, filename, group) -> bool:
    """Non-mutating probe for write_hdf5's group-level no-op: lets export
    callers skip a whole-parquet read when both the fvec and the hdf5
    group already exist (a COMPLETE group only — a mid-stream slab still
    carrying write_hdf5_slab's "_streaming" crash marker must be
    re-driven, so it does not count)."""
    import h5py
    full_filename = get_full_filename(data_dir, filename)
    if not os.path.exists(full_filename):
        return False
    try:
        with h5py.File(full_filename, "r") as f:
            return group in f and "_streaming" not in f[group].attrs
    except OSError:
        return False


def read_hdf5_group(data_dir, filename, group) -> np.ndarray:
    """One dataset of the file as an array."""
    import h5py
    full_filename = get_full_filename(data_dir, filename)
    with h5py.File(full_filename, "r") as f:
        return np.asarray(f[group])


def find_duplicates(filename, groups=("train", "test")) -> dict:
    """Duplicate rows per group present in the file: {group: {"rows",
    "duplicate_groups" (distinct rows seen more than once),
    "duplicate_rows" (copies beyond the first)}}."""
    import h5py
    report = {}
    with h5py.File(filename, "r") as f:
        for group in groups:
            if group not in f:
                continue
            data = np.asarray(f[group])
            _, counts = np.unique(data, axis=0, return_counts=True)
            dupes = int((counts > 1).sum())
            report[group] = {
                "rows": int(data.shape[0]),
                "duplicate_groups": dupes,
                "duplicate_rows": int(counts[counts > 1].sum() - dupes),
            }
    return report
