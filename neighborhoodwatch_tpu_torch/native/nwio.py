"""ctypes bindings of the native fvec/ivec IO engine (native/nwio.cpp).

io/fvec.py takes these paths where `available()` holds and its numpy codec
elsewhere; both write the same bytes and read the same arrays. The library
is built at first use (native/build.py) and loaded once per process.
`NW_TPU_NATIVE=0` in the environment turns the engine off (read at every
call, so one process can run both codecs); without a C++ compiler it is
off too. A compile error raises.
"""

import ctypes
import os
import threading

import numpy as np

from neighborhoodwatch_tpu_torch.native import build

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_i64, c_i32, c_void = ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p
    lib.nwio_fvec_probe.restype = ctypes.c_int
    lib.nwio_fvec_probe.argtypes = [ctypes.c_char_p, ctypes.POINTER(c_i64),
                                    ctypes.POINTER(c_i32)]
    lib.nwio_fvec_read_rows.restype = c_i64
    lib.nwio_fvec_read_rows.argtypes = [ctypes.c_char_p, c_i64, c_i64,
                                        c_void, ctypes.c_int, c_i32]
    lib.nwio_fvec_write_rows.restype = c_i64
    lib.nwio_fvec_write_rows.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                         c_void, c_i64, c_i32]
    lib.nwio_stream_open.restype = c_void
    lib.nwio_stream_open.argtypes = [ctypes.c_char_p, c_i64, ctypes.c_int,
                                     c_i32]
    lib.nwio_stream_next.restype = c_i64
    lib.nwio_stream_next.argtypes = [c_void, c_void]
    lib.nwio_stream_close.restype = None
    lib.nwio_stream_close.argtypes = [c_void]
    return lib


def _load() -> ctypes.CDLL | None:
    global _lib
    if os.environ.get("NW_TPU_NATIVE", "1") == "0":
        return None
    with _lock:
        if _lib is None:
            path = build.build()
            if path is None:
                return None
            _lib = _declare(ctypes.CDLL(path))
        return _lib


def available() -> bool:
    return _load() is not None


def _lib_or_raise() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("the native IO engine is off (NW_TPU_NATIVE=0) "
                           "or has no C++ compiler to build it")
    return lib


def probe(path: str):
    """(n_rows, dim) of a homogeneous fvec/ivec file, or None when the file
    is missing or its size is not a whole number of rows (the numpy codec
    then reads it and reports what is wrong)."""
    n, dim = ctypes.c_int64(), ctypes.c_int32()
    rc = _lib_or_raise().nwio_fvec_probe(path.encode(), ctypes.byref(n),
                                         ctypes.byref(dim))
    return None if rc != 0 else (n.value, dim.value)


def read_rows(path: str, row_start: int, n_rows: int, dim: int,
              payload_dtype, n_threads: int | None = None) -> np.ndarray:
    """Rows [row_start, row_start + n_rows) as an (n_rows, dim) array, read
    by up to `n_threads` threads (default min(8, cores))."""
    if n_threads is None:
        n_threads = min(8, os.cpu_count() or 1)
    out = np.empty((n_rows, dim), dtype=payload_dtype)
    assert out.itemsize == 4
    # dim rides the ABI: the native side refuses a file whose width is not
    # this buffer's
    got = _lib_or_raise().nwio_fvec_read_rows(
        path.encode(), row_start, n_rows, out.ctypes.data_as(ctypes.c_void_p),
        n_threads, dim)
    if got == -7:
        raise IOError(f"nwio_fvec_read_rows({path}): file dim != {dim} "
                      f"(file changed since probe?)")
    if got != n_rows:
        raise IOError(f"nwio_fvec_read_rows({path}) -> {got}, wanted "
                      f"{n_rows}")
    return out


def write_rows(path: str, data: np.ndarray, append: bool = False) -> None:
    """Write (or append) a 2-D array of 4-byte words as fvec/ivec rows."""
    data = np.ascontiguousarray(data)
    if data.ndim != 2 or data.itemsize != 4:
        raise ValueError(f"expected a 2-D array of 4-byte words, got "
                         f"{data.shape} {data.dtype}")
    n, dim = data.shape
    got = _lib_or_raise().nwio_fvec_write_rows(
        path.encode(), int(append), data.ctypes.data_as(ctypes.c_void_p), n,
        dim)
    if got != n:
        raise IOError(f"nwio_fvec_write_rows({path}) -> {got}, wanted {n}")


class FvecStream:
    """Single-pass batch reader over an fvec/ivec file: the native producer
    thread reads batch b+1 while the consumer works on batch b. Yields
    (offset, (rows, dim) array); each batch is a fresh array, so a consumer
    may keep it or copy it to the card synchronously. An empty file yields
    nothing; a second pass raises. Close it by exhausting it, with `with`,
    `close()`, or by dropping it."""

    def __init__(self, path: str, batch_rows: int, payload_dtype,
                 n_threads: int | None = None):
        self._handle = None          # first: __del__ runs on any path
        self._lib = _lib_or_raise()
        info = probe(path)
        if info is None:
            raise IOError(f"cannot stream {path}")
        self.n_rows, self.dim = info
        self.batch_rows = batch_rows
        self.payload_dtype = payload_dtype
        if self.n_rows == 0:
            return                   # the native opener refuses empty files
        # self.dim rides the ABI: the opener probes the file again and
        # refuses another width than this object's buffers have
        self._handle = self._lib.nwio_stream_open(
            path.encode(), batch_rows,
            n_threads or min(4, os.cpu_count() or 1), self.dim)
        if not self._handle:
            raise IOError(f"nwio_stream_open({path}) failed (missing or "
                          f"empty file, or dim != {self.dim}: file changed "
                          f"since probe?)")

    def __iter__(self):
        if self.n_rows == 0:
            return
        if self._handle is None:
            raise IOError("FvecStream already consumed/closed: construct a "
                          "new stream for another pass")
        offset = 0
        try:
            while True:
                buf = np.empty((self.batch_rows, self.dim),
                               dtype=self.payload_dtype)
                got = self._lib.nwio_stream_next(
                    self._handle, buf.ctypes.data_as(ctypes.c_void_p))
                if got < 0:
                    raise IOError(f"nwio_stream_next -> {got}")
                if got == 0:
                    break
                yield offset, buf[:got]
                offset += got
        finally:
            self.close()

    def close(self) -> None:
        if self._handle:
            self._lib.nwio_stream_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()
