"""PyTorch port's native fvec/ivec engine (native/nwio.cpp through
native/nwio.py and io/fvec.py) against the JAX package's codec: the same
bytes on write and append, equal arrays on bulk and streamed reads, the
same refusals; then the build itself: four processes building into one
empty directory at once each load a whole library, a compile error
raises, and without a compiler the numpy codec runs.

The JAX side runs its numpy codec (its own tests hold its native codec
byte-identical to it): its native library is built on first use straight
to its final path, which a test here must not race."""

import os
import subprocess
import sys
import time

import numpy as np
import pytest

from neighborhoodwatch_tpu.io import fvec as jfvec
from neighborhoodwatch_tpu.native import nwio as jnwio

from neighborhoodwatch_tpu_torch.io import fvec
from neighborhoodwatch_tpu_torch.native import build, nwio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def engines(monkeypatch):
    """The port's engine on (built here, where g++ is present), the JAX
    package's codec on numpy."""
    if build.compiler() is None:
        pytest.skip("no C++ compiler to build the native engine")
    monkeypatch.delenv("NW_TPU_NATIVE", raising=False)
    monkeypatch.setattr(jnwio, "available", lambda: False)
    assert fvec.codec() == "native"


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_probe_and_bulk_read(tmp_path):
    data = np.random.default_rng(0).standard_normal((257, 384)) \
        .astype(np.float32)
    path = str(tmp_path / "a.fvec")
    jfvec.write_vectors(path, data)
    assert nwio.probe(path) == (257, 384)
    np.testing.assert_array_equal(nwio.read_rows(path, 0, 257, 384,
                                                 np.float32), data)
    np.testing.assert_array_equal(nwio.read_rows(path, 100, 57, 384,
                                                 np.float32), data[100:157])
    np.testing.assert_array_equal(fvec.read_vectors(path),
                                  jfvec.read_vectors(path))


def test_native_write_byte_identical(tmp_path):
    data = np.random.default_rng(1).standard_normal((64, 129)) \
        .astype(np.float32)
    nwio.write_rows(str(tmp_path / "n.fvec"), data)
    jfvec.write_vectors(str(tmp_path / "j.fvec"), data)
    assert _bytes(tmp_path / "n.fvec") == _bytes(tmp_path / "j.fvec")


@pytest.mark.parametrize("ext", ["ivec", "fvec"])
def test_native_append(tmp_path, ext):
    rng = np.random.default_rng(2)
    a, b = (rng.integers(0, 1000, (n, 16)).astype(np.int32)
            if ext == "ivec" else
            rng.standard_normal((n, 16)).astype(np.float32)
            for n in (10, 7))
    port, ref = str(tmp_path / f"p.{ext}"), str(tmp_path / f"j.{ext}")
    fvec.write_vectors(port, a)
    fvec.append_vectors(port, b)
    jfvec.write_vectors(ref, a)
    jfvec.append_vectors(ref, b)
    assert _bytes(port) == _bytes(ref)
    np.testing.assert_array_equal(jfvec.read_vectors(port), np.vstack([a, b]))


def test_fvec_module_uses_native_roundtrip(tmp_path):
    data = np.random.default_rng(3).standard_normal((1000, 77)) \
        .astype(np.float32)
    path = str(tmp_path / "r.fvec")
    fvec.write_vectors(path, data)
    jfvec.write_vectors(str(tmp_path / "j.fvec"), data)
    assert _bytes(path) == _bytes(tmp_path / "j.fvec")
    np.testing.assert_array_equal(fvec.read_vectors(path), data)
    v = fvec.get_nth_vector(str(tmp_path), "r.fvec", 123)
    assert v == jfvec.get_nth_vector(str(tmp_path), "r.fvec", 123)
    np.testing.assert_array_equal(np.asarray(v, np.float32), data[123])


def _batches(mod, path, batch_rows, count=None):
    return [(o, b.copy()) for o, b in
            mod.iter_vector_batches(path, batch_rows, count=count)]


def test_stream_batches(tmp_path):
    data = np.random.default_rng(4).standard_normal((1003, 64)) \
        .astype(np.float32)
    path = str(tmp_path / "s.fvec")
    jfvec.write_vectors(path, data)
    got, want = _batches(fvec, path, 256), _batches(jfvec, path, 256)
    assert [(o, len(b)) for o, b in got] == \
        [(0, 256), (256, 256), (512, 256), (768, 235)]
    for (o, b), (jo, jb) in zip(got, want, strict=True):
        assert o == jo
        np.testing.assert_array_equal(b, jb)
    np.testing.assert_array_equal(np.vstack([b for _, b in got]), data)


def test_stream_with_count_limit(tmp_path):
    data = np.random.default_rng(5).standard_normal((500, 32)) \
        .astype(np.float32)
    path = str(tmp_path / "c.fvec")
    jfvec.write_vectors(path, data)
    for count in (300, 256, 1000):
        got = _batches(fvec, path, 128, count=count)
        want = _batches(jfvec, path, 128, count=count)
        assert [o for o, _ in got] == [o for o, _ in want]
        np.testing.assert_array_equal(np.vstack([b for _, b in got]),
                                      data[:count])


def test_numpy_codec_matches(tmp_path, monkeypatch):
    """NW_TPU_NATIVE=0 turns the engine off in the same process: the same
    bytes written, the same arrays and batches read."""
    rng = np.random.default_rng(6)
    data = rng.standard_normal((200, 48)).astype(np.float32)
    ids = rng.integers(0, 10**6, (200, 9)).astype(np.int32)
    fvec.write_vectors(str(tmp_path / "n.fvec"), data)
    fvec.write_vectors(str(tmp_path / "n.ivec"), ids)
    native = fvec.read_vectors(str(tmp_path / "n.fvec"))
    native_batches = _batches(fvec, str(tmp_path / "n.fvec"), 64)
    monkeypatch.setenv("NW_TPU_NATIVE", "0")
    assert fvec.codec() == "numpy" and not nwio.available()
    fvec.write_vectors(str(tmp_path / "p.fvec"), data)
    fvec.write_vectors(str(tmp_path / "p.ivec"), ids)
    for ext in ("fvec", "ivec"):
        assert _bytes(tmp_path / f"n.{ext}") == _bytes(tmp_path / f"p.{ext}")
    np.testing.assert_array_equal(fvec.read_vectors(str(tmp_path / "n.fvec")),
                                  native)
    numpy_batches = _batches(fvec, str(tmp_path / "n.fvec"), 64)
    for (o, a), (po, b) in zip(native_batches, numpy_batches, strict=True):
        assert o == po
        np.testing.assert_array_equal(a, b)


def test_native_stream_empty_file_matches_numpy(tmp_path):
    path = str(tmp_path / "empty.fvec")
    fvec.write_vectors(path, np.empty((0, 4), np.float32))
    assert _bytes(path) == b""
    assert list(fvec.iter_vector_batches(path, 16)) == [] == \
        list(jfvec.iter_vector_batches(path, 16))
    assert list(nwio.FvecStream(path, 16, np.float32)) == []
    assert fvec.read_vectors(path).shape == jfvec.read_vectors(path).shape


def test_native_stream_context_manager_and_gc(tmp_path):
    mat = np.arange(80, dtype=np.float32).reshape(20, 4)
    path = str(tmp_path / "m.fvec")
    fvec.write_vectors(path, mat)
    with nwio.FvecStream(path, 8, np.float32) as s:
        got = np.vstack([b for _, b in s])
    assert s._handle is None
    np.testing.assert_array_equal(got, mat)
    s2 = nwio.FvecStream(path, 8, np.float32)
    assert s2._handle
    del s2                                  # __del__ closes; no hang
    s3 = nwio.FvecStream(path, 8, np.float32)
    s3.close()
    s3.close()


def test_read_rows_rejects_dim_mismatch(tmp_path):
    path = str(tmp_path / "a.fvec")
    jfvec.write_vectors(path, np.random.default_rng(5)
                        .standard_normal((10, 8)).astype(np.float32))
    assert nwio.read_rows(path, 0, 10, 8, np.dtype("<f4")).shape == (10, 8)
    for wrong in (4, 16):
        with pytest.raises(IOError, match="dim"):
            nwio.read_rows(path, 0, 10, wrong, np.dtype("<f4"))
    with pytest.raises(IOError, match="-6"):
        nwio.read_rows(path, 5, 6, 8, np.dtype("<f4"))


def test_stream_second_pass_raises(tmp_path):
    path = str(tmp_path / "b.fvec")
    fvec.write_vectors(path, np.random.default_rng(6)
                       .standard_normal((7, 4)).astype(np.float32))
    s = nwio.FvecStream(path, 3, np.dtype("<f4"))
    assert [len(b) for _, b in s] == [3, 3, 1]
    with pytest.raises(IOError, match="consumed/closed"):
        list(s)
    empty = str(tmp_path / "e.fvec")
    open(empty, "wb").close()
    se = nwio.FvecStream(empty, 3, np.dtype("<f4"))
    assert list(se) == [] and list(se) == []


def test_stream_open_rejects_dim_mismatch(tmp_path, monkeypatch):
    path = str(tmp_path / "x.fvec")
    fvec.write_vectors(path, np.ones((16, 8), np.float32))
    real_probe = nwio.probe
    monkeypatch.setattr(nwio, "probe",
                        lambda p: (16, 4) if p == path else real_probe(p))
    with pytest.raises(IOError, match="dim != 4"):
        nwio.FvecStream(path, batch_rows=8, payload_dtype=np.float32)


def test_truncated_file_goes_to_numpy_codec(tmp_path):
    """A file whose size is not a whole number of rows: the engine's probe
    refuses it and the numpy codec reports it, as in the JAX package."""
    path = str(tmp_path / "t.fvec")
    fvec.write_vectors(path, np.ones((4, 8), np.float32))
    with open(path, "ab") as f:
        f.write(b"\0\0")
    assert nwio.probe(path) is None
    for mod in (fvec, jfvec):
        with pytest.raises(AssertionError):
            mod.read_vectors(path)
        with pytest.raises(AssertionError):
            list(mod.iter_vector_batches(path, 2))


_WORKER = r"""
import os, sys, time
import numpy as np
from neighborhoodwatch_tpu_torch.native import build
build.BUILD_DIR = sys.argv[1]
from neighborhoodwatch_tpu_torch.io import fvec
rank, out = int(sys.argv[2]), sys.argv[3]
open(os.path.join(out, f"ready.{rank}"), "w").close()
deadline = time.monotonic() + 120
while not os.path.exists(os.path.join(out, "go")):
    assert time.monotonic() < deadline, "no go signal"
    time.sleep(0.005)
assert fvec.codec() == "native"
data = np.random.default_rng(rank).standard_normal((9000, 24)) \
    .astype(np.float32)
path = os.path.join(out, f"{rank}.fvec")
fvec.write_vectors(path, data)
assert np.array_equal(fvec.read_vectors(path), data)
got = np.vstack([b for _, b in fvec.iter_vector_batches(path, 8192)])
assert np.array_equal(got, data)
print(build.library_path())
"""


def test_concurrent_cold_builds(tmp_path):
    """Four processes build into one empty directory at once: each loads a
    whole library and reads its file correctly, one library is left and
    no temporary file."""
    bdir, out = tmp_path / "build", tmp_path / "out"
    out.mkdir()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    env.pop("NW_TPU_NATIVE", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(bdir), str(rank), str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=REPO) for rank in range(4)]
    try:
        deadline = time.monotonic() + 120
        while not all((out / f"ready.{r}").exists() for r in range(4)):
            assert all(p.poll() is None for p in procs), \
                [p.communicate()[0] for p in procs if p.poll() is not None]
            assert time.monotonic() < deadline, "workers did not start"
            time.sleep(0.01)
        assert not bdir.exists()
        (out / "go").touch()
        outs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o
    assert len({o.strip().splitlines()[-1] for o in outs}) == 1
    assert [f.suffix for f in bdir.iterdir()] == [".so"]


def test_compile_error_raises(tmp_path, monkeypatch):
    """A source that does not compile raises with the compiler's stderr,
    from the build and from the codec's first use; nothing falls back to
    numpy and no temporary file is left. An edited source builds a library
    of another name."""
    with open(build.SRC) as f:
        good = f.read()
    shipped = os.path.basename(build.library_path())
    src = tmp_path / "nwio.cpp"
    src.write_text(good + "\n// edited\n")
    monkeypatch.setattr(build, "SRC", str(src))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(nwio, "_lib", None)
    edited = build.build()
    assert os.path.basename(edited) != shipped
    src.write_text(good + "\nint broken( {\n")
    with pytest.raises(RuntimeError, match="error"):
        build.build()
    path = str(tmp_path / "x.fvec")
    with pytest.raises(RuntimeError, match="nwio.cpp"):
        fvec.write_vectors(path, np.ones((3, 4), np.float32))
    assert not os.path.exists(path)
    assert sorted(os.listdir(tmp_path / "build")) == \
        [os.path.basename(edited)]


def test_no_compiler_takes_numpy_codec(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "compiler", lambda: None)
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(nwio, "_lib", None)
    assert build.build() is None
    assert fvec.codec() == "numpy"
    data = np.random.default_rng(8).standard_normal((33, 5)) \
        .astype(np.float32)
    fvec.write_vectors(str(tmp_path / "p.fvec"), data)
    jfvec.write_vectors(str(tmp_path / "j.fvec"), data)
    assert _bytes(tmp_path / "p.fvec") == _bytes(tmp_path / "j.fvec")
    np.testing.assert_array_equal(
        fvec.read_vectors(str(tmp_path / "p.fvec")), data)
