"""PyTorch port vs the JAX reference end to end on the CPU: embeddings
parquet -> streamed (or table + merge) kNN -> final parquet -> fvec, ivec
and hdf5 export -> validation, plus the streaming checkpoint handed from
one package to the other.

Byte identity needs bit-identical distances, and two fp32 matrix products
from different libraries agree only up to summation order. The byte tests
therefore use dyadic embeddings (multiples of 1/16 in [-0.5, 0.5]): every
product, partial sum and norm is exact in fp32 in any order, so both
packages compute the same bits and any byte difference is a fault of the
pipeline, selection or file layers. The validator tests use Gaussian
unit vectors (the conftest workload)."""

import os
import shutil

import numpy as np
import pyarrow.parquet as pq
import pytest

import neighborhoodwatch_tpu.core.merge as jmerge
import neighborhoodwatch_tpu.core.pipeline as jpipe
import neighborhoodwatch_tpu.io.export as jexport
import neighborhoodwatch_tpu.ops.knn as jknn
import neighborhoodwatch_tpu.validate as jval
from neighborhoodwatch_tpu.core.tuner import KnnPlan as JPlan

import neighborhoodwatch_tpu_torch.core.merge as tmerge
import neighborhoodwatch_tpu_torch.core.pipeline as tpipe
import neighborhoodwatch_tpu_torch.io.export as texport
import neighborhoodwatch_tpu_torch.ops.knn as tknn
import neighborhoodwatch_tpu_torch.validate as tval
from neighborhoodwatch_tpu_torch.core.tuner import KnnPlan as TPlan
from neighborhoodwatch_tpu_torch.io.parquet_io import ParquetStreamer
from neighborhoodwatch_tpu_torch.utils import naming

from tests.conftest import QUERY_COUNT, BASE_COUNT, K, DIMENSIONS

MODEL = "intfloat/e5-small-v2"
PKGS = {"jax": (jpipe, jmerge, jexport, jval, JPlan),
        "torch": (tpipe, tmerge, texport, tval, TPlan)}


def _dataset(root, q, b, k):
    data_dir = naming.setup_model_output_folder(
        str(root), MODEL, len(q), len(b), k)
    dims = q.shape[1]
    qfile = naming.get_source_query_dataset_filename(data_dir, MODEL,
                                                     len(q), dims)
    bfile = naming.get_source_base_dataset_filename(data_dir, MODEL,
                                                    len(b), dims)
    with ParquetStreamer(qfile, ["title", "question"]) as ps:
        ps.stream_to_parquet([["t", f"q{i}"] for i in range(len(q))], q)
    with ParquetStreamer(bfile, ["title", "text"]) as ps:
        ps.stream_to_parquet([["t", f"d{i}"] for i in range(len(b))], b)
    return data_dir, qfile, bfile


def _copy_dataset(src, root):
    """The same embeddings files (bytes and mtimes) under another root."""
    data_dir, qfile, bfile = src
    dst = str(root) + data_dir[len(os.path.dirname(os.path.dirname(
        os.path.dirname(data_dir)))):]
    os.makedirs(f"{dst}/partial", exist_ok=True)
    for f in (qfile, bfile):
        shutil.copy2(f, dst + f[len(data_dir):])
    return dst, dst + qfile[len(data_dir):], dst + bfile[len(data_dir):]


def _run(pkg, ds, q_n, b_n, k, dims, path, monkeypatch, batch=None,
         metric="sqeuclidean"):
    pipe, merge, export, _, plan_cls = PKGS[pkg]
    data_dir, qfile, bfile = ds
    dev = {} if pkg == "jax" else {"device": "cpu"}
    if batch is not None:
        plan = plan_cls(batch_size=batch, tile_size=128, query_block=q_n,
                        bytes_limit=1 << 30, est_bytes=1 << 20)
        monkeypatch.setattr(pipe, "plan_knn", lambda *a, **kw: plan)
    if path == "stream":
        pipe.compute_knn_ds(data_dir, dims, qfile, q_n, bfile, b_n, k=k,
                            metric=metric, **dev)
    else:
        pipe.compute_knn(data_dir, MODEL, dims, qfile, q_n, bfile, b_n,
                         k=k, metric=metric, **dev)
        merge.merge_indices_and_distances(data_dir, k=k, **dev)
    files = export.generate_output_files(
        data_dir, naming.get_model_prefix(MODEL), dims, bfile, qfile, b_n,
        q_n, naming.get_partial_indices_filename(data_dir, -1),
        naming.get_partial_distances_filename(data_dir, -1), k,
        output_hdf5=True)
    h5 = naming.get_hdf5_filename(data_dir, naming.get_model_prefix(MODEL),
                                  dims, b_n, q_n, k)
    return [naming.get_partial_indices_filename(data_dir, -1),
            naming.get_partial_distances_filename(data_dir, -1),
            *files, h5]


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("path", ["stream", "table"])
def test_artifacts_byte_identical_to_jax(tmp_path, monkeypatch, path):
    """Same embeddings parquet through both packages (multi-batch plan:
    256-row batches, a running merge or partial files + merge): the final
    parquets, fvec, ivec and hdf5 files are byte-identical."""
    rng = np.random.default_rng(71)
    q_n, b_n, dims, k = 20, 1000, 16, 10
    q = (rng.integers(-8, 9, (q_n, dims)) / 16.0).astype(np.float32)
    b = (rng.integers(-8, 9, (b_n, dims)) / 16.0).astype(np.float32)
    src = _dataset(tmp_path / "jax", q, b, k)
    dst = _copy_dataset(src, tmp_path / "torch")
    want = _run("jax", src, q_n, b_n, k, dims, path, monkeypatch, batch=256)
    got = _run("torch", dst, q_n, b_n, k, dims, path, monkeypatch, batch=256)
    for w, g in zip(want, got):
        assert os.path.basename(w) == os.path.basename(g)
        assert _bytes(g) == _bytes(w), os.path.basename(g)


def test_jax_validators_accept_port_artifacts(tmp_path, normalized_vectors,
                                              monkeypatch):
    """Gaussian unit vectors (Q=100, B=1000, k=10, 384d) through the
    port's streamed pipeline: the JAX package's validate_files_v0 and
    validate_files accept the port's files, the port's validators accept
    them too, and the neighbor ids equal the JAX pipeline's."""
    q, b = normalized_vectors
    src = _dataset(tmp_path / "jax", q, b, K)
    dst = _copy_dataset(src, tmp_path / "torch")
    want = _run("jax", src, QUERY_COUNT, BASE_COUNT, K, DIMENSIONS,
                "stream", monkeypatch, batch=384)
    got = _run("torch", dst, QUERY_COUNT, BASE_COUNT, K, DIMENSIONS,
               "stream", monkeypatch, batch=384)
    data_dir = dst[0]
    qf, bf, inf, df = got[2:6]
    assert jval.validate_files_v0(data_dir, qf, bf, inf, df) == 0
    assert jval.validate_files(data_dir, qf, bf, inf, df,
                               metric="sqeuclidean") == 0
    assert tval.validate_files_v0(data_dir, qf, bf, inf, df,
                                  device="cpu") == 0
    assert tval.validate_files(data_dir, qf, bf, inf, df,
                               metric="sqeuclidean", device="cpu") == 0
    assert _bytes(got[4]) == _bytes(want[4])            # ivec
    np.testing.assert_allclose(
        pq.read_table(got[1]).to_pandas().values,
        pq.read_table(want[1]).to_pandas().values, atol=1e-5, rtol=0)


def test_port_validators_flag_corruption_like_jax(tmp_path,
                                                  normalized_vectors,
                                                  monkeypatch, capsys):
    """A corrupted distance is counted by both validators of both
    packages, and the port's four labeled cross-check engines run."""
    from neighborhoodwatch_tpu_torch.io import fvec
    q, b = normalized_vectors
    ds = _dataset(tmp_path, q, b, K)
    files = _run("torch", ds, QUERY_COUNT, BASE_COUNT, K, DIMENSIONS,
                 "stream", monkeypatch)
    qf, bf, inf, df = files[2:6]
    d = fvec.read_vectors(df).copy()
    d[3, K - 1] += 0.5          # stays monotonic, breaks the convention
    fvec.write_vectors(df, d)
    data_dir = ds[0]
    assert tval.validate_files_v0(data_dir, qf, bf, inf, df,
                                  device="cpu") == 1
    assert jval.validate_files_v0(data_dir, qf, bf, inf, df) == 1
    capsys.readouterr()
    assert tval.validate_files(data_dir, qf, bf, inf, df,
                               metric="sqeuclidean", device="cpu") == 1
    out = capsys.readouterr().out
    for label in ("[1/4 exact-device]", "[2/4 screened-device]",
                  "[3/4 float64-numpy]", "[4/4 pairwise]"):
        assert label in out


def test_streaming_state_handoff_from_jax(normalized_vectors):
    """JAX StreamingKNN over the first half of the batches, its
    state_arrays() restored into the port, the second half fed to the
    port: the result equals the JAX full run."""
    q, b = normalized_vectors
    offs = list(range(0, BASE_COUNT, 250))
    ja = jknn.StreamingKNN(q, K)
    for off in offs[:2]:
        ja.update(b[off:off + 250], off)
    ta = tknn.StreamingKNN(q, K, device="cpu")
    ta.restore(*ja.state_arrays())
    for off in offs[2:]:
        ta.update(b[off:off + 250], off)
        ja.update(b[off:off + 250], off)
    jd, ji = ja.finalize()
    td, ti = ta.finalize()
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, atol=1e-5, rtol=0)
    # and back: the port's checkpoint restores into the JAX accumulator
    jb = jknn.StreamingKNN(q, K)
    jb.restore(*ta.state_arrays())
    np.testing.assert_array_equal(jb.finalize()[1], ti)


def test_stream_checkpoint_written_by_jax_resumes_in_port(
        tmp_path, normalized_vectors, capsys):
    """partial/stream_state.npz saved by the JAX pipeline after 400 rows
    (with the pipeline's own fingerprint) is picked up by the port's
    compute_knn_ds, which finishes the stream with the same result as a
    fresh exact run."""
    q, b = normalized_vectors
    data_dir, qfile, bfile = _dataset(tmp_path, q, b, K)
    st = os.stat(naming.get_full_filename(data_dir, bfile))
    stq = os.stat(naming.get_full_filename(data_dir, qfile))
    fingerprint = {"f_k": K, "f_metric": "sqeuclidean", "f_dims": DIMENSIONS,
                   "f_base": bfile, "f_nbase": BASE_COUNT,
                   "f_q": QUERY_COUNT, "f_prec": "highest",
                   "f_bsize": st.st_size, "f_bmtime": round(st.st_mtime, 3),
                   "f_qsize": stq.st_size,
                   "f_qmtime": round(stq.st_mtime, 3),
                   "f_qpad": QUERY_COUNT}
    acc = jknn.StreamingKNN(q, k=K)
    acc.update(b[:400], 0)
    ckpt = jpipe._stream_ckpt_path(data_dir)
    jpipe._save_stream_ckpt(ckpt, acc, fingerprint)
    assert tpipe._load_stream_ckpt(ckpt, fingerprint) is not None
    capsys.readouterr()
    tpipe.compute_knn_ds(data_dir, DIMENSIONS, qfile, QUERY_COUNT, bfile,
                         BASE_COUNT, k=K, device="cpu")
    assert "resuming kNN stream from checkpoint: 400" in \
        capsys.readouterr().out
    got_i = pq.read_table(
        naming.get_partial_indices_filename(data_dir, -1)).to_pandas().values
    _, ref_i = jknn.knn(q, b, k=K)
    np.testing.assert_array_equal(got_i, np.asarray(ref_i))
    assert not os.path.exists(ckpt)
