"""PyTorch port of `nw-tools` vs the JAX reference on the CPU: every
command on the same inputs through both packages' `main`, the same JSON
reports and, for `split` and `sort`, the same written bytes; `knn` ids
tie-tolerant against the JAX package's and a float64 oracle (distances
within 1e-5: fp32 sums in another order); the out-of-core fvec batch
reader against the JAX codec."""

import io
import json
import os
from contextlib import redirect_stdout

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from neighborhoodwatch_tpu import tools as jtools
from neighborhoodwatch_tpu.io import fvec as jfvec

from neighborhoodwatch_tpu_torch import tools as ttools
from neighborhoodwatch_tpu_torch.io import fvec as tfvec

from tests.torch_port_util import assert_ids_tie_tolerant


def _run(mod, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert mod.main(argv) == 0
    return buf.getvalue()


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture()
def files(tmp_path):
    """A scalar-column embedding parquet (one zero row, one null cell), a
    list-column parquet, a parquet with NaN/null sort keys, fvec/ivec
    files and truth/candidate neighbour files."""
    rng = np.random.default_rng(3)
    n, d = 300, 8
    mat = rng.standard_normal((n, d)).astype(np.float32)
    mat[17] = 0.0
    cols = {"document_id": pa.array(np.arange(n)),
            "text": pa.array([None if i == 5 else f"doc {i}"
                              for i in range(n)])}
    for i in range(d):
        cols[f"embedding_{i}"] = pa.array(mat[:, i])
    out = {"scalar": str(tmp_path / "scalar.parquet"),
           "list": str(tmp_path / "list.parquet"),
           "keys": str(tmp_path / "keys.parquet"),
           "fvec": str(tmp_path / "x.fvec"),
           "ivec": str(tmp_path / "x.ivec"),
           "truth": str(tmp_path / "truth.ivec"),
           "truth_d": str(tmp_path / "truth_d.fvec"),
           "cand": str(tmp_path / "cand.ivec")}
    pq.write_table(pa.table(cols), out["scalar"])
    pq.write_table(pa.table({
        "id": pa.array(np.arange(n)),
        "embedding": pa.array(list(mat), type=pa.list_(pa.float32()))}),
        out["list"])
    grp = rng.integers(0, 3, n).astype(np.float64)
    grp[[4, 50, 200]] = np.nan
    name = [None if i % 41 == 0 else f"n{int(x)}"
            for i, x in enumerate(rng.integers(0, 20, n))]
    pq.write_table(pa.table({"grp": pa.array(grp), "name": pa.array(name),
                             "row": pa.array(np.arange(n))}), out["keys"])
    tfvec.write_vectors(out["fvec"], mat)
    tfvec.write_vectors(out["ivec"], rng.integers(0, 99, (n, 5))
                        .astype(np.int32))
    truth = np.argsort(rng.standard_normal((40, 64)), axis=1)[:, :10]
    dist = np.sort(rng.random((40, 10)), axis=1).astype(np.float32)
    dist[3, 8:] = dist[3, 7]                          # a tie at the k-th
    cand = truth[:, ::-1].copy()
    cand[:20, :2] = 10_000
    cand[3, 9] = truth[3, 7]
    cand[3, 0] = 63
    tfvec.write_vectors(out["truth"], truth.astype(np.int32))
    tfvec.write_vectors(out["truth_d"], dist)
    tfvec.write_vectors(out["cand"], cand.astype(np.int32))
    return out


@pytest.mark.parametrize("argv", [
    ["inspect", "{scalar}"], ["inspect", "{scalar}", "--head", "0"],
    ["validate", "{scalar}"], ["validate", "{list}"],
    ["ifvec", "{fvec}"], ["ifvec", "{ivec}", "--head", "7"],
    ["recall", "{truth}", "{cand}"], ["recall", "{truth}", "{cand}", "-k", "4"],
    ["recall", "{truth}", "{cand}", "--truth-distances", "{truth_d}", "-k",
     "8"]], ids=lambda a: "-".join(x.strip("{}") for x in a))
def test_report_commands_match_jax(files, argv):
    argv = [a.format(**files) for a in argv]
    got = _run(ttools, argv)
    assert got == _run(jtools, argv)
    assert json.loads(got.splitlines()[0])


@pytest.mark.parametrize("cmd,src,extra", [
    ("split", "list", ["--batch-size", "64"]),
    ("split", "list", ["--batch-size", "1000"]),
    ("sort", "keys", ["--keys", "grp", "name", "--batch-size", "37"]),
    ("sort", "keys", ["--keys", "name", "--batch-size", "1000"]),
    ("sort", "scalar", ["--keys", "embedding_2", "--batch-size", "50"])])
def test_split_and_sort_write_the_same_bytes(files, tmp_path, cmd, src,
                                             extra):
    dst = {m: str(tmp_path / f"{m}_{cmd}.parquet") for m in ("j", "t")}
    jout = _run(jtools, [cmd, files[src], dst["j"]] + extra)
    tout = _run(ttools, [cmd, files[src], dst["t"]] + extra)
    assert json.loads(tout) == dict(json.loads(jout), dst=dst["t"])
    assert _bytes(dst["t"]) == _bytes(dst["j"])
    if cmd == "sort":
        rows = pq.read_table(dst["t"])
        assert rows.num_rows == 300
        assert rows.column(extra[1]).to_pylist() != \
            pq.read_table(files[src]).column(extra[1]).to_pylist()


def test_split_and_sort_edge_cases_match_jax(tmp_path, files):
    """An empty source and a missing column (a single sort run is the
    batch-size 1000 case above)."""
    empty = str(tmp_path / "empty.parquet")
    pq.write_table(pa.table({"id": pa.array([], pa.int64()),
                             "embedding": pa.array(
                                 [], pa.list_(pa.float32()))}), empty)
    for name, fn in (("split", lambda m, d: m.split_embedding_column(
            empty, d)), ("sort", lambda m, d: m.sort_parquet(
            empty, d, keys=["id"]))):
        got = {}
        for tag, mod in (("j", jtools), ("t", ttools)):
            d = str(tmp_path / f"{name}_{tag}.parquet")
            got[tag] = (fn(mod, d), _bytes(d))
        assert got["t"] == got["j"]
    for mod in (jtools, ttools):
        with pytest.raises(AssertionError, match="no column"):
            mod.split_embedding_column(files["list"],
                                       str(tmp_path / "x.parquet"),
                                       column="vec")
        with pytest.raises(AssertionError, match="no sort key"):
            mod.sort_parquet(empty, str(tmp_path / "x.parquet"),
                             keys=["nope"])


def test_hdf5_dupes_match_jax(tmp_path):
    h5py = pytest.importorskip("h5py")
    path = str(tmp_path / "d.hdf5")
    rng = np.random.default_rng(5)
    train = rng.standard_normal((50, 4)).astype(np.float32)
    train[10] = train[3]
    train[11] = train[3]
    with h5py.File(path, "w") as f:
        f["train"] = train
    argv = ["hdf5-dupes", path, "--groups", "train", "test"]
    got = _run(ttools, argv)
    assert got == _run(jtools, argv)
    assert json.loads(got)["train"]["redundant_rows"] == 2
    rep = ttools.recall_report  # hdf5 inputs of recall
    truth = np.argsort(rng.standard_normal((6, 9)), axis=1)[:, :4]
    with h5py.File(str(tmp_path / "gt.h5"), "w") as f:
        f["neighbors"] = truth
        f["distances"] = np.sort(rng.random((6, 4)), axis=1)
    kw = dict(truth_distances=str(tmp_path / "gt.h5"), out=io.StringIO())
    assert rep(str(tmp_path / "gt.h5"), str(tmp_path / "gt.h5"), **kw) == \
        jtools.recall_report(str(tmp_path / "gt.h5"),
                             str(tmp_path / "gt.h5"), **kw)


def test_recall_rejects_what_jax_rejects(files, tmp_path):
    for mod in (jtools, ttools):
        with pytest.raises(ValueError, match="unrecognized extension"):
            mod.recall_report(files["truth"], files["scalar"],
                              out=io.StringIO())
        with pytest.raises(ValueError, match="must be an"):
            mod.recall_report(files["fvec"], files["cand"],
                              out=io.StringIO())
        with pytest.raises(AssertionError, match="exceeds"):
            mod.recall_report(files["truth"], files["cand"], k=11,
                              out=io.StringIO())


@pytest.mark.parametrize("metric,batch_rows", [("sqeuclidean", 128),
                                               ("cosine", 500),
                                               ("dot", 77)])
def test_knn_over_fvec_matches_jax(tmp_path, metric, batch_rows):
    """The streamed kNN over fvec files: ids tie-tolerant against the JAX
    package's and a float64 oracle, distances within 1e-5, the same JSON
    report (paths aside); `--device cpu` through main."""
    rng = np.random.default_rng(13)
    q = rng.standard_normal((20, 24)).astype(np.float32)
    b = rng.standard_normal((500, 24)).astype(np.float32)
    b[40] = b[41]                                     # a planted tie
    qf, bf = str(tmp_path / "q.fvec"), str(tmp_path / "b.fvec")
    tfvec.write_vectors(qf, q)
    tfvec.write_vectors(bf, b)
    k = 7
    reps = {}
    for tag, mod, dev in (("j", jtools, {}), ("t", ttools,
                                              {"device": "cpu"})):
        os.makedirs(tmp_path / tag)
        buf = io.StringIO()
        reps[tag] = mod.knn_over_fvec(qf, bf, k=k, metric=metric,
                                      batch_rows=batch_rows,
                                      out_dir=str(tmp_path / tag), out=buf,
                                      **dev)
        reps[tag] = (reps[tag], json.loads(buf.getvalue()))
    (ji, jd), jrep = reps["j"]
    (ti, td), trep = reps["t"]
    assert os.path.basename(ti) == os.path.basename(ji)
    assert {**trep, "indices": 0, "distances": 0} == \
        {**jrep, "indices": 0, "distances": 0}
    q64, b64 = q.astype(np.float64), b.astype(np.float64)
    if metric == "sqeuclidean":
        full = ((q64[:, None] - b64[None]) ** 2).sum(-1)
    elif metric == "cosine":
        full = 1 - (q64 / np.linalg.norm(q64, axis=1, keepdims=True)) @ \
            (b64 / np.linalg.norm(b64, axis=1, keepdims=True)).T
    else:
        full = -(q64 @ b64.T)
    oracle = np.sort(full, axis=1)[:, :k + 1]
    got_i, want_i = tfvec.read_vectors(ti), jfvec.read_vectors(ji)
    assert_ids_tie_tolerant(got_i, want_i, oracle, 1e-5)
    np.testing.assert_allclose(tfvec.read_vectors(td),
                               jfvec.read_vectors(jd), atol=1e-5, rtol=0)
    out = _run(ttools, ["knn", qf, bf, "-k", str(k), "--metric", metric,
                        "--batch-rows", str(batch_rows), "--out-dir",
                        str(tmp_path / "t"), "--device", "cpu"])
    assert json.loads(out)["indices"] == ti
    assert _bytes(ti) == _bytes(str(tmp_path / "t" / os.path.basename(ti)))


def test_knn_needs_the_card_unless_told(tmp_path, monkeypatch):
    qf = str(tmp_path / "q.fvec")
    tfvec.write_vectors(qf, np.ones((2, 4), np.float32))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttools.main(["knn", qf, qf, "-k", "1"])
    assert _run(ttools, ["knn", qf, qf, "-k", "1", "--device", "cpu"])


@pytest.mark.parametrize("kind,batch_rows,count", [
    ("fvec", 7, None), ("fvec", 100, 13), ("fvec", 1, 5), ("ivec", 64, None),
    ("ivec", 3, 10_000)])
def test_iter_vector_batches_match_jax(files, kind, batch_rows, count):
    path = files[kind]
    got = list(tfvec.iter_vector_batches(path, batch_rows, count))
    want = list(jfvec.iter_vector_batches(path, batch_rows, count))
    assert [o for o, _ in got] == [o for o, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    whole = tfvec.read_vectors(path)
    np.testing.assert_array_equal(np.concatenate([g for _, g in got]),
                                  whole[:count])


def test_iter_vector_batches_rejects_a_truncated_file(tmp_path, files):
    path = str(tmp_path / "cut.fvec")
    with open(path, "wb") as f:
        f.write(_bytes(files["fvec"])[:-4])
    with pytest.raises(AssertionError, match="whole number"):
        list(tfvec.iter_vector_batches(path, 10))
    empty = str(tmp_path / "empty.fvec")
    open(empty, "wb").close()
    assert list(tfvec.iter_vector_batches(empty, 10)) == []
