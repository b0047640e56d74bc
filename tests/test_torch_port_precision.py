"""The exact engines' three product precisions in the port, on the CPU:
`pairwise_distance`, `maxsim_scores`, the kNN and MaxSim engines, `nw`
and `ck --maxsim` end to end, and the stream checkpoint's precision pin.

Meaning (the TPU's, as the JAX package names them): "default" multiplies
bf16-rounded operands, "high" sums hi.hi + hi.lo + lo.hi with hi = bf16(x)
and lo = bf16(x - hi), "highest" is fp32; the sums are fp32. JAX on the
CPU ignores the precision and computes fp32, so the port is held against
two references, each with a bound derived from the rounding:

- the float64 numpy oracle on the same bf16 operands: the port's products
  of bf16 values are exact in fp32, so they differ from it only by the
  fp32 accumulation, at most (T + 8) 2^-24 |q| |b| for T summed terms
  (T = dim, 3 dim for "high"; +8 for the epilogue's few fp32 ops), and
  the l2 distance qn + bn - 2 q.b by (T + 8) 2^-24 (|q| + |b|)^2;
- JAX-CPU's fp32 result: bf16 rounding is at most 2^-8 relative
  (round to nearest with 8 significant bits), so "default" products move
  by at most (2 * 2^-8 + 2^-16) |q| |b|; "high" drops lo.lo (at most
  2^-16 |q| |b|) and rounds both lo terms (2^-16 (1 + 2^-8) |q| |b| each),
  at most 3.1 * 2^-16 |q| |b|, the factor of ops/knn.py:_eps3_rel; plus
  both sides' fp32 accumulation. The l2 distance takes 2x the product
  error, a MaxSim score the sum over query tokens of the largest error of
  a doc token. The bound is the criterion.
"""

import os

import numpy as np
import pyarrow.parquet as pq
import pytest
import torch
import jax.numpy as jnp

import neighborhoodwatch_tpu.ops.distance as jdist
import neighborhoodwatch_tpu.ops.knn as jknn
import neighborhoodwatch_tpu.ops.maxsim as jms
import neighborhoodwatch_tpu.validate as jval

from neighborhoodwatch_tpu_torch.cli import ck_main, nw_main
from neighborhoodwatch_tpu_torch.core import pipeline as tpipe
from neighborhoodwatch_tpu_torch.io import fvec
from neighborhoodwatch_tpu_torch.io.parquet_io import ParquetStreamer
from neighborhoodwatch_tpu_torch.ops import distance as tdist
from neighborhoodwatch_tpu_torch.ops import knn as tknn
from neighborhoodwatch_tpu_torch.ops import maxsim as tms
from neighborhoodwatch_tpu_torch.utils import naming
from neighborhoodwatch_tpu_torch import validate as tval

from tests.torch_port_util import assert_ids_tie_tolerant

PRECISIONS = ("default", "high", "highest")
# relative product error against fp32, per precision (see module doc)
REL = {"default": 2 * 2.0 ** -8 + 2.0 ** -16, "high": 3.1 * 2.0 ** -16,
       "highest": 0.0}
E5_SMALL = "intfloat/e5-small-v2"


def _bf16(x):
    """Round-to-nearest-even bf16 image of finite f32 values, in f32."""
    u = np.asarray(x, dtype=np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _operands(x, precision):
    """The precision's operand blocks of `x` as float64: [x] (highest),
    [hi] (default) or [hi, lo] (high)."""
    x = np.asarray(x, dtype=np.float32)
    if precision == "highest":
        return [x.astype(np.float64)]
    hi = _bf16(x)
    if precision == "default":
        return [hi.astype(np.float64)]
    lo = _bf16(x - hi)                  # x - hi is exact in fp32
    return [hi.astype(np.float64), lo.astype(np.float64)]


def _oracle_dots(q, b, precision):
    """float64 q.b of the precision's bf16 operands."""
    qo, bo = _operands(q, precision), _operands(b, precision)
    if len(qo) == 1:
        return qo[0] @ bo[0].T
    return qo[0] @ bo[0].T + qo[0] @ bo[1].T + qo[1] @ bo[0].T


def _terms(dim, precision):
    return 3 * dim if precision == "high" else dim


def _data(seed, q=16, b=300, d=64, scale=1.0):
    rng = np.random.default_rng(seed)
    return ((scale * rng.standard_normal((q, d))).astype(np.float32),
            (scale * rng.standard_normal((b, d))).astype(np.float32))


def _norms(q, b):
    qn = np.linalg.norm(q.astype(np.float64), axis=1)[:, None]
    bn = np.linalg.norm(b.astype(np.float64), axis=1)[None, :]
    return qn, bn


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean", "cosine",
                                    "dot"])
def test_pairwise_distance_precisions(precision, metric):
    """Every distance against the bf16 oracle (fp32 accumulation bound)
    and against JAX-CPU's fp32 (rounding bound + accumulation)."""
    q, b = _data(1, scale=0.7)
    dim = q.shape[1]
    got = tdist.pairwise_distance(torch.from_numpy(q), torch.from_numpy(b),
                                  metric, precision).numpy().astype(
                                      np.float64)
    want_j = np.asarray(jdist.pairwise_distance(
        jnp.asarray(q), jnp.asarray(b), metric=metric, precision=precision))
    if metric == "cosine":
        # the products see the port's own fp32-normalized rows
        qs = tdist._safe_normalize(torch.from_numpy(q)).numpy()
        bs = tdist._safe_normalize(torch.from_numpy(b)).numpy()
    else:
        qs, bs = q, b
    qn, bn = _norms(qs, bs)
    acc = (_terms(dim, precision) + 8) * 2.0 ** -24
    dots = _oracle_dots(qs, bs, precision)
    if metric in ("sqeuclidean", "euclidean"):
        oracle = np.maximum(qn ** 2 + bn ** 2 - 2.0 * dots, 0.0)
        tight = acc * (qn + bn) ** 2
        loose = 2.0 * (REL[precision] + 2 * acc) * qn * bn + tight
        if metric == "euclidean":
            # |sqrt(x) - sqrt(y)| <= |x - y| / (sqrt(x) + sqrt(y))
            root = np.sqrt(oracle)
            tight = tight / np.maximum(root, 1e-3)
            loose = loose / np.maximum(root, 1e-3)
            oracle = root
    else:
        oracle = 1.0 - dots
        # + the rounding of 1 - q.b
        tight = acc * qn * bn + 2.0 ** -24 * (1.0 + np.abs(oracle))
        loose = (REL[precision] + 2 * acc) * qn * bn + 2 * tight
    assert np.all(np.abs(got - oracle) <= tight)
    assert np.all(np.abs(got - want_j) <= loose)
    if precision != "highest":
        # the rounding is really there: the products are not fp32
        assert np.abs(got - want_j).max() > 0.0


def _tokens(seed, n, t, dim):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, t, dim)).astype(np.float32)
    x /= np.linalg.norm(x, axis=2, keepdims=True)
    mask = rng.random((n, t)) < 0.8
    mask[:, 0] = True
    return x, mask


def _maxsim_oracle(q, qm, d, dm, precision):
    """float64 MaxSim of the precision's bf16 operands, (Q, D)."""
    dots = _oracle_dots(q.reshape(-1, q.shape[-1]),
                        d.reshape(-1, d.shape[-1]), precision)
    sims = dots.reshape(q.shape[0], q.shape[1], d.shape[0], d.shape[1])
    sims = np.where(dm[None, None], sims, -np.inf)
    per_tok = np.where(qm[:, :, None], sims.max(3), 0.0)
    return per_tok.sum(1)


def _maxsim_bound(q, qm, d, dm, rel):
    """Sum over valid query tokens of rel x |q_t| x max |d_s|."""
    qn = np.where(qm, np.linalg.norm(q, axis=2), 0.0).sum(1)[:, None]
    dn = np.where(dm, np.linalg.norm(d, axis=2), 0.0).max(1)[None, :]
    return rel * qn * dn


@pytest.mark.parametrize("precision", PRECISIONS)
def test_maxsim_scores_precisions(precision):
    """MaxSim scores against the bf16 oracle and JAX-CPU's fp32 scores."""
    q, qm = _tokens(2, 6, 9, 32)
    d, dm = _tokens(3, 40, 12, 32)
    got = tms.maxsim_scores(*(torch.from_numpy(x) for x in (q, qm, d, dm)),
                            precision=precision).numpy()
    want_j = np.asarray(jms.maxsim_scores(q, qm, d, dm, precision=precision))
    acc = (_terms(32, precision) + 8) * 2.0 ** -24
    tight = _maxsim_bound(q, qm, d, dm, acc) + 1e-6
    loose = _maxsim_bound(q, qm, d, dm, REL[precision] + 2 * acc) + 1e-6
    assert np.all(np.abs(got - _maxsim_oracle(q, qm, d, dm, precision))
                  <= tight)
    assert np.all(np.abs(got - want_j) <= loose)
    # and the exact engine's top-k on those scores, against JAX's fp32
    # top-k: the k-th best score moves by at most the largest score error
    ts, _ = tms.maxsim_topk(q, qm, d, dm, 7, precision=precision,
                            tile_docs=16, device="cpu")
    js, _ = jms.maxsim_topk(q, qm, d, dm, 7, precision=precision,
                            tile_docs=16)
    assert np.all(np.abs(ts.numpy() - np.asarray(js)) <= loose.max())


@pytest.mark.parametrize("precision", ["default", "high"])
@pytest.mark.parametrize("engine,tile", [("exact", None), ("exact", 128),
                                         ("verified", 128)])
def test_knn_engines_at_precision(precision, engine, tile):
    """knn and StreamingKNN at a reduced precision: ids against the bf16
    oracle's ranking up to ties within the accumulation bound, distances
    against JAX-CPU's fp32 ones within the rounding bound."""
    q, b = _data(4, q=12, b=500, d=48)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    k = 9
    td, ti = tknn.knn(q, b, k, precision=precision, engine=engine,
                      tile_size=tile, device="cpu")
    acc = (_terms(48, precision) + 8) * 2.0 ** -24
    oracle = np.maximum(2.0 - 2.0 * _oracle_dots(q, b, precision), 0.0)
    assert_ids_tie_tolerant(ti.numpy(), np.argsort(oracle, 1,
                                                   kind="stable")[:, :k],
                            np.sort(oracle, 1)[:, :k + 1], 4 * acc * 4)
    jd, _ = jknn.knn(q, b, k=k, precision=precision)
    loose = 2.0 * (REL[precision] + 2 * acc) + 4 * acc * 4
    assert np.all(np.abs(td.numpy() - np.asarray(jd)) <= loose)
    acc_s = tknn.StreamingKNN(q, k, precision=precision, engine=engine,
                              tile_size=128, device="cpu")
    acc_s.update(b[:250], 0)
    acc_s.update(b[250:], 250)
    sd, si = acc_s.finalize()
    np.testing.assert_array_equal(sd, td.numpy())
    np.testing.assert_array_equal(si, ti.numpy())


@pytest.fixture()
def cpu_mesh():
    """A single-rank gloo group in this process (parallel/mesh.make_mesh),
    closed after the test."""
    import torch.distributed as dist
    from neighborhoodwatch_tpu_torch.parallel.mesh import make_mesh
    assert not dist.is_initialized()
    mesh = make_mesh(1, device="cpu")
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


def test_mesh_paths_carry_the_precision(cpu_mesh):
    """sharded_knn, ShardedStreamingKNN, ring_knn and ShardedStreamingMaxSim
    at a reduced precision on a one-rank mesh give the single-device
    engines' results at that precision, on the same tiles."""
    from neighborhoodwatch_tpu_torch.parallel import sharded_knn as tsk
    from neighborhoodwatch_tpu_torch.parallel import sharded_maxsim as tsm
    q, b = _data(7, q=8, b=500, d=32)
    k = 6
    d, i = tsk.sharded_knn(q, b, k, cpu_mesh, precision="default",
                           tile_size=128)
    wd, wi = tknn.knn(q, b, k, precision="default", tile_size=128,
                      device="cpu")
    assert torch.equal(i, wi) and torch.equal(d, wd)
    d, i = tsk.ring_knn(q, b, k, cpu_mesh, precision="high")
    wd, wi = tknn.knn(q, b, k, precision="high", device="cpu")
    assert torch.equal(i, wi) and torch.equal(d, wd)
    acc = tsk.ShardedStreamingKNN(q, k, cpu_mesh, precision="high",
                                  tile_size=128)
    ref = tknn.StreamingKNN(q, k, precision="high", tile_size=128,
                            device="cpu")
    for off in (0, 250):
        acc.update(b[off:off + 250], off)
        ref.update(b[off:off + 250], off)
    for got, want in zip(acc.finalize(), ref.finalize()):
        np.testing.assert_array_equal(got, want)
    qt, qm = _tokens(8, 4, 6, 32)
    dt, dm = _tokens(9, 48, 5, 32)
    acc = tsm.ShardedStreamingMaxSim(qt, qm, 5, cpu_mesh, precision="default",
                                     engine="exact")
    ref = tms.StreamingMaxSim(qt, qm, 5, precision="default", engine="exact",
                              device="cpu")
    for off in (0, 24):
        acc.update(dt[off:off + 24], dm[off:off + 24], off)
        ref.update(dt[off:off + 24], dm[off:off + 24], off)
    for got, want in zip(acc.finalize(), ref.finalize()):
        np.testing.assert_array_equal(got, want)


def test_unknown_precision_is_refused():
    q, b = _data(5, q=2, b=20, d=8)
    for fn in (lambda: tknn.knn(q, b, 3, precision="medium", device="cpu"),
               lambda: tknn.StreamingKNN(q, 3, precision="bf16",
                                         device="cpu"),
               lambda: tdist.pairwise_distance(torch.from_numpy(q),
                                               torch.from_numpy(b),
                                               precision="low")):
        with pytest.raises(ValueError, match="precision"):
            fn()


def _written(tmp_path, q, b, k):
    data_dir = naming.get_model_data_homedir(
        str(tmp_path), E5_SMALL + "_synthetic", q, b, k)
    files = naming.get_ivec_fvec_filenames(data_dir, E5_SMALL, 384, b, q, k)
    return data_dir, files


@pytest.mark.parametrize("precision,dataset_api", [("default", False),
                                                   ("high", True)])
def test_nw_end_to_end_at_precision(tmp_path, capsys, precision,
                                    dataset_api):
    """The port's `nw --precision default|high` on the CPU (it raised
    before): the written distances against the bf16 oracle at the written
    ids (accumulation bound), the ids against the oracle's ranking (ties
    within that bound), and the validators at the rounding bound against
    the fp32 similarities, the JAX package's included."""
    q, b, k = 20, 200, 5
    argv = [str(q), str(b), "-k", str(k), "-m", E5_SMALL, "--synthetic",
            "--post-validation", "--yes", "--device", "cpu",
            "--precision", precision, "--no-gen-hdf5",
            "--data-dir", str(tmp_path)]
    if dataset_api:
        argv.append("--use-dataset-api")
    nw_main(argv)
    out = capsys.readouterr().out
    assert f"metric/precision:    sqeuclidean/{precision}" in out
    assert "Total mismatch count:" in out
    data_dir, files = _written(tmp_path, q, b, k)
    qv, bv = fvec.read_vectors(files[0]), fvec.read_vectors(files[1])
    idx, dist = fvec.read_vectors(files[2]), fvec.read_vectors(files[3])
    qn, bn = _norms(qv, bv)
    acc = (_terms(384, precision) + 8) * 2.0 ** -24
    oracle = np.maximum(qn ** 2 + bn ** 2
                        - 2.0 * _oracle_dots(qv, bv, precision), 0.0)
    tight = acc * float(((qn.max() + bn.max()) ** 2))
    at = np.take_along_axis(oracle, idx.astype(np.int64), axis=1)
    assert np.all(np.abs(dist - at) <= tight)
    assert_ids_tie_tolerant(idx, np.argsort(oracle, 1, kind="stable")[:, :k],
                            np.sort(oracle, 1)[:, :k + 1], 2 * tight)
    # the validators recompute fp32 similarities: d/2 vs 1 - sim
    loose = (REL[precision] + 2 * acc) * float(qn.max() * bn.max()) + tight
    assert tval.validate_files_v0(data_dir, *files, atol=loose,
                                  device="cpu") == 0
    assert jval.validate_files_v0(data_dir, *files, atol=loose) == 0
    assert tval.validate_files(data_dir, *files, atol=loose,
                               metric="sqeuclidean", device="cpu") == 0
    assert jval.validate_files(data_dir, *files, atol=loose,
                               metric="sqeuclidean") == 0


def test_ck_maxsim_end_to_end_at_default_precision(tmp_path, capsys):
    """`ck --maxsim --precision default` on the CPU (the exact MaxSim engine
    runs it): its own and the JAX package's MaxSim validators pass at the
    rounding bound of a score (float64 recomputation), and the written
    scores sit within the accumulation bound of the bf16 oracle."""
    qt, bt, k = 120, 600, 5
    ck_main([str(qt), str(bt), "-k", str(k), "--synthetic", "-es", "small",
             "--maxsim", "--precision", "default", "--yes", "--device",
             "cpu", "--no-gen-hdf5", "--data-dir", str(tmp_path)])
    data_dir = naming.get_model_data_homedir(
        str(tmp_path), "colbertv2.0_maxsim_synthetic", qt, bt, k)
    files = naming.get_ivec_fvec_filenames(data_dir, "colbertv2.0", 128, bt,
                                           qt, k)
    maps = naming.get_doc_id_map_filenames(data_dir, "colbertv2.0", 128, bt,
                                           qt)
    qtok, btok = fvec.read_vectors(files[0]), fvec.read_vectors(files[1])
    q_ranges = tval._doc_token_ranges(fvec.read_vectors(maps[0]))
    b_ranges = tval._doc_token_ranges(fvec.read_vectors(maps[1]))
    neigh, dist = fvec.read_vectors(files[2]), fvec.read_vectors(files[3])
    qmax = max(e - s for s, e in q_ranges)
    tok_n = max(np.linalg.norm(qtok, axis=1).max(),
                np.linalg.norm(btok, axis=1).max())
    acc = (128 + 8) * 2.0 ** -24
    tight = qmax * acc * tok_n ** 2 + 1e-5
    loose = qmax * (REL["default"] + 2 * acc) * tok_n ** 2 + 1e-5
    assert tval.validate_maxsim_files(data_dir, files[0], files[1], *maps,
                                      files[2], files[3], atol=loose) == 0
    assert jval.validate_maxsim_files(data_dir, files[0], files[1], *maps,
                                      files[2], files[3], atol=loose) == 0
    hi_q, hi_b = _bf16(qtok).astype(np.float64), _bf16(btok).astype(
        np.float64)
    for p, (s, e) in enumerate(q_ranges):
        for j, doc in enumerate(neigh[p]):
            bs, be = b_ranges[doc]
            score = (hi_q[s:e] @ hi_b[bs:be].T).max(1).sum()
            assert abs(-dist[p, j] - score) <= tight, (p, j)


def _stream_dataset(root, q, b):
    model = E5_SMALL
    data_dir = naming.setup_model_output_folder(str(root), model, len(q),
                                                len(b), 5)
    dims = q.shape[1]
    qfile = naming.get_source_query_dataset_filename(data_dir, model, len(q),
                                                     dims)
    bfile = naming.get_source_base_dataset_filename(data_dir, model, len(b),
                                                    dims)
    with ParquetStreamer(qfile, ["title", "question"]) as ps:
        ps.stream_to_parquet([["t", f"q{i}"] for i in range(len(q))], q)
    with ParquetStreamer(bfile, ["title", "text"]) as ps:
        ps.stream_to_parquet([["t", f"d{i}"] for i in range(len(b))], b)
    return data_dir, qfile, bfile


def test_checkpoint_pins_the_precision(tmp_path, capsys):
    """A stream checkpoint written at "default" is refused by a run at
    "highest" (f_prec), which starts over and returns the fp32 result; a
    run at "default" resumes from it."""
    q, b = _data(6, q=10, b=400, d=32)
    data_dir, qfile, bfile = _stream_dataset(tmp_path, q, b)
    st = os.stat(naming.get_full_filename(data_dir, bfile))
    stq = os.stat(naming.get_full_filename(data_dir, qfile))

    def fingerprint(precision):
        return {"f_k": 5, "f_metric": "sqeuclidean", "f_dims": 32,
                "f_base": bfile, "f_nbase": 400, "f_q": 10,
                "f_prec": precision, "f_bsize": st.st_size,
                "f_bmtime": round(st.st_mtime, 3), "f_qsize": stq.st_size,
                "f_qmtime": round(stq.st_mtime, 3), "f_qpad": 10}

    def checkpoint():
        acc = tknn.StreamingKNN(q, 5, precision="default", device="cpu")
        acc.update(b[:100], 0)
        tpipe._save_stream_ckpt(tpipe._stream_ckpt_path(data_dir), acc,
                                fingerprint("default"))

    def run(precision):
        tpipe.compute_knn_ds(data_dir, 32, qfile, 10, bfile, 400, k=5,
                             precision=precision, device="cpu")
        out = capsys.readouterr().out
        got = pq.read_table(naming.get_partial_indices_filename(
            data_dir, -1)).to_pandas().values
        return out, got

    checkpoint()
    out, got = run("highest")
    assert "stream checkpoint ignored: f_prec mismatch" in out
    assert "resuming" not in out
    _, want = tknn.knn(q, b, 5, device="cpu")
    np.testing.assert_array_equal(got, want.numpy())
    checkpoint()
    out, got = run("default")
    assert "resuming kNN stream from checkpoint: 100/400" in out
    acc = tknn.StreamingKNN(q, 5, precision="default", device="cpu")
    acc.update(b[:100], 0)
    acc.update(b[100:], 100)
    np.testing.assert_array_equal(got, acc.finalize()[1])
