"""PyTorch port of the kNN scale-out layer (parallel/mesh.py,
parallel/sharded_knn.py, compute_knn_ds(mesh=), `nw --mesh`) against the
JAX package on the CPU.

The JAX reference runs in this process on the virtual 8-device mesh of
tests/conftest.py, as (1, 2) and (2, 2) meshes of its first devices, its
screen kernel in interpret mode as tests/test_sharded.py runs it. The port
runs in gloo ranks on the CPU (tests/torch_port_mesh_worker.py): one spawn
of 2 ranks as a (1, 2) mesh and one of 4 ranks as (2, 2), started together
by a module-scoped fixture; each rank computes every case and writes npz
files, and the tests below check each case.

Tolerances: ids tie-tolerant against the float64 oracle at 1e-5
(assert_ids_tie_tolerant; fp32 distances of unit vectors summed in another
order differ by a few 1e-7, and shard-local sums by ~2e-6 on the exact
duplicates), distances within 1e-5 abs as tests/test_torch_port_pipeline.py
states them, 1e-4 for the screened engine as tests/test_sharded.py does;
the screened engine's repair diagnostics, its calls and the tier exactly
equal to the JAX package's. Every rank returns the same whole arrays."""

import os
import shutil

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from neighborhoodwatch_tpu.core import pipeline as jpipe
from neighborhoodwatch_tpu.core.tuner import KnnPlan as JPlan
from neighborhoodwatch_tpu.ops import knn as jknn
from neighborhoodwatch_tpu.parallel import sharded_knn as jsk
from neighborhoodwatch_tpu.parallel.mesh import make_mesh as jax_mesh
import neighborhoodwatch_tpu.validate as jval

from neighborhoodwatch_tpu_torch.cli import nw_main
from neighborhoodwatch_tpu_torch.io import fvec
from neighborhoodwatch_tpu_torch.utils import naming

from tests import torch_port_mesh_worker as W
from tests.torch_port_util import (
    assert_ids_tie_tolerant, load_rank_results, start_mesh_ranks,
    wait_mesh_ranks,
)

TOL = 1e-5
SCREENED_TOL = 1e-4


def _jmesh(world):
    return jax_mesh(2) if world == 2 else jax_mesh(4, dp=2)


def _oracle(q, b, k, metric="sqeuclidean", n_valid=None):
    """float64 distances, sorted ascending per row, (Q, k + 1)."""
    q = np.asarray(q, np.float64)
    b = np.asarray(b, np.float64)[:n_valid]
    if metric == "cosine":
        qn = q / np.linalg.norm(q, axis=1, keepdims=True)
        bn = b / np.linalg.norm(b, axis=1, keepdims=True)
        d = 1.0 - qn @ bn.T
    else:
        d = ((q * q).sum(1)[:, None] + (b * b).sum(1)[None]
             - 2.0 * q @ b.T)
    return np.sort(d, axis=1)[:, :k + 1]


def _embeddings(data_dir, q, b):
    """q.parquet / b.parquet embedding tables (as tests/test_sharded.py)."""
    os.makedirs(f"{data_dir}/partial", exist_ok=True)
    for name, mat in (("q.parquet", q), ("b.parquet", b)):
        pq.write_table(pa.table({f"embedding_{i}": mat[:, i]
                                 for i in range(mat.shape[1])}),
                       f"{data_dir}/{name}")


def _copy_embeddings(src, dst):
    """The same files, bytes and mtimes, in another directory."""
    os.makedirs(f"{dst}/partial", exist_ok=True)
    for name in ("q.parquet", "b.parquet"):
        shutil.copy2(f"{src}/{name}", f"{dst}/{name}")


def _finals(data_dir):
    return [pq.read_table(fn(data_dir, -1)).to_pandas().values
            for fn in (naming.get_partial_indices_filename,
                       naming.get_partial_distances_filename)]


def _fixed_plan(rows):
    return lambda *a, **kw: JPlan(batch_size=rows, tile_size=128,
                                  query_block=100, bytes_limit=1 << 24,
                                  est_bytes=1 << 22)


def _jax_killed_run(data_dir):
    """The JAX package's compute_knn_ds over a (2, 2) mesh in 200-row
    batches with a checkpoint after each, killed at its third batch: the
    checkpoint holds 400 rows."""
    q, b = W.normalized()
    real = jsk.ShardedStreamingKNN.update_colmajor
    calls = {"n": 0}

    def dying(self, batch, offset=None):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("simulated mid-stream crash")
        return real(self, batch, offset)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpipe, "plan_knn", _fixed_plan(200))
        mp.setattr(jsk.ShardedStreamingKNN, "update_colmajor", dying)
        with pytest.raises(RuntimeError, match="simulated"):
            jpipe.compute_knn_ds(data_dir, q.shape[1], "q.parquet", len(q),
                                 "b.parquet", len(b), k=10,
                                 mesh=_jmesh(4), checkpoint_every=1)
    assert os.path.exists(jpipe._stream_ckpt_path(data_dir))


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """{world: directory of the ranks' npz files}: both spawns."""
    root = tmp_path_factory.mktemp("knn_mesh")
    dirs = {2: root / "w2", 4: root / "w4"}
    q, b = W.normalized()
    _embeddings(dirs[2] / "pipeline", q, b)
    procs = start_mesh_ranks("knn", 2, 1, dirs[2])
    try:
        _embeddings(dirs[4] / "handoff", q, b)
        _copy_embeddings(dirs[4] / "handoff", root / "handoff_jax")
        _jax_killed_run(str(dirs[4] / "handoff"))
        procs += start_mesh_ranks("knn", 4, 2, dirs[4])
    finally:
        wait_mesh_ranks(procs)
    return {**dirs, "root": root}


def _case(port, name, world):
    res = load_rank_results(port[world], name, world)
    assert "error" not in res[0], str(res[0]["error"])
    return res[0]


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_knn_matches_jax(port, world):
    q, b = W.normalized()
    got = _case(port, "sharded", world)
    jd, ji = jsk.sharded_knn(q, b[:960], k=10, mesh=_jmesh(world))
    oracle = _oracle(q, b[:960], 10)
    assert_ids_tie_tolerant(got["i"], np.asarray(ji), oracle, TOL)
    np.testing.assert_allclose(got["d"], np.asarray(jd), atol=TOL)


def test_sharded_knn_k_exceeds_shard_raises(port):
    q, b = W.normalized()
    err = str(load_rank_results(port[2], "k_exceeds_shard", 2)[0]["error"])
    assert err.startswith("AssertionError") and "per-shard" in err
    with pytest.raises(AssertionError, match="per-shard"):
        jsk.sharded_knn(q, b[:160], k=100, mesh=_jmesh(2))


@pytest.mark.parametrize("world", [2, 4])
def test_ring_knn_matches_jax(port, world):
    q, b = W.normalized()
    got = _case(port, "ring", world)
    jd, ji = jsk.ring_knn(q, b[:960], k=10, mesh=_jmesh(world))
    assert_ids_tie_tolerant(got["i"], np.asarray(ji), _oracle(q, b[:960], 10),
                            TOL)
    np.testing.assert_allclose(got["d"], np.asarray(jd), atol=TOL)


def test_ring_knn_cosine_matches_jax(port):
    q, b = W.normalized()
    got = _case(port, "ring_cosine", 4)
    jd, ji = jsk.ring_knn(q, b[:960], k=8, mesh=_jmesh(4), metric="cosine")
    assert_ids_tie_tolerant(got["i"], np.asarray(ji),
                            _oracle(q, b[:960], 8, "cosine"), TOL)
    np.testing.assert_allclose(got["d"], np.asarray(jd), atol=TOL)


def test_ring_knn_tie_break_with_duplicates(port):
    """More exact ties than k across both shards: every fold merges on
    (distance, global index), so the lowest tied ids win on every rank."""
    q, b = W.duplicates()
    got = _case(port, "ring_duplicates", 2)
    jd, ji = jsk.ring_knn(q, b, k=8, mesh=_jmesh(2))
    np.testing.assert_array_equal(got["i"][0], np.arange(0, 64, 4)[:8])
    np.testing.assert_array_equal(got["i"], np.asarray(ji))
    np.testing.assert_allclose(got["d"], np.asarray(jd), atol=TOL)


@pytest.mark.parametrize("name,fn", [("padded_sharded", jsk.sharded_knn),
                                     ("padded_ring", jsk.ring_knn)])
def test_padded_base_rows_are_masked(port, name, fn):
    """Zero pad rows (distance ||q||^2 = 1 on unit queries) beat true
    neighbours unless masked: with n_valid the result is the unpadded
    one."""
    q, bp, n_valid = W.padded_base()
    got = _case(port, name, 2)
    assert got["i"].max() < n_valid
    jd, ji = fn(q, bp, k=10, mesh=_jmesh(2), n_valid=n_valid)
    assert_ids_tie_tolerant(got["i"], np.asarray(ji),
                            _oracle(q, bp, 10, n_valid=n_valid), TOL)
    np.testing.assert_allclose(got["d"], np.asarray(jd), atol=TOL)


def test_unknown_engine_raises(port):
    q, b = W.normalized()
    errors = _case(port, "unknown_engine", 2)["errors"]
    assert all("unknown engine" in str(e) for e in errors), errors
    with pytest.raises(ValueError, match="unknown engine"):
        jsk.sharded_knn(q, b[:960], k=10, mesh=_jmesh(2), engine="screen")


def test_update_colmajor_matches_rowmajor(port):
    """Rank-local col-major columns (local_update_range + global_rows, the
    pipeline's feed) fold to the same state as whole row-major batches."""
    got = _case(port, "colmajor", 2)
    np.testing.assert_array_equal(got["i_col"], got["i_row"])
    np.testing.assert_array_equal(got["d_col"], got["d_row"])


def test_streaming_ragged_batches_match_jax(port):
    q, b = W.normalized()
    got = _case(port, "stream_ragged", 4)
    acc = jsk.ShardedStreamingKNN(q, k=10, mesh=_jmesh(4))
    off = 0
    for size in W.KNN_STREAM:
        acc.update(b[off:off + size], off)
        off += size
    jd, ji = acc.finalize()
    assert_ids_tie_tolerant(got["i"], ji, _oracle(q, b, 10), TOL)
    np.testing.assert_allclose(got["d"], jd, atol=TOL)


def test_streaming_odd_query_rows(port):
    """13 query rows over dp=2: padded to 14, cut back to 13."""
    q, b = W.gauss(7, (13, 64), (512, 64))
    got = _case(port, "odd_rows", 4)
    assert got["d"].shape == (13, 5)
    acc = jsk.ShardedStreamingKNN(q, k=5, mesh=_jmesh(4))
    acc.update(b[:256], 0)
    acc.update(b[256:], 256)
    jd, ji = acc.finalize()
    assert_ids_tie_tolerant(got["i"], ji, _oracle(q, b, 5), TOL)
    np.testing.assert_allclose(got["d"], jd, atol=TOL)


def _jax_screened_stream(q, b, k, batches):
    """The JAX ShardedStreamingKNN(engine="screened") over `batches`, with
    the diagnostics its tier controller observed and the pending one."""
    observed = []
    real = jknn.ScreenTierController.observe

    def spy(self, diag, *args):
        observed.append(np.asarray(diag))
        return real(self, diag, *args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jknn.ScreenTierController, "observe", spy)
        acc = jsk.ShardedStreamingKNN(q, k=k, mesh=_jmesh(2),
                                      engine="screened")
        off = 0
        for size in batches:
            acc.update(b[off:off + size], off)
            off += size
        d, i = acc.finalize()
    pending = (np.asarray(acc._pending_diag[0]) if acc._pending_diag
               else np.array([-1, -1, -1]))
    return d, i, np.array(observed, dtype=np.int64).reshape(-1, 3), \
        pending, acc._tier_idx


def test_small_shard_screened_runs_exact(port):
    """engine="screened" on shards below one mega-tile runs the exact scan:
    the screened engine is never called."""
    q, b = W.gauss(22, (8, 24), (2 * 64, 24))
    got = _case(port, "small_shard_screened", 2)
    assert int(got["screened_calls"]) == 0
    jd, ji = jsk.sharded_knn(q, b, 5, _jmesh(2), engine="screened")
    assert_ids_tie_tolerant(got["i"], np.asarray(ji), _oracle(q, b, 5), TOL)


@pytest.mark.parametrize("name,seed,q_rows,batches", [
    ("screened_one_mega", 21, 6, (W.MEGA * 2,)),
    ("screened_ragged", 31, 8, W.SCREENED_RAGGED)])
def test_screened_stream_matches_jax(port, name, seed, q_rows, batches):
    """The screened engine per shard (the plain version of the screen
    kernel here, the Pallas kernel in interpret mode there), one mega-tile
    per shard or two plus a ragged tail padded to the widest batch: the
    same neighbours, and the same worst-shard repair diagnostics into the
    same tier controller."""
    k = 7
    q, b = W.gauss(seed, (q_rows, 16), (sum(batches), 16))
    got = _case(port, name, 2)
    assert int(got["screened_calls"]) == len(batches)
    jd, ji, observed, pending, tier = _jax_screened_stream(q, b, k, batches)
    assert_ids_tie_tolerant(got["i"], ji, _oracle(q, b, k), SCREENED_TOL)
    np.testing.assert_allclose(got["d"], jd, atol=SCREENED_TOL)
    np.testing.assert_array_equal(got["observed"], observed)
    np.testing.assert_array_equal(got["pending"], pending)
    assert int(got["tier"]) == tier


def test_checkpoint_round_trip_and_shape_guard(port):
    """state_arrays -> restore on the (2, 2) mesh finishes the stream as an
    uninterrupted one; the same checkpoint restores into the JAX package's
    mesh accumulator; a state of another padded shape fails at once,
    naming both shapes."""
    q, b = W.normalized()
    q = q[:99]
    got = _case(port, "checkpoint", 4)
    assert got["ckpt_d"].shape == (100, 10) and int(got["seen"]) == 500
    np.testing.assert_array_equal(got["i"], got["i_whole"])
    np.testing.assert_array_equal(got["d"], got["d_whole"])
    assert "(98, 10)" in str(got["mismatch"]) \
        and "(100, 10)" in str(got["mismatch"])
    acc = jsk.ShardedStreamingKNN(q, k=10, mesh=_jmesh(4))
    acc.restore(got["ckpt_d"], got["ckpt_i"], 500)
    acc.update(b[500:], 500)
    jd, ji = acc.finalize()
    assert_ids_tie_tolerant(got["i"], ji, _oracle(q, b, 10), TOL)
    np.testing.assert_allclose(got["d"], jd, atol=TOL)


def test_compute_knn_ds_mesh_matches_jax(port, tmp_path):
    """The dataset pipeline over the (1, 2) mesh writes the JAX mesh run's
    finals."""
    q, b = W.normalized()
    idx, dist = _case(port, "pipeline", 2)["i"], \
        _case(port, "pipeline", 2)["d"]
    _copy_embeddings(port[2] / "pipeline", tmp_path)
    jpipe.compute_knn_ds(str(tmp_path), q.shape[1], "q.parquet", len(q),
                         "b.parquet", len(b), k=10, initial_batch_size=300,
                         mesh=_jmesh(2))
    j_idx, j_dist = _finals(str(tmp_path))
    assert_ids_tie_tolerant(idx, j_idx, _oracle(q, b, 10), TOL)
    np.testing.assert_allclose(dist, j_dist, atol=TOL)


def test_jax_mesh_checkpoint_resumes_in_port(port):
    """A JAX compute_knn_ds(mesh=(2, 2)) killed after its checkpoint at 400
    rows resumes in the port's compute_knn_ds under 4 gloo ranks (same
    .npz keys, same padded state), streams only the unseen rows, consumes
    the checkpoint, and writes the uninterrupted JAX run's finals."""
    q, b = W.normalized()
    got = _case(port, "handoff", 4)
    assert got["offsets"].min() >= 400, got["offsets"]
    assert not bool(got["ckpt_left"])
    jdir = str(port["root"] / "handoff_jax")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpipe, "plan_knn", _fixed_plan(200))
        jpipe.compute_knn_ds(jdir, q.shape[1], "q.parquet", len(q),
                             "b.parquet", len(b), k=10, mesh=_jmesh(4),
                             checkpoint_every=1)
    j_idx, j_dist = _finals(jdir)
    assert_ids_tie_tolerant(got["i"], j_idx, _oracle(q, b, 10), TOL)
    np.testing.assert_allclose(got["d"], j_dist, atol=TOL)


RESULT_CASES = [(2, n) for n in W.case_names("knn", 2)
                if n not in ("k_exceeds_shard", "unknown_engine")] \
    + [(4, n) for n in W.case_names("knn", 4)]


@pytest.mark.parametrize("world,name", RESULT_CASES)
def test_every_rank_returns_the_same_result(port, world, name):
    """Results gathered over dp are whole on every rank, and replicated
    ones agree across ranks (a distance-only ring merge once made them
    differ per device)."""
    res = load_rank_results(port[world], name, world)
    for other in res[1:]:
        assert other.keys() == res[0].keys()
        for key in res[0]:
            np.testing.assert_array_equal(other[key], res[0][key], key)


def test_nw_mesh_1_on_the_cpu(tmp_path, capsys):
    """`nw --mesh 1 --device cpu`: a single-rank group in process, the
    streamed path (implied), artifacts the JAX package's validators
    accept; the group is closed afterwards."""
    q, b, k = 20, 200, 5
    model = "intfloat/e5-small-v2"
    nw_main([str(q), str(b), "-k", str(k), "-m", model, "--synthetic",
             "--post-validation", "--yes", "--device", "cpu", "--mesh", "1",
             "--no-gen-hdf5", "--data-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "dataset API:         True" in out
    assert "mesh:                dp=1 x mp=1, rank 0, gloo" in out
    assert "Total mismatch count: 0" in out
    assert not torch.distributed.is_initialized()
    data_dir = naming.get_model_data_homedir(
        str(tmp_path), model + "_synthetic", q, b, k)
    files = naming.get_ivec_fvec_filenames(data_dir, model, 384, b, q, k)
    assert fvec.read_vectors(files[2]).shape == (q, k)
    assert jval.validate_files(data_dir, *files, metric="sqeuclidean") == 0
    assert jval.validate_files_v0(data_dir, *files) == 0
