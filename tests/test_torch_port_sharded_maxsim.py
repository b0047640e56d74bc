"""PyTorch port of the MaxSim scale-out layer (parallel/sharded_maxsim.py,
compute_maxsim_knn(mesh=), `ck --maxsim --mesh`) against the JAX package on
the CPU.

As tests/test_torch_port_sharded.py: the JAX reference runs in this
process on (1, 2) and (2, 2) meshes of the virtual 8-device mesh, its
MaxSim screen kernel in interpret mode as tests/test_sharded_maxsim.py runs
it; the port runs in one spawn of 2 gloo ranks and one of 4, started
together by a module-scoped fixture (tests/torch_port_mesh_worker.py),
where the screen runs the kernel's plain PyTorch version.

Tolerances: scores within 1e-3 abs (fp32 sums of up to 8 token maxima of
O(10) each, as tests/test_torch_port_maxsim.py states them); ids
tie-tolerant against the float64 oracle at that tolerance; per tile, the
adaptive tier, the tiles escalated to the 3-pass screen and the query rows
repaired exactly equal to the JAX package's."""

import os
import shutil

import numpy as np
import pyarrow.parquet as pq
import pytest
import torch

import neighborhoodwatch_tpu.core.colbert_pipeline as jcp
import neighborhoodwatch_tpu.core.pipeline as jpipe
import neighborhoodwatch_tpu.validate as jval
from neighborhoodwatch_tpu.ops import maxsim as jm
from neighborhoodwatch_tpu.ops import maxsim_kernel as jmk
from neighborhoodwatch_tpu.parallel import sharded_maxsim as jsm
from neighborhoodwatch_tpu.parallel.mesh import make_mesh as jax_mesh

from neighborhoodwatch_tpu_torch.cli import ck_main
from neighborhoodwatch_tpu_torch.io import fvec
from neighborhoodwatch_tpu_torch.io.parquet_io import ParquetStreamer
from neighborhoodwatch_tpu_torch.parallel import sharded_maxsim as tsm
from neighborhoodwatch_tpu_torch.utils import naming

from tests import torch_port_mesh_worker as W
from tests.torch_port_util import (
    assert_ids_tie_tolerant, load_rank_results, maxsim_oracle_wide,
    start_mesh_ranks, wait_mesh_ranks,
)

SCORE_TOL = 1e-3
DIM = 16
COLS = [f"token_embedding_{i}" for i in range(DIM)]


def _jmesh(world):
    return jax_mesh(2) if world == 2 else jax_mesh(4, dp=2)


# ---- the doc-tracked token dataset of the pipeline handoff

def _docs(rng, n, lo, hi):
    return [rng.standard_normal((int(rng.integers(lo, hi)), DIM))
            .astype(np.float32) for _ in range(n)]


def _handoff_docs():
    rng = np.random.default_rng(8)
    return _docs(rng, 5, 2, 6), _docs(rng, 23, 2, 9)


def _write_dataset(root):
    """q_src.parquet (one row group) and b_src.parquet (three)."""
    os.makedirs(f"{root}/partial", exist_ok=True)
    for name, docs, chunks in (("q_src", _handoff_docs()[0], 1),
                               ("b_src", _handoff_docs()[1], 3)):
        toks = np.concatenate(docs, axis=0)
        ids = np.concatenate([np.full(len(t), i, np.int32)
                              for i, t in enumerate(docs)])
        step = -(-len(toks) // chunks)
        with ParquetStreamer(f"{root}/{name}.parquet", COLS) as st:
            for s in range(0, len(toks), step):
                st.stream_tokens_with_doc_ids(toks[s:s + step],
                                              ids[s:s + step])


def _jax_maxsim_run(root, die_after_checkpoint=False):
    """The JAX package's compute_maxsim_knn over a (2, 2) mesh in 8-doc
    tiles with a checkpoint after each parquet batch; killed right after
    its first checkpoint when asked."""
    real = jpipe._save_stream_ckpt

    def save_and_die(*args):
        real(*args)
        raise RuntimeError("simulated crash after a checkpoint")

    with pytest.MonkeyPatch.context() as mp:
        if die_after_checkpoint:
            mp.setattr(jpipe, "_save_stream_ckpt", save_and_die)
        return jcp.compute_maxsim_knn(
            root, f"{root}/q_src.parquet", f"{root}/b_src.parquet", k=4,
            tile_docs=8, batch_rows=40, checkpoint_every=1, mesh=_jmesh(4))


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """{world: directory of the ranks' npz files}: both spawns."""
    root = tmp_path_factory.mktemp("maxsim_mesh")
    dirs = {2: root / "w2", 4: root / "w4"}
    os.makedirs(dirs[2])
    procs = start_mesh_ranks("maxsim", 2, 1, dirs[2])
    try:
        handoff = str(dirs[4] / "maxsim_handoff")
        _write_dataset(handoff)
        shutil.copytree(handoff, root / "maxsim_jax")
        with pytest.raises(RuntimeError, match="simulated"):
            _jax_maxsim_run(handoff, die_after_checkpoint=True)
        assert os.path.exists(jpipe._stream_ckpt_path(handoff))
        procs += start_mesh_ranks("maxsim", 4, 2, dirs[4])
    finally:
        wait_mesh_ranks(procs)
    return {**dirs, "root": root}


def _case(port, name, world):
    res = load_rank_results(port[world], name, world)
    assert "error" not in res[0], str(res[0]["error"])
    return res[0]


def _jax_stream(name, k, tiles, world, **kw):
    """The JAX ShardedStreamingMaxSim over the case's tiles; per tile the
    tier, the tiles escalated to the 3-pass screen (its row replacement)
    and the query rows the exact repair recomputed, as the port counts
    them."""
    q, qm, d, dm = W.maxsim_inputs(name)
    counts = {"escalated": 0, "repaired": 0}
    real_replace, real_topk = jsm._replace_rows, jm.maxsim_topk

    def replace(*args):
        counts["escalated"] += 1
        return real_replace(*args)

    def repair(queries, *args, **kwargs):
        counts["repaired"] += len(queries)
        return real_topk(queries, *args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsm, "_replace_rows", replace)
        mp.setattr(jm, "maxsim_topk", repair)
        acc = jsm.ShardedStreamingMaxSim(q, qm, k=k, mesh=_jmesh(world), **kw)
        off, trail = 0, []
        for size in tiles:
            acc.update(d[off:off + size], dm[off:off + size], off)
            off += size
            trail.append((acc._tier_idx, counts["escalated"],
                          counts["repaired"]))
        s, i = acc.finalize()
    return s, i, np.array(trail, dtype=np.int64)


def _oracle_sorted(q, qm, d, dm, k, chunk=4096):
    """The float64 MaxSim oracle's best k + 1 scores per query, descending
    (maxsim_oracle's arithmetic, vectorized over doc chunks)."""
    q = np.where(qm[..., None], q, 0.0).astype(np.float64)
    scores = []
    for s in range(0, len(d), chunk):
        sims = np.einsum("qtx,dsx->qtds", q, d[s:s + chunk].astype(np.float64))
        sims = np.where(dm[None, None, s:s + chunk], sims, -np.inf).max(3)
        scores.append(np.where(qm[..., None], sims, 0.0).sum(1))
    return -np.sort(-np.concatenate(scores, axis=1), axis=1)[:, :k + 1]


def _check(got, s, i, name, k):
    q, qm, d, dm = W.maxsim_inputs(name)
    wide = _oracle_sorted(q, qm, d, dm, k)
    assert_ids_tie_tolerant(got["i"], i, wide, SCORE_TOL)
    np.testing.assert_allclose(got["s"], s, atol=SCORE_TOL)
    np.testing.assert_allclose(got["s"], wide[:, :k], atol=SCORE_TOL)


@pytest.mark.parametrize("name,world,k,tiles,kw", [
    # multi-tile ragged widths, ragged query tokens, the dp axis
    ("matches", 4, 9, W.MAXSIM_TILES, {}),
    # 5 query rows over dp=2, tiles of 57 and 44 docs (not multiples of mp)
    ("tile_padding", 4, 4, (57, 44), {}),
    # one mega-tile per shard through the screen
    ("screened", 2, 6, (2 * W.MEGA_DOCS,), {"engine": "screened"}),
    # a ragged tail of 10 docs < k: the exact mesh path takes that tile
    ("ragged_tail", 2, 12, (2 * W.MEGA_DOCS, 10), {"engine": "screened"}),
    # the fixed 1-pass tier over two tiles of crowded docs: mass
    # certificate failures escalate each tile to the 3-pass screen, and
    # the first tile's rows are then repaired exactly
    ("escalation", 2, 10, (2 * W.MEGA_DOCS,) * 2,
     {"engine": "screened", "screen_precision": "default"}),
    # the adaptive tier controller fed the mesh-wide diagnostics
    ("adaptive", 2, 10, (2 * W.MEGA_DOCS,) * 3, {"engine": "screened"}),
])
def test_sharded_maxsim_matches_jax(port, name, world, k, tiles, kw):
    got = _case(port, name, world)
    s, i, trail = _jax_stream(name, k, tiles, world, **kw)
    _check(got, s, i, name, k)
    np.testing.assert_array_equal(got["trail"], trail)


def test_escalation_and_repair_are_exercised(port):
    """The escalation case escalates both tiles and repairs the first
    one's rows; the adaptive stream leaves the 3-pass tier after two
    clean tiles (the trails above equal the JAX package's)."""
    esc = _case(port, "escalation", 2)["trail"]
    np.testing.assert_array_equal(esc, [[0, 1, 16], [0, 2, 16]])
    ada = _case(port, "adaptive", 2)["trail"]
    np.testing.assert_array_equal(ada[:, 0], [0, 2, 2])


def test_forced_repair_is_exact(port):
    """Every certificate forced to fail: the sharded exact repair replaces
    every row of the tile, and the result is still exact."""
    got = _case(port, "forced_repair", 2)
    calls = []
    real = jm._maxsim_select

    def failing(*args, **kwargs):
        calls.append(1)
        out = real(*args, **kwargs)
        return (out[0], out[1], out[2] & False) + tuple(out[3:])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jm, "_maxsim_select", failing)
        s, i, trail = _jax_stream("forced_repair", 9, (2 * W.MEGA_DOCS,), 2,
                                  engine="screened")
    assert calls, "the forced-failure select never ran: a jit cache hit"
    _check(got, s, i, "forced_repair", 9)
    np.testing.assert_array_equal(got["trail"], trail)
    assert got["trail"][-1, 2] == 3          # every query row repaired


def test_checkpoint_round_trip_and_shape_guard(port):
    """state_arrays at 160 docs -> restore -> finish equals the JAX mesh
    stream; a state of another shape fails at once, naming both."""
    got = _case(port, "maxsim_checkpoint", 2)
    assert int(got["seen"]) == 160
    assert "(4, 4)" in str(got["mismatch"]) \
        and "(4, 5)" in str(got["mismatch"])
    q, qm, d, dm = W.maxsim_inputs("checkpoint")
    acc = jsm.ShardedStreamingMaxSim(q, qm, k=5, mesh=_jmesh(2))
    acc.update(d[:160], dm[:160], 0)
    acc.update(d[160:], dm[160:], 160)
    s, i = acc.finalize()
    _check(got, s, i, "checkpoint", 5)


def test_jax_mesh_checkpoint_resumes_in_port(port):
    """A JAX compute_maxsim_knn(mesh=(2, 2)) killed after its first
    checkpoint resumes in the port's compute_maxsim_knn under 4 gloo ranks
    and writes the uninterrupted JAX run's finals."""
    got = _case(port, "maxsim_handoff", 4)
    assert len(got["resumed_at"]) == 1 and got["resumed_at"][0] > 0
    assert tuple(got["counts"]) == (5, 23)
    jdir = str(port["root"] / "maxsim_jax")
    _jax_maxsim_run(jdir)
    j_idx = pq.read_table(
        naming.get_partial_indices_filename(jdir, -1)).to_pandas().values
    j_dist = pq.read_table(
        naming.get_partial_distances_filename(jdir, -1)).to_pandas().values
    q_docs, b_docs = _handoff_docs()
    q, qm = jm.pad_token_lists(q_docs, DIM)
    d, dm = jm.pad_token_lists(b_docs, DIM)
    _, _, wide = maxsim_oracle_wide(q, qm, d, dm, 4)
    assert_ids_tie_tolerant(got["i"], j_idx, wide, SCORE_TOL)
    np.testing.assert_allclose(got["d"], j_dist, atol=SCORE_TOL)
    np.testing.assert_allclose(got["d"], -wide[:, :4], atol=SCORE_TOL)


RESULT_CASES = [(2, n) for n in W.case_names("maxsim", 2)] \
    + [(4, n) for n in W.case_names("maxsim", 4)]


@pytest.mark.parametrize("world,name", RESULT_CASES)
def test_every_rank_returns_the_same_result(port, world, name):
    res = load_rank_results(port[world], name, world)
    for other in res[1:]:
        assert other.keys() == res[0].keys()
        for key in res[0]:
            np.testing.assert_array_equal(other[key], res[0][key], key)


def test_merge_partial_topk_desc_matches_bruteforce_and_jax():
    """Per-rank partial lists (descending, -inf padded, ties across ranks)
    merge to the whole-set top-k, ties by ascending doc id."""
    rng = np.random.default_rng(0)
    p, rows, kk, k = 3, 6, 5, 7
    all_s = np.round(rng.standard_normal((p, rows, kk)), 1).astype(np.float32)
    all_s = -np.sort(-all_s, axis=2)
    all_s[1, :, 3:] = -np.inf
    all_i = rng.permutation(p * rows * kk).reshape(p, rows, kk) \
        .astype(np.int32)
    s, i = tsm.merge_partial_topk_desc(all_s, all_i, k)
    js, ji = jsm.merge_partial_topk_desc(all_s, all_i, k)
    np.testing.assert_array_equal(s, js)
    np.testing.assert_array_equal(i, ji)
    for r in range(rows):
        pairs = sorted(zip(-all_s[:, r].ravel(), all_i[:, r].ravel()))[:k]
        np.testing.assert_array_equal(i[r], [x[1] for x in pairs])
        np.testing.assert_array_equal(s[r], [-x[0] for x in pairs])


def test_auto_engine_dim_gate_and_unknown_engine(monkeypatch):
    """"auto" asks the device-taking kernel predicate of the single-device
    engine: on CUDA tensors it takes the kernel where the JAX gate does on
    a TPU (dim <= 128 or a multiple of 128, tq <= 32, a mega-tile of docs
    per shard), never on the CPU; a failed plan and "exact" win; unknown
    engine names raise."""
    import jax
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    q = np.zeros((4, 8, 128), np.float32)
    jeng = jsm.ShardedStreamingMaxSim(q, np.ones((4, 8), bool), k=2,
                                      mesh=_jmesh(2))
    for docs, tq, ok, dim in [(W.MEGA_DOCS, 32, True, 128),
                              (W.MEGA_DOCS, 32, True, 256),
                              (W.MEGA_DOCS, 32, True, 192),
                              (W.MEGA_DOCS, 32, True, 200),
                              (W.MEGA_DOCS, 48, True, 128),
                              (W.MEGA_DOCS - 1, 32, True, 128),
                              (W.MEGA_DOCS, 32, False, 128)]:
        want = jeng._engine(docs, tq, ok, dim)
        assert tsm._shard_engine("auto", docs, tq, ok, dim, "cuda") == want
        assert tsm._shard_engine("auto", docs, tq, ok, dim, "cpu") == "exact"
        assert tsm._shard_engine("exact", docs, tq, ok, dim, "cuda") \
            == "exact"
        assert tsm._shard_engine("screened", docs, tq, ok, dim, "cpu") \
            == ("screened" if ok else "exact")
    assert jmk.MEGA_DOCS == W.MEGA_DOCS
    with pytest.raises(ValueError, match="unknown engine"):
        tsm.ShardedStreamingMaxSim(q, np.ones((4, 8), bool), k=2, mesh=None,
                                   engine="screend")


def test_ck_maxsim_mesh_1_on_the_cpu(tmp_path, capsys):
    """`ck --maxsim --mesh 1 --device cpu`: a single-rank group in
    process; the JAX package's MaxSim validator accepts the artifacts."""
    qt, bt, k = 120, 600, 5
    ck_main([str(qt), str(bt), "-k", str(k), "--synthetic", "-es", "small",
             "--maxsim", "--post-validation", "--yes", "--device", "cpu",
             "--mesh", "1", "--no-gen-hdf5", "--data-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "mesh:                dp=1 x mp=1, rank 0, gloo" in out
    assert "Total mismatch count: 0" in out
    assert not torch.distributed.is_initialized()
    data_dir = naming.get_model_data_homedir(
        str(tmp_path), "colbertv2.0_maxsim_synthetic", qt, bt, k)
    files = naming.get_ivec_fvec_filenames(data_dir, "colbertv2.0", 128, bt,
                                           qt, k)
    maps = naming.get_doc_id_map_filenames(data_dir, "colbertv2.0", 128, bt,
                                           qt)
    assert fvec.read_vectors(files[2]).shape[1] == k
    assert jval.validate_maxsim_files(data_dir, files[0], files[1], *maps,
                                      files[2], files[3]) == 0
