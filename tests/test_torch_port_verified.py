"""The port's "verified" engine vs the JAX package's on the CPU.

The JAX engine selects each tile's candidates with `lax.approx_min_k`
(exact on the CPU, where XLA has no PartialReduce), proves the selection
with a count argument and falls back to `lax.top_k` for the whole tile when
a row fails. The port runs the same three stages in
ops/verified_kernel.py (the plain version here; csrc/verified_select.cu on
the card, held against it by tests/test_torch_port_cuda_verified.py), with
a per-row fallback.

Tolerances: distances within 1e-5 absolute (two fp32 products of the same
inputs, summed in another order); neighbour ids equal wherever the float64
oracle separates neighbours by more than that, and as sets up to ties
(tests/torch_port_util.py:assert_ids_tie_tolerant). Where the port is held
against its own exact engine, on the same products, ids and distances are
equal outright."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import neighborhoodwatch_tpu.ops.knn as jknn

from neighborhoodwatch_tpu_torch.ops import knn as tknn
from neighborhoodwatch_tpu_torch.ops import verified_kernel as vk
from neighborhoodwatch_tpu_torch.ops.topk import smallest_k
from neighborhoodwatch_tpu_torch.parallel import sharded_knn as tsk

from tests.torch_port_util import assert_ids_tie_tolerant

TOL = 1e-5
CPU = torch.device("cpu")
CUDA = torch.device("cuda")


def _data(seed, q=24, b=900, d=48, unit=True):
    rng = np.random.default_rng(seed)
    qv = rng.standard_normal((q, d)).astype(np.float32)
    bv = rng.standard_normal((b, d)).astype(np.float32)
    if unit:
        qv /= np.linalg.norm(qv, axis=1, keepdims=True)
        bv /= np.linalg.norm(bv, axis=1, keepdims=True)
    return qv, bv


def _oracle(q, b, metric, width):
    """float64 distances of every base row, ascending, `width` wide."""
    q64, b64 = q.astype(np.float64), b.astype(np.float64)
    if metric == "cosine":
        q64 = q64 / np.linalg.norm(q64, axis=1, keepdims=True)
        b64 = b64 / np.linalg.norm(b64, axis=1, keepdims=True)
        d = 1.0 - q64 @ b64.T
    else:
        d = ((q64[:, None, :] - b64[None, :, :]) ** 2).sum(-1)
    return np.sort(d, axis=1)[:, :width]


@pytest.mark.parametrize("metric", ["sqeuclidean", "cosine"])
@pytest.mark.parametrize("tile", [None, 256])
def test_verified_knn_matches_jax(metric, tile):
    """knn(engine="verified"), in one tile and scanned in 256-row tiles
    (the last one overlapping), against the JAX engine."""
    q, b = _data(1)
    k = 10
    jd, ji = jknn.knn(q, b, k=k, metric=metric, engine="verified",
                      tile_size=tile)
    td, ti = tknn.knn(q, b, k, metric=metric, engine="verified",
                      tile_size=tile, device="cpu")
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=TOL, rtol=0)
    assert_ids_tie_tolerant(ti.numpy(), np.asarray(ji),
                            _oracle(q, b, metric, k + 1), TOL)
    # and the port's own exact engine, on the same products: equal
    ed, ei = tknn.knn(q, b, k, metric=metric, engine="exact",
                      tile_size=tile, device="cpu")
    assert torch.equal(ti, ei) and torch.equal(td, ed)


@pytest.mark.parametrize("batches", [[300, 300, 300], [900]])
def test_verified_streaming_matches_jax(batches):
    """StreamingKNN(engine="verified") over base batches (the ragged ones
    scanned in 128-row tiles) against the JAX accumulator."""
    q, b = _data(2)
    k = 12
    jacc = jknn.StreamingKNN(q, k=k, engine="verified", tile_size=128)
    tacc = tknn.StreamingKNN(q, k=k, engine="verified", tile_size=128,
                             device="cpu")
    off = 0
    for n in batches:
        jacc.update(b[off:off + n], off)
        tacc.update(b[off:off + n], off)
        off += n
    jd, ji = jacc.finalize()
    td, ti = tacc.finalize()
    np.testing.assert_allclose(td, np.asarray(jd), atol=TOL, rtol=0)
    assert_ids_tie_tolerant(ti, np.asarray(ji),
                            _oracle(q, b, "sqeuclidean", k + 1), TOL)


def test_verified_engine_with_triplicate_ties():
    """Duplicated base rows force exact ties (the JAX package's own test,
    tests/test_verified_engine.py): no duplicate ids in a row, every
    reported distance equals its id's true distance, and the distances
    equal JAX's. Unit rows, so that 1e-5 is the absolute tolerance of the
    other tests."""
    q, b0 = _data(42, q=16, b=128, d=64)
    b = np.concatenate([b0, b0[:32], b0[:32]], axis=0)
    jd, _ = jknn.knn(q, b, k=12, engine="verified")
    for tile in (None, 96):
        td, ti = tknn.knn(q, b, 12, engine="verified", tile_size=tile,
                          device="cpu")
        td, ti = td.numpy(), ti.numpy()
        np.testing.assert_allclose(td, np.asarray(jd), atol=TOL, rtol=0)
        assert all(len(set(row)) == len(row) for row in ti.tolist())
        q64, b64 = q.astype(np.float64), b.astype(np.float64)
        true_d = np.array([((q64[i] - b64[ti[i]]) ** 2).sum(axis=1)
                           for i in range(len(q))])
        np.testing.assert_allclose(td, true_d, rtol=1e-5, atol=TOL)


def _tile_cases():
    rng = np.random.default_rng(5)
    d = rng.standard_normal((6, 300)).astype(np.float32) ** 2
    tail = d.copy()
    tail[:, 200:] = np.inf                  # a masked tail
    tail[2] = np.inf                        # an all-inf row
    coarse = np.round(d * 2) / 2            # many exact ties
    return {"random": d, "tail": tail, "coarse": coarse}


@pytest.mark.parametrize("case", ["random", "tail", "coarse"])
@pytest.mark.parametrize("k", [1, 40, 250, 300])
def test_verified_select_matches_jax_select(case, k):
    """The select alone on one distance tile against JAX's
    `_verified_smallest_k`: masked tails, an all-inf row, many ties, and k
    whose margin max(k + 28, 5k/4) exceeds the row (250, 300 of 300
    columns). Distances equal; ids as sets over the finite entries and
    equal to the exact engine's (the lowest positions among ties)."""
    d = _tile_cases()[case]
    jd, ji = jknn._verified_smallest_k(jnp.asarray(d), k)
    td, ti, ok = vk.verified_select(torch.from_numpy(d), k)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert bool(ok.all())
    ed, ei = smallest_k(torch.from_numpy(d), k)
    assert torch.equal(ti, ei) and torch.equal(td, ed)
    if case != "coarse":
        # no ties among finite values: the finite ids are the same sets
        for r in range(len(d)):
            fin = np.isfinite(td[r].numpy())
            assert set(ti[r].numpy()[fin].tolist()) == \
                set(np.asarray(ji)[r][fin].tolist())


_top_margin = vk.top_margin


def _drop_argmin(d, margin):
    """A candidate stage that misses each row's true nearest neighbour."""
    d = d.clone()
    d[torch.arange(len(d)), d.argmin(1)] = float("inf")
    return _top_margin(d, margin)


def test_planted_candidates_fail_the_proof_and_fall_back():
    """A candidate set without the row's minimum: the proof fails on every
    row, the failures are counted, and the fallback returns the exact
    engine's selection."""
    d = torch.from_numpy(_tile_cases()["random"])
    vk.reset_failed_rows()
    sd, si, ok = vk.verified_select_plain(d, 20, candidates=_drop_argmin)
    assert not bool(ok.any())
    assert vk.failed_rows() == len(d)
    ed, ei = smallest_k(d, 20)
    assert torch.equal(si, ei) and torch.equal(sd, ed)
    # the wrapper's `exclude` (the kernel's planted failure) on the CPU
    d2 = d.clone()
    d2[:, 7] = -1.0
    _, si2, ok2 = vk.verified_select(d2, 20, exclude=7)
    assert not bool(ok2.any()) and bool((si2[:, 0] == 7).all())
    assert vk.failed_rows() == 2 * len(d)


def test_planted_failure_inside_the_engine(monkeypatch):
    """The engine with a broken candidate stage on some tiles still
    returns the exact engine's result, and says how many rows fell back."""
    q, b = _data(3)
    monkeypatch.setattr(vk, "top_margin", _drop_argmin)
    vk.reset_failed_rows()
    td, ti = tknn.knn(q, b, 10, engine="verified", tile_size=256,
                      device="cpu")
    ed, ei = tknn.knn(q, b, 10, engine="exact", tile_size=256, device="cpu")
    assert torch.equal(ti, ei) and torch.equal(td, ed)
    assert vk.failed_rows() == len(q) * 4          # 4 tiles, every row


def test_proof_holds_where_a_tie_straddles_the_kth():
    """40 entries tie at the row's minimum and the candidate stage keeps
    the 31 with the HIGHEST positions: the selection is another tied
    subset than the exact engine's, and the count argument accepts it,
    as JAX's does (knn.py:74-78)."""
    d = torch.ones((2, 60))
    d[:, 40:] = 2.0

    def highest_positions(d, margin):
        sd, pos = _top_margin(d.flip(1), margin)
        return sd, d.shape[1] - 1 - pos
    sd, si, ok = vk.verified_select_plain(d, 3, candidates=highest_positions)
    assert bool(ok.all())
    assert sd.tolist() == [[1.0] * 3] * 2
    assert si.tolist() == [[9, 10, 11]] * 2      # 40 - 31 = 9 onwards
    assert smallest_k(d, 3)[1].tolist() == [[0, 1, 2]] * 2


def test_select_engine_by_device():
    """"auto" on the card: screened from two mega-tiles, verified below;
    on the CPU: exact (the JAX package off the TPU). Named engines pass
    through; the screened paths' fallbacks follow the device."""
    big = tknn._SCREEN_MIN_BASE
    assert tknn._select_engine("auto", big, CUDA) == "screened"
    assert tknn._select_engine("auto", big - 1, CUDA) == "verified"
    assert tknn._select_engine("auto", None, CUDA) == "verified"
    assert tknn._select_engine("auto", big, CPU) == "exact"
    assert tknn._select_engine("auto", 10, CPU) == "exact"
    for dev in (CPU, CUDA):
        for name in ("exact", "verified", "screened"):
            assert tknn._select_engine(name, 10, dev) == name
    with pytest.raises(ValueError, match="unknown engine"):
        tknn._select_engine("vrfied", 10, CPU)
    assert tknn._fallback_engine(CUDA) == "verified"
    assert tknn._fallback_engine(CPU) == "exact"
    # a mesh shard the screen does not take
    assert tsk._small_shard_engine("auto", CUDA) == "verified"
    assert tsk._small_shard_engine("screened", CUDA) == "verified"
    assert tsk._small_shard_engine("auto", CPU) == "exact"
    assert tsk._small_shard_engine("exact", CUDA) == "exact"
    assert tsk._small_shard_engine("verified", CPU) == "verified"


def test_verified_margin_and_support():
    assert vk.margin_for(8192, 100) == 128
    assert vk.margin_for(8192, 1024) == 1280
    assert vk.margin_for(8192, 1) == 29
    assert vk.margin_for(50, 40) == 50
    assert vk.supports(32768, 1024) and vk.supports(9000, 6553)
    assert not vk.supports(20000, 7000) and not vk.supports(10, 11)
    with pytest.raises(ValueError):
        vk.verified_select(torch.zeros((2, 10)), 11)
    with pytest.raises(ValueError):
        vk.verified_select(torch.zeros((2, 40)), 20, exclude=3)


def test_sharded_small_shard_runs_the_scan_engine():
    """On the CPU a sharded fold's small shard with an explicit verified
    request scans with the verified select and matches the exact one."""
    q, b = _data(4, q=8, b=600)
    qt, bt = torch.from_numpy(q), torch.from_numpy(b)
    out = {}
    for eng in ("verified", "exact"):
        d, i, diag = tsk._shard_topk(qt, bt, 590, 1000, 7, "sqeuclidean",
                                     eng, 128, "auto", False)
        out[eng] = (d, i)
        assert diag == (0, 0, 0)
    assert torch.equal(out["verified"][0], out["exact"][0])
    assert torch.equal(out["verified"][1], out["exact"][1])
    assert int(out["exact"][1].max()) < 1590


def test_screened_knn_small_base_matches_jax():
    """screened_knn below one mega-tile takes the exact engine in both
    packages; the port's result equals JAX's."""
    q, b = _data(6, q=10, b=500)
    jd, ji = jknn.screened_knn(q, b, 9)
    td, ti = tknn.screened_knn(q, b, 9, device="cpu")
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=TOL, rtol=0)
    assert_ids_tie_tolerant(ti.numpy(), np.asarray(ji),
                            _oracle(q, b, "sqeuclidean", 10), TOL)
