"""PyTorch port of the kNN engines vs the JAX reference and a float64
oracle: the exact engine, the screened engine with its certificate and
repairs (planted bin collisions), the plans and budgets, the adaptive tier
controller and the streaming accumulator. The JAX screen kernel runs in
interpret mode on the CPU; the port's CPU path runs the kernel's plain
PyTorch version.

Tolerances: indices are compared exactly wherever the float64 distances
are distinct at fp32 resolution; distances within 1e-4 abs (fp32 sums
in a different order on O(100)-sized squared distances)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from neighborhoodwatch_tpu.ops import knn as jknn
from neighborhoodwatch_tpu.ops import screen_kernel as jsk

from neighborhoodwatch_tpu_torch.ops import knn as tknn

from tests.torch_port_util import assert_ids_tie_tolerant

MEGA = jsk.MEGA


def _data(q_n, b_n, d, seed, normalize=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((q_n, d)).astype(np.float32)
    b = rng.standard_normal((b_n, d)).astype(np.float32)
    if normalize:
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        b /= np.linalg.norm(b, axis=1, keepdims=True)
    return q, b


def _oracle(q, b, k, metric):
    q64, b64 = q.astype(np.float64), b.astype(np.float64)
    if metric in ("sqeuclidean", "euclidean"):
        dm = ((q64 ** 2).sum(1)[:, None] + (b64 ** 2).sum(1)[None, :]
              - 2 * q64 @ b64.T)
    elif metric == "cosine":
        qn = q64 / np.linalg.norm(q64, axis=1, keepdims=True)
        bn = b64 / np.linalg.norm(b64, axis=1, keepdims=True)
        dm = 1.0 - qn @ bn.T
    else:
        dm = 1.0 - q64 @ b64.T
    return np.argsort(dm, axis=1, kind="stable")[:, :k]


def _oracle_sorted(q, b, k, metric):
    """The oracle's k best distances, ascending, in float64 and on the
    metric's own scale (the scale the distance tolerance is stated on)."""
    q64, b64 = q.astype(np.float64), b.astype(np.float64)
    if metric in ("sqeuclidean", "euclidean"):
        dm = np.maximum((q64 ** 2).sum(1)[:, None]
                        + (b64 ** 2).sum(1)[None, :] - 2 * q64 @ b64.T, 0.0)
        if metric == "euclidean":
            dm = np.sqrt(dm)
    elif metric == "cosine":
        qn = q64 / np.linalg.norm(q64, axis=1, keepdims=True)
        bn = b64 / np.linalg.norm(b64, axis=1, keepdims=True)
        dm = 1.0 - qn @ bn.T
    else:
        dm = 1.0 - q64 @ b64.T
    return np.sort(dm, axis=1)[:, :k]


def _same_sets(idx, oracle):
    for r in range(len(oracle)):
        assert set(np.asarray(idx)[r].tolist()) == set(oracle[r]), r


def _port_knn(q, b, k, **kw):
    d, i = tknn.knn(q, b, k, device="cpu", **kw)
    return d.numpy(), i.numpy()


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean", "cosine",
                                    "dot"])
def test_exact_engine_matches_jax_on_conftest_workload(normalized_vectors,
                                                       metric):
    """Q=100, B=1000, k=10, 384d: single-tile and scanned (shifted
    pad-free last tile) exact engines, with a base offset."""
    q, b = normalized_vectors
    k = 10
    jd, ji = jknn.knn(q, b, k, metric=metric, engine="exact")
    # both engines take sqrt before the selection, which folds squared
    # distances one ulp apart into fp32 ties: which of two tied neighbours
    # comes first then depends on the matmul's rounding on this machine.
    # Ids are compared exactly wherever the oracle's distances are more
    # than the distance tolerance (1e-5) apart, as sets where they tie.
    tol = 1e-5
    # k + 1 oracle values: a tie across the k-th boundary lets the two
    # sides hold different members of it
    osort = _oracle_sorted(q, b, k + 1, metric)
    for tile in (None, 384):
        td, ti = _port_knn(q, b, k, metric=metric, engine="exact",
                           tile_size=tile, base_offset=7)
        assert ti.dtype == np.int32
        assert_ids_tie_tolerant(ti - 7, np.asarray(ji), osort, tol)
        np.testing.assert_allclose(td, np.asarray(jd), atol=tol, rtol=0)
    _same_sets(ti - 7, _oracle(q, b, k, metric))
    # "verified" and "auto" on the CPU are the exact engine
    for engine in ("verified", "auto", "screened"):
        td2, ti2 = _port_knn(q, b, k, metric=metric, engine=engine)
        assert_ids_tie_tolerant(ti2, np.asarray(ji), osort, tol)
        np.testing.assert_allclose(td2, np.asarray(jd), atol=tol, rtol=0)


@pytest.mark.parametrize("metric", ["sqeuclidean", "cosine", "dot"])
def test_screened_engine_matches_jax_two_megas(metric):
    """2 x MEGA rows x 48d through the screen, the certified re-rank and
    the repair: indices equal to the JAX screened engine and the float64
    oracle."""
    q, b = _data(8, 2 * MEGA, 48, seed=2, normalize=metric == "cosine")
    k = 25
    jd, ji = jknn.knn(q, b, k, metric=metric, engine="screened")
    td, ti = _port_knn(q, b, k, metric=metric, engine="screened")
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_allclose(td, np.asarray(jd), atol=1e-4, rtol=0)
    _same_sets(ti, _oracle(q, b, k, metric))
    te, ie = _port_knn(q, b, k, metric=metric, engine="exact")
    np.testing.assert_array_equal(ti, ie)


def _plant_one_bin(q, b, qi, start, spacing=1e-3, n=5):
    """n near-identical rows 128 apart: one lane bin, more than KEEP-1."""
    target = q[qi] + 1e-4 * np.arange(q.shape[1], dtype=np.float32)
    for j in range(n):
        b[start + j * 128] = target + spacing * j


def _traced_both(q, b, k, metric="sqeuclidean", precision="default", **kw):
    jd, ji, jdiag = jknn.screened_knn_traced(
        jnp.asarray(q), jnp.asarray(b), b.shape[0], 0, k, metric, precision,
        with_diagnostics=True, **kw)
    td, ti, tdiag = tknn.screened_knn_traced(
        torch.from_numpy(q), torch.from_numpy(b), b.shape[0], 0, k, metric,
        precision, with_diagnostics=True, **kw)
    return (np.asarray(jd), np.asarray(ji), tuple(np.asarray(jdiag))), \
        (td.numpy(), ti.numpy(), tdiag)


def _check_repair(q, b, k, want_diag, **kw):
    (jd, ji, jdiag), (td, ti, tdiag) = _traced_both(q, b, k, **kw)
    assert tdiag == jdiag == want_diag, (tdiag, jdiag)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, atol=1e-4, rtol=0)
    _same_sets(ti, _oracle(q, b, k, "sqeuclidean"))


def test_class_a_bin_repair_matches_jax():
    """A 5-way collision in one lane bin fails query 0's bin certificate;
    the suspicious-bin repair (class A) recovers it, on both sides."""
    q, b = _data(4, MEGA, 32, seed=41)
    _plant_one_bin(q, b, 0, 7)
    _check_repair(q, b, 5, (1, 0, 0))


def test_class_b_rescan_matches_jax():
    """Collisions in more than REPAIR_BINS bins of one query force the
    class-B full rescan."""
    q, b = _data(3, MEGA, 32, seed=43)
    bins = tknn.REPAIR_BINS + 1
    for bin_j in range(bins):
        _plant_one_bin(q, b, 0, bin_j + 3)
        b[[bin_j + 3 + j * 128 for j in range(5)]] += 0.01 * bin_j
    _check_repair(q, b, 4 * bins, (0, 1, 0))


def test_whole_batch_recompute_matches_jax():
    """More class-B queries than the budget (max_fallback=1): the whole
    batch is recomputed exactly, and both engines say so."""
    q, b = _data(3, MEGA, 32, seed=53)
    bins = tknn.REPAIR_BINS + 1
    for qi in (0, 2):
        for bin_j in range(bins):
            start = qi + bin_j * 7 + 3
            _plant_one_bin(q, b, qi, start)
            b[[start + j * 128 for j in range(5)]] += 0.01 * bin_j
    _check_repair(q, b, 4 * bins, (0, 2, 1), max_fallback=1)


def test_class_a_budget_overflow_falls_to_class_b_like_jax():
    """160 queries all flag class A at k=5; the class-A budget floors at
    128 rows, so the 32 past it must take the class-B rescan."""
    nq = 160
    q, b = _data(nq, MEGA, 32, seed=59)
    for qi in range(nq):
        _plant_one_bin(q, b, qi, (qi // 128) * 1024 + qi % 128)
    _check_repair(q, b, 5, (160, 32, 0))


def test_prepared_base_stats_and_error_bounds_match_jax():
    q, b = _data(8, MEGA + 300, 48, seed=23)
    b[17] = np.nan                       # excluded from the stats
    jbn, jstats, jbhi = jknn._prepare_arrays(jnp.asarray(b))
    prep = tknn.prepare_base(b, device="cpu")
    np.testing.assert_allclose(prep.stats.numpy(), np.asarray(jstats),
                               rtol=2e-6)
    np.testing.assert_allclose(prep.bn_row.numpy(), np.asarray(jbn),
                               rtol=2e-6)
    np.testing.assert_array_equal(
        prep.bhi.float().numpy(), np.asarray(jbhi.astype(jnp.float32)))
    for passes in (1, 2):
        want = jknn._screen_err_bounds(jnp.asarray(q), jnp.asarray(b),
                                       passes, base_stats=jstats)
        got = tknn._screen_err_bounds(torch.from_numpy(q),
                                      torch.from_numpy(b), passes,
                                      base_stats=prep.stats)
        for w, g in zip(want, got):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-6)
    b[17] = 0.5
    prep = tknn.prepare_base(b, device="cpu")
    d0, i0 = _port_knn(q, b, 10, engine="screened")
    d1, i1 = tknn.knn(q, prep, 10, engine="screened", device="cpu")
    np.testing.assert_array_equal(i0, i1.numpy())
    np.testing.assert_array_equal(d0, d1.numpy())


def test_plans_and_budgets_match_jax():
    for k in (1, 10, 100, 150, 600):
        for passes in (1, 2, 3):
            for lean in (False, True):
                for cap in (50, 1000, 100_000):
                    assert (tknn._merge_width(k, passes, cap, lean)
                            == jknn._merge_width(k, passes, cap, lean))
                for n in (MEGA, 1_000_000):
                    for sub in (28, 56, 112):
                        assert (tknn._screen_plan(n, k, 1536, sub, passes,
                                                  lean)
                                == jknn._screen_plan(n, k, 1536, sub,
                                                     passes, lean))
        for q_rows in (3, 1000, 10_000, 24_576, 100_000):
            for rate in (0.05, 0.02, 0.004, 0.0065, 0.002):
                assert (tknn._chernoff_budget(q_rows, rate, k)
                        == jknn._chernoff_budget(q_rows, rate, k))
            for sub in (None, 56, 112):
                for mf in (None, 1, 200):
                    assert (tknn._repair_budget(q_rows, mf, sub, k)
                            == jknn._repair_budget(q_rows, mf, sub, k))
    for m in (128, 256, 4096):
        for dim in (48, 1536, 65536):
            assert tknn._gather_block(m, dim) == jknn._gather_block(m, dim)
            assert tknn._acc_rel(dim) == jknn._acc_rel(dim)
            assert tknn._eps3_rel(dim) == jknn._eps3_rel(dim)
    assert tknn._BIN_FLAG_RATE == jknn._BIN_FLAG_RATE
    assert tknn.REPAIR_BINS == jknn.REPAIR_BINS
    assert tknn._SCREEN_MIN_BASE == jknn._SCREEN_MIN_BASE == 2 * MEGA


def test_tier_controller_follows_jax_ladder():
    """Same diagnostics sequence -> same escalations and de-escalations."""
    rng = np.random.default_rng(61)
    jc, tc = jknn.ScreenTierController(), tknn.ScreenTierController()
    seq = ([(600, 0, 0)] + [(0, 0, 0)] * 20 + [(0, 200, 1)]
           + [(int(x), 0, 0) for x in rng.integers(0, 400, 40)])
    for diag in seq:
        level = tc.tier_idx
        jc.observe(np.array(diag), level, 10_000, 1_000_000, 100)
        tc.observe(diag, level, 10_000, 1_000_000, 100)
        assert tc.tier_idx == jc.tier_idx and tc.tier_arg == jc.tier_arg
    for args in (("auto",), ("high",), ("medium",)):
        assert tknn.resolve_screen_tier(*args) == \
            jknn.resolve_screen_tier(*args)


def test_streaming_screened_matches_jax():
    """StreamingKNN with the screened engine and the adaptive tier over two
    base batches equals the JAX accumulator, tier decisions included.

    Batches end on a 512-row boundary: in interpret mode the JAX kernel
    reads a partially filled 512-row block's missing rows as NaN, whose
    keys decode to NaN certificate minima and fail every query's bin
    certificate (a class-A repair that changes no result but does move
    the tier controller); the port masks rows past B with +inf."""
    q, b = _data(6, 2 * MEGA + 1024, 48, seed=67)
    k = 12
    n = MEGA + 512
    ja = jknn.StreamingKNN(q, k, engine="screened")
    ta = tknn.StreamingKNN(q, k, engine="screened", device="cpu")
    for off in (0, n):
        ja.update(jnp.asarray(b[off:off + n]), off)
        ta.update(b[off:off + n], off)
    jd, ji = ja.finalize()
    td, ti = ta.finalize()
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, atol=1e-4, rtol=0)
    assert ta._tier_idx == ja._tier_idx
    _same_sets(ti, _oracle(q, b, k, "sqeuclidean"))
