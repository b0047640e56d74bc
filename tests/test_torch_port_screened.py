"""PyTorch port's host-repair engine `ops/knn.py:screened_knn` against the
JAX package's `screened_knn` (its screen kernel in interpret mode) and a
float64 oracle, on the CPU, where the port runs the kernel's plain
version: every metric on one mega-tile plus a ragged tail, a 2-mega
aligned base against the exact engine, the tiny-base and k > cap early
returns, base_offset, the merge-width clamp, planted duplicates, and a
planted bin collision that fails the certificate and takes the repair.

Ids are equal but for ties (tests/torch_port_util.py), distances within
1e-5 relative. A JAX base that ends inside a 512-row block reads NaN in
interpret mode, which changes its repair counts but not its results, so
only final results are compared."""

import numpy as np
import pytest

from neighborhoodwatch_tpu.ops import knn as jknn
from neighborhoodwatch_tpu.ops import screen_kernel as jsk

from neighborhoodwatch_tpu_torch.ops import knn as tknn
from neighborhoodwatch_tpu_torch.ops import screen_kernel as tsk

from tests.torch_port_util import assert_ids_tie_tolerant

MEGA = jsk.MEGA
TOL = 1e-5


def _data(q_n, b_n, d, seed, normalize=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((q_n, d)).astype(np.float32)
    b = rng.standard_normal((b_n, d)).astype(np.float32)
    if normalize:
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        b /= np.linalg.norm(b, axis=1, keepdims=True)
    return q, b


def _oracle_sorted(q, b, k, metric):
    """The float64 oracle's k best distances, ascending, on the metric's
    own scale."""
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


@pytest.fixture()
def spy(monkeypatch):
    """Counts the port's screens and the rows of its exact rescans."""
    seen = {"screens": 0, "rescan_rows": 0}
    screen, scan = tsk.screen_candidates, tknn._knn_scan

    def counted_screen(*a, **kw):
        seen["screens"] += 1
        return screen(*a, **kw)

    def counted_scan(query, *a, **kw):
        seen["rescan_rows"] += query.shape[0]
        return scan(query, *a, **kw)
    monkeypatch.setattr(tsk, "screen_candidates", counted_screen)
    monkeypatch.setattr(tknn, "_knn_scan", counted_scan)
    return seen


def _compare(q, b, k, metric="sqeuclidean", base_offset=0, **kw):
    """Port vs JAX screened_knn on the same inputs; returns the port's
    (dist, idx) as numpy."""
    jd, ji = jknn.screened_knn(q, b, k, metric=metric,
                               base_offset=base_offset, interpret=True, **kw)
    td, ti = tknn.screened_knn(q, b, k, metric=metric,
                               base_offset=base_offset, device="cpu", **kw)
    td, ti = td.numpy(), ti.numpy()
    assert ti.dtype == np.int32 and td.shape == ti.shape == (len(q), k)
    osort = _oracle_sorted(q, b, min(k + 1, len(b)), metric)
    assert_ids_tie_tolerant(ti - base_offset,
                            np.asarray(ji) - base_offset, osort, TOL)
    np.testing.assert_allclose(td, np.asarray(jd), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(td, osort[:, :k], rtol=TOL, atol=TOL)
    return td, ti


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean", "cosine",
                                    "dot"])
def test_one_mega_ragged_tail_all_metrics(metric, spy):
    q, b = _data(16, MEGA + 1000, 64, seed=1)
    _compare(q, b, 10, metric)
    assert spy["screens"] == 1


@pytest.mark.parametrize("precision", ["medium", "high"])
def test_explicit_tiers(precision, spy):
    q, b = _data(12, MEGA + 333, 48, seed=17)
    _compare(q, b, 8, "cosine", screen_precision=precision)
    assert spy["screens"] == 1


def test_two_megas_aligned_matches_exact_engine(spy):
    q, b = _data(8, 2 * MEGA, 48, seed=2)
    td, ti = _compare(q, b, 25)
    ed, ei = tknn.knn(q, b, 25, engine="exact", device="cpu")
    assert_ids_tie_tolerant(ti, ei.numpy(), _oracle_sorted(q, b, 26,
                                                           "sqeuclidean"),
                            TOL)
    np.testing.assert_allclose(td, ed.numpy(), rtol=TOL, atol=TOL)
    assert spy["screens"] == 1


def test_tiny_base_takes_exact_engine(spy):
    q, b = _data(8, 500, 32, seed=3)
    _compare(q, b, 5)
    assert spy["screens"] == 0


def test_k_above_cap_takes_exact_engine(spy):
    """One mega holds 128 lanes x (KEEP-1) = 384 candidates: k=400 cannot be
    represented, so no screen runs."""
    q, b = _data(4, MEGA, 16, seed=11)
    sub = tsk.pick_sub(MEGA, 400)
    cap, _, _ = tknn._screen_plan(MEGA, 400, 16, sub, 1, lean=True)
    assert cap < 400
    _compare(q, b, 400)
    assert spy["screens"] == 0


def test_base_offset_added_last(spy):
    q, b = _data(4, MEGA + 17, 32, seed=4)
    _, i0 = tknn.screened_knn(q, b, 5, device="cpu")
    _, i1 = _compare(q, b, 5, base_offset=1234)
    np.testing.assert_array_equal(i1, i0.numpy() + 1234)


@pytest.mark.parametrize("m", [3, 16, 512])
def test_merge_width_clamped(m, spy):
    """m below k is raised to k, m above the cap lowered to it; a slim m
    fails certificates, whose rows are rescanned, and stays exact."""
    q, b = _data(6, MEGA + 200, 32, seed=13)
    _compare(q, b, 12, m=m)
    assert spy["screens"] == 1


def test_planted_duplicates_first_at_zero(spy):
    q, b = _data(6, MEGA + 31, 32, seed=13)
    for r in range(6):
        b[100 + 97 * r] = q[r]
    d, i = _compare(q, b, 4)
    for r in range(6):
        assert i[r, 0] == 100 + 97 * r, (r, i[r])
        assert abs(d[r, 0]) < 1e-4, d[r]


def test_bin_collision_fails_certificate_and_is_repaired(spy):
    """Five near-copies of a query 128 rows apart share one lane bin, which
    keeps 4: query 0's certificate fails and its row is rescanned exactly
    and written back."""
    q, b = _data(4, MEGA, 32, seed=5)
    target = q[0] + 1e-4 * np.arange(32, dtype=np.float32)
    for j in range(5):
        b[7 + j * 128] = target + 1e-6 * j
    _, i = _compare(q, b, 5)
    assert set(i[0].tolist()) == {7 + j * 128 for j in range(5)}
    assert spy["screens"] == 1 and spy["rescan_rows"] >= 1
