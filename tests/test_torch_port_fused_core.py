"""The plain versions of the kNN core's fused kernels (ops/fused_core.py)
and the engines around them, on the CPU, against the JAX package's jitted
functions they stand for: F1 `prepare_plain` against `_prepare_arrays`, F2
(`distance_tile_plain` inside `_knn_scan` / `_knn_full`) against JAX's
`_knn_scan` / `_knn_full`, F3 (`_exact_pair_dists` on (query rows, base,
ids)) against JAX's `_exact_pair_dists` on gathered rows, F3's grouped
order (`group_pairs_plain`, `rerank_group_plain`: the pairs sorted by id,
distances computed there and scattered back, bit for bit
`pair_distances`' over the pairs in their own order) and its launch plan
(`rerank_plan`), and
`screened_knn_traced` end to end at 1, 2 and 3 passes with planted class-A
and class-B repairs (the JAX screen kernel in interpret mode).

Tolerances: the bf16 operand bit for bit (NaN rows as NaN on both sides,
whose payloads the two frameworks' conversions write differently); norms
within (dim + 16) 2^-24 relative; statistics at or above the float64
truth; distances within 1e-5 (fp32 sums in another order); ids equal but
for ties (tests/torch_port_util.py)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from neighborhoodwatch_tpu.ops import knn as jknn
from neighborhoodwatch_tpu.ops import screen_kernel as jsk

from neighborhoodwatch_tpu_torch.ops import fused_core as fc
from neighborhoodwatch_tpu_torch.ops import knn as tknn

from tests.torch_port_util import assert_ids_tie_tolerant

TOL = 1e-5
METRICS = ("sqeuclidean", "euclidean", "cosine", "dot")


def _planted_rows(n, dim, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, dim)).astype(np.float32)
    x[3] = np.nan                            # a NaN row
    x[5, 1] = np.inf                         # +inf and -inf rows
    x[7, 0] = -np.inf
    x[9] = 0.0                               # a zero row
    x[11, -1] = 3.4e38                       # overflows to inf in bf16
    x[13, 0] = np.nan                        # one NaN entry
    x[15] *= 1e-3                            # a short row
    x[17, 0] = 1.0 + 2.0 ** -8               # a tie: rounds to even
    return x


@pytest.mark.parametrize("dim", [7, 64, 130])
def test_prepare_plain_matches_jax(dim):
    x = _planted_rows(300, dim, seed=dim)
    jbn, jstats, jbhi = jknn._prepare_arrays(jnp.asarray(x))
    bn, stats, bhi = fc.prepare_plain(torch.from_numpy(x))
    jbits = np.asarray(jbhi).view(np.uint16)
    bits = bhi.view(torch.int16).numpy().view(np.uint16)
    nan = np.isnan(np.asarray(jbhi.astype(jnp.float32)))
    np.testing.assert_array_equal(np.isnan(bhi.float().numpy()), nan)
    np.testing.assert_array_equal(bits[~nan], jbits[~nan])
    assert bits[11, -1] == 0x7F80            # the overflow to +inf
    jbn = np.asarray(jbn)
    fin = np.isfinite(jbn)
    np.testing.assert_array_equal(np.isfinite(bn.numpy()), fin)
    rel = (dim + 16) * 2.0 ** -24
    np.testing.assert_array_less(np.abs(bn.numpy() - jbn)[fin],
                                 rel * jbn[fin] + 1e-38)
    np.testing.assert_allclose(stats.numpy(), np.asarray(jstats),
                               rtol=2 * rel)
    # the statistics bound the float64 truth over the rows kept
    x64 = x.astype(np.float64)
    b64 = (x64 ** 2).sum(1)
    lo64 = np.sqrt(((x64 - bhi.double().numpy()) ** 2).sum(1))
    pos = fin & (b64 > 0)
    truth = [b64[fin].max(), np.sqrt(b64[fin].max()), lo64[fin].max(),
             (lo64[pos] / np.sqrt(b64[pos])).max()]
    assert all(float(stats[j]) >= truth[j] for j in range(4))
    # the norms alone: the same sums as F1's bn_row
    np.testing.assert_array_equal(fc.sq_norms(torch.from_numpy(x)).numpy(),
                                  bn.numpy())


def _data(q_n, b_n, d, seed, normalize=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((q_n, d)).astype(np.float32)
    b = rng.standard_normal((b_n, d)).astype(np.float32)
    if normalize:
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        b /= np.linalg.norm(b, axis=1, keepdims=True)
    return q, b


def _oracle_sorted(q, b, n_valid, k, metric):
    q64, b64 = q.astype(np.float64), b[:n_valid].astype(np.float64)
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


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("dim,n_b,n_valid,tile", [
    (64, 1000, 1000, 384),                   # shifted last tile
    (7, 900, 733, 256),                      # rows past n_valid masked
    (130, 500, 411, None)])                  # one tile, n_valid masked
def test_scan_and_full_match_jax(metric, dim, n_b, n_valid, tile):
    q, b = _data(20, n_b, dim, seed=dim + n_b)
    k = 15
    if tile is None:
        jd, ji = jknn._knn_full(jnp.asarray(q), jnp.asarray(b), n_valid, 5,
                                k, metric, "highest")
        td, ti = tknn._knn_full(torch.from_numpy(q), torch.from_numpy(b),
                                n_valid, 5, k, metric)
    else:
        jd, ji = jknn._knn_scan(jnp.asarray(q), jnp.asarray(b), n_valid, 5,
                                k, metric, "highest", tile)
        td, ti = tknn._knn_scan(torch.from_numpy(q), torch.from_numpy(b),
                                n_valid, 5, k, metric, tile)
    osort = _oracle_sorted(q, b, n_valid, k + 1, metric)
    assert_ids_tie_tolerant(ti.numpy() - 5, np.asarray(ji) - 5, osort, TOL)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=TOL,
                               atol=TOL)
    assert int(ti.max()) < n_valid + 5


@pytest.mark.parametrize("metric", METRICS)
def test_distance_tile_plain_matches_jax_epilogue(metric):
    """The plain F2 on the port's norms and products against JAX's
    pairwise_distance with the scan's mask, garbage rows included."""
    from neighborhoodwatch_tpu.ops.distance import pairwise_distance as jpd
    from neighborhoodwatch_tpu_torch.ops import distance as tdist
    q, b = _data(9, 300, 64, seed=4)
    b[2] = np.nan
    b[3, 0] = np.inf
    lo, hi = 40, 250
    want = np.asarray(jpd(jnp.asarray(q), jnp.asarray(b), metric=metric))
    want = np.where((np.arange(300) >= lo) & (np.arange(300) < hi), want,
                    np.inf)
    qx, qn = tdist.query_operand(torch.from_numpy(q), metric)
    got = tdist.tile_distance(qx, qn, torch.from_numpy(b), None, metric,
                              lo=lo, hi=hi).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("dim", [7, 64, 130])
def test_exact_pair_dists_matches_jax(metric, dim):
    rng = np.random.default_rng(dim)
    q = rng.standard_normal((33, dim)).astype(np.float32)
    b = rng.standard_normal((500, dim)).astype(np.float32)
    b[6] = np.nan
    ids = rng.integers(0, 500, (33, 40))
    ids[:, 0] = 6
    want = np.asarray(jknn._exact_pair_dists(jnp.asarray(q),
                                             jnp.asarray(b[ids]), metric))
    for block in (None, 8):
        got = tknn._exact_pair_dists(torch.from_numpy(q), torch.from_numpy(b),
                                     torch.from_numpy(ids), metric,
                                     block).numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        fin = ~np.isnan(want)
        np.testing.assert_allclose(got[fin], want[fin], rtol=TOL,
                                   atol=TOL * dim)


def _plant_one_bin(q, b, qi, start, spacing=1e-3, n=5):
    """n near-identical rows 128 apart: one lane bin, more than KEEP-1."""
    target = q[qi] + 1e-4 * np.arange(q.shape[1], dtype=np.float32)
    for j in range(n):
        b[start + j * 128] = target + spacing * j


@pytest.mark.parametrize("precision", ["default", "medium", "high"])
@pytest.mark.parametrize("case", ["class_a", "class_b"])
def test_screened_traced_repairs_match_jax(precision, case):
    """A planted collision in one lane bin (class A) or in more bins than
    REPAIR_BINS (class B) at each screen tier: the repair counts, ids and
    distances equal JAX's, the ids the float64 oracle's."""
    q, b = _data(4, jsk.MEGA, 32, seed=41)
    k = 5
    if case == "class_a":
        _plant_one_bin(q, b, 0, 7)
        want = (1, 0, 0)
    else:
        bins = tknn.REPAIR_BINS + 1
        for bin_j in range(bins):
            _plant_one_bin(q, b, 0, bin_j + 3)
            b[[bin_j + 3 + j * 128 for j in range(5)]] += 0.01 * bin_j
        k = 4 * bins
        want = (0, 1, 0)
    jd, ji, jdiag = jknn.screened_knn_traced(
        jnp.asarray(q), jnp.asarray(b), b.shape[0], 0, k, "sqeuclidean",
        precision, with_diagnostics=True)
    td, ti, tdiag = tknn.screened_knn_traced(
        torch.from_numpy(q), torch.from_numpy(b), b.shape[0], 0, k,
        "sqeuclidean", precision, with_diagnostics=True)
    assert tdiag == tuple(np.asarray(jdiag)) == want
    osort = _oracle_sorted(q, b, len(b), k + 1, "sqeuclidean")
    assert_ids_tie_tolerant(ti.numpy(), np.asarray(ji), osort, TOL)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=TOL,
                               atol=1e-4)


# ------------------------------------------------- F3's grouped variant


def _group_case(case, seed=0, q_rows=33, m=40, n=500, dim=130):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((q_rows, dim)).astype(np.float32)
    b = rng.standard_normal((n, dim)).astype(np.float32)
    b[6] = np.nan                            # a NaN row
    ids = rng.integers(0, n, (q_rows, m))
    if case == "repeated":                   # ids repeated within a row
        ids[:, 1::3] = ids[:, 0:1]
        ids[:, 2] = 6
    elif case == "shared":                   # one id shared by every query
        ids[:, 5] = 17
        ids[:, 7] = 17
    elif case == "out_of_range":
        ids[0, 3], ids[4, 0], ids[-1, -1] = n, -1, n + 100
    elif case == "empty":
        ids = ids[:, :0]
    return q, b, ids


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("case", ["repeated", "shared", "out_of_range",
                                  "empty"])
def test_grouped_order_equals_pair_distances(metric, case):
    """Distances computed in the grouped order (by id) and scattered back
    equal pair_distances over the pairs in their own order bit for bit (a
    row's product sum does not depend on where the pair lies); an id
    outside the base gives NaN there and nothing else changes; they agree
    with rerank_plain (torch.bmm's sums) and with JAX's _exact_pair_dists
    on the gathered rows within 1e-5 (fp32 sums in another order)."""
    q, b, ids = _group_case(case, seed=len(case) + len(metric))
    bad = (ids < 0) | (ids >= len(b))
    safe = np.where(bad, 0, ids)
    tq, tb = torch.from_numpy(q), torch.from_numpy(b)
    got = fc.rerank_group_plain(tq, tb, torch.from_numpy(ids), metric,
                                block=97)
    own = fc.pair_distances(tq[:, None, :], tb[torch.from_numpy(safe)],
                            metric)
    assert got.shape == ids.shape == own.shape
    assert bool(torch.isnan(got[torch.from_numpy(bad)]).all())
    keep = torch.from_numpy(~bad)
    assert torch.equal(got[keep].view(torch.int32),
                       own[keep].view(torch.int32))
    if ids.size:
        g = got.numpy()
        plain = fc.rerank_plain(tq, tb, torch.from_numpy(safe), metric,
                                block=8).numpy()
        ref = np.asarray(jknn._exact_pair_dists(jnp.asarray(q),
                                                jnp.asarray(b[safe]),
                                                metric))
        for want in (plain, ref):
            np.testing.assert_array_equal(np.isnan(g)[~bad],
                                          np.isnan(want)[~bad])
            fin = ~bad & ~np.isnan(want)
            np.testing.assert_allclose(g[fin], want[fin], rtol=TOL,
                                       atol=TOL * q.shape[1])


@pytest.mark.parametrize("case", ["repeated", "shared", "out_of_range"])
def test_group_pairs_plain(case):
    """Every pair once, groups ascending, each group the pair's id (B for
    an id outside the base), pairs in their order within a group."""
    _, b, ids = _group_case(case, seed=3)
    n = len(b)
    keys, pairs = fc.group_pairs_plain(torch.from_numpy(ids), n)
    keys, pairs = keys.numpy().astype(np.int64), pairs.numpy()
    assert sorted(pairs) == list(range(ids.size))
    assert (np.diff(keys) >= 0).all()
    ident = ids.reshape(-1)[pairs]
    np.testing.assert_array_equal(
        keys, np.where((ident >= 0) & (ident < n), ident, n))
    same = np.diff(keys) == 0
    assert (np.diff(pairs)[same] > 0).all()
    if case == "shared":                     # one group holds them all
        assert (keys == 17).sum() == (ids == 17).sum() >= 2 * ids.shape[0]


def test_rerank_plan_at_the_main_paths_shapes():
    """"rowwise" is F3's default; the grouped kernel, where forced, takes
    every call of the engines' shapes (its plan has rules of shape only):
    nw's 1,000 x 256 / 320 x 1024 over 100,000 rows, knn(auto)'s 10,000 x
    256 x 1536 over 1M, its class-A repair's 768 x 1,792 and a few
    queries, each with the workspace its C launch function recomputes."""
    assert fc.DEFAULT_VARIANT == {"rerank_rows": "rowwise"}
    for shape in ((1000, 256, 1024, 100_000), (1000, 320, 1024, 100_000),
                  (10_000, 256, 1536, 1_000_000),
                  (768, 1792, 1536, 1_000_000), (8, 512, 1536, 1_000_000),
                  (300, 256, 1536, 5000)):
        pl = fc.rerank_plan(*shape)
        assert (pl.variant, pl.reason) == ("grouped", "")
        assert pl.workspace_bytes == fc.rerank_workspace(*shape[:2],
                                                         shape[3])


def test_rerank_plan_refusals_and_workspace():
    plan = fc.rerank_plan
    assert plan(0, 256, 64, 10).reason == "empty"
    assert plan(1000, 0, 64, 10).reason == "empty"
    assert plan(1000, 256, 130, 10).reason == "dim"
    assert plan(1000, 256, 2052, 10).reason == "dim"
    assert plan(1000, 256, 2048, 100_000).variant == "grouped"
    assert plan(1000, 256, 4, 0).variant == "grouped"
    assert plan(1000, 256, 64, 10, aligned=False).reason == "unaligned"
    assert plan(2 ** 15, 2 ** 15, 64, 10).reason == "size"
    assert plan(1000, 256, 64, 2 ** 30).reason == "size"
    for bad in ((-1, 1, 4, 1), (1, 1, 4, -1)):
        with pytest.raises(ValueError):
            plan(*bad)
    # the layout's words: counts, scan totals, groups, pairs, query norms
    assert fc.rerank_workspace(3, 5, 9) == 4 * (12 + 4 + 16 + 16 + 4)


def test_rerank_plan_is_asked_once_a_shape(monkeypatch):
    """The wrapper's plan on a device, once a shape; the shapes it sends
    to "rowwise" kept with their reasons."""
    monkeypatch.setattr(fc, "_rerank_plans", {})
    fc.reset_launches()
    big = fc._plan_rerank("dev", 1000, 256, 1024, 100_000, True)
    assert big.variant == "grouped" and fc.rerank_rows.last_plan is big
    assert fc._plan_rerank("dev", 1000, 256, 1024, 100_000, True) is big
    odd = fc._plan_rerank("dev", 4, 64, 130, 100_000, True)
    assert odd.variant == "rowwise"
    loose = fc._plan_rerank("dev", 4, 64, 1024, 100_000, False)
    assert loose.variant == "rowwise"
    assert fc.rerank_rows.rowwise_plans == {
        (4, 64, 130, 100_000, True): "dim",
        (4, 64, 1024, 100_000, False): "unaligned"}
    fc.reset_launches()
    assert fc.rerank_rows.launches_by_variant == {"grouped": 0,
                                                  "rowwise": 0, "plain": 0}
    assert fc.rerank_rows.rowwise_plans == {}


def test_rerank_forced_variant_checks_and_restores():
    with pytest.raises(ValueError):
        with fc.forced_variant("split"):
            pass
    with fc.forced_variant("rowwise"):
        with fc.forced_variant("plain"):
            assert fc._forced_variant == "plain"
        assert fc._forced_variant == "rowwise"
    assert fc._forced_variant is None
    # CPU tensors take the plain version under any variant, uncounted
    q, b, ids = _group_case("repeated")
    fc.reset_launches()
    want = fc.rerank_plain(torch.from_numpy(q), torch.from_numpy(b),
                           torch.from_numpy(ids), "dot")
    for v in fc.VARIANTS:
        with fc.forced_variant(v):
            got = fc.rerank_rows(torch.from_numpy(q), torch.from_numpy(b),
                                 torch.from_numpy(ids), "dot")
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert fc.rerank_rows.launches == 0
    assert sum(fc.rerank_rows.launches_by_variant.values()) == 0
