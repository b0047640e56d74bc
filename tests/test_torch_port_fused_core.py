"""The plain versions of the kNN core's fused kernels (ops/fused_core.py)
and the engines around them, on the CPU, against the JAX package's jitted
functions they stand for: F1 `prepare_plain` against `_prepare_arrays`, F2
(`distance_tile_plain` inside `_knn_scan` / `_knn_full`) against JAX's
`_knn_scan` / `_knn_full`, F3 (`_exact_pair_dists` on (query rows, base,
ids)) against JAX's `_exact_pair_dists` on gathered rows, over random,
repeated and shared ids and none, F3's routing on meta tensors standing
for CUDA tensors (a fake library: one `rerank_rows_launch` a call), and
`screened_knn_traced` end to end at 1, 2 and 3 passes with planted class-A
and class-B repairs (the JAX screen kernel in interpret mode).

Tolerances: the bf16 operand bit for bit (NaN rows as NaN on both sides,
whose payloads the two frameworks' conversions write differently); norms
within (dim + 16) 2^-24 relative; statistics at or above the float64
truth; distances within 1e-5 (fp32 sums in another order); ids equal but
for ties (tests/torch_port_util.py)."""

import contextlib

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


def _rerank_case(case, seed=0, q_rows=33, m=40, n=500, dim=130):
    """(q, b, ids) of an F3 call: a NaN base row (6); random ids, the
    first of each row the NaN row, or ids repeated within a row, one id
    shared by every query, ids outside the base, no ids at all."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((q_rows, dim)).astype(np.float32)
    b = rng.standard_normal((n, dim)).astype(np.float32)
    b[6] = np.nan
    ids = rng.integers(0, n, (q_rows, m))
    if case == "random":
        ids[:, 0] = 6
    elif case == "repeated":                 # ids repeated within a row
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
@pytest.mark.parametrize("dim,case", [
    pytest.param(7, "random", id="7"), pytest.param(64, "random", id="64"),
    pytest.param(130, "random", id="130"), (130, "repeated"),
    (130, "shared"), (130, "empty")])
def test_exact_pair_dists_matches_jax(metric, dim, case):
    q, b, ids = _rerank_case(case, seed=dim, dim=dim)
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


# ------------------------------------------------- F3 on the card's path


class _FakeRerankLibrary:
    """Stands for the built rerank_rows library: each launch returns `err`
    and is recorded with its arguments."""

    def __init__(self, err=0):
        self.err, self.calls = err, []

    def launcher(self, name, entry="launch"):
        def launch(*args):
            self.calls.append((name, entry, args))
            return self.err
        return launch


@pytest.fixture()
def card(monkeypatch):
    """Meta tensors take F3's kernel path (the CUDA checks widened to
    them), on a fake library; the plain version raises if called."""
    lib = _FakeRerankLibrary()
    monkeypatch.setattr(fc, "_launcher", lib.launcher)
    monkeypatch.setattr(fc, "_stream", lambda dev: 7)
    monkeypatch.setattr(fc, "_cuda_f32", lambda t, name: t.contiguous())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())

    def plain(*a, **kw):
        raise AssertionError("rerank_rows ran its plain version on the card")
    monkeypatch.setattr(fc, "rerank_plain", plain)
    fc.reset_launches()
    return lib


@pytest.mark.parametrize("case", ["repeated", "shared", "out_of_range",
                                  "empty"])
def test_card_tensors_launch_rerank_rows_once(card, case):
    """Each call launches rerank_rows_launch once, counted under
    "rowwise", with the shapes and metric code the C interface takes and
    16-byte loads (`vec`) exactly where dim % 4 == 0 and the base is
    aligned; the ids go to the kernel as they are, in int64."""
    _, b, ids = _rerank_case(case)
    q_rows, m = ids.shape
    for dim, offset, vec in ((128, 0, 1), (130, 0, 0), (128, 1, 0)):
        q = torch.empty((q_rows, dim), device="meta")
        base = torch.empty(len(b) * dim + offset, device="meta")[offset:]
        t_ids = torch.empty(ids.shape, dtype=torch.int32, device="meta")
        out = fc.rerank_rows(q, base.view(len(b), dim), t_ids, "cosine")
        assert out.shape == ids.shape and out.dtype == torch.float32
        name, entry, args = card.calls[-1]
        assert (name, entry) == ("rerank_rows", "launch")
        assert len(args) == len(fc._ARGTYPES["rerank_rows"]["launch"])
        assert args[1] == base.data_ptr() and args[3] == out.data_ptr()
        assert args[4:] == (q_rows, m, dim, len(b), 2, vec, 7)
    assert len(card.calls) == 3
    assert fc.rerank_rows.launches == 3
    assert fc.rerank_rows.launches_by_variant == {"rowwise": 3, "plain": 0}


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
    q, b, ids = _rerank_case("repeated")
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
