"""F4, the fallback tile's fp32 products as an exact bf16x6 split with the
distance epilogue fused in (csrc/split_distance.cu, ops/fused_core.py:
split_distance), on the CPU: the split, the plain version against float64
within the error model, the launch plan, the routing of
ops/distance.py:tile_distance with its counters, and the query pieces
cut once a scan.

The kernel runs only on the card (tests/test_torch_port_cuda_split_distance.py
holds it against the plain version and float64 there); meta tensors stand
for CUDA tensors here (the wrapper's device check and planned_split's
patched to let them through), with a fake library that records the
launches.

Tolerances: the split is exact (float64 sums of the pieces equal the
input); a distance of the plain version lies within the model's dot error
(fused_core.split_error_bound, in units of 2^-24 sum_k |q_k b_k|; twice
that for the (sq)euclidean metrics, which read 2 dot) plus the fp32 norms'
own rounding ((dim + 3) 2^-24 (|q|^2 + |b|^2)) of the float64 distance."""

import contextlib

import numpy as np
import pytest
import torch

from neighborhoodwatch_tpu_torch.ops import distance as tdist
from neighborhoodwatch_tpu_torch.ops import fused_core as fc
from neighborhoodwatch_tpu_torch.ops import knn as tknn
from neighborhoodwatch_tpu_torch.utils import profiling

U = 2.0 ** -24
METRICS = ("sqeuclidean", "euclidean", "cosine", "dot")


# ------------------------------------------------------------ the split


def _finite_patterns(n, seed):
    """n fp32 values from random bit patterns, the non-finite ones
    dropped, with the edges of the range added."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    x = bits.view(np.float32)
    x = x[np.isfinite(x)]
    edges = np.float32([3.4028235e38, -3.4028235e38, 1.1754944e-38,
                        -1.1754944e-38, 1.4e-45, 0.0, -0.0, 1.0, -1.0])
    return torch.from_numpy(np.concatenate([x, edges]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_reconstructs_every_finite_fp32(seed):
    """x0 + x1 + x2 == x for finite fp32 values across the whole range of
    bit patterns whose last bit lies at or above 2^-133 (|x| >= 2^-110;
    below, the loss is under 2^-133): each piece a bf16 value (low 16 bits
    zero) of x's sign or 0, |x1| <= 2^-7 |x|, |x2| <= 2^-14 |x|, every
    piece finite."""
    x = _finite_patterns(1 << 20, seed)
    pieces = fc.split_pieces_plain(x)
    x64 = x.double()
    total = sum(p.double() for p in pieces)
    for p in pieces:
        assert bool(torch.isfinite(p).all())
        assert int((p.view(torch.int32) & 0xFFFF).abs().max()) == 0
        assert bool((torch.sign(p) * torch.sign(x) >= 0).all())
    normal = x64.abs() >= 2.0 ** -110
    assert torch.equal(total[normal], x64[normal])
    assert bool(((total - x64).abs()[~normal] < 2.0 ** -133).all())
    assert bool((pieces[1].abs() <= 2.0 ** -7 * x64.abs()).all())
    assert bool((pieces[2].abs() <= 2.0 ** -14 * x64.abs()).all())


def test_split_of_non_finite_values():
    """x0 keeps inf, -inf and NaN (whatever a NaN's payload); their
    residual pieces are NaN."""
    x = torch.tensor([float("inf"), -float("inf"), float("nan"), 2.5])
    x = torch.cat([x, torch.tensor([0x7F800001, -4194304],
                                   dtype=torch.int32).view(torch.float32)])
    x0, x1, x2 = fc.split_pieces_plain(x)
    assert torch.equal(x0[:2], x[:2])
    assert bool(torch.isnan(x0[[2, 4, 5]]).all())
    assert bool(torch.isnan(x1[[0, 1, 2, 4, 5]]).all())
    assert float(x0[3] + x1[3] + x2[3]) == 2.5


# ------------------------------------------------- the plain version


def _rows(rng, n, dim, planted=False):
    x = rng.standard_normal((n, dim)).astype(np.float32)
    if planted:
        x[1, 3] = np.inf                     # a non-finite row each
        x[2] = np.nan
        x[4, 0] = -np.inf
        x[5] *= 2.0 ** rng.integers(-20, 20, dim)   # a wide exponent range
    return torch.from_numpy(x)


def _float64_distances(q, b, metric):
    q64, b64 = q.double(), b.double()
    if metric == "cosine":
        q64 = q64 / q64.norm(dim=1, keepdim=True)
        b64 = b64 / b64.norm(dim=1, keepdim=True)
    dot = q64 @ b64.T
    scale = q64.abs() @ b64.abs().T
    norms = (q64 * q64).sum(1)[:, None] + (b64 * b64).sum(1)[None, :]
    if metric in ("sqeuclidean", "euclidean"):
        d = torch.clamp_min(norms - 2.0 * dot, 0.0)
        return (d.sqrt() if metric == "euclidean" else d), scale, norms
    return 1.0 - dot, scale, norms


def _slack(metric, bound, dim, d64, scale, norms):
    """The largest |distance - float64 distance| the model allows."""
    if metric in ("sqeuclidean", "euclidean"):
        sq = 2 * bound * U * scale + (dim + 3) * U * norms
        if metric == "sqeuclidean":
            return sq
        return torch.sqrt(sq) + 2 * U * d64     # |sqrt(a) - sqrt(b)|
    return bound * U * scale + 2 * U * d64.abs() + U   # <= sqrt(|a - b|)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("dim,lo,hi", [(100, 0, None), (128, 3, 60),
                                       (256, 0, 50), (384, 10, None),
                                       (1024, 0, None), (1536, 7, 69)])
def test_plain_within_the_model_of_float64(metric, dim, lo, hi):
    """split_distance_plain at the plan's chunk against float64 distances:
    within the model where both sides are finite, +inf on the non-finite
    rows and outside [lo, hi), finite elsewhere."""
    rng = np.random.default_rng(dim)
    q, b = _rows(rng, 24, dim, planted=True), _rows(rng, 70, dim)
    b[9] = float("nan")
    qx, qn = tdist.query_operand(q, metric)
    bx = tdist._safe_normalize(b) if metric == "cosine" else b
    bn = fc.sq_norms(bx) if qn is not None else None
    kc = fc.split_chunk_for(dim)
    got = fc.split_distance_plain(qx, qn, bx, bn, metric, lo, hi).double()
    want, scale, norms = _float64_distances(q, b, metric)
    bound = fc.split_error_bound(dim, kc)
    cols = torch.arange(70)
    valid = ((cols >= lo) & (cols < (70 if hi is None else hi)))[None, :] \
        & torch.isfinite(want)
    assert bool(torch.isinf(got[~valid]).all())
    assert bool((got[~valid] > 0).all())
    assert bool(torch.isfinite(got[valid]).all())
    err = (got - want).abs()[valid]
    slack = _slack(metric, bound, dim, want, scale, norms)[valid]
    assert bool((err <= slack).all()), float((err / slack).max())


@pytest.mark.parametrize("kc", [32, 64, 128])
def test_plain_on_cancelling_dots(kc):
    """Dots that cancel heavily (large terms summing to about 0) stay
    within the model at every chunk the plan can take."""
    rng = np.random.default_rng(kc)
    dim = 512
    q = rng.standard_normal((8, dim)).astype(np.float32)
    b = rng.standard_normal((8, dim)).astype(np.float32)
    prod = rng.standard_normal(dim) * 1e3
    prod[-1] = -prod[:-1].sum()
    b[0] = (prod / q[0]).astype(np.float32)
    q, b = torch.from_numpy(q), torch.from_numpy(b)
    got = fc.split_distance_plain(q, None, b, None, "dot", kc=kc).double()
    want, scale, _ = _float64_distances(q, b, "dot")
    err = (got - want).abs()
    slack = _slack("dot", fc.split_error_bound(dim, kc), dim, want, scale,
                   None)
    assert bool((err <= slack).all())


def test_plain_refuses_a_dim_no_chunk_admits():
    with pytest.raises(ValueError, match="no chunk"):
        fc.split_distance_plain(torch.ones(2, 64), None, torch.ones(3, 64),
                                None, "dot")


# ------------------------------------------------------------- the plan


def test_chunk_by_dim():
    """The longest chunk whose bound stays within dim: 128 at the cells'
    1,024 and 1,536 dims and from 328 up, 64 at 176-324, 32 at 100-172,
    none below 100 (those dims keep the fp32 path)."""
    assert fc.split_chunk_for(1536) == fc.split_chunk_for(1024) == 128
    assert 526 < fc.split_error_bound(1536, 128) < 527
    assert 441 < fc.split_error_bound(1024, 128) < 442
    assert fc.split_chunk_for(328) == fc.split_chunk_for(384) == 128
    assert fc.split_chunk_for(176) == fc.split_chunk_for(324) == 64
    assert fc.split_chunk_for(100) == fc.split_chunk_for(172) == 32
    assert fc.split_chunk_for(96) == fc.split_chunk_for(64) == 0


def test_the_plans_chunk_is_the_longest_the_bound_admits():
    for dim in range(4, 4100, 4):
        kc = fc.split_chunk_for(dim)
        longer = [c for c in fc.SPLIT_CHUNKS if c > kc]
        assert all(fc.split_error_bound(dim, c) > dim for c in longer)
        if kc:
            assert fc.split_error_bound(dim, kc) <= dim


@pytest.mark.parametrize("shape,reason", [
    ((0, 8192, 1536), "empty"), ((10000, 0, 1536), "empty"),
    ((10000, 8192, 1534), "dim"), ((10000, 8192, 96), "dim"),
    ((10000, 8192, 1537), "dim"),
    ((fc.SPLIT_MIN_Q - 1, 8192, 1024), "rows"), ((70, 999, 130), "dim"),
    ((fc.SPLIT_MIN_Q_NARROW - 1, 8192, 1020), "rows"),
    ((fc.SPLIT_MIN_Q, 8192, 512), "rows")])
def test_plan_sends_to_the_fp32_path(shape, reason):
    pl = fc.split_plan(*shape)
    assert (pl.route, pl.reason) == ("fp32", reason)
    assert fc.split_plan(10000, 8192, 1536, aligned=False).reason == \
        "unaligned"


def test_fewest_query_rows_by_dim():
    """F4 takes SPLIT_MIN_Q query rows from SPLIT_WIDE_DIM dims and
    SPLIT_MIN_Q_NARROW below (the crossovers timed on the card)."""
    wide, narrow = fc.SPLIT_WIDE_DIM, fc.SPLIT_WIDE_DIM - 4
    assert fc.split_min_q(wide) == fc.split_min_q(1536) == fc.SPLIT_MIN_Q
    assert fc.split_min_q(narrow) == fc.split_min_q(100) == \
        fc.SPLIT_MIN_Q_NARROW
    assert fc.split_plan(fc.SPLIT_MIN_Q, 8192, wide).route == "split"
    assert fc.split_plan(fc.SPLIT_MIN_Q_NARROW - 1, 8192, narrow).reason \
        == "rows"
    assert fc.split_plan(fc.SPLIT_MIN_Q_NARROW, 8192, narrow).route == \
        "split"


@pytest.mark.parametrize("q_rows,t_rows,dim,kc,cluster,grid", [
    (10000, 8192, 1536, 128, 2, 80 * 64), (10000, 8192, 1024, 128, 2, 5120),
    (1000, 8192, 1024, 128, 2, 8 * 64), (fc.SPLIT_MIN_Q, 1, 1024, 128, 2, 2),
    (fc.SPLIT_MIN_Q_NARROW, 1, 100, 32, 2, 8),
    (fc.SPLIT_MIN_Q_NARROW, 129, 256, 64, 2, 16)])
def test_plan_of_the_main_shapes(q_rows, t_rows, dim, kc, cluster, grid):
    pl = fc.split_plan(q_rows, t_rows, dim)
    assert pl == fc.SplitPlan("split", "", kc, cluster, grid,
                              fc.SPLIT_SMEM, fc.split_error_bound(dim, kc))
    # the launcher's shared memory: four 48 KB slots, 1 KB alignment, bars
    assert fc.SPLIT_SMEM == 1024 + 4 * 49152 + 64


def test_plan_refuses_what_it_cannot_plan():
    with pytest.raises(ValueError):
        fc.split_plan(-1, 8, 128)


# ------------------------------------------- the wrapper on a fake card


class _FakeLibrary:
    """Stands for the built library: records each launch, returns `err`."""

    def __init__(self, err=0):
        self.err, self.calls = err, []

    def launcher(self, name, entry="launch"):
        def launch(*args):
            self.calls.append((name, entry, args))
            return self.err
        return launch


@pytest.fixture()
def card(monkeypatch):
    """Meta tensors take the kernels' path on a fake library; the fp32
    route's library product runs on meta tensors as on CUDA ones."""
    lib = _FakeLibrary()
    monkeypatch.setattr(fc, "_cuda_f32", lambda t, name: t)
    monkeypatch.setattr(fc, "planned_split", fc.split_plan_for)
    monkeypatch.setattr(fc, "_launcher", lib.launcher)
    monkeypatch.setattr(fc, "_stream", lambda dev: 7)
    monkeypatch.setattr(fc, "_split_plans", {})
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    fc.reset_launches()
    return lib


def _meta(q_rows, t_rows, dim):
    t = dict(device="meta")
    return (torch.zeros((q_rows, dim), **t), torch.zeros(q_rows, **t),
            torch.zeros((t_rows, dim), **t), torch.zeros(t_rows, **t))


@pytest.mark.parametrize("metric,code", [("sqeuclidean", 0),
                                         ("euclidean", 1), ("dot", 2)])
def test_tile_distance_launches_f4_on_its_plan(card, metric, code):
    q, qn, b, bn = _meta(1000, 8192, 1024)
    out = tdist.tile_distance(q, qn, b, bn, metric, "highest", lo=5,
                              hi=9000)
    assert out.shape == (1000, 8192) and out.device.type == "meta"
    names = [(n, e) for n, e, _ in card.calls]
    assert names == [("split_distance", "pieces_launch"),
                     ("split_distance", "pieces_launch"),
                     ("split_distance", "launch")]
    (_, _, pq), (_, _, pb), (_, _, args) = card.calls
    assert pq[1:4] == (1000, 1024, 1024) and pb[1:4] == (8192, 1024, 1024)
    assert len(args) == len(fc._ARGTYPES["split_distance"]["launch"])
    pl = fc.split_plan(1000, 8192, 1024)
    # Q, T, dim, lo, hi (clamped to T), metric, kc, cluster, smem, stream
    assert args[5:] == (1000, 8192, 1024, 5, 8192, code, pl.kc, pl.cluster,
                        pl.smem_bytes, 7)
    l2 = metric != "dot"
    assert (args[2] is not None, args[3] is not None) == (l2, l2)
    assert fc.split_distance.launches == 1
    assert fc.split_distance.split_launches == 2
    assert fc.split_distance.last_plan == pl


@pytest.mark.parametrize("shape", [(1000, 8192, 1536), (10000, 8192, 1024)])
def test_the_query_is_cut_once_per_tensor(card, shape):
    """query_pieces cuts the query once, and every tile handed its pieces
    cuts only the tile; a tile without them cuts the query itself; the
    bf16 precisions and a shape on the fp32 path cut nothing."""
    q, qn, b, bn = _meta(*shape)
    qp = tdist.query_pieces(q, b, "highest")
    assert qp.shape == (3, shape[0], fc.piece_ld(shape[2]))
    assert fc.split_distance.split_launches == 1
    for _ in range(3):
        tdist.tile_distance(q, qn, b, bn, "sqeuclidean", q_pieces=qp)
    assert fc.split_distance.split_launches == 1 + 3
    assert fc.split_distance.launches == 3
    tdist.tile_distance(q, qn, b, bn, "sqeuclidean")
    assert fc.split_distance.split_launches == 4 + 2
    assert tdist.query_pieces(q, b, "high") is None
    assert tdist.query_pieces(q[:fc.SPLIT_MIN_Q - 1], b, "highest") is None
    assert fc.split_distance.split_launches == 6


def test_split_distance_refuses_pieces_of_another_query(card):
    q, qn, b, bn = _meta(1000, 8192, 1024)
    with pytest.raises(ValueError, match="query pieces"):
        fc.split_distance(q, qn, b, bn, "sqeuclidean",
                          q_pieces=fc.split_pieces(q[:999]))


@pytest.mark.parametrize("engine", ["exact", "verified"])
def test_the_scan_cuts_the_query_once_a_call(monkeypatch, engine):
    """_knn_scan asks query_pieces once, for its prepared query and tile
    shape at its precision, and hands the result to every tile."""
    asked, handed = [], []
    pieces = object()

    def query_pieces(q, tile, precision):
        asked.append((tuple(q.shape), tuple(tile.shape), precision))
        return pieces

    def tile_distance(*args, q_pieces=None, **kw):
        handed.append(q_pieces)
        return tdist.tile_distance(*args, **kw)
    monkeypatch.setattr(tknn, "query_pieces", query_pieces)
    monkeypatch.setattr(tknn, "tile_distance", tile_distance)
    rng = np.random.default_rng(7)
    q, b = _rows(rng, 20, 64), _rows(rng, 1000, 64)
    d, i = tknn._knn_scan(q, b, 990, 0, 5, "sqeuclidean", 256, engine)
    assert asked == [((20, 64), (256, 64), "highest")]
    assert handed == [pieces] * 4
    dw, iw = tknn._knn_full(q, b, 990, 0, 5, "sqeuclidean", engine)
    assert torch.equal(i, iw)


@pytest.mark.parametrize("shape,precision", [
    ((100, 8192, 1024), "highest"), ((1000, 8192, 96), "highest"),
    ((1000, 8192, 1024), "high"), ((1000, 8192, 1024), "default")])
def test_other_shapes_and_precisions_keep_the_library_product(card, shape,
                                                              precision):
    """A shape the plan sends to the fp32 path, and the bf16 precisions,
    take the library product and F2, as before."""
    q, qn, b, bn = _meta(*shape)
    tdist.tile_distance(q, qn, b, bn, "sqeuclidean", precision)
    assert [(n, e) for n, e, _ in card.calls] == [("distance_tile",
                                                   "launch")]
    assert fc.split_distance.launches == 0
    if precision == "highest":
        reason = "rows" if shape[0] == 100 else "dim"
        assert fc.split_distance.fp32_plans == {(*shape, True): reason}


def test_unaligned_rows_keep_the_library_product(card):
    q, qn, b, bn = _meta(1000, 8193, 1024)
    tdist.tile_distance(q, qn, b[1:].T.contiguous().T, bn[1:], "sqeuclidean")
    assert fc.split_distance.launches == 0
    assert list(fc.split_distance.fp32_plans.values()) == ["unaligned"]


def test_a_refused_launch_raises(card):
    card.err = 22001
    q, qn, b, bn = _meta(1000, 8192, 1024)
    with pytest.raises(RuntimeError, match="22001"):
        fc.split_distance(q, qn, b, bn, "sqeuclidean")


def test_split_distance_refuses_a_shape_its_plan_sends_away(card):
    q, qn, b, bn = _meta(100, 8192, 1024)
    with pytest.raises(ValueError, match="fp32 path"):
        fc.split_distance(q, qn, b, bn, "sqeuclidean")


# ------------------------------------------------------------ counters


def _profiled():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def test_counters_count_tiles_by_route_on_the_cpu():
    """On the CPU every "highest" tile takes the fp32 product: counted in
    dist.fp32_tiles under a recording profiler, nothing counted without
    one, and the bf16 precisions count nothing."""
    profiling._REC.clear()
    q, b = torch.ones(300, 128), torch.ones(500, 128)
    qx, qn = tdist.query_operand(q, "sqeuclidean")
    tdist.tile_distance(qx, qn, b, None, "sqeuclidean")
    with _profiled():
        for _ in range(3):
            tdist.tile_distance(qx, qn, b, None, "sqeuclidean")
        tdist.tile_distance(qx, qn, b, None, "sqeuclidean", "high")
        recs = profiling.records()
    assert recs["counters"] == {"dist.fp32_tiles": 3}


def test_counters_count_tiles_by_route_on_the_card(card):
    profiling._REC.clear()
    q, qn, b, bn = _meta(1000, 8192, 1024)
    small = _meta(100, 8192, 1024)
    with _profiled():
        for _ in range(4):
            tdist.tile_distance(q, qn, b, bn, "sqeuclidean")
        tdist.tile_distance(*small, "sqeuclidean")
        recs = profiling.records()
    assert recs["counters"] == {"dist.split_tiles": 4, "dist.fp32_tiles": 1}
    assert fc.split_distance.launches == 4


def test_the_cpu_path_is_the_fp32_product_bit_for_bit():
    """CPU tensors keep `query @ tile.T` and the plain epilogue at
    "highest" (the JAX package's parity holds there)."""
    rng = np.random.default_rng(3)
    q, b = _rows(rng, 300, 256), _rows(rng, 400, 256)
    qx, qn = tdist.query_operand(q, "sqeuclidean")
    bn = fc.sq_norms(b)
    got = tdist.tile_distance(qx, qn, b, bn, "sqeuclidean", lo=2, hi=390)
    want = fc.distance_tile_plain(qx @ b.T, qn, bn, "sqeuclidean", 2, 390)
    assert torch.equal(got, want)
