"""F4 (csrc/split_distance.cu, ops/fused_core.py:split_distance): the
fallback tile's fp32 products as an exact bf16x6 split on the tensor cores
with the distance epilogue fused in, on the card, against its plain
version and float64, and the engines that route "highest" tiles to it.

This file imports neither jax nor the JAX package, so it runs where the
card is and JAX is not installed:

    python -m pytest --noconftest tests/test_torch_port_cuda_split_distance.py -q

Without a card its tests skip (the kernel has no CPU mode); the CPU tests
(tests/test_torch_port_split_distance.py) hold the plain version against
float64 and the plan, routing and counters on a fake library.

Tolerances: the error model (fused_core.split_error_bound, units of 2^-24
sum_k |q_k b_k|, twice that where the metric reads 2 dot) plus the fp32
norms' rounding, against float64, for the kernel and the plain version
each. The kernel against the plain version, which cuts the same pieces
and sums the same chunks in another order: PLAIN_ULPS ulps of the
distance plus PLAIN_UNITS units of 2^-24 sum_k |q_k b_k| of the dot
(through the metric), a limit that the plain version without its third
pieces (the bf16x3 split) must exceed on the same rows. Two launches bit
for bit; +inf exactly where the plain version and the fp32 path put it."""

import numpy as np
import pytest
import torch

from neighborhoodwatch_tpu_torch.ops import distance as tdist
from neighborhoodwatch_tpu_torch.ops import fused_core as fc
from neighborhoodwatch_tpu_torch.ops import knn as tknn
from neighborhoodwatch_tpu_torch.ops import screen_kernel as sk
from neighborhoodwatch_tpu_torch.utils import profiling

U = 2.0 ** -24
METRICS = ("sqeuclidean", "euclidean", "cosine", "dot")
# the kernel against its plain version: ulps of the distance, and units
# of 2^-24 sum_k |q_k b_k| of the dot
PLAIN_ULPS, PLAIN_UNITS = 4, 4


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from neighborhoodwatch_tpu_torch import resolve_device
    return resolve_device("cuda")


def _bits(t):
    return t.contiguous().view(torch.int32).cpu()


def _slack(metric, bound, dim, q, b):
    """(Q, T) float64 distances of rows q, b and the largest |distance -
    float64| the model allows each."""
    q64, b64 = q.double(), b.double()
    dot = q64 @ b64.T
    scale = q64.abs() @ b64.abs().T
    norms = (q64 * q64).sum(1)[:, None] + (b64 * b64).sum(1)[None, :]
    if metric in ("sqeuclidean", "euclidean"):
        d = torch.clamp_min(norms - 2.0 * dot, 0.0)
        sq = 2 * bound * U * scale + (dim + 3) * U * norms
        if metric == "sqeuclidean":
            return d, sq
        return d.sqrt(), torch.sqrt(sq) + 2 * U * d.sqrt()
    d = 1.0 - dot
    return d, bound * U * scale + 2 * U * d.abs() + U


def _off_plain(metric, d, plain, q, b):
    """(Q, T) |d - plain| of finite distances as a share of the limit
    PLAIN_ULPS ulps of `plain` plus PLAIN_UNITS units of the dot (twice
    that where the metric reads 2 dot; through the root for euclidean);
    0 where `plain` is not finite."""
    p = plain.double()
    ulp = (torch.nextafter(plain.abs(), torch.full_like(plain, float("inf")))
           - plain.abs()).double()
    dot = PLAIN_UNITS * U * (q.double().abs() @ b.double().abs().T)
    if metric in ("sqeuclidean", "euclidean"):
        dot = 2 * dot
    if metric == "euclidean":
        dot = dot / (2 * p)
    off = (d.double() - p).abs() / (PLAIN_ULPS * ulp + dot)
    return torch.where(torch.isfinite(p), off, torch.zeros_like(off))


def _without_third_pieces(monkeypatch, *args):
    """split_distance_plain with every third piece zero: the bf16x3 split,
    whose error the limit of the kernel against the plain version must
    see."""
    cut = fc.split_pieces_plain
    with monkeypatch.context() as m:
        m.setattr(fc, "split_pieces_plain",
                  lambda x: (*cut(x)[:2], torch.zeros_like(x)))
        return fc.split_distance_plain(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("q_rows,t,dim,lo,hi,planted", [
    (256, 8192, 1024, 0, None, False), (1000, 1000, 256, 3, 990, False),
    (1025, 333, 100, 5, 300, False), (513, 4097, 1536, 17, 4000, False),
    (1000, 8192, 1024, 0, 8100, True), (10000, 600, 1536, 100, None, True)])
def test_f4_matches_plain_and_float64(cuda, metric, q_rows, t, dim, lo, hi,
                                      planted, monkeypatch):
    """Ragged Q and T edges (rows past a block, columns past a slot), both
    masks, non-finite rows: within the model of float64, within a few ulps
    of the plain version where the bf16x3 split is not, +inf where the
    plain version and the fp32 path put it, two launches bit for bit, one
    launch each."""
    g = torch.Generator(device=cuda).manual_seed(q_rows + t + dim)
    q = torch.randn(q_rows, dim, device=cuda, generator=g)
    b = torch.randn(t, dim, device=cuda, generator=g)
    if planted:
        q[3, 5] = float("inf")
        b[7, 1] = float("nan")
        b[9, 2] = -float("inf")
    qx, qn = tdist.query_operand(q, metric)
    bx = tdist._safe_normalize(b) if metric == "cosine" else b
    bn = fc.sq_norms(bx) if qn is not None else None
    pl = fc.planned_split(qx, bx)
    assert pl.route == "split"
    launches = fc.split_distance.launches
    got = fc.split_distance(qx, qn, bx, bn, metric, lo, hi)
    again = fc.split_distance(qx, qn, bx, bn, metric, lo, hi)
    assert fc.split_distance.launches == launches + 2
    assert torch.equal(_bits(got), _bits(again))
    plain = fc.split_distance_plain(qx, qn, bx, bn, metric, lo, hi)
    fp32 = fc.distance_tile(qx @ bx.T, qn, bn, metric, lo, hi)
    fin = torch.isfinite(plain)
    assert torch.equal(torch.isfinite(got), fin)
    assert torch.equal(fin, torch.isfinite(fp32))
    assert bool((got[~fin] == float("inf")).all())
    rows = torch.arange(0, q_rows, max(1, q_rows // 97), device=cuda)
    want, slack = _slack(metric, pl.bound, dim, qx[rows], bx)
    ok = fin[rows]
    assert bool(((got[rows].double() - want).abs() <= slack)[ok].all())
    assert bool(((plain[rows].double() - want).abs() <= slack)[ok].all())
    off = _off_plain(metric, got[rows], plain[rows], qx[rows], bx)
    assert float(off.max()) <= 1.0
    args = (qx[rows], None if qn is None else qn[rows], bx, bn, metric, lo,
            hi)
    bf16x3 = _without_third_pieces(monkeypatch, *args)
    assert float(_off_plain(metric, bf16x3, plain[rows], qx[rows],
                            bx).max()) > 1.0


@pytest.mark.cuda
def test_scan_cuts_the_query_once_and_counts_tiles(cuda):
    """The verified engine's scan at "highest": the query's pieces once a
    call, one split pass and one F4 launch a tile, counted by route under
    a recording profiler; a query too short for the plan takes the fp32
    path and F2."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((1000, 128)).astype(
        np.float32)).to(cuda)
    b = torch.from_numpy(rng.standard_normal((20_001, 128)).astype(
        np.float32)).to(cuda)
    tiles = -(-len(b) // 4096)
    fc.reset_launches()
    profiling._REC.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        tknn.knn(q, b, 10, engine="verified", tile_size=4096)
        tknn.knn(q[:100], b, 10, engine="verified", tile_size=4096)
        recs = profiling.records()
    assert recs["counters"]["dist.split_tiles"] == tiles
    assert recs["counters"]["dist.fp32_tiles"] == tiles
    assert fc.split_distance.launches == tiles
    assert fc.split_distance.split_launches == tiles + 1
    assert fc.distance_tile.launches == tiles


def _crowded(rng, n, dim):
    """Unit rows about one direction (cosine ~0.75) in Zipf-sized
    clusters: the screen's certificate fails, so the fallback scans."""
    axis = rng.standard_normal(dim)
    axis /= np.linalg.norm(axis)
    centers = rng.standard_normal((64, dim))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    which = rng.zipf(1.5, n) % 64
    x = 0.75 * axis + 0.5 * centers[which] + 0.1 * rng.standard_normal(
        (n, dim)) / np.sqrt(dim)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [1024, 256])
def test_knn_auto_equals_the_fp32_path_up_to_ties(cuda, dim, monkeypatch):
    """knn(auto) at a screened size on crowded rows, whose fallback scans
    on F4, against the same call with every tile on the fp32 path: the
    same distances within twice the model, the same ids wherever no other
    row lies that close."""
    rng = np.random.default_rng(dim)
    q = torch.from_numpy(_crowded(rng, 1500, dim)).to(cuda)
    b = torch.from_numpy(_crowded(rng, 2 * sk.MEGA + 77, dim)).to(cuda)
    launches = fc.split_distance.launches
    d, i = tknn.knn(q, b, 100)
    assert fc.split_distance.launches > launches
    monkeypatch.setattr(fc, "split_min_q", lambda dim: 1 << 30)
    monkeypatch.setattr(fc, "_split_plans", {})
    launches = fc.split_distance.launches
    dw, iw = tknn.knn(q, b, 100)
    assert fc.split_distance.launches == launches
    bound = fc.split_error_bound(dim, fc.split_chunk_for(dim))
    tol = 2 * (2 * bound + dim + 3) * U * 2.0      # unit rows: norms 2
    assert float((d - dw).abs().max()) <= tol
    moved = i != iw
    assert bool(((d - dw).abs() <= tol)[moved].all())
    # a moved id lies within the tolerance of the fp32 path's k-th
    assert bool((d[moved] <= dw[:, -1:].expand_as(d)[moved] + tol).all())
