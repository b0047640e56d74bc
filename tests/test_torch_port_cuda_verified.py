"""The verified engine's select kernel (csrc/verified_select.cu) against its
plain PyTorch version, the engines that launch it, and the bf16 products
of precision "default"/"high", on the card.

This file imports neither jax nor the JAX package, so it runs where the
card is and JAX is not installed:

    python -m pytest --noconftest tests/test_torch_port_cuda_verified.py -q

Without a card its tests skip (the kernel has no CPU mode); the CPU tests
(tests/test_torch_port_verified.py, tests/test_torch_port_precision.py)
hold the plain versions against the JAX reference."""

import numpy as np
import pytest
import torch

from neighborhoodwatch_tpu_torch.ops import knn as tknn
from neighborhoodwatch_tpu_torch.ops import verified_kernel as vk
from neighborhoodwatch_tpu_torch.ops.distance import pairwise_distance
from neighborhoodwatch_tpu_torch.ops.topk import smallest_k


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _tile(rng, q, n, kind):
    d = rng.standard_normal((q, n)).astype(np.float32) ** 2
    if kind == "crowded":
        # every distance in [1.30, 1.34]: the top bits of every key agree
        d = (1.30 + 0.04 * rng.random((q, n))).astype(np.float32)
    elif kind == "dot":
        # "dot" distances: both signs, the range across the sign fold
        d = (0.1 * rng.standard_normal((q, n))).astype(np.float32)
    elif kind == "nan":
        d[:, 5::11] = np.nan                # NaN sorts after +inf
        d[:, 7::13] = np.inf
        d[:, 2::17] = -0.0
        d[-1] = np.nan                      # an all-NaN row
    elif kind == "ties":
        # every value three times over: ties at and around the k-th
        d = np.repeat(d[:, : n // 3 + 1], 3, axis=1)[:, :n].copy()
    elif kind == "tail":
        d[:, n - n // 3:] = np.inf          # a masked tail
        d[0] = np.inf                       # an all-inf row
    elif kind == "zeros":
        d[:, ::7] = 0.0
        d[:, 3::7] = -0.0                   # -0.0 ties +0.0
    elif kind == "coarse":
        d = np.round(d * 4) / 4             # few distinct values
    return d


def _same(got, want):
    """Positions equal, distances equal bit for bit, proof verdicts equal."""
    assert torch.equal(got[1].cpu(), want[1])
    assert torch.equal(got[0].cpu().view(torch.int32),
                       want[0].view(torch.int32))
    assert torch.equal(got[2].cpu(), want[2])


def _plan_of(q, n, k):
    """The path the launch took: the plan's path and where its keys
    live."""
    pl, active = vk.verified_select.last_plan
    assert active >= 1
    assert pl == vk.plan(q, n, k, vk._sm_count(torch.device("cuda")))
    return f"{pl.path}/{pl.keys_in}"


@pytest.mark.cuda
@pytest.mark.parametrize("q,n,k,kind", [
    (7, 100, 1, "random"),
    (64, 8192, 100, "random"),
    (33, 8192, 100, "ties"),
    (20, 5000, 100, "tail"),
    (12, 3000, 64, "zeros"),
    (40, 4096, 100, "coarse"),
    # a persistent tile of many narrow rows: about two blocks an SM walk
    # 600 rows, the next row in flight
    (600, 2000, 10, "random"),
    (300, 8192, 100, "crowded"),
    (300, 8192, 100, "dot"),
    (300, 4096, 100, "nan"),
    (300, 8192, 1024, "tail"),
    # the repair plan's widest tile: 128 rows x 32,768 columns, clusters
    (128, 32768, 100, "random"),
    (128, 32768, 100, "crowded"),
    (16, 32768, 1024, "ties"),
    # the escalation's 16 x 262,144: 8 blocks a row, slices in shared
    # memory
    (16, 262144, 100, "random"),
    (16, 262144, 1024, "dot"),
    # N % 4 != 0: no bulk copies (a base of 4,099 rows in one tile)
    (4, 4099, 100, "random"),
    # wider than a cluster's shared memory: every sweep reads L2
    (3, 70001, 100, "random"),
    (2, 1000448, 100, "crowded"),
    # margin > N: the margin is clamped to the row; k = N
    (9, 50, 40, "random"),
    (5, 64, 64, "ties"),
    (3, 300, 300, "nan"),
    # the largest k the kernel sorts in shared memory
    (2, 9000, 6553, "random")])
def test_verified_select_matches_plain(cuda, q, n, k, kind):
    """The kernel returns what the plain version returns, position for
    position and bit for bit (both keep the lowest positions among equal
    values), the proof holds on every row and no row falls back."""
    rng = np.random.default_rng(q * 1000 + n)
    d = torch.from_numpy(_tile(rng, q, n, kind))
    vk.reset_failed_rows()
    want = vk.verified_select_plain(d, k)
    launches = vk.verified_select.launches
    got = vk.verified_select(d.to(cuda), k)
    torch.cuda.synchronize()
    assert vk.verified_select.launches == launches + 1
    _plan_of(q, n, k)
    _same(got, want)
    assert bool(want[2].all())
    assert vk.failed_rows() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("q,n,k,path", [
    (200, 8192, 100, "persistent/registers"),
    (6, 32768, 1024, "cluster/registers"),
    (3, 262144, 100, "cluster/shared"),
    (6, 70001, 10, "cluster/device")])
def test_planted_failure_falls_back_in_kernel(cuda, q, n, k, path):
    """Column 0 holds each row's minimum and is kept out of the candidate
    stage: every row fails the proof, is counted, and is selected again
    exactly inside the kernel, on every path of the plan."""
    rng = np.random.default_rng(n)
    d = torch.from_numpy(_tile(rng, q, n, "random"))
    d[:, 0] = -1.0
    vk.reset_failed_rows()
    dist, pos, ok = vk.verified_select(d.to(cuda), k, exclude=0)
    torch.cuda.synchronize()
    assert _plan_of(q, n, k) == path
    assert not bool(ok.any())
    assert vk.failed_rows() == q
    want_d, want_i = smallest_k(d, k)
    assert torch.equal(pos.cpu(), want_i)
    assert torch.equal(dist.cpu(), want_d)
    _same((dist, pos, ok), vk.verified_select(d, k, exclude=0))


@pytest.mark.cuda
def test_verified_select_refuses_what_it_cannot_take(cuda):
    d = torch.zeros((4, 100), device=cuda)
    with pytest.raises(ValueError):
        vk.verified_select(d.T.contiguous().T, 5)           # strided
    with pytest.raises(ValueError):
        vk.verified_select(d.double(), 5)
    with pytest.raises(ValueError):
        vk.verified_select(torch.zeros((2, 20000), device=cuda), 7000)
    with pytest.raises(ValueError):
        vk.verified_select(d, 101)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["sqeuclidean", "cosine", "dot"])
def test_verified_engine_equals_exact_on_card(cuda, metric):
    """knn(engine="verified") and the exact engine give the same ids and
    distances, tiled and in one tile; "auto" below two mega-tiles is the
    verified engine and launches the kernel once per tile."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((50, 96)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((20000, 96)).astype(np.float32))
    q, b = q.to(cuda), b.to(cuda)
    assert tknn._select_engine("auto", len(b), cuda) == "verified"
    for tile in (4096, 32768):
        de, ie = tknn.knn(q, b, 100, metric=metric, engine="exact",
                          tile_size=tile)
        launches = vk.verified_select.launches
        da, ia = tknn.knn(q, b, 100, metric=metric, engine="auto",
                          tile_size=tile)
        assert vk.verified_select.launches - launches == -(-len(b) // tile)
        assert torch.equal(ia, ie)
        assert torch.equal(da, de)


@pytest.mark.cuda
def test_screened_fallback_launches_verified(cuda):
    """The screened engine's exact fallback on the card runs the verified
    engine: a base below one mega-tile goes straight to it."""
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((30, 64)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((9000, 64)).astype(np.float32))
    q, b = q.to(cuda), b.to(cuda)
    launches = vk.verified_select.launches
    d, i = tknn.screened_knn_traced(q, b, len(b), 0, 10, "sqeuclidean")
    assert vk.verified_select.launches > launches
    de, ie = tknn.knn(q, b, 10, engine="exact")
    assert torch.equal(i, ie)
    assert torch.equal(d, de)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["default", "high", "highest"])
def test_precision_products_on_card(cuda, precision):
    """The card's bf16 products (one library product with an fp32 result)
    against the CPU's fp32 products of the same bf16-rounded operands,
    which are exact term by term: they differ only in the order of
    addition, at most dim * 2^-24 * |q| |b| on each product (times 3 terms
    of the bf16x3 sum, doubled by the l2 epilogue); and the result is fp32,
    not bf16."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((40, 256)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((300, 256)).astype(np.float32))
    want = pairwise_distance(q, b, "sqeuclidean", precision)
    got = pairwise_distance(q.to(cuda), b.to(cuda), "sqeuclidean",
                            precision).cpu()
    assert got.dtype == torch.float32
    qn = q.norm(dim=1)[:, None]
    bn = b.norm(dim=1)[None, :]
    bound = 2 * 3 * (256 + 8) * 2.0 ** -24 * (qn + bn) ** 2
    assert bool(((got - want).abs() <= bound).all())
