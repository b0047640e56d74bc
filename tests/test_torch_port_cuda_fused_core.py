"""The kNN core's fused kernels (ops/fused_core.py: F1 csrc/prepare_base.cu,
F2 csrc/distance_tile.cu, F3 csrc/rerank_rows.cu) against their plain
PyTorch versions, the merge's top-m on the verified select (K7) against
the stable sort, and the engines that launch them, on the card.

This file imports neither jax nor the JAX package, so it runs where the
card is and JAX is not installed:

    python -m pytest --noconftest tests/test_torch_port_cuda_fused_core.py -q

Without a card its tests skip (the kernels have no CPU mode); the CPU
tests (tests/test_torch_port_fused_core.py) hold the plain versions
against the JAX reference.

Tolerances: F1's bf16 operand and F2's distances are bit for bit; F1's
norms differ from torch's sums only by the order of addition, at most
(dim + 16) 2^-24 relative, and its statistics stay upper bounds of the
float64 truth; F3's distances within 1e-5 (fp32 sums in another order on
unit rows), the same bits on every run."""

import numpy as np
import pytest
import torch

from neighborhoodwatch_tpu_torch.ops import fused_core as fc
from neighborhoodwatch_tpu_torch.ops import knn as tknn
from neighborhoodwatch_tpu_torch.ops import screen_kernel as sk
from neighborhoodwatch_tpu_torch.ops import verified_kernel as vk
from neighborhoodwatch_tpu_torch.ops.topk import smallest_k

TOL = 1e-5
METRICS = ("sqeuclidean", "euclidean", "cosine", "dot")


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from neighborhoodwatch_tpu_torch import resolve_device
    return resolve_device("cuda")


def _bits(t):
    return t.contiguous().view(torch.int16 if t.dtype == torch.bfloat16
                               else torch.int32).cpu()


def _edge_values():
    """fp32 values at every exponent, both signs, with the low 16 mantissa
    bits on each side of the rounding point and both parities of the kept
    last bit: every case of round to nearest even into bf16, subnormals,
    overflow to inf, inf and NaN payloads."""
    exps = np.arange(256, dtype=np.uint32) << 23
    hi = np.array([0, 1 << 16, 0x7F0000], dtype=np.uint32)
    lo = np.array([0, 1, 0x7FFF, 0x8000, 0x8001, 0xFFFF], dtype=np.uint32)
    mant = (hi[:, None] | lo[None, :]).reshape(-1)
    bits = (exps[:, None] | mant[None, :]).reshape(-1)
    bits = np.concatenate([bits, bits | np.uint32(0x80000000)])
    return bits.view(np.float32)


def _rows(n, dim, seed, planted=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, dim)).astype(np.float32)
    if planted:
        x[3] = np.nan                        # a NaN row
        x[5, 1] = np.inf                     # an inf row
        x[7, 0] = -np.inf
        x[9] = 0.0                           # a zero row
        x[11, -1] = 3.4e38                   # rounds to bf16 inf
        x[13, 0] = np.nan                    # one NaN entry
        x[15] *= 1e-3                        # a short row: the ratio stat
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("n,dim,aligned", [
    (1000, 1536, True), (777, 130, True), (513, 7, True), (300, 64, True),
    (301, 64, False), (64, 1024, False)])
def test_prepare_base_matches_plain(cuda, n, dim, aligned):
    """bhi bit for bit (NaN rows included), bn_row within the order-of-
    addition bound, the statistics upper bounds of the float64 truth over
    the finite rows and within the guard of the plain version's."""
    x = torch.from_numpy(_rows(n, dim, seed=n + dim)).to(cuda)
    if not aligned:                          # rows at a 4-byte offset
        buf = torch.empty(n * dim + 1, device=cuda)
        buf[1:] = x.reshape(-1)
        x = buf[1:].view(n, dim)
        assert x.data_ptr() % 16 != 0
    bn_p, st_p, bhi_p = fc.prepare_plain(x)
    launches = fc.prepare_base.launches
    bn_k, st_k, bhi_k = fc.prepare_base(x)
    torch.cuda.synchronize()
    assert fc.prepare_base.launches == launches + 1
    assert bhi_k.dtype == torch.bfloat16 and bhi_k.shape == (n, dim)
    assert torch.equal(_bits(bhi_k), _bits(bhi_p))
    fin = torch.isfinite(bn_p)
    assert torch.equal(torch.isfinite(bn_k), fin)
    rel = (dim + 16) * 2.0 ** -24
    assert bool(((bn_k - bn_p).abs()[fin] <= rel * bn_p[fin]).all())
    # the float64 truth over the rows the plain version keeps (finite in
    # fp32: a row whose fp32 norm overflows never becomes a candidate)
    x64 = x.double().cpu()
    b64 = (x64 * x64).sum(1)
    ok = fin.cpu()
    r64 = x64 - bhi_p.double().cpu()
    lo64 = (r64 * r64).sum(1).sqrt()
    truth = [b64[ok].max(), b64[ok].max().sqrt(), lo64[ok].max(),
             (lo64[ok & (b64 > 0)] / b64[ok & (b64 > 0)].sqrt()).max()]
    for j in range(4):
        assert float(st_k[j]) >= float(truth[j]), j
        assert abs(float(st_k[j]) - float(st_p[j])) <= 2 * rel * float(
            st_p[j]), j
    # the norms alone: the same kernel, the same sums
    assert torch.equal(_bits(fc.sq_norms(x)), _bits(bn_k))


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [1536, 130])
def test_prepare_base_rounds_every_exponent_edge(cuda, dim):
    """Every fp32 rounding case into bf16 against the integer round to
    nearest even of the plain version (torch's own conversion on the
    card), NaN payloads to the canonical NaN as torch converts them."""
    v = _edge_values()
    n = -(-len(v) // dim)
    x = np.resize(v, n * dim).reshape(n, dim)
    x = torch.from_numpy(x).to(cuda)
    _, _, bhi_k = fc.prepare_base(x)
    want = sk.bf16_round(x).to(torch.bfloat16)
    assert torch.equal(_bits(bhi_k), _bits(want))
    assert torch.equal(_bits(bhi_k), _bits(x.to(torch.bfloat16)))


@pytest.mark.cuda
def test_prepare_base_empty_and_refusals(cuda):
    bn, st, bhi = fc.prepare_base(torch.zeros((0, 8), device=cuda))
    assert bn.shape == (0,) and bhi.shape == (0, 8)
    assert torch.equal(st.cpu(), torch.zeros(4))
    with pytest.raises(TypeError):
        fc.prepare_base(torch.zeros((4, 8), device=cuda, dtype=torch.float64))


def _dots_and_norms(q_rows, t, dim, seed, cuda):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((q_rows, dim)).astype(
        np.float32)).to(cuda)
    b = torch.from_numpy(rng.standard_normal((t, dim)).astype(
        np.float32)).to(cuda)
    b[1] = np.nan                            # NaN and inf products
    b[2, 0] = np.inf
    b[4] = q[0]                              # a zero distance
    return q @ b.T, fc.sq_norms(q), fc.sq_norms(b)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("q_rows,t,dim,lo,hi", [
    (1000, 8192, 64, 0, 8192),               # nw's fallback tile
    (512, 8192, 96, 3000, 8192),             # a shifted last tile
    (37, 130, 7, 0, 100),                    # rows past n_valid
    (5, 4097, 13, 17, 4001),                 # T % 4 != 0: scalar path
    (9, 64, 8, 0, 0),                        # every column masked
    (3, 256, 8, 300, 400)])                  # the mask outside the tile
def test_distance_tile_matches_plain_bit_for_bit(cuda, metric, q_rows, t,
                                                 dim, lo, hi):
    dots, qn, bn = _dots_and_norms(q_rows, t, dim, q_rows + t, cuda)
    want = fc.distance_tile_plain(dots, qn, bn, metric, lo, hi)
    launches = fc.distance_tile.launches
    got = fc.distance_tile(dots, qn, bn, metric, lo, hi)
    torch.cuda.synchronize()
    assert fc.distance_tile.launches == launches + 1
    assert torch.equal(_bits(got), _bits(want))
    assert not bool(torch.isnan(got).any())


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
def test_pairwise_distance_on_card_matches_op_by_op(cuda, metric):
    """The card's pairwise_distance (F1's norms, the library product, F2)
    against the op-by-op epilogue on the same products and norms."""
    from neighborhoodwatch_tpu_torch.ops import distance
    rng = np.random.default_rng(8)
    q = torch.from_numpy(rng.standard_normal((70, 130)).astype(
        np.float32)).to(cuda)
    b = torch.from_numpy(rng.standard_normal((999, 130)).astype(
        np.float32)).to(cuda)
    got = distance.pairwise_distance(q, b, metric)
    qx, qn = distance.query_operand(q, metric)
    bx = distance._safe_normalize(b) if metric == "cosine" else b
    bn = fc.sq_norms(bx) if qn is not None else None
    want = fc.distance_tile_plain(qx @ bx.T, qn, bn, metric)
    assert torch.equal(_bits(got), _bits(want))


def _unit(rng, n, dim):
    x = rng.standard_normal((n, dim)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _twice(fn):
    """`fn` twice, equal bit for bit."""
    got, again = fn(), fn()
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(again))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("q_rows,m,dim,n", [
    (300, 256, 1536, 5000), (64, 37, 128, 999), (50, 100, 8, 300),
    (64, 37, 130, 999), (50, 100, 7, 300), (20, 300, 64, 4096),
    (7, 33, 2048, 50)])
def test_rerank_rows_matches_plain(cuda, metric, q_rows, m, dim, n):
    """The kernel against the plain version (16-byte loads where dim % 4
    == 0, single values elsewhere), NaN rows, duplicates, an id outside
    the base."""
    rng = np.random.default_rng(q_rows + m + dim)
    q = torch.from_numpy(_unit(rng, q_rows, dim)).to(cuda)
    b = torch.from_numpy(_unit(rng, n, dim)).to(cuda)
    b[6] = np.nan                            # a garbage row: NaN both sides
    ids = torch.from_numpy(rng.integers(0, n, (q_rows, m))).to(cuda)
    ids[:, 0] = 6
    ids[:, 1] = ids[:, 2]                    # duplicates
    want = fc.rerank_plain(q, b, ids, metric, block=16)
    launches = fc.rerank_rows.launches
    got = _twice(lambda: fc.rerank_rows(q, b, ids.to(torch.int32), metric))
    assert fc.rerank_rows.launches == launches + 2
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert bool(torch.isnan(got[:, 0]).all())
    fin = ~torch.isnan(want)
    assert float((got - want).abs()[fin].max()) <= TOL
    # an id outside the base gives NaN, and nothing else changes
    ids[0, 5] = n
    ids[-1, -1] = -3
    got2 = _twice(lambda: fc.rerank_rows(q, b, ids, metric))
    assert bool(torch.isnan(got2[0, 5])) and bool(torch.isnan(got2[-1, -1]))
    got2[0, 5], got2[-1, -1] = got[0, 5], got[-1, -1]
    assert torch.equal(_bits(got2), _bits(got))


@pytest.mark.cuda
def test_rerank_forced_variants_on_the_card(cuda):
    """F3 on this card at nw's re-rank (1,000 x 256 of 1,024 dims over
    100,000 rows): "rowwise" by default and forced, the same bits, a dim no
    multiple of 4 too; "plain" runs the plain version, counted there;
    each launch counted on its variant."""
    rng = np.random.default_rng(5)
    fc.reset_launches()
    q = torch.from_numpy(_unit(rng, 1000, 1024)).to(cuda)
    b = torch.from_numpy(_unit(rng, 100_000, 1024)).to(cuda)
    ids = torch.from_numpy(rng.integers(0, 100_000, (1000, 256))).to(cuda)
    got = fc.rerank_rows(q, b, ids, "sqeuclidean")
    with fc.forced_variant("rowwise"):
        forced = fc.rerank_rows(q, b, ids, "sqeuclidean")
        odd = fc.rerank_rows(q[:4, :130], b[:, :130], ids[:4], "dot")
    assert torch.equal(_bits(forced), _bits(got))
    want = fc.rerank_plain(q[:4, :130], b[:, :130], ids[:4], "dot")
    assert float((odd - want).abs().max()) <= TOL
    with fc.forced_variant("plain"):
        plain = fc.rerank_rows(q, b, ids, "sqeuclidean", block=64)
    assert float((plain - got).abs().max()) <= TOL
    assert fc.rerank_rows.launches == 3
    assert fc.rerank_rows.launches_by_variant == {"rowwise": 3, "plain": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("q_rows,width,m", [
    (1000, 3456, 256), (300, 1536, 320), (7, 1153, 100), (50, 384, 256)])
def test_merge_select_on_k7_equals_stable_sort(cuda, q_rows, width, m):
    """_merge_select on the card (K7) returns the stable sort's first m:
    values bit for bit and the same ids in the same order, with ties,
    +inf bins and NaN entries."""
    rng = np.random.default_rng(width)
    d = np.round(rng.random((q_rows, width)) * 200).astype(np.float32)
    d[:, ::13] = np.inf
    d[:, 5::29] = np.nan
    d[0] = np.inf                            # a row with no candidate
    md = torch.from_numpy(d).to(cuda)
    mi = torch.from_numpy(rng.permutation(q_rows * width).reshape(
        q_rows, width).astype(np.int32)).to(cuda)
    launches = vk.verified_select.launches
    sd, si = tknn._merge_select(md, mi, m)
    assert vk.verified_select.launches == launches + 1
    wd, order = torch.sort(md, dim=1, stable=True)
    assert torch.equal(_bits(sd), _bits(wd[:, :m]))
    assert torch.equal(si.cpu(), torch.gather(mi, 1, order[:, :m]).cpu())


def _tie_tolerant(d, i, de, ie):
    assert float((d - de).abs().max()) <= TOL
    moved = i != ie
    assert bool(((d - de).abs() <= TOL)[moved].all())


def _counts():
    return (fc.prepare_base.launches, fc.distance_tile.launches,
            fc.rerank_rows.launches, vk.verified_select.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["sqeuclidean", "cosine"])
def test_screened_engine_launches_the_fused_kernels(cuda, metric):
    """knn(auto) over two mega-tiles and a ragged tail (D=72, not a
    multiple of 64): F1 prepares, F3 re-ranks, K7 takes the merge's top-m
    and the re-rank's top-k; the result equals the exact engine's."""
    rng = np.random.default_rng(11)
    q = torch.from_numpy(_unit(rng, 64, 72)).to(cuda)
    b = torch.from_numpy(_unit(rng, 2 * sk.MEGA + 77, 72)).to(cuda)
    before = _counts()
    d, i = tknn.knn(q, b, 10, metric=metric)
    after = _counts()
    assert after[0] > before[0] and after[2] > before[2]
    assert after[3] >= before[3] + 2
    de, ie = tknn.knn(q, b, 10, metric=metric, engine="exact")
    _tie_tolerant(d, i, de, ie)


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["exact", "verified"])
@pytest.mark.parametrize("metric", METRICS)
def test_exact_engines_launch_f2_per_tile(cuda, engine, metric):
    """The exact and verified engines' tiles: one F2 launch a tile, the
    base's norms once a call (F1's norms), the result equal to the CPU's
    within the tolerance, ids tie-tolerant."""
    rng = np.random.default_rng(12)
    q = _unit(rng, 40, 96)
    b = _unit(rng, 20_001, 96)
    before = _counts()
    d, i = tknn.knn(torch.from_numpy(q).to(cuda),
                    torch.from_numpy(b).to(cuda), 50, metric=metric,
                    engine=engine, tile_size=4096)
    after = _counts()
    assert after[1] - before[1] == -(-len(b) // 4096)
    l2 = metric in ("sqeuclidean", "euclidean")
    assert after[0] - before[0] == (2 if l2 else 0)
    dc, ic = tknn.knn(q, b, 50, metric=metric, engine="exact",
                      tile_size=4096, device="cpu")
    _tie_tolerant(d.cpu(), i.cpu(), dc, ic)


@pytest.mark.cuda
def test_class_a_repair_on_f3_matches_cpu(cuda):
    """A planted 5-way collision in one lane bin: the class-A repair reads
    the suspicious bins' rows through F3 on the card and gives the CPU's
    repair counts and ids."""
    rng = np.random.default_rng(41)
    q = rng.standard_normal((4, 32)).astype(np.float32)
    b = rng.standard_normal((sk.MEGA, 32)).astype(np.float32)
    target = q[0] + 1e-4 * np.arange(32, dtype=np.float32)
    for j in range(5):
        b[7 + j * 128] = target + 1e-3 * j
    want = tknn.screened_knn_traced(torch.from_numpy(q), torch.from_numpy(b),
                                    len(b), 0, 5, "sqeuclidean", "default",
                                    with_diagnostics=True)
    launches = fc.rerank_rows.launches
    got = tknn.screened_knn_traced(torch.from_numpy(q).to(cuda),
                                   torch.from_numpy(b).to(cuda), len(b), 0, 5,
                                   "sqeuclidean", "default",
                                   with_diagnostics=True)
    assert got[2] == want[2] == (1, 0, 0)
    assert fc.rerank_rows.launches - launches == 2
    assert torch.equal(got[1].cpu(), want[1])
    assert float((got[0].cpu() - want[0]).abs().max()) <= 1e-4
    assert torch.equal(smallest_k(got[0].cpu(), 5)[0], got[0].cpu())
