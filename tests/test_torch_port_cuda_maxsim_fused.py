"""The MaxSim engines' fused kernels (ops/maxsim_fused.py: M1
csrc/maxsim_dense.cu, M2 csrc/maxsim_pairs.cu, in the variants "split"
on csrc/maxsim_split.cuh, the default, and "ffma" on csrc/maxsim_tile.cuh)
against their plain PyTorch versions and a float64 oracle, and the
engines that launch them against the same engines on the plain versions,
on the card.

This file imports neither jax nor the JAX package, so it runs where the
card is and JAX is not installed:

    python -m pytest --noconftest tests/test_torch_port_cuda_maxsim_fused.py -q

Without a card its tests skip (the kernels have no CPU mode); the CPU
tests (tests/test_torch_port_maxsim_fused.py) hold the plain versions
against the JAX reference.

Tolerances: scores within 1e-3 relative (at least 1e-3 absolute), the
MaxSim tolerance: fp32 sums of up to Tq token maxima, each a dim-long fp32
dot product, taken in another order than the library product's. M1's
NaN -> -1e30 positions equal bit for bit, M2's NaN positions equal. Two
launches of a kernel equal bit for bit (no atomics). Against float64 each
variant within its error model (the dot's bound, the "split" plan's or dim
for "ffma", plus 64 for the token sum, in units of 2^-24 sum|q d|). Engine
ids tie-tolerant against a float64 oracle at 1e-3."""

import numpy as np
import pytest
import torch

from neighborhoodwatch_tpu_torch.ops import maxsim as tm
from neighborhoodwatch_tpu_torch.ops import maxsim_fused as mf
from neighborhoodwatch_tpu_torch.ops import topk

from torch_port_util import assert_ids_tie_tolerant

TOL = 1e-3
NEG = np.float32(mf.NEG)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from neighborhoodwatch_tpu_torch import resolve_device
    return resolve_device("cuda")


def _corpus(seed, Q, Tq, D, Td, dim, garbage=True):
    """Unit tokens (ColBERT's), ragged masks; with `garbage`: an all-masked
    query and doc, NaN in a valid and in a masked doc token, inf in a
    masked doc token, +inf and -inf in one valid doc token (a NaN or an
    infinite score),
    NaN in a masked query token. As numpy arrays."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((Q, Tq, dim)).astype(np.float32)
    d = rng.standard_normal((D, Td, dim)).astype(np.float32)
    q /= np.linalg.norm(q, axis=2, keepdims=True)
    d /= np.linalg.norm(d, axis=2, keepdims=True)
    qm = rng.random((Q, Tq)) < 0.8
    dm = rng.random((D, Td)) < 0.7
    qm[:, 0] = True
    dm[:, 0] = True
    if garbage:
        qm[1] = False                       # an all-masked query
        dm[2] = False                       # an all-masked doc
        d[3, 0, 0] = np.nan                 # NaN, valid: a NaN score
        d[4, Td - 1] = np.inf               # inf, masked unless Td == 1
        dm[4, Td - 1] = Td == 1
        d[5, 0, ::2] = np.inf               # +inf and -inf, valid
        d[5, 0, 1::2] = -np.inf
        d[6, Td // 2, :] = np.nan           # NaN, masked
        dm[6, Td // 2] = Td // 2 == 0
        q[Q - 1, Tq - 1, 0] = np.nan        # NaN in a masked query token
        qm[Q - 1, Tq - 1] = Tq == 1
    return q, qm, d, dm


def _on(cuda, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
            for a in arrays]


def _assert_scores(got, want, nan_is_neg):
    """Scores within TOL relative; M1: the NEG positions equal bit for
    bit; M2: NaN positions equal."""
    got, want = got.double().cpu(), want.double().cpu()
    if nan_is_neg:
        assert not torch.isnan(got).any()
        neg = want == float(NEG)
        assert torch.equal(got[neg], want[neg])
        assert torch.equal(got == float(NEG), neg)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    inf = torch.isinf(want)
    assert torch.equal(got[inf], want[inf])
    fin = torch.isfinite(want)
    tol = TOL * torch.clamp_min(want[fin].abs(), 1.0)
    err = (got[fin] - want[fin]).abs()
    assert bool((err <= tol).all()), float((err - tol).max())


# (Q, Tq, D, Td, dim): the stream's fallback step, phase 6(b)'s Td, the
# exact engine's 128-doc tile, a ragged shape (vector path), an odd dim
# (4-byte copies), passages and docs past one tile's slots (chunk loops)
DENSE_SHAPES = [(718, 32, 2048, 16, 128), (718, 32, 2048, 64, 128),
                (1000, 32, 128, 16, 128), (29, 13, 501, 7, 96),
                (9, 13, 77, 7, 97), (11, 130, 40, 140, 64),
                (8, 1, 9, 1, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", DENSE_SHAPES)
def test_dense_matches_plain(cuda, shape):
    q, qm, d, dm = _on(cuda, *_corpus(sum(shape), *shape))
    want = mf.maxsim_dense_plain(q, qm, d, dm)
    before = mf.maxsim_dense.launches
    got = mf.maxsim_dense(q, qm, d, dm)
    torch.cuda.synchronize()
    assert mf.maxsim_dense.launches == before + 1
    assert got.shape == want.shape
    _assert_scores(got, want, nan_is_neg=True)
    # planted: the NaN doc loses (but for the all-masked query, which
    # scores 0 against every doc)
    others = [r for r in range(shape[0]) if r != 1]
    assert bool((got[others, 3] == float(NEG)).all())
    assert bool((got[1] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["default", "high", "highest"])
@pytest.mark.parametrize("shape", [(64, 32, 512, 16, 128), (9, 13, 77, 7, 97)])
def test_dense_precisions_match_plain(cuda, precision, shape):
    q, qm, d, dm = _on(cuda, *_corpus(7, *shape))
    want = mf.maxsim_dense_plain(q, qm, d, dm, precision)
    got = mf.maxsim_dense(q, qm, d, dm, precision)
    _assert_scores(got, want, nan_is_neg=True)


@pytest.mark.cuda
def test_dense_unaligned_rows_take_the_scalar_copies(cuda):
    q, qm, d, dm = _on(cuda, *_corpus(3, 40, 32, 300, 16, 128))
    buf = torch.empty(d.numel() + 1, device=cuda)
    buf[1:] = d.reshape(-1)
    du = buf[1:].view(d.shape)
    assert du.data_ptr() % 16 != 0
    _assert_scores(mf.maxsim_dense(q, qm, du, dm),
                   mf.maxsim_dense_plain(q, qm, d, dm), nan_is_neg=True)


def _ids(rng, B, M, N, bad=True):
    ids = rng.integers(0, N, size=(B, M))
    if bad:
        ids[0, 0], ids[0, 1] = -1, N        # outside the docs: NaN
    ids[1, 2:6] = ids[1, 6]                 # repeated candidates
    ids[2, :3] = [2, 3, 5]                  # garbage docs
    return ids


# (B, M, N, Tq, Td, dim): the re-rank at (1,000, m=256) over 8,192 docs,
# phase 6(b)'s Td = 64, the class-A repair's 512 bin members, a ragged
# shape, an odd dim, passages and docs past a block's slots
PAIRS_SHAPES = [(1000, 256, 8192, 32, 16, 128), (300, 256, 8192, 32, 64, 128),
                (40, 512, 8192, 32, 16, 128), (29, 37, 501, 13, 7, 96),
                (9, 20, 77, 13, 7, 97), (7, 9, 50, 40, 300, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", PAIRS_SHAPES)
def test_pairs_match_plain(cuda, shape):
    B, M, N, Tq, Td, dim = shape
    q, qm, d, dm = _on(cuda, *_corpus(sum(shape), B, Tq, N, Td, dim))
    ids = torch.from_numpy(_ids(np.random.default_rng(B), B, M, N)).to(cuda)
    want = mf.maxsim_pairs_plain(q, qm, d, dm, ids)
    before = mf.maxsim_pairs.launches
    got = mf.maxsim_pairs(q, qm, d, dm, ids)
    torch.cuda.synchronize()
    assert mf.maxsim_pairs.launches == before + 1
    _assert_scores(got, want, nan_is_neg=False)
    assert bool(torch.isnan(got[0, :2]).all())
    assert bool(torch.isnan(got[2, 1]))              # the NaN doc
    assert bool((got[1] == 0).all())                 # the all-masked query
    # int32 ids: the same launch
    assert torch.equal(mf.maxsim_pairs(q, qm, d, dm, ids.int()).view(
        torch.int32), got.view(torch.int32))


@pytest.mark.cuda
def test_two_launches_give_equal_bits(cuda):
    q, qm, d, dm = _on(cuda, *_corpus(11, 718, 32, 2048, 16, 128))
    a = mf.maxsim_dense(q, qm, d, dm)
    b = mf.maxsim_dense(q, qm, d, dm)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    ids = torch.from_numpy(_ids(np.random.default_rng(1), 718, 256,
                                2048)).to(cuda)
    a = mf.maxsim_pairs(q, qm, d, dm, ids)
    b = mf.maxsim_pairs(q, qm, d, dm, ids)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
def test_empty_and_refusals(cuda):
    q, qm, d, dm = _on(cuda, *_corpus(2, 8, 4, 10, 3, 16))
    assert mf.maxsim_dense(q[:0], qm[:0], d, dm).shape == (0, 10)
    ids = torch.zeros((8, 0), dtype=torch.long, device=cuda)
    assert mf.maxsim_pairs(q, qm, d, dm, ids).shape == (8, 0)
    with pytest.raises(TypeError):
        mf.maxsim_dense(q.double(), qm, d, dm)
    with pytest.raises(TypeError):
        mf.maxsim_dense(q, qm.int(), d, dm)
    with pytest.raises(ValueError):
        mf.maxsim_dense(q, qm, d[:, :, :8], dm)
    with pytest.raises(ValueError):
        mf.maxsim_dense(q, qm, d, dm.cpu())
    with pytest.raises(TypeError):
        mf.maxsim_pairs(q, qm, d, dm, ids.float())
    with pytest.raises(ValueError):
        mf.maxsim_pairs(q, qm, d, dm, ids[:3])


def _oracle_sorted(q, qm, d, dm, k):
    """float64 MaxSim on the card, each query's scores sorted best first,
    (Q, k + 1), NaN scores as -inf (they lose in every engine)."""
    qd, dd = q.double(), d.double()
    rows = []
    for s in range(0, q.shape[0], 16):
        sims = torch.einsum("qtk,dsk->qtds", qd[s:s + 16], dd)
        sims = torch.where(dm[None, None], sims, -1e30)
        tok = sims.amax(3)
        tok = torch.where(qm[s:s + 16, :, None], tok, 0.0)
        rows.append(tok.sum(1))
    sc = torch.cat(rows).nan_to_num(nan=-np.inf)
    return torch.sort(sc, dim=1, descending=True).values[:, :k + 1].cpu()


def _plain_engines(monkeypatch):
    monkeypatch.setattr(mf, "maxsim_dense", mf.maxsim_dense_plain)
    monkeypatch.setattr(mf, "maxsim_pairs", mf.maxsim_pairs_plain)
    monkeypatch.setattr(tm, "_smallest_k", topk.smallest_k)


@pytest.mark.cuda
@pytest.mark.parametrize("engine,tile_docs", [("exact", 128),
                                              ("exact", 2048),
                                              ("screened", 0)])
def test_engines_on_the_kernels_match_the_plain_engines(cuda, monkeypatch,
                                                        engine, tile_docs):
    """maxsim_topk on M1 / M2 (and K7 in the tile step) against the same
    engine on the plain versions: ids tie-tolerant, scores within 1e-3;
    M1 launched once a tile, M2 at least once a screened call."""
    Q, Tq, D, Td, dim, k = 64, 32, 9000, 16, 128, 20
    q, qm, d, dm = _on(cuda, *_corpus(5, Q, Tq, D, Td, dim, garbage=False))
    kw = dict(engine=engine, device="cuda")
    if tile_docs:
        kw["tile_docs"] = tile_docs
    mf.reset_launches()
    s_k, i_k = tm.maxsim_topk(q, qm, d, dm, k, **kw)
    torch.cuda.synchronize()
    if engine == "exact":
        assert mf.maxsim_dense.launches == -(-D // tile_docs)
    else:
        assert mf.maxsim_pairs.launches >= 1
    with monkeypatch.context() as m:
        _plain_engines(m)
        s_p, i_p = tm.maxsim_topk(q, qm, d, dm, k, **kw)
    oracle = _oracle_sorted(q, qm, d, dm, k)
    assert_ids_tie_tolerant(i_k.cpu().numpy(), i_p.cpu().numpy(),
                            oracle.numpy(), TOL)
    np.testing.assert_allclose(s_k.cpu().numpy(), s_p.cpu().numpy(),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(s_k.cpu().numpy(), oracle[:, :k].numpy(),
                               atol=TOL, rtol=0)


@pytest.mark.cuda
def test_tile_step_ties_take_the_lowest_position(cuda):
    """Every doc tied: the tile step on K7 returns positions 0 .. k-1 and
    keeps the running list's earlier ids on ties, as the stable sort."""
    q, qm, d, dm = _on(cuda, *_corpus(9, 4, 8, 300, 8, 32, garbage=False))
    d = d[:1].expand(300, -1, -1).contiguous()
    dm = dm[:1].expand(300, -1).contiguous()
    s, i = tm._exact_topk(q, qm, d, dm, 10, 128)
    assert i.cpu().tolist() == [list(range(10))] * 4


# ------------------------------------------- the variants: "split", "ffma"
# Each variant against the plain version (MaxSim tolerance, planted
# positions equal) and against a float64 oracle within its error model:
# |score - oracle| <= (dot bound + 64) 2^-24 sum_t max_s sum_k |q_tk d_sk|,
# the dot bound `error_bound` for "split" (the plan's) and dim for "ffma"
# (maxsim_acc_rel's dot term), 64 the token sum's.

VARIANT_DENSE = [(718, 32, 2048, 16, 128), (718, 32, 2048, 64, 128),
                 (1000, 32, 128, 16, 128), (29, 13, 501, 7, 96),
                 (50, 24, 300, 32, 128), (33, 8, 100, 8, 64),
                 (11, 5, 300, 3, 64), (9, 13, 77, 7, 97)]
VARIANT_PAIRS = [(1000, 256, 8192, 32, 16, 128),
                 (300, 256, 50000, 32, 64, 128),
                 (64, 512, 8192, 32, 16, 128), (29, 37, 501, 13, 7, 96),
                 (40, 100, 300, 24, 32, 64), (7, 9, 50, 40, 3, 128),
                 (9, 20, 77, 13, 7, 97)]


def _oracle_dense(q, qm, d, dm):
    """float64 scores (NaN kept) and the error scale sum_t max_s sum_k
    |q_tk d_sk| over valid tokens, on the card, 16 passages at a time."""
    qd, dd = q.double(), d.double()
    scores, scales = [], []
    for s in range(0, q.shape[0], 16):
        qs = qd[s:s + 16]
        sims = torch.einsum("qtk,dsk->qtds", qs, dd)
        absd = torch.einsum("qtk,dsk->qtds", qs.abs().nan_to_num(0, 0, 0),
                            dd.abs().nan_to_num(0, 0, 0))
        sel = torch.where(dm[None, None], sims, -1e30)
        tok = torch.where(torch.isnan(sel).any(3), np.nan, sel.amax(3))
        on = qm[s:s + 16, :, None]
        scores.append(torch.where(on, tok, 0.0).sum(1))
        a = torch.where(dm[None, None], absd, 0.0).amax(3)
        scales.append(torch.where(on, a, 0.0).sum(1))
    return torch.cat(scores), torch.cat(scales)


def _within_model(got, oracle, scale, dot_bound, nan_is_neg):
    fin = torch.isfinite(oracle) & (oracle.abs() < 1e29)
    err = (got.double() - oracle)[fin].abs()
    lim = (dot_bound + 64) * 2.0 ** -24 * scale[fin]
    assert bool((err <= lim + 1e-30).all()), float((err / lim).max())
    return float((err / (scale[fin] * 2.0 ** -24)).max()) if err.numel() \
        else 0.0


def _dot_bound(variant, wrapper, dim):
    if variant == "split" and wrapper.last_plan.variant == "split":
        return wrapper.last_plan.error_bound
    return float(dim)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", mf.VARIANTS)
@pytest.mark.parametrize("shape", VARIANT_DENSE)
def test_dense_variants_match_plain_and_oracle(cuda, variant, shape):
    Q, Tq, D, Td, dim = shape
    q, qm, d, dm = _on(cuda, *_corpus(sum(shape) + 1, *shape))
    small = Q * D <= 200_000
    for precision in ("highest", "high", "default") if small else \
            ("highest",):
        mf.reset_launches()
        with mf.forced_variant(variant):
            got = mf.maxsim_dense(q, qm, d, dm, precision)
            again = mf.maxsim_dense(q, qm, d, dm, precision)
        torch.cuda.synchronize()
        taken = mf.maxsim_dense.last_plan.variant if variant == "split" \
            else "ffma"
        assert mf.maxsim_dense.launches_by_variant[taken] == 2
        assert torch.equal(got.view(torch.int32), again.view(torch.int32))
        _assert_scores(got, mf.maxsim_dense_plain(q, qm, d, dm, precision),
                       nan_is_neg=True)
        if precision == "highest":
            oracle, scale = _oracle_dense(q, qm, d, dm)
            _within_model(got, oracle, scale,
                          _dot_bound(variant, mf.maxsim_dense, dim), True)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", mf.VARIANTS)
@pytest.mark.parametrize("shape", VARIANT_PAIRS)
def test_pairs_variants_match_plain_and_oracle(cuda, variant, shape):
    B, M, N, Tq, Td, dim = shape
    q, qm, d, dm = _on(cuda, *_corpus(sum(shape) + 2, B, Tq, N, Td, dim))
    ids = torch.from_numpy(_ids(np.random.default_rng(B), B, M, N)).to(cuda)
    mf.reset_launches()
    with mf.forced_variant(variant):
        got = mf.maxsim_pairs(q, qm, d, dm, ids)
        again = mf.maxsim_pairs(q, qm, d, dm, ids)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    _assert_scores(got, mf.maxsim_pairs_plain(q, qm, d, dm, ids),
                   nan_is_neg=False)
    assert bool(torch.isnan(got[0, :2]).all())
    # the oracle on 32 queries' candidates
    rows = list(range(min(B, 32)))
    for b in rows:
        inside = (ids[b] >= 0) & (ids[b] < N)
        cand = ids[b].clamp(0, N - 1)
        oracle, scale = _oracle_dense(q[b:b + 1], qm[b:b + 1], d[cand],
                                      dm[cand])
        oracle = torch.where(inside[None], oracle, np.nan)
        _within_model(got[b:b + 1], oracle, scale,
                      _dot_bound(variant, mf.maxsim_pairs, dim), False)


@pytest.mark.cuda
def test_split_adversarial_dots_within_the_bound(cuda):
    """Heavy cancellation, a wide exponent range and a value near FLT_MAX:
    each dot of "split" within its error bound of the float64 dot."""
    rng = np.random.default_rng(3)
    dim = 128
    a = rng.standard_normal((64, dim)).astype(np.float32)
    b = rng.standard_normal((64, dim)).astype(np.float32)
    prod = rng.standard_normal(dim) * 1e3
    prod[-1] = -prod[:-1].sum()
    b[0] = (prod / np.where(a[0] == 0, 1, a[0])).astype(np.float32)
    a[1] *= (2.0 ** rng.integers(-20, 20, dim)).astype(np.float32)
    b[1] *= (2.0 ** rng.integers(-20, 20, dim)).astype(np.float32)
    a[2, 0] = np.float32(3.3e38)
    b[:, 0] = np.float32(1e-30)
    # one-token passages and docs: each score is one dot
    q, d = _on(cuda, a[:, None, :], b[:, None, :])
    qm = torch.ones((64, 1), dtype=torch.bool, device=cuda)
    with mf.forced_variant("split"):
        got = mf.maxsim_dense(q, qm, d, qm)
    assert mf.maxsim_dense.last_plan.variant == "split"
    exact = a.astype(np.float64) @ b.astype(np.float64).T
    scale = np.abs(a.astype(np.float64)) @ np.abs(b.astype(np.float64)).T
    err = np.abs(got.double().cpu().numpy() - exact)
    bound = mf.maxsim_dense.last_plan.error_bound
    assert (err <= bound * 2.0 ** -24 * scale).all(), float(
        (err / (scale * 2.0 ** -24)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,shape,want", [
    # every td_p (8, 16, 32, 64), tq_p (8 ... 64), grid in y
    ("maxsim_dense", (40, 5, 300, 3, 64), (8, 8)),
    ("maxsim_dense", (40, 16, 300, 16, 128), (16, 16)),
    ("maxsim_dense", (40, 32, 3000, 32, 128), (32, 32)),
    ("maxsim_dense", (40, 64, 300, 64, 128), (64, 64)),
    ("maxsim_dense", (7, 64, 300, 9, 128), (64, 16)),
    # M2's N: 16, 32, 64
    ("maxsim_pairs", (40, 30, 300, 13, 7, 128), (16, 8)),
    ("maxsim_pairs", (40, 30, 300, 32, 64, 128), (32, 64)),
    ("maxsim_pairs", (40, 30, 300, 40, 16, 128), (64, 16)),
    ("maxsim_pairs", (9, 600, 300, 60, 32, 96), (64, 32)),
])
def test_each_plan_path_matches_plain(cuda, kernel, shape, want):
    if kernel == "maxsim_dense":
        Q, Tq, D, Td, dim = shape
    else:
        Q, M, D, Tq, Td, dim = shape
    q, qm, d, dm = _on(cuda, *_corpus(sum(shape), Q, Tq, D, Td, dim))
    wrapper = getattr(mf, kernel)
    with mf.forced_variant("split"):
        if kernel == "maxsim_dense":
            got = mf.maxsim_dense(q, qm, d, dm)
            want_s = mf.maxsim_dense_plain(q, qm, d, dm)
        else:
            ids = torch.from_numpy(_ids(np.random.default_rng(Q), Q, M,
                                        D)).to(cuda)
            got = mf.maxsim_pairs(q, qm, d, dm, ids)
            want_s = mf.maxsim_pairs_plain(q, qm, d, dm, ids)
    pl = wrapper.last_plan
    assert pl.variant == "split" and (pl.tq_p, pl.td_p) == want
    _assert_scores(got, want_s, nan_is_neg=kernel == "maxsim_dense")


@pytest.mark.cuda
def test_forced_variant_and_the_default(cuda):
    """The default launches DEFAULT_VARIANT; forced_variant the other;
    the plan's "ffma" shapes are counted there; both give the plain
    version's scores."""
    q, qm, d, dm = _on(cuda, *_corpus(4, 64, 32, 512, 16, 128))
    ids = torch.from_numpy(_ids(np.random.default_rng(4), 64, 50,
                                512)).to(cuda)
    mf.reset_launches()
    a = mf.maxsim_dense(q, qm, d, dm)
    b = mf.maxsim_pairs(q, qm, d, dm, ids)
    for w in (mf.maxsim_dense, mf.maxsim_pairs):
        v = mf.DEFAULT_VARIANT[w.__name__]
        assert w.launches_by_variant[v] == w.launches == 1
    for v in mf.VARIANTS:
        with mf.forced_variant(v):
            _assert_scores(mf.maxsim_dense(q, qm, d, dm), a, True)
            _assert_scores(mf.maxsim_pairs(q, qm, d, dm, ids), b, False)
    for w in (mf.maxsim_dense, mf.maxsim_pairs):
        assert w.launches == 3
        assert sum(w.launches_by_variant.values()) == 3
    # dim 97: the plan sends "split" to "ffma"
    q, qm, d, dm = _on(cuda, *_corpus(5, 9, 13, 77, 7, 97))
    mf.reset_launches()
    with mf.forced_variant("split"):
        mf.maxsim_dense(q, qm, d, dm)
    assert mf.maxsim_dense.launches_by_variant == {"split": 0, "ffma": 1}
    assert mf.maxsim_dense.last_plan.reason == "dim"
