"""The "split" variant of the MaxSim engines' fused kernels
(csrc/maxsim_split.cuh, M1 and M2 in ops/maxsim_fused.py) on the CPU: a
model of its arithmetic, its error bound, its launch plan and the
wrappers' refusals.

The kernels run only on the card (tests/test_torch_port_cuda_maxsim_fused.py
holds both variants against the plain versions there). What can be checked
here is the arithmetic the kernel does, modelled step by step below: the
truncating bf16x6 split of each fp32 operand (a NaN made canonical first),
exact products (in float64), x0 y0 summed a chunk of kc dims at a time and
the other five products (order 2 then order 1 in each chunk) over the
whole dim, in two accumulators, every add truncated to fp32 (the
conservative model the kernel's error bound assumes), each x0 y0 chunk
promoted into an fp32 total with a round-to-nearest add and the small
products joined at the end by another (left out where they make the dot
NaN); then the masked max over doc tokens and the sum over query
tokens in the kernel's column order. That model is held against
a float64 oracle within `error_bound` (at every shape, and on adversarial
dots: heavy cancellation, a wide exponent range, a value near FLT_MAX),
and against the JAX package's `maxsim_scores` and `_maxsim_select`'s
re-rank scores at HIGHEST within the CPU MaxSim tolerance (1e-5 relative,
at least 1e-5 absolute; NEG, NaN and infinite positions equal). The plan
(plain Python) must admit a dim only where the bound stays within the dot
budget of `maxsim_acc_rel`, and the wrappers must launch what the plan says,
count it, and raise on a refused launch without falling back."""

import contextlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from neighborhoodwatch_tpu.ops import maxsim as jm
from neighborhoodwatch_tpu.ops import maxsim_kernel as jmk

from neighborhoodwatch_tpu_torch.ops import maxsim_fused as mf
from neighborhoodwatch_tpu_torch.ops import maxsim_kernel as tmk

TOL = 1e-5
NEG = float(np.float32(mf.NEG))
U = 2.0 ** -24
# the six products (a piece of the doc side, of the query side) in the
# order the kernel issues them: order 2, then 1, then 0
ORDER3 = ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0))


# ------------------------------------------------------- the arithmetic


def split3(x):
    """The kernel's split of fp32 values (csrc/maxsim_split.cuh:
    split_pair): a NaN made canonical, x0 = x with its low 16 bits
    cleared, x1 the same of r1 = x - x0, x2 the same of r1 - x1. Returns
    (x0, x1, x2, r1)."""
    x = np.asarray(x, dtype=np.float32)
    x = np.where(np.isnan(x), np.uint32(0x7FFFFFFF).view(np.float32), x)
    x0 = cut16(x)
    with np.errstate(invalid="ignore", over="ignore"):
        r1 = (x - x0).astype(np.float32)
        x1 = cut16(r1)
        x2 = cut16((r1 - x1).astype(np.float32))
    return x0, x1, x2, r1


def cut16(x):
    """fp32 values truncated to bf16, as the kernel packs a piece."""
    x = np.asarray(x, np.float32)
    return (x.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)


def trunc32(v):
    """float64 values truncated (toward zero) to fp32."""
    f = v.astype(np.float32)
    up = np.abs(f.astype(np.float64)) > np.abs(v)
    return np.where(up, np.nextafter(f, np.float32(0)), f)


def model_dots(a, b, pieces, kc):
    """(m, dim) x (n, dim) fp32 token rows -> (m, n) dots as the "split"
    kernel computes them (see the module docstring)."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    dim = a.shape[1]
    if pieces == 3:
        ap, bp, order = split3(a)[:3], split3(b)[:3], ORDER3
    else:
        nan = np.uint32(0x7FFFFFFF).view(np.float32)
        ap = (cut16(np.where(np.isnan(a), nan, a)),)
        bp = (cut16(np.where(np.isnan(b), nan, b)),)
        order = ((0, 0),)
    cols = -(-dim // 32) * 32           # slots of 32 columns, zeros past dim

    def chain(acc, pa, pb, c0):
        for k in range(c0, min(c0 + kc, dim)):
            prod = (ap[pa][:, k, None].astype(np.float64)
                    * bp[pb][None, :, k].astype(np.float64))
            acc = trunc32(acc.astype(np.float64) + prod)
        return acc

    def rn(x, y):
        return (x.astype(np.float64) + y.astype(np.float64)).astype(
            np.float32)

    tot = None
    small = zeros = np.zeros((a.shape[0], b.shape[0]), np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        for c0 in range(0, cols, kc):
            if pieces == 3:
                for pa, pb in order[:5]:
                    small = chain(small, pa, pb, c0)
            main = chain(zeros, 0, 0, c0)
            tot = main if tot is None else rn(tot, main)
        if pieces == 3:
            t = rn(tot, small)
            tot = np.where(np.isnan(t), tot, t)
    return tot


def model_scores(q, qm, d, dm, pieces=3, kc=32, tq_p=None):
    """M1's (Q, D) scores from model_dots: the doc mask selects (-1e30),
    max.NaN over doc tokens, then the sum over each passage's valid tokens
    in the kernel's order (a column lane's columns 8j + 2 tig + e by j and
    e, then (lane 0 + lane 1) + (lane 2 + lane 3)); NaN -> NEG."""
    Q, Tq, dim = q.shape
    D, Td, _ = d.shape
    tq_p = tq_p or max(8, 1 << (Tq - 1).bit_length())
    dots = model_dots(d.reshape(D * Td, dim), q.reshape(Q * Tq, dim),
                      pieces, kc).reshape(D, Td, Q, Tq)
    with np.errstate(invalid="ignore"):
        sel = np.where(dm[:, :, None, None], dots, np.float32(NEG))
        tok = np.where(np.isnan(sel).any(1), np.nan, sel.max(1))  # (D, Q, Tq)
    out = np.zeros((Q, D), np.float32)
    for e in range(D):
        for p in range(Q):
            lanes = []
            for tig in range(4):
                s = np.float32(0)
                for j in range(tq_p // 8):
                    for x in range(2):
                        t = 8 * j + 2 * tig + x
                        if t < Tq and qm[p, t]:
                            s = np.float32(s + tok[e, p, t])
                lanes.append(s)
            out[p, e] = np.float32(np.float32(lanes[0] + lanes[1])
                                   + np.float32(lanes[2] + lanes[3]))
    return np.where(np.isnan(out), np.float32(NEG), out)


def _corpus(seed, Q, Tq, D, Td, dim, garbage=True):
    """Ragged masks; with `garbage`: an all-masked query and doc, NaN in a
    valid and in a masked doc token, inf in a masked doc token, +inf and
    -inf in one valid doc token, NaN in a masked query token."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((Q, Tq, dim)).astype(np.float32)
    d = rng.standard_normal((D, Td, dim)).astype(np.float32)
    qm = rng.random((Q, Tq)) < 0.8
    dm = rng.random((D, Td)) < 0.7
    qm[:, 0] = True
    dm[:, 0] = True
    if garbage:
        qm[1] = False
        dm[2] = False
        d[3, 0, 0] = np.nan
        d[4, Td - 1] = np.inf
        dm[4, Td - 1] = Td == 1
        d[5, 0, ::2] = np.inf
        d[5, 0, 1::2] = -np.inf
        d[6, Td // 2, :] = np.nan
        dm[6, Td // 2] = Td // 2 == 0
        q[Q - 1, Tq - 1, 0] = np.nan
        qm[Q - 1, Tq - 1] = Tq == 1
    return q, qm, d, dm


def _assert_scores(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    inf = np.isinf(want)
    np.testing.assert_array_equal(got[inf], want[inf])
    neg = want == NEG
    np.testing.assert_array_equal(got[neg], want[neg])
    fin = np.isfinite(want)
    assert np.all(np.abs(got[fin] - want[fin])
                  <= tol * np.maximum(np.abs(want[fin]), 1.0))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_is_exact_and_small(seed):
    """x0 + x1 + x2 == x for fp32 values across the exponent range whose
    last bit lies at or above 2^-133 (|x| >= 2^-110; below, the loss is
    under 2^-133), every piece a bf16 value (low 16 bits zero) of x's sign
    or 0, |x1| < 2^-7 |x|, |x2| < 2^-14 |x|; a value near FLT_MAX stays
    finite in every piece."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(20000)
         * 2.0 ** rng.integers(-100, 100, 20000)).astype(np.float32)
    x = np.concatenate([x, np.float32([3.4028235e38, -3.4028230e38,
                                       np.finfo(np.float32).tiny, 1.0,
                                       -0.0, 0.0])])
    x0, x1, x2, _ = split3(x)
    ax = np.abs(x.astype(np.float64))
    for p in (x0, x1, x2):
        assert np.isfinite(p).all()
        assert (p.view(np.uint32) & 0xFFFF).max() == 0
        assert (np.sign(p) * np.sign(x) >= 0).all()
    total = x0.astype(np.float64) + x1.astype(np.float64) + x2
    normal = ax >= 2.0 ** -110
    np.testing.assert_array_equal(total[normal], x[normal].astype(np.float64))
    assert (np.abs(total - x)[~normal] < 2.0 ** -133).all()
    assert (np.abs(x1) <= 2.0 ** -7 * ax).all()
    assert (np.abs(x2) <= 2.0 ** -14 * ax).all()


def test_split_of_non_finite_values():
    """x0 keeps inf, -inf and NaN, whatever a NaN's payload (one in the low
    bits alone would truncate to inf without the canonical NaN); their
    residual pieces are NaN, a finite value's finite."""
    x = np.float32([np.inf, -np.inf, np.nan, 3.4028235e38, -1.5, 0.0])
    x = np.concatenate([x, np.uint32([0x7F800001, 0xFFC00000]).view(
        np.float32)])
    x0, x1, x2, r1 = split3(x)
    np.testing.assert_array_equal(x0[:2], x[:2])
    assert np.isnan(x0[[2, 6, 7]]).all() and np.isfinite(x0[3:6]).all()
    np.testing.assert_array_equal(np.isnan(r1), [1, 1, 1, 0, 0, 0, 1, 1])
    assert np.isfinite(x1[3:6]).all() and np.isfinite(x2[3:6]).all()


def test_model_keeps_the_plain_non_finite_dots():
    """Where a token holds inf or NaN, the model's dot is the plain dot's
    inf or NaN (the small products left out where they make it NaN): inf
    meeting exact (zero-residual) values, inf against inf of either sign,
    NaN, inf times 0."""
    a = np.ones((4, 64), np.float32)
    b = np.ones((5, 64), np.float32)
    a[0, 3] = np.inf                    # + inf . 1 -> +inf
    a[1, 3] = -np.inf
    a[2, 5] = np.uint32(0x7F800001).view(np.float32)   # a NaN
    b[1, 3] = -np.inf                   # -inf meets +inf / -inf
    b[2, 3] = 0.0                       # inf * 0 -> NaN
    b[3, 7] = 1e-3                      # a residual piece meets inf
    b[4] = np.float32(0.1)              # residuals everywhere
    got = model_dots(a, b, 3, 16)
    with np.errstate(invalid="ignore"):
        want = (a.astype(np.float64) @ b.astype(np.float64).T)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    inf = np.isinf(want)
    np.testing.assert_array_equal(got[inf], want[inf])
    fin = np.isfinite(want)
    assert np.allclose(got[fin], want[fin], rtol=1e-6)


def _adversarial(rng, n, dim):
    """Token rows whose dots cancel heavily, span a wide exponent range,
    and hold one value near FLT_MAX."""
    a = rng.standard_normal((n, dim)).astype(np.float32)
    b = rng.standard_normal((n, dim)).astype(np.float32)
    # cancellation: b[0] makes a[0] . b[0] (nearly) 0 with large terms
    prod = rng.standard_normal(dim) * 1e3
    prod[-1] = -prod[:-1].sum()
    b[0] = (prod / np.where(a[0] == 0, 1, a[0])).astype(np.float32)
    # a wide exponent range
    a[1] *= (2.0 ** rng.integers(-20, 20, dim)).astype(np.float32)
    b[1] *= (2.0 ** rng.integers(-20, 20, dim)).astype(np.float32)
    # one value near FLT_MAX against a small one
    a[2, 0] = np.float32(3.3e38)
    b[:, 0] = np.float32(1e-30)
    return a, b


@pytest.mark.parametrize("dim,pieces", [(64, 3), (96, 3), (128, 3),
                                        (128, 1), (384, 1), (48, 1)])
def test_model_within_the_error_bound(dim, pieces):
    """Every dot of the model within error_bound(dim, kc, pieces) 2^-24
    sum_k |q_k d_k| of the float64 dot, at the chunk the plan takes, on
    unit-scale rows and on the adversarial ones."""
    kc = mf.chunk_for(dim, pieces)
    assert kc in (16, 32)
    bound = mf.error_bound(dim, kc, pieces)
    assert bound <= dim
    rng = np.random.default_rng(dim + pieces)
    a = rng.standard_normal((24, dim)).astype(np.float32)
    b = rng.standard_normal((20, dim)).astype(np.float32)
    a2, b2 = _adversarial(rng, 6, dim)
    for x, y in ((a, b), (a2, b2)):
        if pieces == 1:                 # bf16-valued operands
            x, y = split3(x)[0], split3(y)[0]
        got = model_dots(x, y, pieces, kc).astype(np.float64)
        x64, y64 = x.astype(np.float64), y.astype(np.float64)
        exact = x64 @ y64.T
        scale = np.abs(x64) @ np.abs(y64).T
        assert np.isfinite(got).all()
        err = np.abs(got - exact)
        assert (err <= bound * U * scale).all(), float(
            (err / (scale * U)).max())


@pytest.mark.parametrize("shape", [(5, 32, 9, 16, 128), (4, 13, 8, 7, 96),
                                   (3, 8, 7, 1, 64)])
def test_model_matches_jax_maxsim_scores(shape):
    """The model's M1 scores against JAX's jitted maxsim_scores at
    HIGHEST, garbage planted: within 1e-5, NEG and NaN positions equal."""
    q, qm, d, dm = _corpus(sum(shape), *shape)
    kc = mf.chunk_for(shape[-1], 3)
    want = np.asarray(jm.maxsim_scores(q, qm, d, dm, precision="highest"))
    got = model_scores(q, qm, d, dm, 3, kc)
    _assert_scores(got, want)
    assert (got[[r for r in range(shape[0]) if r != 1], 3] == NEG).all()
    assert (got[1] == 0).all()


def test_model_matches_jax_rerank_scores():
    """M2's arithmetic (chunks of 16): the model's scores of each query's
    own candidates against the scores JAX's _maxsim_select re-ranks them
    with at HIGHEST (the 3-pass screen)."""
    rng_q, qm, d, dm = _corpus(17, 6, 12, 300, 8, 64, garbage=False)
    k = 7
    jn, jd, _, jst = jmk.screen_maxsim(rng_q, qm, d, dm,
                                       screen_precision="high")
    m, block, _ = jm.maxsim_screen_plan(300, k, 8, 64, 3)
    js, jdoc, _ = jm._maxsim_select(
        jnp.asarray(rng_q), jnp.asarray(qm), jnp.asarray(d), jnp.asarray(dm),
        jn, jd, k, m, block=block, passes=3, doc_stats=jst)
    js, jdoc = np.asarray(js), np.asarray(jdoc)
    kc = mf.chunk_for(64, 3)
    assert kc == 16
    got = np.stack([model_scores(rng_q[b:b + 1], qm[b:b + 1], d[jdoc[b]],
                                 dm[jdoc[b]], 3, kc, tq_p=16)[0]
                    for b in range(len(jdoc))])
    _assert_scores(got, js)


# --------------------------------------------------------- the bound


@pytest.mark.parametrize("kernel,pieces", [("maxsim_dense", 3),
                                           ("maxsim_dense", 1),
                                           ("maxsim_pairs", 3)])
def test_bound_within_the_dot_budget_wherever_admitted(kernel, pieces):
    """For every dim up to 4,096 the plan admits, the bound stays at or
    below dim 2^-24: the dot term of maxsim_acc_rel (the port's and the
    JAX package's, which are equal), so rerank_acc holds unchanged."""
    admitted = []
    for dim in range(1, 4097):
        pl = mf.plan(kernel, 64, 32, 1000, 16, dim, pieces, True, 132, 256)
        if pl.variant != "split":
            assert pl.reason in ("dim", "error model", "shared memory")
            continue
        admitted.append(dim)
        assert pl.kc == mf.chunk_for(dim, pieces) > 0
        assert pl.error_bound == mf.error_bound(dim, pl.kc, pieces)
        assert pl.error_bound <= dim
        assert pl.error_bound * U + 64 * U * 1.05 <= \
            tmk.maxsim_acc_rel(dim) + 1e-18
        assert tmk.maxsim_acc_rel(dim) == jmk.maxsim_acc_rel(dim)
    assert 128 in admitted and all(dim % 16 == 0 for dim in admitted)
    assert min(admitted) == (64 if pieces == 3 else 48)


def test_bound_formula():
    """The terms: dropped 16.0625 (bf16x6; 0 at 1 piece), x0 y0's chunks
    2 kc, the small products over the dim dim (10/64 + 30/16384) (none at
    1 piece), a promotion a chunk; the plan's chunk is 16, and it admits
    dims from 64 (3 pieces) or 48 (1 piece) in steps of 16."""
    c = 1 + 2 ** -16
    small = 10 / 64 + 30 / 16384
    assert mf.error_bound(128, 16, 3) == pytest.approx(
        16.0625 + 32 + 128 * small + 8 * c)
    assert mf.error_bound(384, 16, 1) == pytest.approx(32 + 24 * c)
    assert mf.error_bound(80, 16, 3) == pytest.approx(
        16.0625 + 32 + 80 * small + 5 * c)
    assert mf.error_bound(128, 16, 3) == pytest.approx(76.297, abs=1e-3)
    assert mf.chunk_for(128, 3) == mf.chunk_for(64, 3) == mf.KC == 16
    assert mf.chunk_for(48, 1) == mf.chunk_for(384, 1) == 16
    assert mf.chunk_for(48, 3) == mf.chunk_for(32, 1) == 0
    assert mf.chunk_for(97, 3) == mf.chunk_for(200, 3) == 0


# ---------------------------------------------------------- the plan


@pytest.mark.parametrize("kernel,shape,precision,want", [
    # M1: the stream's fallback step, phase 6(b)'s Td, the exact engine's
    # 128-doc tile, ck's Tq 24 x Td 32, "high" (3 dim) and "default", a
    # ragged shape, short tokens
    ("maxsim_dense", (718, 32, 2048, 16, 128), "highest",
     ("split", 3, 16, 32, 16, 11)),
    ("maxsim_dense", (718, 32, 2048, 64, 128), "highest",
     ("split", 3, 16, 32, 64, 11)),
    ("maxsim_dense", (1000, 32, 128, 16, 128), "highest",
     ("split", 3, 16, 32, 16, 1)),
    ("maxsim_dense", (512, 24, 8192, 32, 128), "highest",
     ("split", 3, 16, 32, 32, 1)),
    ("maxsim_dense", (64, 32, 512, 16, 128), "high",
     ("split", 1, 16, 32, 16, 8)),
    ("maxsim_dense", (64, 32, 512, 16, 128), "default",
     ("split", 1, 16, 32, 16, 8)),
    ("maxsim_dense", (29, 13, 501, 7, 96), "highest",
     ("split", 3, 16, 16, 8, 7)),
    ("maxsim_dense", (11, 5, 300, 3, 64), "highest",
     ("split", 3, 16, 8, 8, 4)),
    # M2: the re-rank, Td 64, the class-A repair, ck's shapes, a ragged
    # one, a passage of 40 tokens (N = 64)
    ("maxsim_pairs", (1000, 32, 8192, 16, 128, 256), "highest",
     ("split", 3, 16, 32, 16, 1)),
    ("maxsim_pairs", (1000, 32, 50000, 64, 128, 256), "highest",
     ("split", 3, 16, 32, 64, 3)),
    ("maxsim_pairs", (64, 32, 8192, 16, 128, 512), "highest",
     ("split", 3, 16, 32, 16, 2)),
    ("maxsim_pairs", (512, 24, 8192, 32, 128, 256), "highest",
     ("split", 3, 16, 32, 32, 1)),
    ("maxsim_pairs", (29, 13, 501, 7, 96, 37), "highest",
     ("split", 3, 16, 16, 8, 1)),
    ("maxsim_pairs", (7, 40, 50, 3, 128, 9), "highest",
     ("split", 3, 16, 64, 8, 1)),
])
def test_plan_of_the_main_shapes(kernel, shape, precision, want):
    pieces = 3 if precision == "highest" else 1
    if kernel == "maxsim_pairs":
        q_n, tq, docs, td, dim, m = shape
    else:
        (q_n, tq, docs, td, dim), m = shape, 0
        dim = 3 * dim if precision == "high" else dim
    pl = mf.plan(kernel, q_n, tq, docs, td, dim, pieces, True, 132, m)
    assert (pl.variant, pl.pieces, pl.kc, pl.tq_p, pl.td_p,
            pl.grid[1]) == want
    assert pl.reason == "" and pl.error_bound <= dim
    pairs = kernel == "maxsim_pairs"
    dpt = mf.slot_rows(pairs) // pl.td_p
    if pairs:
        assert pl.grid[0] == q_n
        assert pl.cand_block % dpt == 0
        assert pl.grid[1] == -(-m // pl.cand_block)
        assert (pl.grid[1] - 1) * pl.cand_block < m
        n = bc = pl.tq_p
    else:
        assert pl.grid[0] == -(-q_n // (mf.DENSE_COLS // pl.tq_p))
        assert pl.grid[1] <= -(-docs // dpt)
        n, bc = mf.WG_N, mf.DENSE_COLS
    assert pl.smem_bytes == mf.smem_bytes(pairs, n, bc, dim, pieces)
    assert pl.smem_bytes <= mf.SMEM_BLOCK
    assert mf.b_bytes(bc, dim, pieces) <= mf.MAX_B_BYTES
    assert mf.stages_for(pairs, n, bc, dim, pieces) >= 2


@pytest.mark.parametrize("kernel,shape,pieces,aligned,reason", [
    ("maxsim_dense", (9, 13, 77, 7, 97), 3, True, "dim"),
    ("maxsim_dense", (9, 13, 77, 7, 8), 3, True, "dim"),
    ("maxsim_dense", (9, 13, 77, 7, 32), 3, True, "error model"),
    ("maxsim_dense", (9, 13, 77, 7, 48), 3, True, "error model"),
    ("maxsim_dense", (9, 13, 77, 7, 200), 3, True, "dim"),
    ("maxsim_dense", (9, 13, 77, 7, 32), 1, True, "error model"),
    ("maxsim_dense", (11, 130, 40, 140, 64), 3, True, "tokens"),
    ("maxsim_dense", (11, 13, 40, 65, 64), 3, True, "tokens"),
    ("maxsim_dense", (11, 13, 40, 7, 256), 3, True, "shared memory"),
    ("maxsim_dense", (11, 13, 40, 7, 128), 3, False, "unaligned"),
    ("maxsim_dense", (0, 13, 40, 7, 128), 3, True, "empty"),
    ("maxsim_pairs", (7, 40, 50, 300, 64, 9), 3, True, "tokens"),
    ("maxsim_pairs", (7, 100, 50, 30, 64, 9), 3, True, "tokens"),
    ("maxsim_dense", (7, 100, 50, 30, 64), 3, True, "tokens"),
    ("maxsim_pairs", (7, 40, 50, 30, 64, 0), 3, True, "empty"),
    ("maxsim_pairs", (7, 40, 50, 30, 97, 9), 3, True, "dim"),
])
def test_plan_sends_what_the_split_does_not_take_to_ffma(kernel, shape,
                                                         pieces, aligned,
                                                         reason):
    if kernel == "maxsim_pairs":
        q_n, tq, docs, td, dim, m = shape
    else:
        (q_n, tq, docs, td, dim), m = shape, 0
    pl = mf.plan(kernel, q_n, tq, docs, td, dim, pieces, aligned, 132, m)
    assert (pl.variant, pl.reason) == ("ffma", reason)
    assert pl.kc == pl.smem_bytes == 0


def test_plan_refuses_what_it_cannot_plan():
    with pytest.raises(ValueError):
        mf.plan("maxsim_keys", 1, 1, 1, 1, 128, 3, True, 132)
    with pytest.raises(ValueError):
        mf.plan("maxsim_pairs", 1, 1, 1, 1, 128, 1, True, 132, 4)
    with pytest.raises(ValueError):
        mf.plan("maxsim_dense", 1, 1, 1, 1, 128, 2, True, 132)
    with pytest.raises(ValueError):
        mf.plan("maxsim_dense", 1, 1, 1, 1, 128, 3, True, 0)


@pytest.mark.parametrize("q_n", [1, 7, 64, 131, 718, 1000, 20000])
@pytest.mark.parametrize("docs", [1, 15, 128, 2048, 8192, 200_000])
def test_dense_grid_covers_every_tile(q_n, docs):
    """Every query tile and every 128-row doc tile has a block; no block
    row in y is empty; at most 16 in y."""
    for td in (1, 16, 64):
        pl = mf.plan("maxsim_dense", q_n, 32, docs, td, 128, 3, True, 132)
        tiles = -(-docs // (mf.slot_rows(False) // pl.td_p))
        assert pl.grid[0] * (mf.DENSE_COLS // pl.tq_p) >= q_n
        assert 1 <= pl.grid[1] <= min(16, tiles)


# ------------------------------------------------- the wrappers' launch


class _FakeLibrary:
    """Stands for a built library: each launch returns `err`."""

    def __init__(self, err=0):
        self.err, self.calls = err, []

    def launcher(self, name, entry="launch"):
        def launch(*args):
            self.calls.append((name, entry, args))
            return self.err
        return launch


@pytest.fixture()
def card(monkeypatch):
    """Meta tensors take the kernels' path on a fake library of a 132-SM
    card; the plain versions raise if called. Returns the library."""
    lib = _FakeLibrary()
    monkeypatch.setattr(mf, "_ON_CARD", ("cuda", "meta"))
    monkeypatch.setattr(mf, "_launcher", lib.launcher)
    monkeypatch.setattr(mf, "_stream", lambda dev: 7)
    monkeypatch.setattr(mf, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(mf, "_plans", {})
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    for name in ("maxsim_dense", "maxsim_pairs"):
        def plain(*a, name=name, **kw):
            raise AssertionError(f"{name} ran its plain version on the card")
        monkeypatch.setattr(mf, f"{name}_plain", plain)
        monkeypatch.setattr(getattr(mf, name), "ffma_plans", {})
    mf.reset_launches()
    return lib


def _meta(Q, Tq, D, Td, dim, m=6):
    t = dict(device="meta")
    return (torch.zeros((Q, Tq, dim), **t),
            torch.ones((Q, Tq), dtype=torch.bool, **t),
            torch.zeros((D, Td, dim), **t),
            torch.ones((D, Td), dtype=torch.bool, **t),
            torch.zeros((Q, m), dtype=torch.long, **t))


@pytest.mark.parametrize("precision,dim,pieces", [("highest", 128, 3),
                                                  ("default", 128, 1),
                                                  ("high", 128, 1)])
def test_dense_launches_the_split_on_its_plan(card, precision, dim, pieces):
    q, qm, d, dm, _ = _meta(40, 32, 300, 16, dim)
    out = mf.maxsim_dense(q, qm, d, dm, precision)
    assert out.shape == (40, 300) and out.device.type == "meta"
    (name, entry, args), = card.calls
    assert (name, entry) == ("maxsim_dense", "split_launch")
    assert len(args) == len(mf._ARGTYPES[name][entry]) and args[-1] == 7
    pl = mf.maxsim_dense.last_plan
    op_dim = 3 * dim if precision == "high" else dim
    assert pl == mf.plan("maxsim_dense", 40, 32, 300, 16, op_dim, pieces,
                         True, 132)
    # Q, Tq, D, Td, dim, pieces, kc, tq_p, td_p, grid y, smem
    assert args[5:16] == (40, 32, 300, 16, op_dim, pieces, pl.kc, pl.tq_p,
                          pl.td_p, pl.grid[1], pl.smem_bytes)
    assert mf.maxsim_dense.launches == 1
    assert mf.maxsim_dense.launches_by_variant == {"split": 1, "ffma": 0}


def test_pairs_launch_the_split_on_its_plan(card):
    q, qm, d, dm, ids = _meta(40, 32, 300, 16, 128, m=256)
    out = mf.maxsim_pairs(q, qm, d, dm, ids.int())
    assert out.shape == (40, 256)
    (name, entry, args), = card.calls
    assert (name, entry) == ("maxsim_pairs", "split_launch")
    assert len(args) == len(mf._ARGTYPES[name][entry]) and args[-1] == 7
    pl = mf.maxsim_pairs.last_plan
    # B, Tq, N, Td, dim, M, kc, n, td_p, cand_block, smem
    assert args[6:17] == (40, 32, 300, 16, 128, 256, pl.kc, 32, 16,
                          pl.cand_block, pl.smem_bytes)
    assert mf.maxsim_pairs.launches_by_variant == {"split": 1, "ffma": 0}


def test_forced_ffma_and_the_plans_ffma_shapes(card):
    """forced_variant("ffma") launches the FFMA kernel; under "split" the
    plan sends dim 97 to "ffma", counted there and kept with its reason."""
    q, qm, d, dm, ids = _meta(4, 8, 30, 4, 128)
    with mf.forced_variant("ffma"):
        mf.maxsim_dense(q, qm, d, dm)
        mf.maxsim_pairs(q, qm, d, dm, ids)
    assert [(c[0], c[1]) for c in card.calls] == [
        ("maxsim_dense", "launch"), ("maxsim_pairs", "launch")]
    q, qm, d, dm, ids = _meta(4, 8, 30, 4, 97)
    mf.maxsim_dense(q, qm, d, dm)
    mf.maxsim_pairs(q, qm, d, dm, ids)
    assert [c[1] for c in card.calls[2:]] == ["launch", "launch"]
    assert mf.maxsim_dense.last_plan.reason == "dim"
    assert list(mf.maxsim_dense.ffma_plans.values()) == ["dim"]
    assert list(mf.maxsim_pairs.ffma_plans.values()) == ["dim"]
    for w in (mf.maxsim_dense, mf.maxsim_pairs):
        assert w.launches == 2
        assert w.launches_by_variant == {"split": 0, "ffma": 2}


@pytest.mark.parametrize("name", ["maxsim_dense", "maxsim_pairs"])
def test_a_refused_split_launch_raises_and_never_falls_back(card, name):
    """A launch that returns an error (here the launcher's refusal of a
    plan it would not make) raises; nothing runs "ffma" or the plain
    version in its place, nothing is counted."""
    card.err = 22001
    q, qm, d, dm, ids = _meta(4, 32, 30, 16, 128)
    with pytest.raises(RuntimeError, match=r"\(split\): CUDA error 22001"):
        if name == "maxsim_dense":
            mf.maxsim_dense(q, qm, d, dm)
        else:
            mf.maxsim_pairs(q, qm, d, dm, ids)
    assert [(c[0], c[1]) for c in card.calls] == [(name, "split_launch")]
    assert getattr(mf, name).launches == 0
    assert getattr(mf, name).launches_by_variant == {"split": 0, "ffma": 0}


def test_forced_variant_checks_and_restores():
    assert mf.DEFAULT_VARIANT == {"maxsim_dense": "split",
                                  "maxsim_pairs": "split"}
    with pytest.raises(ValueError):
        with mf.forced_variant("plain"):
            pass
    with mf.forced_variant("ffma"):
        assert mf._variant(mf.maxsim_dense) == "ffma"
        with mf.forced_variant("split"):
            assert mf._variant(mf.maxsim_pairs) == "split"
        assert mf._variant(mf.maxsim_pairs) == "ffma"
    assert mf._variant(mf.maxsim_dense) == "split"


def test_cpu_tensors_take_no_plan():
    """On CPU tensors the wrappers run the plain versions: no plan, no
    count, under any variant."""
    mf.reset_launches()
    q, qm, d, dm = (torch.from_numpy(np.ascontiguousarray(a))
                    for a in _corpus(3, 5, 8, 20, 4, 128, garbage=False))
    ids = torch.zeros((5, 3), dtype=torch.long)
    before = mf.maxsim_dense.last_plan
    for v in mf.VARIANTS:
        with mf.forced_variant(v):
            mf.maxsim_dense(q, qm, d, dm)
            mf.maxsim_pairs(q, qm, d, dm, ids)
    assert mf.maxsim_dense.last_plan is before
    assert mf.maxsim_dense.launches == mf.maxsim_pairs.launches == 0
