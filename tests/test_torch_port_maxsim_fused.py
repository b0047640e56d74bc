"""The plain versions of the MaxSim engines' fused kernels
(ops/maxsim_fused.py) and the wrappers around them, on the CPU, against the
JAX package's jitted functions they stand for: M1 `maxsim_dense_plain`
against `maxsim_scores`, M2 `maxsim_pairs_plain` against the scores
`_maxsim_select`'s `refine` returns and a float64 oracle, the tile step's
selection against JAX's with planted ties, and the wrappers' dispatch
(CPU tensors run the plain versions, uncounted; meta tensors stand for
CUDA tensors on a fake library, to hold the refusals).

JAX on the CPU computes every precision in fp32, so "default" and "high"
are held against JAX's fp32 scores of the operands those precisions
multiply (the bf16 roundings; the bf16 hi/lo split along dim), made here
in numpy: their products are exact in fp32, so only the order of the sums
differs. Tolerances: 1e-5 relative (at least 1e-5 absolute; fp32 sums of
up to 32 token maxima of unit-scale dot products), NEG and infinite
positions equal; M2 against the float64 oracle within 1e-4; ids of the
tile step equal."""

import contextlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from neighborhoodwatch_tpu.ops import maxsim as jm
from neighborhoodwatch_tpu.ops import maxsim_kernel as jmk

from neighborhoodwatch_tpu_torch.ops import distance as tdist
from neighborhoodwatch_tpu_torch.ops import maxsim as tm
from neighborhoodwatch_tpu_torch.ops import maxsim_fused as mf
from neighborhoodwatch_tpu_torch.utils import cuda_build

TOL = 1e-5
NEG = float(np.float32(mf.NEG))
WRAPPERS = ("maxsim_dense", "maxsim_pairs")


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


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _bf16(x):
    """Round to nearest even into bf16, in fp32 (NaN and inf kept)."""
    x = np.asarray(x, dtype=np.float32)
    u = x.view(np.uint32).astype(np.uint64)
    r = ((u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000).astype(np.uint32)
    return np.where(np.isnan(x), x, r.view(np.float32))


def _operands(q, d, precision):
    """The fp32 operands whose fp32 products are the products at
    `precision`, made in numpy."""
    if precision == "highest":
        return q, d
    qh, dh = _bf16(q), _bf16(d)
    if precision == "default":
        return qh, dh
    with np.errstate(invalid="ignore"):
        ql, dl = _bf16(q - qh), _bf16(d - dh)
    return (np.concatenate([qh, qh, ql], axis=-1),
            np.concatenate([dh, dl, dh], axis=-1))


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


# (Q, Tq, D, Td, dim): odd everything, ColBERT's widths, one-token passages
DENSE_SHAPES = [(7, 13, 40, 7, 9), (5, 32, 30, 16, 128), (8, 1, 12, 1, 5)]


@pytest.mark.parametrize("precision", ["default", "high", "highest"])
@pytest.mark.parametrize("shape", DENSE_SHAPES)
def test_dense_plain_matches_jax(precision, shape):
    q, qm, d, dm = _corpus(sum(shape), *shape)
    qo, do = _operands(q, d, precision)
    want = np.asarray(jm.maxsim_scores(qo, qm, do, dm, precision="highest"))
    got = mf.maxsim_dense_plain(*_t(q, qm, d, dm), precision=precision)
    assert got.shape == (shape[0], shape[2]) and got.dtype == torch.float32
    _assert_scores(got.numpy(), want)
    assert not np.isnan(got.numpy()).any()
    others = [r for r in range(shape[0]) if r != 1]
    assert (got.numpy()[others, 3] == NEG).all()     # the NaN doc loses
    assert (got.numpy()[1] == 0).all()               # the all-masked query
    # maxsim_scores is the wrapper, so the plain version on the CPU
    assert torch.equal(tm.maxsim_scores(*_t(q, qm, d, dm), precision),
                       got)


@pytest.mark.parametrize("precision", ["default", "high", "highest"])
def test_operands_multiply_as_products(precision):
    """The kernel's fp32 operands: their fp32 product is products()'s on
    the CPU bit for bit, and equal to the numpy operands."""
    q, _, d, _ = _corpus(3, 4, 6, 9, 5, 24, garbage=False)
    tq, td = _t(q, d)
    qo, do = mf.maxsim_operands(tq, td, precision)
    assert qo.dtype == do.dtype == torch.float32
    dim = 3 * 24 if precision == "high" else 24
    assert qo.shape == (4, 6, dim) and do.shape == (9, 5, dim)
    want = tdist.products(tq.reshape(-1, 24), td.reshape(-1, 24), precision)
    assert torch.equal(qo.reshape(-1, dim) @ do.reshape(-1, dim).T, want)
    nq, nd = _operands(q, d, precision)
    np.testing.assert_array_equal(qo.numpy(), nq)
    np.testing.assert_array_equal(do.numpy(), nd)


def _pairs_oracle(q, qm, d, dm, ids):
    """float64 MaxSim of each query against docs[ids]: NaN where a
    selected product is NaN, NaN for an id outside the docs."""
    out = np.full(ids.shape, np.nan)
    for b in range(ids.shape[0]):
        for j, e in enumerate(ids[b]):
            if not 0 <= e < len(d):
                continue
            with np.errstate(invalid="ignore"):
                sims = q[b].astype(np.float64) @ d[e].astype(np.float64).T
            sims = np.where(dm[e][None, :], sims, -1e30)
            tok = np.where(np.isnan(sims).any(1), np.nan, sims.max(1))
            out[b, j] = np.where(qm[b], tok, 0.0).sum()
    return out


@pytest.mark.parametrize("block", [None, 1, 3, 64])
@pytest.mark.parametrize("shape", [(6, 13, 40, 7, 9), (5, 32, 30, 16, 32)])
def test_pairs_plain_matches_oracle(block, shape):
    """NaN passes through, an id outside [0, N) gives NaN, repeated
    candidates score alike; any block gives the same scores."""
    B, Tq, N, Td, dim = shape
    q, qm, d, dm = _corpus(sum(shape), B, Tq, N, Td, dim)
    rng = np.random.default_rng(B)
    ids = rng.integers(0, N, size=(B, 11))
    ids[0, :3] = [-1, N, N + 7]
    ids[2, :4] = [3, 5, 2, 3]
    got = mf.maxsim_pairs_plain(*_t(q, qm, d, dm, ids), block=block)
    want = _pairs_oracle(q, qm, d, dm, ids)
    assert got.shape == ids.shape and got.dtype == torch.float32
    got = got.numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[0, :3]).all() and np.isnan(got[2, [0, 3]]).all()
    fin = np.isfinite(want)
    assert np.all(np.abs(got[fin] - want[fin])
                  <= 1e-4 * np.maximum(np.abs(want[fin]), 1.0))
    assert (got[1] == 0).all()                       # the all-masked query
    # int32 ids and the wrapper on CPU tensors: the same scores
    np.testing.assert_array_equal(
        mf.maxsim_pairs(*_t(q, qm, d, dm, ids.astype(np.int32)),
                        block=block).numpy(), got)


@pytest.mark.parametrize("tier", ["high", "default"])
def test_pairs_plain_matches_jax_refine(tier):
    """The screened select's re-rank: JAX `_maxsim_select` returns the
    scores its `refine` computed for the docs it returns; the plain
    version scores the same docs alike, and the port's select returns the
    same docs and scores on JAX's candidates."""
    q, qm, d, dm = _corpus(17, 6, 12, 300, 8, 32, garbage=False)
    k = 7
    jn, jd, _, jst = jmk.screen_maxsim(q, qm, d, dm, screen_precision=tier)
    passes = {"high": 3, "default": 1}[tier]
    m, block, _ = jm.maxsim_screen_plan(300, k, 8, 32, passes)
    js, jdoc, _ = jm._maxsim_select(
        jnp.asarray(q), jnp.asarray(qm), jnp.asarray(d), jnp.asarray(dm),
        jn, jd, k, m, block=block, passes=passes, doc_stats=jst)
    js, jdoc = np.asarray(js), np.asarray(jdoc)
    got = mf.maxsim_pairs_plain(*_t(q, qm, d, dm, jdoc))
    _assert_scores(got.numpy(), js)
    ts, tdoc, _ = tm._maxsim_select(
        *_t(q, qm, d, dm, np.asarray(jn), np.asarray(jd)), k, m,
        block=block, passes=passes, doc_stats=torch.from_numpy(
            np.asarray(jst)))
    np.testing.assert_array_equal(tdoc.numpy(), jdoc)
    _assert_scores(ts.numpy(), js)


def test_tile_step_ties_take_jax_ids():
    """Every doc of a tile tied (and a duplicate pair across tiles): the
    tile step's per-tile top-k and its running merge return JAX's ids,
    lowest position first, the running list's ids on ties."""
    q, qm, d, dm = _corpus(23, 3, 5, 70, 4, 8, garbage=False)
    d[10:40] = d[10]
    dm[10:40] = dm[10]
    d[50] = d[3]
    dm[50] = dm[3]
    for tile in (16, 32, 70):
        js, ji = jm.maxsim_topk(q, qm, d, dm, 12, tile_docs=tile)
        ts, ti = tm.maxsim_topk(q, qm, d, dm, 12, tile_docs=tile,
                                device="cpu")
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        _assert_scores(ts.numpy(), np.asarray(js))
    # all tied: positions 0 .. k-1
    d[:] = d[0]
    dm[:] = dm[0]
    ts, ti = tm.maxsim_topk(q, qm, d, dm, 9, tile_docs=16, device="cpu")
    assert ti.tolist() == [list(range(9))] * 3
    run_s = torch.full((3, 9), -float("inf"))
    run_i = torch.zeros((3, 9), dtype=torch.int32)
    s, i = tm._maxsim_tile_step(run_s, run_i, *_t(q, qm, d[:16], dm[:16]),
                                0, 70, 9)
    assert i.dtype == torch.int32 and i.tolist() == [list(range(9))] * 3
    s2, i2 = tm._maxsim_tile_step(s, i, *_t(q, qm, d[16:32], dm[16:32]),
                                  16, 70, 9)
    assert torch.equal(i2, i) and torch.equal(s2, s)


def _calls(device="cpu", dtype=torch.float32, ids_dtype=torch.int64):
    """One call of each wrapper on tensors of `device`."""
    q = torch.zeros((3, 5, 8), dtype=dtype, device=device)
    qm = torch.ones((3, 5), dtype=torch.bool, device=device)
    d = torch.zeros((10, 4, 8), dtype=dtype, device=device)
    dm = torch.ones((10, 4), dtype=torch.bool, device=device)
    ids = torch.zeros((3, 6), dtype=ids_dtype, device=device)
    return {"maxsim_dense": lambda **kw: mf.maxsim_dense(q, qm, d, dm, **kw),
            "maxsim_pairs": lambda: mf.maxsim_pairs(q, qm, d, dm, ids)}


def test_cpu_tensors_run_the_plain_versions_uncounted(monkeypatch):
    def no_build(name):
        raise AssertionError(f"loaded {name} for CPU tensors")
    monkeypatch.setattr(cuda_build, "load", no_build)
    mf.reset_launches()
    calls = _calls()
    assert calls["maxsim_dense"]().shape == (3, 10)
    assert calls["maxsim_pairs"]().shape == (3, 6)
    q, qm, d, dm = _corpus(2, 6, 8, 300, 8, 16)
    tm.maxsim_topk(q, qm, d, dm, 5, device="cpu")
    tm.maxsim_topk(q, qm, d, dm, 5, engine="screened", device="cpu")
    assert mf.maxsim_dense.launches == mf.maxsim_pairs.launches == 0


class _FakeLibrary:
    """Stands for a built library: its launch returns `err`."""

    def __init__(self, err=0):
        self.err, self.calls = err, []

    def launcher(self, name):
        def launch(*args):
            self.calls.append((name, args))
            return self.err
        return launch


@pytest.fixture()
def card(monkeypatch):
    """Meta tensors take the kernels' path, on a fake library; the plain
    versions raise if called. Returns the library."""
    lib = _FakeLibrary()
    monkeypatch.setattr(mf, "_ON_CARD", ("cuda", "meta"))
    monkeypatch.setattr(mf, "_launcher", lib.launcher)
    monkeypatch.setattr(mf, "_stream", lambda dev: 7)
    monkeypatch.setattr(mf, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    for name in WRAPPERS:
        def plain(*a, name=name, **kw):
            raise AssertionError(f"{name} ran its plain version on the card")
        monkeypatch.setattr(mf, f"{name}_plain", plain)
    mf.reset_launches()
    return lib


@pytest.mark.parametrize("precision,dim", [("highest", 8), ("default", 8),
                                           ("high", 24)])
def test_card_tensors_launch_dense_and_count(card, precision, dim):
    out = _calls("meta")["maxsim_dense"](precision=precision)
    assert out.device.type == "meta" and out.shape == (3, 10)
    assert [c[0] for c in card.calls] == ["maxsim_dense"]
    args = card.calls[0][1]
    assert len(args) == len(mf._ARGTYPES["maxsim_dense"]["launch"]) and \
        args[-1] == 7
    # Q, Tq, D, Td, dim (3 dim at "high": the split), the 16-byte copies
    assert args[5:11] == (3, 5, 10, 4, dim, 1)
    assert mf.maxsim_dense.launches == 1 and mf.maxsim_pairs.launches == 0


@pytest.mark.parametrize("ids_dtype", [torch.int64, torch.int32])
def test_card_tensors_launch_pairs_and_count(card, ids_dtype):
    out = _calls("meta", ids_dtype=ids_dtype)["maxsim_pairs"]()
    assert out.device.type == "meta" and out.shape == (3, 6)
    assert [c[0] for c in card.calls] == ["maxsim_pairs"]
    args = card.calls[0][1]
    assert len(args) == len(mf._ARGTYPES["maxsim_pairs"]["launch"]) and \
        args[-1] == 7
    # B, Tq, N, Td, dim, M, the 16-byte copies
    assert args[6:13] == (3, 5, 10, 4, 8, 6, 1)
    assert mf.maxsim_pairs.launches == 1 and mf.maxsim_dense.launches == 0


def test_card_tensors_refuse_what_the_kernels_do_not_take(card):
    m = "meta"
    q = torch.zeros((3, 5, 8), device=m)
    qm = torch.ones((3, 5), dtype=torch.bool, device=m)
    d = torch.zeros((10, 4, 8), device=m)
    dm = torch.ones((10, 4), dtype=torch.bool, device=m)
    ids = torch.zeros((3, 6), dtype=torch.long, device=m)
    for name in WRAPPERS:
        with pytest.raises(TypeError):
            _calls(m, dtype=torch.float64)[name]()
    with pytest.raises(TypeError):                  # an int mask
        mf.maxsim_dense(q, qm.int(), d, dm)
    with pytest.raises(TypeError):                  # float ids
        mf.maxsim_pairs(q, qm, d, dm, ids.float())
    with pytest.raises(ValueError):                 # another dim
        mf.maxsim_dense(q, qm, d[:, :, :4], dm)
    with pytest.raises(ValueError):                 # a mask of other tokens
        mf.maxsim_dense(q, qm[:, :4], d, dm)
    with pytest.raises(ValueError):                 # no doc tokens
        mf.maxsim_dense(q, qm, d[:, :0], dm[:, :0])
    with pytest.raises(ValueError):                 # ids of other queries
        mf.maxsim_pairs(q, qm, d, dm, ids[:2])
    with pytest.raises(ValueError):                 # 2-D tokens
        mf.maxsim_pairs(q[:, 0], qm, d, dm, ids)
    with pytest.raises(ValueError):                 # an unknown precision
        mf.maxsim_dense(q, qm, d, dm, precision="medium")
    assert card.calls == []
    assert mf.maxsim_dense.launches == mf.maxsim_pairs.launches == 0


def test_card_tensors_refuse_another_device(card, monkeypatch):
    """Operands on two devices are refused; a device type that takes no
    kernel is refused, never run plain."""
    m = "meta"
    q = torch.zeros((3, 5, 8), device=m)
    qm = torch.ones((3, 5), dtype=torch.bool, device=m)
    d = torch.zeros((10, 4, 8), device=m)
    dm = torch.ones((10, 4), dtype=torch.bool, device=m)
    ids = torch.zeros((3, 6), dtype=torch.long, device=m)
    with pytest.raises(ValueError):
        mf.maxsim_dense(q, qm, d, torch.ones((10, 4), dtype=torch.bool))
    with pytest.raises(ValueError):
        mf.maxsim_pairs(q, qm, torch.zeros((10, 4, 8)), dm, ids)
    with pytest.raises(ValueError):
        mf.maxsim_pairs(q, qm, d, dm, torch.zeros((3, 6), dtype=torch.long))
    monkeypatch.setattr(mf, "_ON_CARD", ("cuda",))
    for name in WRAPPERS:
        with pytest.raises(ValueError, match="unsupported device"):
            _calls(m)[name]()
    assert card.calls == []


@pytest.mark.parametrize("name", WRAPPERS)
def test_a_refused_launch_raises_and_never_falls_back(card, name):
    card.err = 1
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        _calls("meta")[name]()
    assert getattr(mf, name).launches == 0


def test_empty_inputs_launch_nothing(card):
    m = "meta"
    q = torch.zeros((0, 5, 8), device=m)
    qm = torch.ones((0, 5), dtype=torch.bool, device=m)
    d = torch.zeros((10, 4, 8), device=m)
    dm = torch.ones((10, 4), dtype=torch.bool, device=m)
    assert mf.maxsim_dense(q, qm, d, dm).shape == (0, 10)
    ids = torch.zeros((0, 6), dtype=torch.long, device=m)
    assert mf.maxsim_pairs(q, qm, d, dm, ids).shape == (0, 6)
    assert card.calls == []
    assert mf.maxsim_dense.launches == mf.maxsim_pairs.launches == 0


def test_gather_block_is_the_repairs_old_bound():
    """The plain version's default block: the class-A repair's bound on
    its (rows, w, td, dim) gather, as it was in the select."""
    for w, td, dim in ((512, 16, 128), (512, 64, 128), (256, 180, 256),
                       (1, 1, 1), (512, 1024, 1024)):
        blk = min(128, max(8, (1 << 28) // max(1, w * td * dim * 4)))
        assert mf.gather_block(w, td, dim) == 1 << (blk.bit_length() - 1)
    assert mf.gather_block(512, 16, 128) == 64
