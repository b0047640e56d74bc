"""PyTorch port of the MaxSim screen and engine vs the JAX reference and a
float64 oracle, on the CPU: the JAX screen kernel runs in interpret mode,
the port runs the kernel's plain PyTorch version.

Tolerances:
- screen candidates: empty slots equal; decoded scores within
  (PACK_EPS_REL + 4 maxsim_acc_rel(dim)) x (sum_t ||q_t|| x max ||d_s||)
  (fp32 sums in another order plus one key quantum), ids different only
  between docs whose scores are that close (maxsim_kernel.candidates_agree);
- certificate statistics within 2e-6 relative (fp32 norms summed in
  another order);
- engine scores within 1e-3 abs, as tests/test_maxsim.py uses (fp32 sums of
  up to 32 token maxima of O(10) each); ids tie-tolerant against the
  float64 oracle with that tolerance;
- certificate, repair and tier decisions: exactly equal."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from neighborhoodwatch_tpu.ops import maxsim as jm
from neighborhoodwatch_tpu.ops import maxsim_kernel as jmk

from neighborhoodwatch_tpu_torch.ops import maxsim as tm
from neighborhoodwatch_tpu_torch.ops import maxsim_kernel as tmk

from tests.torch_port_util import (
    assert_ids_tie_tolerant, maxsim_oracle_wide,
)

SCORE_TOL = 1e-3


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _corpus(seed, Q, Tq, D, Td, dim, garbage=False):
    """Ragged masks, a single-token query, an empty doc and (with
    `garbage`) one NaN and one inf doc."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((Q, Tq, dim)).astype(np.float32)
    d = rng.standard_normal((D, Td, dim)).astype(np.float32)
    qm = rng.random((Q, Tq)) < 0.8
    qm[:, 0] = True
    qm[0, 1:] = False
    dm = rng.random((D, Td)) < 0.7
    dm[:, 0] = True
    dm[5] = False
    if garbage:
        d[9, 1] = np.nan
        dm[9, 1] = True
        d[11, 0, ::2] = np.inf
        d[11, 0, 1::2] = -np.inf
    return q, qm, d, dm


def _oracle_sorted(q, qm, d, dm, k):
    return maxsim_oracle_wide(q, qm, d, dm, k)[2]


# (Tq, Td, dim, D, passes-tier, garbage, pipelined)
SCREEN_CASES = (
    [(7, 12, 32, 300, tier, True, None)
     for tier in ("default", "medium", "high")]
    # Td=24: the doc-block regression of tests/test_maxsim.py (db must stay
    # a divisor of the mega)
    + [(12, 24, 32, 300, tier, False, None)
       for tier in ("default", "medium", "high")]
    # Td=40: two 32-token chunks with a running max on the JAX side
    + [(5, 40, 32, 300, tier, True, None)
       for tier in ("default", "medium", "high")]
    + [(8, 12, 256, 200, "high", False, None),
       (32, 16, 128, 150, "medium", False, None),
       # two mega-tiles, D not a multiple of 8192
       (6, 8, 16, 8192 + 300, "medium", True, None),
       # K5, the pipelined TPU schedule: the same keys
       (7, 12, 32, 300, "high", True, True)])


@pytest.mark.parametrize("Tq,Td,dim,D,tier,garbage,pipelined", SCREEN_CASES)
def test_screen_maxsim_matches_jax(Tq, Td, dim, D, tier, garbage, pipelined):
    q, qm, d, dm = _corpus(3, 5, Tq, D, Td, dim, garbage)
    jn, jd, j_mega, j_stats = jmk.screen_maxsim(
        q, qm, d, dm, screen_precision=tier, pipelined=pipelined,
        want_dlo_stat=True)
    tq_, tqm, td_, tdm = _t(q, qm, d, dm)
    tn, tdoc, t_mega, t_stats = tmk.screen_maxsim(
        tq_, tqm, td_, tdm, screen_precision=tier, pipelined=pipelined,
        want_dlo_stat=True)
    assert t_mega == j_mega
    assert tn.shape == tuple(jn.shape) and tdoc.dtype == torch.int32
    err, swapped = tmk.candidates_agree(
        (tn, tdoc), tuple(_t(np.asarray(jn), np.asarray(jd))),
        tq_, tqm, td_, tdm)
    # docs past the corpus decode past D on both sides, never below 0
    assert int(tdoc.min()) >= 0
    np.testing.assert_allclose(t_stats.numpy(), np.asarray(j_stats),
                               rtol=2e-6, equal_nan=True)


def test_screen_maxsim_ids_equal_where_scores_are_separated():
    """Well-separated scores (one direction, distinct magnitudes): the two
    screens must list the same doc in every slot."""
    q, qm, d, dm = _collision_corpus(np.random.default_rng(5), 16, 640, 0, 0)
    jn, jd, _, _ = jmk.screen_maxsim(q, qm, d, dm, screen_precision="high")
    tn, tdoc, _, _ = tmk.screen_maxsim(*_t(q, qm, d, dm),
                                       screen_precision="high")
    real = np.asarray(jn) < 1e29
    np.testing.assert_array_equal(tdoc.numpy()[real], np.asarray(jd)[real])
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, qm, d, dm = _t(*_corpus(1, 2, 4, 20, 4, 32))
    ops = tmk.prepare_operands(q, qm, d, dm, 3)
    with pytest.raises(TypeError):
        tmk.maxsim_keys(ops[0].float(), *ops[1:5], 3)
    with pytest.raises(ValueError, match="query tokens"):
        tmk.maxsim_keys(torch.zeros((2, 33, 32), dtype=torch.bfloat16),
                        *ops[1:5], 1)
    with pytest.raises(ValueError, match="contiguous"):
        tmk.maxsim_keys(ops[0], ops[1],
                        ops[2].transpose(0, 1).contiguous().transpose(0, 1),
                        ops[3], ops[4], 3)
    with pytest.raises(AssertionError, match="32 query tokens"):
        tmk.screen_maxsim(torch.zeros((1, 40, 32)),
                          torch.ones((1, 40), dtype=torch.bool), d, dm)
    with pytest.raises(AssertionError, match="multiple of 128"):
        tmk.screen_maxsim(torch.zeros((1, 4, 192)), qm[:1],
                          torch.zeros((20, 4, 192)), dm)


def test_constants_and_error_models_match_jax():
    assert tmk.MEGA_DOCS == jmk.MEGA_DOCS and tmk.NEG_BIAS == jmk.NEG_BIAS
    assert tmk.CAND_PER_MEGA == jmk.CAND_PER_MEGA
    assert tm.MAXSIM_TIER_LADDER == jm.MAXSIM_TIER_LADDER and tm.NEG == jm.NEG
    for dim in (16, 32, 128, 256, 1024, 4096):
        assert tmk.maxsim_acc_rel(dim) == jmk.maxsim_acc_rel(dim)
        assert tmk.maxsim_eps3_rel(dim) == jmk.maxsim_eps3_rel(dim)
    for tier in ("auto", "high", "medium", "default"):
        assert tm.resolve_maxsim_tier(tier) == jm.resolve_maxsim_tier(tier)


def test_plans_match_jax():
    for n_docs in (100, 4096, 8192, 8193, 50_000, 200_000):
        assert tm.maxsim_bin_cap(n_docs) == jm.maxsim_bin_cap(n_docs)
        for k in (1, 10, 100, 400, 3000):
            for td in (8, 16, 64, 180, 2048):
                for dim in (32, 128, 1024):
                    for passes in (1, 2, 3):
                        assert (tm.maxsim_screen_plan(n_docs, k, td, dim,
                                                      passes)
                                == jm.maxsim_screen_plan(n_docs, k, td, dim,
                                                         passes))


def test_engine_choice(monkeypatch):
    """Typos raise on both sides; "auto" is the exact engine on the CPU
    and the screened one for CUDA tensors of >= 4096 docs that the kernel
    takes (the JAX gate, TPU-only, is held to the same table with its
    backend patched)."""
    import jax
    with pytest.raises(ValueError, match="unknown engine"):
        tm._maxsim_engine("screend", 10_000, 8, 128, "cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        jm._maxsim_engine("screend", 10_000, 8, 128)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    for n_docs in (100, 4095, 4096, 10_000):
        for tq in (8, 32, 40):
            for dim in (64, 128, 192, 256):
                want = jm._maxsim_engine("auto", n_docs, tq, dim)
                assert tm._maxsim_engine("auto", n_docs, tq, dim,
                                         "cuda") == want
                assert tm._maxsim_engine("auto", n_docs, tq, dim,
                                         "cpu") == "exact"
                for fixed in ("exact", "screened"):
                    assert tm._maxsim_engine(fixed, n_docs, tq, dim,
                                             "cpu") == fixed


def test_tier_controller_follows_jax_ladder():
    """Same diagnostics sequence -> same downshifts and re-escalations."""
    rng = np.random.default_rng(11)
    jc, tc = jm.MaxSimTierController(), tm.MaxSimTierController()
    seq = ([(0, 0, 900)] * 3 + [(0, 0, 0)] * 3 + [(400, 0, 0)]
           + [(0, 5, 5)] * 5 + [(700, 0, 0)] + [(0, 0, 0)] * 9
           + [(int(a), int(b), int(c))
              for a, b, c in rng.integers(0, 600, (40, 3))])
    levels = set()
    for diag in seq:
        level = tc.tier_idx
        jc.observe(np.array(diag), level, 1000)
        tc.observe(np.array(diag), level, 1000)
        assert tc.tier_idx == jc.tier_idx and tc.tier_arg == jc.tier_arg
        levels.add(tc.tier_idx)
    assert levels == {0, 1, 2}
    # diagnostics taken at another level only reset the streak
    jc.observe(np.array((0, 0, 0)), (jc.tier_idx + 1) % 3, 1000)
    tc.observe(np.array((0, 0, 0)), (tc.tier_idx + 1) % 3, 1000)
    assert tc.tier_idx == jc.tier_idx and tc._streak == jc._streak == 0


def test_maxsim_scores_and_pad_token_lists_match_jax():
    q, qm, d, dm = _corpus(21, 4, 6, 70, 9, 24, garbage=True)
    want = np.asarray(jm.maxsim_scores(q, qm, d, dm))
    got = tm.maxsim_scores(*_t(q, qm, d, dm)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert (got[:, [9, 11]] <= -1e29).all()       # garbage docs lose
    for a, b in zip(tm.maxsim_oracle(q, qm, d[:9], dm[:9], 4),
                    jm.maxsim_oracle(q, qm, d[:9], dm[:9], 4)):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(2)
    lists = [rng.standard_normal((n, 8)).astype(np.float32)
             for n in (3, 0, 11, 8)]
    for max_tokens in (None, 16, 4):
        for a, b in zip(tm.pad_token_lists(lists, 8, max_tokens),
                        jm.pad_token_lists(lists, 8, max_tokens)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("tile_docs", [16, 64, 1000])
def test_exact_engine_matches_jax_and_oracle(tile_docs):
    q, qm, d, dm = _corpus(31, 6, 9, 150, 7, 16, garbage=True)
    k = 8
    js, ji = jm.maxsim_topk(q, qm, d, dm, k, tile_docs=tile_docs)
    ts, ti = tm.maxsim_topk(q, qm, d, dm, k, tile_docs=tile_docs,
                            device="cpu")
    assert ti.dtype == torch.int32
    finite = [i for i in range(150) if i not in (9, 11)]
    os_, oi, ow = maxsim_oracle_wide(q, qm, d[finite], dm[finite], k)
    assert_ids_tie_tolerant(ti.numpy(), np.asarray(ji), ow, SCORE_TOL)
    assert_ids_tie_tolerant(ti.numpy(), np.asarray(finite)[oi], ow,
                            SCORE_TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=SCORE_TOL)
    np.testing.assert_allclose(ts.numpy(), os_, atol=SCORE_TOL)


@pytest.mark.parametrize("tier", ["high", "medium", "default"])
@pytest.mark.parametrize("shape", [(8, 300, 12, 32), (5, 200, 40, 16)])
def test_screened_engine_matches_jax_and_oracle(tier, shape):
    """Every tier: ids equal to the JAX screened engine and the oracle,
    the diagnostics triple equal."""
    Tq, D, Td, dim = shape
    q, qm, d, dm = _corpus(41, 7, Tq, D, Td, dim)
    k = 9
    js, ji, jdiag = jm.maxsim_topk_screened(q, qm, d, dm, k,
                                            screen_precision=tier,
                                            with_diagnostics=True)
    ts, ti, tdiag = tm.maxsim_topk_screened(q, qm, d, dm, k,
                                            screen_precision=tier,
                                            with_diagnostics=True,
                                            device="cpu")
    np.testing.assert_array_equal(tdiag, np.asarray(jdiag))
    os_, oi, ow = maxsim_oracle_wide(q, qm, d, dm, k)
    assert_ids_tie_tolerant(ti.numpy(), np.asarray(ji), ow, SCORE_TOL)
    assert_ids_tie_tolerant(ti.numpy(), oi, ow, SCORE_TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=SCORE_TOL)
    np.testing.assert_allclose(ts.numpy(), os_, atol=SCORE_TOL)
    # engine="screened" through maxsim_topk on CPU tensors: the plain
    # version, same result
    ts2, ti2 = tm.maxsim_topk(q, qm, d, dm, k, engine="screened",
                              screen_precision=tier, device="cpu")
    np.testing.assert_array_equal(ti2.numpy(), ti.numpy())


def test_screened_engine_falls_back_when_plan_says_no():
    """k above the bin capacity: both sides take the exact engine and the
    diagnostics are None."""
    q, qm, d, dm = _corpus(43, 3, 4, 500, 4, 16)
    k = 400                                         # cap is 384
    assert not jm.maxsim_screen_plan(500, k, 4, 16)[2]
    js, ji, jdiag = jm.maxsim_topk_screened(q, qm, d, dm, k,
                                            with_diagnostics=True)
    ts, ti, tdiag = tm.maxsim_topk_screened(q, qm, d, dm, k,
                                            with_diagnostics=True,
                                            device="cpu")
    assert jdiag is None and tdiag is None
    assert_ids_tie_tolerant(ti.numpy(), np.asarray(ji),
                            _oracle_sorted(q, qm, d, dm, k), SCORE_TOL)


def _collision_corpus(rng, dim, n_docs, lane, n_plant, plant_top=10.0,
                      plant_gap=0.2):
    """tests/test_maxsim.py's corpus whose only certifiable defect is a bin
    collision: every doc's tokens point along one unit vector with a
    distinct magnitude, and the n_plant strongest docs all sit in lane bin
    `lane` (stride 128)."""
    v = np.zeros(dim, np.float32)
    v[0] = 1.0
    mags = 1.0 + 0.005 * np.arange(n_docs, dtype=np.float32)
    for j in range(n_plant):
        mags[j * 128 + lane] = plant_top - plant_gap * j
    d = np.tile(v, (n_docs, 8, 1)) * mags[:, None, None]
    dm = np.ones((n_docs, 8), bool)
    q = (v[None, None, :]
         + 0.05 * rng.standard_normal((2, 4, dim))).astype(np.float32)
    qm = np.ones((2, 4), bool)
    return q, qm, d.astype(np.float32), dm


def _no_fallback(*a, **kw):
    raise AssertionError("the exact fallback ran: the class-A repair "
                         "should have certified this batch")


@pytest.mark.parametrize("n_docs,lane,n_plant,k",
                         [(640, 0, 5, 6),      # > KEEP-1 collide in one bin
                          (768, 3, 6, 8)])     # kept clones re-scored: dedup
def test_class_a_repair_decisions_match_jax(monkeypatch, n_docs, lane,
                                            n_plant, k):
    """One-bin collisions with an intact count certificate are repaired by
    the select itself, on both sides: the exact fallback must not run, no
    neighbour appears twice, and the select's ok / prediction outputs are
    equal."""
    q, qm, d, dm = _collision_corpus(np.random.default_rng(778), 16, n_docs,
                                     lane, n_plant)
    monkeypatch.setattr(jm, "maxsim_topk", _no_fallback)
    monkeypatch.setattr(tm, "_exact_topk", _no_fallback)
    before = tm.counts.repaired
    js, ji, jdiag = jm.maxsim_topk_screened(q, qm, d, dm, k,
                                            with_diagnostics=True)
    ts, ti, tdiag = tm.maxsim_topk_screened(q, qm, d, dm, k,
                                            with_diagnostics=True,
                                            device="cpu")
    assert tm.counts.repaired == before + 2   # both queries
    np.testing.assert_array_equal(tdiag, np.asarray(jdiag))
    os_, oi = jm.maxsim_oracle(q, qm, d, dm, k)
    np.testing.assert_array_equal(ti.numpy(), oi)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    for r in range(2):
        assert len(set(ti.numpy()[r].tolist())) == k
    np.testing.assert_allclose(ts.numpy(), os_, rtol=1e-5, atol=1e-4)

    # the select's own outputs, on each side's candidates
    jn, jd, _, jst = jmk.screen_maxsim(q, qm, d, dm, screen_precision="high",
                                       want_dlo_stat=True)
    m, block, _ = jm.maxsim_screen_plan(n_docs, k, 8, 16, 3)
    _, _, jok, jpred = jm._maxsim_select(
        jnp.asarray(q), jnp.asarray(qm), jnp.asarray(d), jnp.asarray(dm),
        jn, jd, k, m, block=block, passes=3, doc_stats=jst,
        with_diagnostics=True)
    tq_, tqm, td_, tdm = _t(q, qm, d, dm)
    tn, tdoc, _, tst = tmk.screen_maxsim(tq_, tqm, td_, tdm,
                                         screen_precision="high",
                                         want_dlo_stat=True)
    _, _, tok, tpred = tm._maxsim_select(tq_, tqm, td_, tdm, tn, tdoc, k, m,
                                         block=block, passes=3,
                                         doc_stats=tst,
                                         with_diagnostics=True)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(tpred.numpy(), np.asarray(jpred))
    assert tok.all()


def test_unrepairable_collisions_reach_the_exact_engine():
    """Collisions in more than REPAIR_BINS bins of one query cannot be
    repaired from the bins: both sides report the same failures and both
    return the oracle's neighbours through the exact fallback."""
    rng = np.random.default_rng(780)
    q, qm, d, dm = _collision_corpus(rng, 16, 768, 0, 0)
    mags = 1.0 + 0.005 * np.arange(768, dtype=np.float32)
    top = 10.0
    for lane in (0, 1, 2):                     # 3 bins x 5 planted docs
        for j in range(5):
            mags[j * 128 + lane] = top
            top -= 0.2
    d = (d / np.abs(d).max(axis=(1, 2), keepdims=True)
         * mags[:, None, None]).astype(np.float32)
    k = 15
    js, ji, jdiag = jm.maxsim_topk_screened(q, qm, d, dm, k,
                                            with_diagnostics=True)
    before = tm.counts.exact_fallbacks
    ts, ti, tdiag = tm.maxsim_topk_screened(q, qm, d, dm, k,
                                            with_diagnostics=True,
                                            device="cpu")
    np.testing.assert_array_equal(tdiag, np.asarray(jdiag))
    assert tdiag[0] == 2
    assert tm.counts.exact_fallbacks == before + 2
    os_, oi = jm.maxsim_oracle(q, qm, d, dm, k)
    np.testing.assert_array_equal(ti.numpy(), oi)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_subhigh_failures_escalate_to_the_3_pass_screen(monkeypatch):
    """A failed sub-high certificate escalates its queries to the 3-pass
    screen, and only a failed 3-pass certificate reaches the exact
    engine: same route on both sides."""
    rng = np.random.default_rng(77)
    dim, k = 32, 5
    q, qm = jm.pad_token_lists(
        [rng.standard_normal((6, dim)).astype(np.float32)
         for _ in range(9)], dim)
    d, dm = jm.pad_token_lists(
        [rng.standard_normal((8, dim)).astype(np.float32)
         for _ in range(300)], dim)
    routes = {}
    for name, mod, fallback in (("jax", jm, "maxsim_topk"),
                                ("torch", tm, "_exact_topk")):
        tiers, real_select = [], mod._maxsim_select

        def spy_select(*a, _tiers=tiers, _real=real_select, **kw):
            _tiers.append(kw.get("passes", 3))
            s, doc_k, ok = _real(*a, **kw)
            if len(_tiers) == 1:        # force the sub-high cert to fail
                ok = ok & False
            return s, doc_k, ok

        monkeypatch.setattr(mod, "_maxsim_select", spy_select)
        monkeypatch.setattr(mod, fallback, _no_fallback)
        routes[name] = tiers
    js, ji = jm.maxsim_topk_screened(q, qm, d, dm, k,
                                     screen_precision="default")
    before = tm.counts.escalated
    ts, ti = tm.maxsim_topk_screened(q, qm, d, dm, k,
                                     screen_precision="default",
                                     device="cpu")
    assert routes["torch"] == routes["jax"] == [1, 3]
    assert tm.counts.escalated == before + 9
    os_, oi, ow = maxsim_oracle_wide(q, qm, d, dm, k)
    assert_ids_tie_tolerant(ti.numpy(), oi, ow, SCORE_TOL)
    assert_ids_tie_tolerant(ti.numpy(), np.asarray(ji), ow, SCORE_TOL)
    np.testing.assert_allclose(ts.numpy(), os_, atol=SCORE_TOL)


@pytest.mark.parametrize("tier", ["auto", "high", "default"])
def test_streaming_matches_jax(tier):
    """StreamingMaxSim with the screened engine over three tiles, the last
    with padding rows (n_valid): ids equal to the JAX accumulator and the
    oracle, the adaptive tier decisions too."""
    q, qm, d, dm = _corpus(51, 6, 8, 700, 10, 32)
    k = 12
    ja = jm.StreamingMaxSim(q, qm, k, engine="screened",
                            screen_precision=tier)
    ta = tm.StreamingMaxSim(q, qm, k, engine="screened",
                            screen_precision=tier, device="cpu")
    for off, n in ((0, 300), (300, 300)):
        ja.update(d[off:off + n], dm[off:off + n])
        ta.update(d[off:off + n], dm[off:off + n], offset=off)
    # last tile: 100 real docs + 28 padding rows whose mask says "valid"
    pad_d = np.concatenate([d[600:], np.ones((28, 10, 32), np.float32)])
    pad_m = np.concatenate([dm[600:], np.ones((28, 10), bool)])
    ja.update(pad_d, pad_m, n_valid=100)
    ta.update(pad_d, pad_m, n_valid=100)
    assert ta.docs_seen == ja.docs_seen == 700
    assert ta._tier_idx == ja._tier_idx
    js, ji = ja.finalize()
    ts, ti = ta.finalize()
    os_, oi, ow = maxsim_oracle_wide(q, qm, d, dm, k)
    assert_ids_tie_tolerant(ti, ji, ow, SCORE_TOL)
    assert_ids_tie_tolerant(ti, oi, ow, SCORE_TOL)
    np.testing.assert_allclose(ts, js, atol=SCORE_TOL)


def test_streaming_exact_path_and_checkpoint_cross_packages():
    """"auto" on the CPU streams through the exact engine; a state taken
    from one package's accumulator restores into the other's, and both
    finish equal to the oracle."""
    q, qm, d, dm = _corpus(61, 5, 6, 90, 7, 16, garbage=True)
    k = 7
    ja = jm.StreamingMaxSim(q, qm, k)
    ta = tm.StreamingMaxSim(q, qm, k, device="cpu")
    ja.update(d[:40], dm[:40], 0)
    ta.update(d[:40], dm[:40], 0)
    js, ji, jseen = ja.state_arrays()
    ts, ti, tseen = ta.state_arrays()
    assert jseen == tseen == 40 and ti.dtype == np.int32
    np.testing.assert_array_equal(ti, ji)
    # hand each side the other's checkpoint
    ja2 = jm.StreamingMaxSim(q, qm, k)
    ta2 = tm.StreamingMaxSim(q, qm, k, device="cpu")
    ja2.restore(ts, ti, tseen)
    ta2.restore(js, ji, jseen)
    for acc in (ja2, ta2):
        acc.update(d[40:], dm[40:], 40)
    finite = [i for i in range(90) if i not in (9, 11)]
    os_, oi, ow = maxsim_oracle_wide(q, qm, d[finite], dm[finite], k)
    want = np.asarray(finite)[oi]
    for acc in (ja2, ta2):
        s, i = acc.finalize()
        assert_ids_tie_tolerant(i, want, ow, SCORE_TOL)
        np.testing.assert_allclose(s, os_, atol=SCORE_TOL)
    with pytest.raises(AssertionError, match="saw only 3"):
        short = tm.StreamingMaxSim(q, qm, k, device="cpu")
        short.update(d[:3], dm[:3])
        short.finalize()
    with pytest.raises(ValueError, match="unknown engine"):
        tm.StreamingMaxSim(q, qm, k, engine="Exact",
                           device="cpu").update(d, dm)


@pytest.mark.parametrize("dim,passes,variant", [
    (128, 1, "wgmma"), (128, 2, "wgmma"), (128, 3, "wgmma"),
    (64, 3, "wgmma"),
    (50, 3, "wgmma"),      # prepare_operands pads 50 to 64
    (32, 3, "mma"),        # half a 64-column chunk
    (96, 2, "mma"), (256, 3, "mma"),
])
def test_variant_is_chosen_by_shape_alone(dim, passes, variant):
    """The kernel variant follows the padded token dim that
    prepare_operands gives the kernel, and nothing else."""
    q, qm, d, dm = _t(*_corpus(3, 2, 4, 6, 3, dim))
    dimp = tmk.prepare_operands(q, qm, d, dm, passes)[0].shape[2]
    assert tmk.pick_variant(dimp) == variant


def test_doc_position_in_its_lane_bin():
    """What both kernel variants rely on: a 128-doc step gives every lane
    bin (mega, d % 128) exactly one doc, at position (d % 8192) // 128.
    A doc planted as the best match of a query in the second mega comes
    back in slab 0 of its bin with that position, and decodes to itself."""
    q, qm, d, dm = _corpus(5, 3, 4, tmk.MEGA_DOCS + 900, 3, 16)
    qm[:], dm[:] = True, True
    doc = tmk.MEGA_DOCS + 5 * 128 + 93
    d[doc] = 4 * q[1, :3]
    ops = tmk.prepare_operands(*_t(q, qm, d, dm), 3)
    keys = tmk.maxsim_keys(*ops[:5], 3)
    col = tmk.CAND_PER_MEGA + 93
    assert int(keys[1, col] & tmk.POS_MASK) == (doc % tmk.MEGA_DOCS) // 128 == 5
    assert int(tmk.decode_keys(keys)[1][1, col]) == doc
    assert set(tmk.maxsim_keys.launches_by_variant) == set(tmk.VARIANTS)
