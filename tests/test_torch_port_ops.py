"""PyTorch port vs the JAX reference: distances, top-k, bf16 rounding,
small utilities, import hygiene and the device rule. Inputs come from a
numpy seed and go through both packages on the CPU."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from neighborhoodwatch_tpu.core import tuner as jtuner
from neighborhoodwatch_tpu.ops import distance as jdist
from neighborhoodwatch_tpu.ops import screen_kernel as jsk
from neighborhoodwatch_tpu.ops import topk as jtopk
from neighborhoodwatch_tpu.utils import misc as jmisc
from neighborhoodwatch_tpu.utils import naming as jnaming

from neighborhoodwatch_tpu_torch.core import tuner as ttuner
from neighborhoodwatch_tpu_torch.ops import distance as tdist
from neighborhoodwatch_tpu_torch.ops import knn as tknn
from neighborhoodwatch_tpu_torch.ops import screen_kernel as tsk
from neighborhoodwatch_tpu_torch.ops import topk as ttopk
from neighborhoodwatch_tpu_torch.utils import misc as tmisc
from neighborhoodwatch_tpu_torch.utils import naming as tnaming

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean", "cosine",
                                    "dot"])
def test_pairwise_distance_matches_jax(metric):
    """All four metrics, with +inf, -inf, NaN and zero base rows: the port
    sets every non-finite distance to +inf like the reference. Distances
    within 1e-5 abs (fp32, different summation order), non-finite
    positions identical."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((9, 40)).astype(np.float32)
    b = rng.standard_normal((70, 40)).astype(np.float32)
    # unit rows keep distances O(1), where 1e-5 is ~100 fp32 ulps
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    b[5] = np.inf
    b[6] = -np.inf
    b[7] = np.nan
    b[8] = 0.0
    want = np.asarray(jdist.pairwise_distance(jnp.asarray(q), jnp.asarray(b),
                                              metric=metric))
    got = tdist.pairwise_distance(_t(q), _t(b), metric).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    assert not np.isnan(got).any()
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=1e-5, rtol=0)


def test_smallest_k_and_merges_match_jax_with_ties():
    """Ties are everywhere in these integer-valued lists: the stable sort
    must reproduce lax.top_k's lowest-position-wins order exactly, and
    indices leave as int32."""
    rng = np.random.default_rng(5)
    d = rng.integers(0, 6, (7, 50)).astype(np.float32)
    jd, ji = jtopk.smallest_k(jnp.asarray(d), 12)
    td, ti = ttopk.smallest_k(_t(d), 12)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))

    da = np.sort(rng.integers(0, 6, (7, 10)).astype(np.float32), axis=1)
    db = np.sort(rng.integers(0, 6, (7, 10)).astype(np.float32), axis=1)
    ia = rng.integers(0, 100, (7, 10)).astype(np.int32)
    ib = rng.integers(100, 200, (7, 10)).astype(np.int32)
    jd, ji = jtopk.merge_topk(*map(jnp.asarray, (da, ia, db, ib)), k=10)
    td, ti = ttopk.merge_topk(_t(da), _t(ia), _t(db), _t(ib), 10)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))

    ds = np.sort(rng.integers(0, 5, (3, 7, 10)).astype(np.float32), axis=2)
    is_ = rng.integers(0, 1000, (3, 7, 10)).astype(np.int32)
    jd, ji = jtopk.merge_topk_many(jnp.asarray(ds), jnp.asarray(is_), 10)
    td, ti = ttopk.merge_topk_many(_t(ds), _t(is_), 10)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))

    jd, ji = jtopk.sort_topk(jnp.asarray(d), jnp.asarray(d.astype(np.int32)))
    td, ti = ttopk.sort_topk(_t(d), _t(d.astype(np.int32)))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ttopk.check_monotonic(td) and jtopk.check_monotonic(np.asarray(jd))
    assert not ttopk.check_monotonic(_t(d))


def test_bf16_round_bitwise_equal_to_jax():
    """Integer round-to-nearest-even: bit-identical to the JAX function on
    random values, wide exponents, crafted tie/carry patterns, zeros,
    subnormals, +/-inf and NaN payloads (0x7FFFFFFF and 0xFFFFFFFF wrap
    to finite values without the NaN guard)."""
    rng = np.random.default_rng(7)
    vals = [rng.standard_normal(8192).astype(np.float32),
            (rng.standard_normal(2048) *
             np.exp(rng.uniform(-80, 80, 2048))).astype(np.float32)]
    exps = np.array([0, 1, 63, 127, 200, 254], np.uint32)
    m7 = np.array([0, 1, 0x7E, 0x7F], np.uint32)
    low = np.array([0x0000, 0x0001, 0x7FFF, 0x8000, 0x8001, 0xFFFF],
                   np.uint32)
    bits = [(s << 31) | (e << 23) | (m << 16) | lo
            for s in (0, 1) for e in exps for m in m7 for lo in low]
    vals.append(np.array(bits, np.uint32).view(np.float32))
    vals.append(np.array([0x7FFFFFFF, 0xFFFFFFFF, 0x7FC00000, 0xFFC00000,
                          0x7F800001, 0xFF800001, 0x7FBFFFFF, 0x00000001,
                          0x807FFFFF, 0x7F7FFFFF, 0xFF7FFFFF],
                         np.uint32).view(np.float32))
    vals.append(np.array([0.0, -0.0, 1e-44, -1e-44, 1e-38, 3.4e38, -3.4e38,
                          np.inf, -np.inf], np.float32))
    x = np.concatenate(vals)
    want = np.asarray(jsk.bf16_round(x)).view(np.uint32)
    got = tsk.bf16_round(_t(x)).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)
    # and the value the bf16 operand is made of is the rounded one
    fin = np.isfinite(x)
    back = tsk.bf16_round(_t(x)).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(back[fin].view(np.uint32), want[fin])


def test_constants_and_small_helpers_match_jax():
    for name in ("LANES", "TB", "SUB_PER_MEGA", "MEGA", "KEEP",
                 "CAND_PER_MEGA", "POS_BITS", "POS_MASK", "PACK_EPS_REL",
                 "PASSES", "_BIG_BASE"):
        assert getattr(tsk, name) == getattr(jsk, name), name
    for n in (1000, 500_000, 917_503, 917_504, 2_000_000):
        for k in (None, 10, 150, 151):
            for qr in (None, 1000, 24576, 24577):
                assert tsk.pick_sub(n, k, qr) == jsk.pick_sub(n, k, qr)
    for dim in (1, 48, 1536, 65536):
        assert tsk.norm_guard(dim) == jsk.norm_guard(dim)
    for x, m in ((0, 128), (1, 128), (129, 128), (5000, 1024)):
        assert tmisc.round_up(x, m) == jmisc.round_up(x, m)
        assert tmisc.cdiv(x, m) == jmisc.cdiv(x, m)
    assert tmisc.is_zero_embedding([0.0, 0.0])
    assert not tmisc.is_zero_embedding([0.0, 1.0])
    for args in (("voyage-3-large", 1024, 128), ("voyage-3-large", 128, 128),
                 ("e5", 1024, 128), ("e5", 384, 384)):
        assert (tmisc.output_dimension_validity_check(*args)
                == jmisc.output_dimension_validity_check(*args))


def test_naming_helpers_match_jax():
    for args in (("/d", "intfloat/e5-small-v2", 384, 1000, 100, 10, None),
                 ("/d", "voyage-3-large", 1024, 5, 3, 2, "binary")):
        assert (tnaming.get_ivec_fvec_filenames(*args)
                == jnaming.get_ivec_fvec_filenames(*args))
        assert (tnaming.get_hdf5_filename(*args)
                == jnaming.get_hdf5_filename(*args))
    for fn in ("get_source_query_dataset_filename",
               "get_source_base_dataset_filename"):
        assert (getattr(tnaming, fn)("/h", "a/b", 7, 384, None)
                == getattr(jnaming, fn)("/h", "a/b", 7, 384, None))
    for i in (-1, 0, 3):
        assert (tnaming.get_partial_indices_filename("/h", i)
                == jnaming.get_partial_indices_filename("/h", i))
        assert (tnaming.get_partial_distances_filename("/h", i)
                == jnaming.get_partial_distances_filename("/h", i))
    assert (tnaming.get_model_data_homedir("/o", "a/b", 1, 2, 3)
            == jnaming.get_model_data_homedir("/o", "a/b", 1, 2, 3))


def test_cpu_memory_plan_matches_jax():
    """Off the accelerator both planners use the same host budget, so the
    streamed batch sizes (and with them the batch boundaries every
    artifact depends on) are identical."""
    for args in ((100, 384, 10, 1000), (10_000, 1536, 100, 1_000_000),
                 (5, 8, 3, 70)):
        want = jtuner.plan_knn(*args, initial_batch_size=300)
        got = ttuner.plan_knn(*args, initial_batch_size=300, device="cpu")
        assert (got.batch_size, got.tile_size, got.est_bytes) == \
            (want.batch_size, want.tile_size, want.est_bytes)
    assert ttuner.device_memory_budget("cpu") == 8 << 30


def test_port_imports_without_jax():
    """The port must never import jax or the JAX package: import every
    module of it with both blocked in sys.modules."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['neighborhoodwatch_tpu'] = None\n"
        "import neighborhoodwatch_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.startswith(('jax', 'jaxlib',"
        " 'neighborhoodwatch_tpu.')) and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "clean" in res.stdout


def test_entry_points_raise_without_a_card(monkeypatch):
    """device=None means "cuda": with no card the entry points raise
    instead of falling back to the CPU; device="cpu" runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    q = np.zeros((2, 4), np.float32)
    b = np.ones((5, 4), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tknn.knn(q, b, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tknn.StreamingKNN(q, 2)
    d, i = tknn.knn(q, b, 2, device="cpu")
    assert i.dtype == torch.int32 and tuple(d.shape) == (2, 2)
    assert not torch.backends.cuda.matmul.allow_tf32


def test_screen_wrapper_rejects_unknown_arguments():
    q = torch.zeros((2, 8), dtype=torch.bfloat16)
    qn = torch.zeros(2)
    with pytest.raises(ValueError):
        tsk.screen_keys(q, q, q, q, qn, qn, tsk.MEGA, 4, "l2")
    with pytest.raises(ValueError):
        tsk.screen_keys(q, q, q, q, qn, qn, tsk.MEGA, 1, "cos")
    with pytest.raises(ValueError):
        tsk.screen_keys(q, q, q, q, qn, qn, 100, 1, "l2")
