"""PyTorch port of the screen kernel vs the JAX reference.

The JAX Pallas kernels run in interpret mode on the CPU (as the JAX
package's own tests run them); the port's CPU path is the plain PyTorch
version of the Hopper kernel (csrc/screen_keys.cu), which the card checks
against the same plain version in chip_smoke.py.

Tolerance: both sides multiply the same bf16 operands exactly into fp32
but accumulate in a different order, so a distance may differ by a few
fp32 accumulation roundings, and through the key quantization (POS_BITS
low mantissa bits replaced by the bin position) by one quantum:
|d_port - d_jax| <= (PACK_EPS_REL + 4 * _acc_rel(D)) * scale, with scale
the metric's screen scale (qn + bn_max for l2, |q| |b|_max for dot, |q|
for rdot). A decoded row id may differ only where the two distances are
within that tolerance (two rows of one bin that close can swap order),
and masked rows (+inf or NaN keys) must be masked on both sides: their
positions are padding and the JAX interpret mode fills out-of-bounds
blocks with different contents.

Epilogue forms: the port uses the fused l2 form |qn + bn - 2acc| at passes
<= 2 and the clamped form |max(qn + bn - 2acc, 0)| at passes = 3, as the
JAX package does at these shapes (_fused_ok passes them to _kernel_fused
at <= 2 passes). On shapes where the JAX gate would pick the dk-chunked
kernel at <= 2 passes, the two forms differ only on distances that round
negative (|x| vs 0), both inside the accumulation eps.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from neighborhoodwatch_tpu.ops import screen_kernel as jsk
from neighborhoodwatch_tpu.ops.knn import _acc_rel

from neighborhoodwatch_tpu_torch.ops import screen_kernel as tsk

MEGA = tsk.MEGA


def _data(q_n, b_n, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((q_n, d)).astype(np.float32),
            rng.standard_normal((b_n, d)).astype(np.float32))


def _scale(q, b, epilogue):
    q64, b64 = q.astype(np.float64), b.astype(np.float64)
    qn = (q64 ** 2).sum(1)
    bn = (b64 ** 2).sum(1)
    if epilogue == "l2":
        return (qn + bn.max())[:, None]
    if epilogue == "dot":
        return (np.sqrt(qn) * np.sqrt(bn.max()))[:, None]
    return np.sqrt(qn)[:, None]


def _compare(q, b, epilogue, precision, sub=None, pipelined=None):
    jd, ji, jn = jsk.screen_candidates(
        jnp.asarray(q), jnp.asarray(b), epilogue=epilogue,
        screen_precision=precision, sub=sub, interpret=True,
        pipelined=pipelined)
    td, ti, tn = tsk.screen_candidates(torch.from_numpy(q),
                                       torch.from_numpy(b),
                                       epilogue=epilogue,
                                       screen_precision=precision, sub=sub)
    jd, ji = np.asarray(jd), np.asarray(ji)
    td, ti = td.numpy(), ti.numpy()
    assert tn == jn
    assert td.shape == jd.shape and ti.dtype == np.int32
    fin = np.isfinite(jd)
    np.testing.assert_array_equal(np.isfinite(td), fin)
    tol = (tsk.PACK_EPS_REL + 4 * _acc_rel(q.shape[1])) \
        * np.broadcast_to(_scale(q, b, epilogue), jd.shape)
    diff = np.abs(np.where(fin, td, 0).astype(np.float64)
                  - np.where(fin, jd, 0))
    assert (diff[fin] <= tol[fin]).all(), diff[fin].max()
    swapped = fin & (ti != ji)
    assert (diff[swapped] <= tol[swapped]).all()
    assert swapped.sum() <= max(2, fin.sum() // 1000)
    # every finite candidate decodes to a real row of its bin
    rows = ti[fin]
    assert (rows >= 0).all() and (rows < b.shape[0]).all()
    return td, ti


@pytest.mark.parametrize("precision", ["default", "medium", "high"])
@pytest.mark.parametrize("epilogue", ["l2", "dot", "rdot"])
def test_screen_keys_match_jax_interpret(precision, epilogue):
    """Ragged base (one mega + 333 rows), D = 48 (the JAX side pads to
    128), Q = 12: passes 1/2/3 x l2/dot/rdot."""
    q, b = _data(12, MEGA + 333, 48, seed=1)
    _compare(q, b, epilogue, precision)


def test_screen_keys_wide_tier_matches_jax():
    """sub=112 (896-row bins, in-bin positions past 511) with planted
    exact matches deep in the mega: the decode recovers the planted rows
    on both sides."""
    mega = tsk.TB * 112
    q, b = _data(4, mega + 70, 24, seed=11)
    plant = np.array([110_003, 111_222, 112_441, 114_660]) % mega
    b[plant] = q
    td, ti = _compare(q, b, "l2", "default", sub=112)
    np.testing.assert_array_equal(ti[np.arange(4), td.argmin(1)], plant)


@pytest.mark.parametrize("epilogue", ["dot", "l2"])
def test_screen_keys_cover_the_unpipelined_kernel(epilogue):
    """The plain dk-chunked Pallas kernel (_kernel, pipelined=False) gives
    the same keys as the fused and pipelined ones; the one Hopper kernel
    covers it too. At one pass its l2 epilogue is the clamped form, which
    differs from the port's fused form only on distances that round
    negative: none here (every distance is far from zero)."""
    q, b = _data(8, MEGA + 91, 128, seed=17)
    _compare(q, b, epilogue, "default", pipelined=False)


def test_decode_and_masking_of_ragged_and_invalid_rows():
    """n_rows and n_valid mask rows with +inf norms: no masked row is ever
    decoded as a finite candidate, and the best candidate of each query is
    the float64 argmin over the valid rows."""
    q, b = _data(5, MEGA + 500, 32, seed=23)
    n_valid = MEGA - 1000
    cd, ci, n_mega = tsk.screen_candidates(
        torch.from_numpy(q), torch.from_numpy(b), epilogue="l2",
        screen_precision="high", n_rows=MEGA + 200, n_valid=n_valid)
    cd, ci = cd.numpy(), ci.numpy()
    assert n_mega == 2
    fin = np.isfinite(cd)
    assert (ci[fin] < n_valid).all()
    bv = b[:n_valid].astype(np.float64)
    d64 = ((q.astype(np.float64) ** 2).sum(1)[:, None]
           + (bv ** 2).sum(1)[None, :] - 2 * q.astype(np.float64) @ bv.T)
    np.testing.assert_array_equal(ci[np.arange(5), cd.argmin(1)],
                                  d64.argmin(1))


def test_screen_keys_plain_rejects_position_overflow():
    q = torch.zeros((2, 8), dtype=torch.bfloat16)
    qn = torch.zeros(2)
    with pytest.raises(ValueError, match="positions"):
        tsk.screen_keys(q, q, q, q, qn, qn, 1025 * tsk.LANES, 1, "l2")
