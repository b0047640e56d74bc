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


def test_rows_r_and_r_plus_128_share_a_lane_bin_at_adjacent_positions():
    """What the wgmma variant's 256-row step relies on: rows r and r + 128
    of a step fall in the same lane bin (mega, r % 128) at positions
    (r % mega_rows) // 128 = 2*step and 2*step + 1, so a wider step adds
    no bins. Planted exact matches at such a pair come back as the two
    best keys of one bin with exactly those positions."""
    mega = 1024                       # 8 positions, 4 steps of 256 rows
    q, b = _data(3, 2 * mega + 40, 16, seed=31)
    step, lane = 2, 77
    r = mega + step * 256 + lane      # second mega, first half of its step 2
    b[r] = q[0]
    b[r + 128] = q[0] * 1.25
    qt, bt = torch.from_numpy(q), torch.from_numpy(b)
    qh = tsk.bf16_round(qt)
    bhi = tsk.bf16_round(bt).to(torch.bfloat16)
    keys = tsk.screen_keys(qh.to(torch.bfloat16), None, bhi, None,
                           (qt * qt).sum(1), (bt * bt).sum(1), mega, 1, "l2")
    col = tsk.CAND_PER_MEGA + lane     # bin (mega 1, lane), slabs 0 and 1
    pos = (keys[0, [col, col + tsk.LANES]] & tsk.POS_MASK).tolist()
    assert pos == [2 * step, 2 * step + 1]
    assert pos == [(x % mega) // tsk.LANES for x in (r, r + 128)]
    _, ci = tsk._decode_keys(keys, "l2", mega)
    assert ci[0, [col, col + tsk.LANES]].tolist() == [r, r + 128]


@pytest.mark.parametrize("D,aligned,variant", [
    (1536, True, "wgmma"), (768, True, "wgmma"), (1024, True, "wgmma"),
    (200, True, "wgmma"),      # D % 64 != 0, D % 8 == 0: TMA zero fill
    (8, True, "wgmma"),
    (45, True, "mma"),         # rows not 16-byte aligned
    (1540, True, "mma"),       # D % 8 == 4
    (1536, False, "mma"),      # an operand pointer off 16 bytes
])
def test_variant_is_chosen_by_shape_alone(D, aligned, variant):
    assert tsk.pick_variant(D, aligned) == variant


def test_forced_variant_restores_and_rejects_unknown_names():
    assert tsk._forced_variant is None
    with tsk.forced_variant("mma"):
        assert tsk._forced_variant == "mma"
        with tsk.forced_variant("wgmma"):
            assert tsk._forced_variant == "wgmma"
        assert tsk._forced_variant == "mma"
    assert tsk._forced_variant is None
    with tsk.forced_variant("wgmma", cluster=4):
        assert tsk._forced_cluster == 4
    assert tsk._forced_cluster == 0
    with pytest.raises(ValueError, match="variant"):
        with tsk.forced_variant("wmma"):
            pass
    with pytest.raises(ValueError, match="cluster"):
        with tsk.forced_variant("wgmma", cluster=3):
            pass
    assert set(tsk.screen_keys.launches_by_variant) == set(tsk.VARIANTS)


def test_library_hash_covers_the_shared_header(tmp_path, monkeypatch):
    """Both kernel sources include csrc/wgmma_mainloop.cuh: an edited
    header must name a new library, or a stale one would be loaded."""
    from neighborhoodwatch_tpu_torch.utils import cuda_build
    import os
    assert os.path.exists(os.path.join(cuda_build.CSRC, "wgmma_mainloop.cuh"))
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(cuda_build, "CSRC", str(tmp_path))
    first = cuda_build.library_path("k")
    assert cuda_build.library_path("k") == first
    (tmp_path / "h.cuh").write_text("// two\n")
    assert cuda_build.library_path("k") != first
