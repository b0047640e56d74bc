"""The launch plan of E3's "staged" kernel (ops/encoder_fused.py:row_plan,
masked_softmax), on the CPU: pure Python, over every shape the encoders
produce and the edges beside them.

What the plan must hold, whatever the card: a grid of at least one block
and never more than the card holds at once (`sms` x the blocks an SM
holds), one block a step, as the launch function checks; steps of
consecutive rows that cover every row exactly once, the fewest passes
that fit them into that grid; "rowpass" exactly where the rows cannot be
staged (a width not a multiple of 8, unaligned pointers, no block fits an
SM). The kernel itself runs only on the card
(tests/test_torch_port_cuda_encoder_fused.py)."""

import numpy as np
import pytest

from neighborhoodwatch_tpu_torch.ops import encoder_fused as ef

SMS = 132
DTYPES = ["bfloat16", "float16", "float32"]
# E3's (B, heads) at each T: e5-small/base/large, ColBERT, ragged
E3_BATCHES = [(1, 12), (3, 5), (8, 16), (37, 16), (64, 12), (64, 16)]


def occupancy(blocks):
    """A model of the occupancy query: the blocks an SM holds by registers
    and threads (E3 takes no dynamic shared memory)."""
    return lambda: blocks


def walk(pl, rows):
    """Every row's visits when block b takes the step of rows from b x
    rows_per_step, as the kernel does."""
    seen = np.zeros(rows, dtype=np.int64)
    for block in range(pl.grid):
        r0 = block * pl.rows_per_step
        valid = min(pl.rows_per_step, rows - r0)
        assert valid >= 1, (block, r0)
        seen[r0:r0 + valid] += 1
    return seen


def check(rows, width, aligned, resident):
    pl = ef.row_plan(rows, width, aligned, SMS, resident)
    if width % 8 or not aligned:
        assert pl.variant == "rowpass"
        assert pl.reason == ("width" if width % 8 else "unaligned")
        assert (pl.grid, pl.passes) == (0, 0)
        return pl
    assert pl.variant == "staged" and pl.reason == ""
    assert pl.lanes == ef.row_lanes(width)
    per_pass = ef.pass_rows(width)
    assert pl.rows_per_step == pl.passes * per_pass
    held = SMS * resident()
    assert 1 <= pl.grid <= held
    assert pl.grid == -(-rows // pl.rows_per_step)
    # the fewest passes: one fewer would need more blocks than the card
    # holds at once
    assert pl.passes == 1 or -(-rows // (per_pass * (pl.passes - 1))) > held
    assert (walk(pl, rows) == 1).all()
    return pl


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T", [1, 7, 8, 16, 31, 32, 40, 64, 100, 128, 200,
                               220, 256, 300, 512])
def test_e3_plan(T, dtype):
    """E3 over the tokenizer's buckets (16 .. 512, ColBERT's 220) and T's
    that are no multiple of 8 (1, 7, 31, 100, 300: "rowpass"); the blocks
    an SM the occupancy query gives for each dtype's registers."""
    for B, heads in E3_BATCHES:
        for aligned in (True, False):
            check(B * heads * T, T, aligned,
                  occupancy(6 if dtype != "float32" else 5))


def test_plan_at_the_main_paths_shapes():
    """e5-large's 64 x 16 heads at the sentence buckets 64 and 128 and at
    512 (passages): the passes that fit the rows into the blocks the card
    holds, a block a step; nw's e5-small at 12 heads x 32 for one passage:
    a block a step of one pass."""
    res8 = occupancy(8)
    e3 = check(64 * 16 * 512, 512, True, res8)
    assert (e3.lanes, e3.passes, e3.rows_per_step, e3.grid) == \
        (64, 125, 500, 1049)
    assert e3.grid <= SMS * 8
    s64 = check(64 * 16 * 64, 64, True, res8)
    assert (s64.lanes, s64.passes, s64.rows_per_step, s64.grid) == \
        (8, 2, 64, 1024)
    s128 = check(64 * 16 * 128, 128, True, res8)
    assert (s128.lanes, s128.passes, s128.rows_per_step, s128.grid) == \
        (16, 8, 128, 1024)
    one = check(12 * 32, 32, True, res8)
    assert (one.grid, one.passes) == (6, 1)


def test_plan_edges_and_refusals():
    res = occupancy(4)
    assert ef.row_plan(0, 64, True, SMS, res).reason == "empty"
    assert ef.row_plan(2 ** 30, 64, True, SMS, res).reason == "rows"
    assert ef.row_plan(4096, 36, True, SMS, res).reason == "width"
    assert ef.row_plan(4096, 64, False, SMS, res).reason == "unaligned"
    # no block fits an SM: "rowpass", with the reason
    none = ef.row_plan(4096, 64, True, SMS, occupancy(0))
    assert (none.variant, none.reason) == ("rowpass", "occupancy")
    assert (none.lanes, none.passes, none.rows_per_step, none.grid) == \
        (0, 0, 0, 0)
    # the occupancy query is asked only for rows the kernel can take
    def never():
        raise AssertionError("asked the occupancy query")
    assert ef.row_plan(4096, 36, True, SMS, never).reason == "width"
    for bad in (dict(rows=-1), dict(width=0), dict(sms=0)):
        kw = {**dict(rows=8, width=64, aligned=True, sms=SMS,
                     resident=res), **bad}
        with pytest.raises(ValueError):
            ef.row_plan(**kw)


def test_lanes_are_the_rowpass_layout():
    """Both of E3's kernels lay a row out alike, so they give the same
    bits: a lane for 8 keys, 4 to 64 lanes."""
    assert [ef.row_lanes(t) for t in
            (8, 32, 40, 64, 128, 200, 256, 264, 512)] == \
        [4, 4, 8, 8, 16, 32, 32, 64, 64]
    assert ef.pass_rows(32) == 64
    assert ef.pass_rows(512) == 4
