"""The launch plan of the encoders' "staged" kernels
(ops/encoder_fused.py:row_plan, E1 embed_layernorm, E2 add_layernorm and
E3 masked_softmax), on the CPU: pure Python, over every shape the encoders
produce and the edges beside them.

What the plan must hold, whatever the card: shared memory equal to what
the C launch functions recompute (staged_bytes: E2's w and b, E3 none),
within the 227 KB a block may use; a grid of at least one block and never
more than the card holds at once (`sms` x the blocks an SM holds at those
bytes), one block a step, as the launch functions check; steps of
consecutive rows that cover every row exactly once, the fewest passes
that fit them into that grid; "rowpass" exactly where the rows cannot be
staged (a width not a multiple of 8, unaligned pointers, no block fits an
SM). E1's steps run through the tokens position by position: a model of
its kernel's walk (`embed_walk`) visits every (b, t) exactly once, each
within the positions its block staged. The kernels themselves run only on
the card (tests/test_torch_port_cuda_encoder_fused.py)."""

import numpy as np
import pytest

from neighborhoodwatch_tpu_torch.ops import encoder_fused as ef

SMS = 132
SMEM_LIMIT = 232448           # dynamic shared memory a block (227 KB)
SMEM_PER_SM = 233472          # an H100 SM's shared memory
SMEM_RESERVED = 1024          # the driver's share a block
DTYPES = ["bfloat16", "float16", "float32"]
# E2's rows: nw's and ck's padded shapes (64 x 32 / 128 / 512, one
# passage of 17 or 32 tokens, a 37-row tail), and the edges
E2_ROWS = [1, 7, 8, 9, 17, 32, 63, 2048, 8192, 64 * 220, 32768, 37 * 128]
# E3's (B, heads) at each T: e5-small/base/large, ColBERT, ragged
E3_BATCHES = [(1, 12), (3, 5), (8, 16), (37, 16), (64, 12), (64, 16)]


def occupancy(regs_blocks):
    """A model of the occupancy query: the blocks an SM holds by registers
    and threads, and by shared memory."""
    def resident(smem):
        return min(regs_blocks, SMEM_PER_SM // (smem + SMEM_RESERVED))
    return resident


def walk(pl, rows):
    """Every row's visits when block b takes the step of rows from b x
    rows_per_step, as the kernels do."""
    seen = np.zeros(rows, dtype=np.int64)
    for block in range(pl.grid):
        r0 = block * pl.rows_per_step
        valid = min(pl.rows_per_step, rows - r0)
        assert valid >= 1, (block, r0)
        seen[r0:r0 + valid] += 1
    return seen


def check(kernel, rows, width, aligned, resident):
    pl = ef.row_plan(kernel, rows, width, aligned, SMS, resident)
    if width % 8 or not aligned:
        assert pl.variant == "rowpass"
        assert pl.reason == ("width" if width % 8 else "unaligned")
        assert (pl.grid, pl.passes, pl.smem_bytes) == (0, 0, 0)
        return pl
    assert pl.variant == "staged" and pl.reason == ""
    assert pl.lanes == ef.row_lanes(kernel, width)
    per_pass = ef.pass_rows(kernel, width)
    assert pl.rows_per_step == pl.passes * per_pass
    assert pl.smem_bytes == ef.staged_bytes(kernel, width) <= SMEM_LIMIT
    held = SMS * resident(pl.smem_bytes)
    assert 1 <= pl.grid <= held
    assert pl.grid == -(-rows // pl.rows_per_step)
    # the fewest passes: one fewer would need more blocks than the card
    # holds at once
    assert pl.passes == 1 or -(-rows // (per_pass * (pl.passes - 1))) > held
    assert (walk(pl, rows) == 1).all()
    # E2's w and b: one bulk copy each of 16-byte multiples
    assert pl.smem_bytes % 16 == 0
    return pl


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("width", [384, 768, 1024, 4096, 1032, 200, 8, 36])
def test_e2_plan(width, dtype):
    """E2 over the encoders' widths (e5-small 384, bert-base and ColBERT
    768, e5-large 1,024), the widest row, a four-warp row, and widths a
    bulk copy cannot take (36) or that fill a few lanes (8); the blocks an
    SM the occupancy query gives for each dtype's registers."""
    for rows in E2_ROWS:
        for aligned in (True, False):
            for regs_blocks in (4, 1) if dtype != "float32" else (3, 1):
                check("add_layernorm", rows, width, aligned,
                      occupancy(regs_blocks))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T", [1, 7, 8, 16, 31, 32, 40, 64, 100, 128, 200,
                               220, 256, 300, 512])
def test_e3_plan(T, dtype):
    """E3 over the tokenizer's buckets (16 .. 512, ColBERT's 220) and T's
    that are no multiple of 8 (1, 7, 31, 100, 300: "rowpass"); the blocks
    an SM the occupancy query gives for each dtype's registers."""
    for B, heads in E3_BATCHES:
        for aligned in (True, False):
            check("masked_softmax", B * heads * T, T, aligned,
                  occupancy(6 if dtype != "float32" else 5))


def test_plan_at_the_main_paths_shapes():
    """nw's 64 x 32 forward: a block a step of one pass, one wave; longer
    shapes: the passes that fit the rows into the blocks the card holds,
    a block a step."""
    res = occupancy(4)
    small = ef.row_plan("add_layernorm", 64 * 32, 1024, True, SMS, res)
    assert (small.grid, small.passes, small.smem_bytes) == (256, 1, 8192)
    mid = ef.row_plan("add_layernorm", 64 * 128, 1024, True, SMS, res)
    assert (mid.passes, mid.grid) == (2, 512)
    res8 = occupancy(8)
    e3 = ef.row_plan("masked_softmax", 64 * 16 * 512, 512, True, SMS, res8)
    assert (e3.passes, e3.rows_per_step, e3.grid, e3.smem_bytes) == \
        (125, 500, 1049, 0)
    assert e3.grid <= SMS * 8
    one = ef.row_plan("masked_softmax", 12 * 32, 32, True, SMS, res8)
    assert (one.grid, one.passes) == (6, 1)


def test_plan_edges_and_refusals():
    res = occupancy(4)
    assert ef.row_plan("add_layernorm", 0, 1024, True, SMS, res) \
        .reason == "empty"
    assert ef.row_plan("masked_softmax", 2 ** 30, 64, True, SMS, res) \
        .reason == "rows"
    # no block fits an SM: "rowpass", with the reason
    none = ef.row_plan("masked_softmax", 4096, 64, True, SMS,
                       lambda smem: 0)
    assert (none.variant, none.reason) == ("rowpass", "occupancy")
    for bad in (dict(kernel="rerank_rows"), dict(kernel="embed_layernorm"),
                dict(rows=-1), dict(width=0), dict(sms=0)):
        kw = {**dict(kernel="add_layernorm", rows=8, width=64,
                     aligned=True, sms=SMS, resident=res), **bad}
        with pytest.raises(ValueError):
            ef.row_plan(**kw)


def test_lanes_are_the_rowpass_layout():
    """Both variants lay a row out alike, so they give the same bits: E2
    a warp up to 1,024 values, four warps above; E3 a lane for 8 keys."""
    assert [ef.row_lanes("add_layernorm", n) for n in
            (8, 256, 512, 1024, 1032, 4096)] == [32] * 4 + [128] * 2
    assert [ef.row_lanes("masked_softmax", t) for t in
            (8, 32, 40, 64, 128, 200, 256, 264, 512)] == \
        [4, 4, 8, 8, 16, 32, 32, 64, 64]
    assert ef.pass_rows("add_layernorm", 1024) == 8
    assert ef.pass_rows("add_layernorm", 4096) == 2
    assert ef.pass_rows("masked_softmax", 32) == 64
    assert ef.pass_rows("masked_softmax", 512) == 4


# ------------------------------------------------------------------ E1


def embed_walk(pl, batch, seq):
    """Every token's visits when E1's "staged" kernel runs plan `pl`:
    block i takes the position-major rows [i step, (i + 1) step), group g
    of a pass the row g + j x (rows a pass) of pass j, row r the token
    (r % batch, r // batch), whose position row the block staged among its
    `positions`."""
    rows = batch * seq
    per_pass = ef.THREADS // max(32, pl.lanes)
    seen = np.zeros((batch, seq), dtype=np.int64)
    for block in range(pl.grid):
        r0 = block * pl.rows_per_step
        r1 = min(r0 + pl.rows_per_step, rows)
        assert r0 < r1, (block, r0)
        t_lo = r0 // batch
        assert (r1 - 1) // batch - t_lo + 1 <= pl.positions
        for j in range(pl.passes):
            for g in range(per_pass):
                r = r0 + g + j * per_pass
                if r < r1:
                    seen[r % batch, r // batch] += 1
    return seen


def check_e1(batch, seq, width, sms, resident):
    pl = ef.row_plan("embed_layernorm", batch * seq, width, True, sms,
                     resident, batch=batch)
    if pl.variant == "rowpass":
        assert pl.reason in ("smem", "occupancy", "one pass"), pl
        return pl
    assert pl.lanes == ef.row_lanes("embed_layernorm", width)
    per_pass = ef.pass_rows("embed_layernorm", width)
    assert pl.passes * per_pass >= pl.rows_per_step >= 1
    assert pl.passes == 1 or pl.rows_per_step == pl.passes * per_pass
    # one full pass a block is "rowpass"'s own layout: sent there
    assert pl.passes > 1 or pl.rows_per_step < per_pass
    assert pl.grid == -(-batch * seq // pl.rows_per_step)
    assert pl.positions == ef.staged_positions(pl.rows_per_step, batch, seq)
    assert pl.smem_bytes == ef.staged_bytes("embed_layernorm", width,
                                            pl.positions) <= SMEM_LIMIT
    assert 1 <= pl.grid <= sms * resident(pl.smem_bytes)
    assert (embed_walk(pl, batch, seq) == 1).all()
    return pl


@pytest.mark.parametrize("width", [384, 768, 1024, 1032, 4096])
def test_e1_walk_covers_every_token_once(width):
    """Random batches, sequence lengths, SM counts and residencies: the
    plan's steps, walked as the kernel walks them, cover every token
    exactly once, each block's positions within its shared rows."""
    rng = np.random.default_rng(width)
    for _ in range(40):
        batch = int(rng.integers(1, 80))
        seq = int(rng.integers(1, 513))
        sms = int(rng.choice([1, 2, 5, 17, 64, 132]))
        check_e1(batch, seq, width, sms, occupancy(int(rng.integers(1, 5))))


def test_e1_plan_at_the_main_paths_shapes():
    """nw's 64 x 32: one full pass of 8 tokens a block, "rowpass"'s own
    layout, so "rowpass" ("one pass"); ck's 1 x 32: a token a block, spread
    over 32 SMs; longer shapes: the passes that fit the tokens into the
    blocks the card holds."""
    res = occupancy(3)
    small = check_e1(64, 32, 1024, SMS, res)
    assert (small.variant, small.reason) == ("rowpass", "one pass")
    assert check_e1(64, 32, 1024, SMS, occupancy(2)).reason == "one pass"
    one = check_e1(1, 32, 768, SMS, res)
    assert (one.rows_per_step, one.grid, one.positions) == (1, 32, 1)
    for seq in (128, 512):
        pl = check_e1(64, seq, 1024, SMS, res)
        assert pl.passes > 1 and pl.grid <= SMS * 3
    colbert = check_e1(64, 256, 768, SMS, res)
    assert colbert.smem_bytes == 768 * 4 * (3 + colbert.positions)


def test_e1_plan_edges_and_refusals():
    res = occupancy(3)
    plan = ef.row_plan
    assert plan("embed_layernorm", 64 * 36, 36, True, SMS, res,
                batch=64).reason == "width"
    assert plan("embed_layernorm", 64 * 32, 1024, False, SMS, res,
                batch=64).reason == "unaligned"
    assert plan("embed_layernorm", 0, 1024, True, SMS, res,
                batch=1).reason == "empty"
    assert plan("embed_layernorm", 2 ** 30, 1024, True, SMS, res,
                batch=2 ** 21).reason == "rows"
    # one SM, one block: a step of every token, more positions than
    # shared memory holds
    assert plan("embed_layernorm", 512, 4096, True, 1, occupancy(1),
                batch=1).reason == "smem"
    assert plan("embed_layernorm", 4096, 64, True, SMS,
                lambda smem: 0, batch=8).reason == "occupancy"
    for batch in (None, 0, 3):
        with pytest.raises(ValueError):
            plan("embed_layernorm", 64, 1024, True, SMS, res, batch=batch)


def test_staged_positions():
    """A step within one position where it divides the batch, whole
    positions where the batch divides it, else at most two more than
    (step - 1) // batch; never more than the sequence."""
    assert ef.staged_positions(8, 64, 32) == 1
    assert ef.staged_positions(128, 64, 512) == 2
    assert ef.staged_positions(88, 64, 512) == 3
    assert ef.staged_positions(3, 37, 32) == 2
    assert ef.staged_positions(1, 1, 32) == 1
    assert ef.staged_positions(512, 1, 32) == 32
    rng = np.random.default_rng(0)
    for _ in range(500):
        step, batch = int(rng.integers(1, 300)), int(rng.integers(1, 90))
        seq = int(rng.integers(1, 600))
        worst = max((min(r0 + step, batch * seq) - 1) // batch - r0 // batch
                    + 1 for r0 in range(0, batch * seq, step))
        assert worst <= ef.staged_positions(step, batch, seq)
