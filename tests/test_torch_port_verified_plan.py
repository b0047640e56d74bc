"""The verified select's kernel (csrc/verified_select.cu) on the CPU: its launch plan, the wrapper's refusals, and a PyTorch model of
its candidate stage held against the plain version and the JAX package.

The kernel runs only on the card (tests/test_torch_port_cuda_verified.py
holds it against the plain version there). What can be checked here is the
plan the wrapper launches it with (ops/verified_kernel.py:plan, plain
Python), that a refused launch raises and is never retried, and the
algorithm of its candidate stage: `adaptive_candidates`
below bins each row's ordered keys over the row's finite range, refines the
boundary bin alone, and gathers all entries up to it or, when one key
crowds the boundary, the lowest columns equal to it, as the kernel does.
Its candidates must be the row's exact top-margin, so the plain version
with this candidate stage returns what it returns with its own, bit for
bit; against JAX's `_verified_smallest_k` (approx_min_k, exact on the CPU)
the distances are equal and the ids pick entries of those distances (JAX
may take another subset of tied entries, knn.py:74-78)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import neighborhoodwatch_tpu.ops.knn as jknn

from neighborhoodwatch_tpu_torch.ops import verified_kernel as vk
from neighborhoodwatch_tpu_torch.ops.topk import smallest_k

INF_KEY = 0xFF800000
BINS = 2048


# ---------------------------------------------------------------- the plan


@pytest.mark.parametrize("q,n,k,want", [
    # phase 13's tiles: the whole-batch fallback's, and with ties
    (1000, 8192, 1, ("persistent", 1, 264, "registers", 2)),
    (1000, 8192, 100, ("persistent", 1, 264, "registers", 2)),
    (1000, 8192, 1024, ("persistent", 1, 264, "registers", 2)),
    (512, 8192, 100, ("persistent", 1, 264, "registers", 2)),
    # the class-B repair's 128 x 32,768: two blocks a row fill the card
    (128, 32768, 100, ("cluster", 2, 128, "shared", 1)),
    # the escalation's 16 x 262,144: eight blocks a row, 128 KB slices
    (16, 262144, 100, ("cluster", 8, 16, "shared", 1)),
    (16, 262144, 1024, ("cluster", 8, 16, "shared", 1)),
    # wider than a cluster's shared memory: every sweep reads L2
    (2, 1000448, 100, ("cluster", 8, 2, "device", 0)),
    # N % 4 != 0: no bulk copies
    (4, 4099, 100, ("cluster", 2, 4, "registers", 0)),
])
def test_plan_of_the_main_shapes(q, n, k, want):
    pl = vk.plan(q, n, k)
    assert (pl.path, pl.cluster, pl.clusters, pl.keys_in,
            pl.buffers) == want
    assert pl.grid == pl.clusters * pl.cluster
    assert pl.threads == vk.THREADS
    assert pl.smem_bytes <= vk.SMEM_LIMIT


def test_plan_shared_bytes_follow_the_kernel_layout():
    """The bytes the launch function recomputes from (slice, buffers,
    capacity) and refuses when they differ."""
    for q, n, k in [(1000, 8192, 100), (1000, 8192, 1024), (16, 262144, 7),
                    (2, 9000, 6553)]:
        pl = vk.plan(q, n, k)
        cap = vk.candidate_capacity(vk.margin_for(n, k))
        assert pl.smem_bytes == (pl.buffers * pl.slice * 4 + cap * 16
                                 + (2048 + 4) * 4 + 16 + 256)
    assert vk.candidate_capacity(vk.margin_for(8192, 1)) == 64
    assert vk.candidate_capacity(vk.margin_for(8192, 100)) == 256
    assert vk.candidate_capacity(vk.margin_for(8192, 1024)) == 2048 + 512


@pytest.mark.parametrize("q", [1, 5, 131, 132, 1000, 20000])
@pytest.mark.parametrize("n", [1, 50, 4099, 8192, 8193, 32768, 70001,
                               262144, 1000448, 4_000_000])
def test_no_plan_exceeds_the_card(q, n):
    """Every plan stays within a block's shared memory and a portable
    cluster, covers the row with blocks that each hold columns, keeps
    slices wider than the registers in a cluster, and copies rows in bulk
    only where they are a multiple of 16 bytes long."""
    for k in sorted({1, min(n, 100), min(n, 1024), min(n, 6553)}):
        if not vk.supports(n, k):
            continue
        pl = vk.plan(q, n, k)
        assert pl.smem_bytes <= vk.SMEM_LIMIT
        assert 1 <= pl.cluster <= vk.MAX_CLUSTER
        assert pl.slice * pl.cluster >= n > pl.slice * (pl.cluster - 1)
        assert pl.slice <= vk.TILE or pl.cluster >= 2
        assert (pl.keys_in == "registers") == (pl.slice <= vk.TILE)
        assert pl.buffers == 0 or (n % 4 == 0 and pl.slice % 4 == 0)
        assert 1 <= pl.clusters <= q
        per_sm = min(vk.BLOCKS_PER_SM, vk.SMEM_PER_SM
                     // (pl.smem_bytes + vk.SMEM_RESERVED))
        assert pl.grid <= max(132 * per_sm, pl.cluster)


def test_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError):
        vk.plan(10, 100, 0)
    with pytest.raises(ValueError):
        vk.plan(10, 100, 101)
    with pytest.raises(ValueError):
        vk.plan(10, 20000, 7000)            # margin 8750 > MAX_MARGIN
    with pytest.raises(ValueError):
        vk.plan(10, 2 ** 31, 10)            # 32-bit positions
    with pytest.raises(ValueError):
        vk.plan(0, 100, 10)
    # an unaligned tile is loaded by the threads, never by bulk copies
    assert vk.plan(1000, 8192, 100, aligned=False).buffers == 0


# ------------------------------------------------- the wrapper's refusals


class _FakeLibrary:
    """Stands for the built library: every launch returns `err` and is
    recorded with the plan's arguments it was given."""

    def __init__(self, err):
        self.err, self.calls = err, []

    def verified_select_adaptive_launch(self, *args):
        self.calls.append(args[10:15])
        return self.err


@pytest.mark.parametrize("q,n,aligned,path", [
    (1000, 8192, True, "persistent/registers"),
    (6, 32768, True, "cluster/registers"),
    (128, 32768, True, "cluster/shared"),
    (2, 1000448, True, "cluster/device"),
    (4, 4099, True, "cluster/registers"),
    (1000, 8192, False, "persistent/registers")])
def test_a_refused_launch_raises_and_never_falls_back(q, n, aligned, path):
    """A launch the library refuses (here: cudaErrorInvalidConfiguration)
    raises and is tried once, on every path of the plan; an accepted one
    runs once on the plan's cluster, clusters, slice, buffers and bytes."""
    pl = vk.plan(q, n, 100, 132, aligned)
    assert f"{pl.path}/{pl.keys_in}" == path
    want = (pl.cluster, pl.clusters, pl.slice, pl.buffers, pl.smem_bytes)
    args = (0, q, n, 100, vk.margin_for(n, 100), -1, 0, 0, 0, 0)
    lib = _FakeLibrary(9)
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        vk._launch(lib, args, 0, 132, aligned)
    assert lib.calls == [want]
    lib = _FakeLibrary(0)
    vk._launch(lib, args, 0, 132, aligned)
    assert lib.calls == [want]
    assert vk.verified_select.last_plan == (pl, 0)


# ------------------------------------- a model of the candidate stage


def ordered_keys(d):
    """The kernel's ordered keys as int64: fp32 bits with the sign folded,
    -0.0 on +0.0's key, every NaN on the largest."""
    u = d.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    mag = u & 0x7FFFFFFF
    k = torch.where(u >= 0x80000000, u ^ 0xFFFFFFFF, u | 0x80000000)
    k = torch.where(mag == 0, 0x80000000, k)
    return torch.where(mag > 0x7F800000, 0xFFFFFFFF, k)


def _bitlen(x):
    return int(x).bit_length()


def adaptive_candidates(stats, exclude=-1):
    """A candidate stage for `verified_select_plain` that works as the
    kernel's: per row, the first digit over the finite keys' range (+inf
    and NaN in an overflow bin), further digits over the boundary bin
    alone until the bins up to it hold at most candidate_capacity entries
    or it holds one key, then every entry up to its top or, for one
    crowding key, the lowest columns equal to it. Returns the margin best
    by (key, column) of what it gathered; appends (path, further digits,
    gathered) per row to `stats`."""
    def candidates(d, margin):
        q_rows, n = d.shape
        keys = ordered_keys(d)
        cap = vk.candidate_capacity(margin)
        out_v = torch.empty((q_rows, margin), dtype=d.dtype)
        out_i = torch.empty((q_rows, margin), dtype=torch.int64)
        cols = torch.arange(n)
        for r in range(q_rows):
            take = cols != exclude
            kt, ct = keys[r][take], cols[take]
            fin = kt < INF_KEY
            rank = margin - 1
            if bool(fin.any()):
                base, top = int(kt[fin].min()), int(kt[fin].max())
                shift = max(0, _bitlen(top - base) - 11)
            else:
                base, top, shift = 0xFFFFFFFF, 0, 0
            below, rounds, first = 0, 0, True
            while True:
                inr = (kt >= base) & (kt <= top)
                hist = torch.bincount((kt[inr] - base) >> shift,
                                      minlength=BINS + 1)
                if first:
                    hist[BINS] = int((kt > top).sum())
                cum = torch.cumsum(hist, 0)
                b = int(torch.searchsorted(cum, rank - below, right=True))
                if b == BINS:
                    lo, hi = INF_KEY, 0xFFFFFFFF
                else:
                    lo = base + (b << shift)
                    hi = min(base + ((b + 1) << shift) - 1, top)
                below += int(cum[b] - hist[b])
                cnt = int(hist[b])
                if below + cnt <= cap or lo == hi:
                    break
                base, top = lo, hi
                shift = max(0, _bitlen(hi - lo) - 11)
                first = False
                rounds += 1
            if below + cnt <= cap:
                sel = kt <= hi
                path = "all"
            else:
                sel = kt < hi
                eq = torch.nonzero(kt == hi)[:, 0][:rank - below + 1]
                sel[eq] = True
                path = "ties"
            gk, gc = kt[sel], ct[sel]
            order = torch.argsort(gk * (1 << 32) + gc)[:margin]
            out_i[r] = gc[order]
            out_v[r] = d[r, out_i[r]]
            stats.append((path, rounds, int(sel.sum())))
        return out_v, out_i
    return candidates


def _tile(kind, q=6, n=3000, seed=7):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((q, n)).astype(np.float32) ** 2
    if kind == "crowded":
        # every distance in [1.30, 1.34]: one top digit for every key
        d = (1.30 + 0.04 * rng.random((q, n))).astype(np.float32)
    elif kind == "ties":
        d = np.repeat(d[:, : n // 3 + 1], 3, axis=1)[:, :n].copy()
    elif kind == "coarse":
        d = np.round(d * 2) / 2             # few values, crowded bins
    elif kind == "tail":
        d[:, n - n // 3:] = np.inf          # a masked tail
        d[1] = np.inf                       # an all-inf row
    elif kind == "zeros":
        d[:, ::7] = 0.0
        d[:, 3::7] = -0.0                   # -0.0 ties +0.0
    elif kind == "nan":
        d[:, 5::11] = np.nan
        d[:, 7::13] = np.inf
        d[-1] = np.nan
    elif kind == "dot":
        # "dot" distances: both signs, the range across the sign fold
        d = (0.1 * rng.standard_normal((q, n))).astype(np.float32)
    return d.astype(np.float32)


def _bits(t):
    return t.contiguous().view(torch.int32)


KINDS = ["random", "crowded", "ties", "coarse", "tail", "zeros", "nan",
         "dot"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", [1, 100, 1024])
def test_model_equals_the_plain_version(kind, k):
    """With the model as its candidate stage the plain version returns what
    it returns with a stable sort's top-margin, bit for bit, and no row
    falls back: the model's candidates are the exact top-margin."""
    d = torch.from_numpy(_tile(kind))
    stats = []
    vk.reset_failed_rows()
    got = vk.verified_select_plain(d, k, adaptive_candidates(stats))
    want = vk.verified_select_plain(d, k)
    assert torch.equal(got[1], want[1])
    assert torch.equal(_bits(got[0]), _bits(want[0]))
    assert bool(got[2].all()) and vk.failed_rows() == 0
    assert len(stats) == d.shape[0]


@pytest.mark.parametrize("kind", KINDS)
def test_model_against_jax(kind):
    """The JAX package's select on the same tile: equal distances (-0.0 as
    0.0), and JAX's ids name entries of those distances."""
    d = _tile(kind, q=4, n=600)
    k = 40
    jd, ji = jknn._verified_smallest_k(jnp.asarray(d), k)
    jd, ji = np.asarray(jd), np.asarray(ji)
    td, ti, ok = vk.verified_select_plain(torch.from_numpy(d), k,
                                          adaptive_candidates([]))
    np.testing.assert_array_equal(np.take_along_axis(d, ji, 1), jd)
    if kind == "nan":
        # JAX's approx_min_k may return NaN entries (at the end of its k)
        # where finite ones remain; the port, as its exact engine, orders
        # NaN after every finite value. Its finite picks lead the port's.
        # (The engines hand the select no NaN: pairwise_distance turns
        # every non-finite distance into +inf.)
        for r in range(len(d)):
            fin = ~np.isnan(jd[r])
            np.testing.assert_array_equal(td[r].numpy()[:fin.sum()],
                                          jd[r][fin])
    else:
        np.testing.assert_array_equal(td.numpy(), jd)
    assert bool(ok.all())
    ed, ei = smallest_k(torch.from_numpy(d), k)
    assert torch.equal(ti, ei) and torch.equal(_bits(td), _bits(ed))


def test_model_reaches_every_path():
    """Spread rows need no further digit; an all-inf row's boundary is the
    overflow bin, refined down to +inf's key; a key crowding the boundary
    takes the lowest columns equal to it."""
    stats = []
    vk.verified_select_plain(torch.from_numpy(_tile("random")), 100,
                             adaptive_candidates(stats))
    assert all(s == ("all", 0, s[2]) and 128 <= s[2] <= 256 for s in stats)
    stats = []
    vk.verified_select_plain(torch.from_numpy(_tile("tail")), 100,
                             adaptive_candidates(stats))
    assert stats[1][0] == "ties" and stats[1][1] >= 2
    stats = []
    vk.verified_select_plain(torch.from_numpy(_tile("coarse")), 100,
                             adaptive_candidates(stats))
    assert {s[0] for s in stats} == {"ties"}
    stats = []
    vk.verified_select_plain(torch.from_numpy(_tile("crowded")), 100,
                             adaptive_candidates(stats))
    assert {s[0] for s in stats} == {"all"}


@pytest.mark.parametrize("kind", ["random", "ties", "tail"])
def test_model_with_a_column_left_out(kind):
    """The kernel's `exclude`: the model without column 0 returns the plain
    version's planted candidate set; where column 0 holds each row's
    minimum, every row fails the proof and falls back to the exact
    selection."""
    d = torch.from_numpy(_tile(kind))
    want = vk.verified_select_plain(d, 100, vk._without_column(0))
    got = vk.verified_select_plain(d, 100, adaptive_candidates([], 0))
    assert torch.equal(got[1], want[1])
    assert torch.equal(_bits(got[0]), _bits(want[0]))
    assert torch.equal(got[2], want[2])
    d[:, 0] = -1.0
    vk.reset_failed_rows()
    dist, pos, ok = vk.verified_select_plain(d, 100,
                                             adaptive_candidates([], 0))
    assert not bool(ok.any()) and vk.failed_rows() == d.shape[0]
    ed, ei = smallest_k(d, 100)
    assert torch.equal(pos, ei) and torch.equal(_bits(dist), _bits(ed))
