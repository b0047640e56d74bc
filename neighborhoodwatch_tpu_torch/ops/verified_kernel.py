"""The "verified" engine's per-tile select: k smallest per row with a count
proof (counterpart of `_verified_smallest_k` in ops/knn.py, whose candidate
stage is the TPU's `lax.approx_min_k`).

Three stages, as in the JAX function:
  1. candidates: `margin = min(N, max(k + 28, 5k/4))` entries of the row
     that should hold its k smallest (`approx_min_k` at recall 0.999 there;
     an exact top-margin here, which is a valid output of it);
  2. the k best candidates by (value, position);
  3. the proof: with tau the k-th selected value, the row holds as many
     values below tau as the selection does, or the row is selected again
     exactly. JAX falls back for the whole tile when one row fails; here
     each failed row falls back alone, which returns the same sets.
The result is a true k-smallest multiset of each row; among equal values
the lower position comes first, so both versions below return what the
exact engine's stable sort returns.

`verified_select` is the one kernel entry: on CUDA tensors it launches the
hand-written Hopper kernel in csrc/verified_select.cu (candidates, sort,
proof and fallback in one launch, no host sync) and counts the launch; on
CPU tensors it runs `verified_select_plain`, the same three stages in
PyTorch, whose candidate stage a test can replace. Rows that failed the
proof are added to a counter per device (a device tensor for the kernel),
read by `failed_rows()`: the engines never read it, so they add no host
sync.

The kernel ("adaptive": rows held in registers, an adaptive first digit,
a persistent grid that prefetches the next row with bulk copies, clusters
for wide or few rows) is launched on the plan `plan` computes.
"""

import ctypes
import functools
from dataclasses import dataclass

import torch

from neighborhoodwatch_tpu_torch.ops.topk import smallest_k

# candidates the kernel sorts in shared memory (margin <= this, k <= 6553)
MAX_MARGIN = 8192

# the kernel's constants (csrc/verified_select.cu)
THREADS = 256           # a block
KEYS_PER_THREAD = 32    # held in registers
TILE = THREADS * KEYS_PER_THREAD   # a block's slice up to this stays resident
MAX_CLUSTER = 8         # blocks a cluster, portable
SHARED_COLUMNS = 32768  # the widest slice a block keeps in shared memory
MIN_CLUSTER_COLUMNS = 2048   # columns a block of a spread row holds at least
BLOCKS_PER_SM = 2       # the kernel's launch bounds
SMEM_LIMIT = 232448     # dynamic shared memory a block may use
SMEM_PER_SM = 233472    # shared memory of an SM
SMEM_RESERVED = 1024    # the driver's share of it per block
_HIST_WORDS = 2048 + 4  # 2,048 bins + the overflow bin, padded
_FIXED_BYTES = _HIST_WORDS * 4 + 2 * 8 + 64 * 4   # + mbarriers, scratch

_failed: dict[torch.device, torch.Tensor] = {}
_failed_host = 0


def margin_for(n: int, k: int) -> int:
    """Candidates per row: k + 28 or 5k/4, whichever is larger, at most n
    (the JAX function's margin)."""
    return min(n, max(k + 28, (k * 5) // 4))


def supports(n: int, k: int) -> bool:
    """Whether the kernel takes a row of n entries at this k."""
    return 1 <= k <= n and margin_for(n, k) <= MAX_MARGIN


def candidate_capacity(margin: int) -> int:
    """Candidates the kernel gathers at most before it sorts
    them (through a second buffer of as many): with P the power of two >=
    max(margin, 32), 2P up to P = 256, P + 512 above. The bins below the
    boundary bin and the boundary bin itself then fit without a further
    digit on all but crowded rows, and k = 1024 keeps two blocks an SM."""
    p = max(32, 1 << (margin - 1).bit_length())
    return 2 * p if p <= 256 else p + 512


@dataclass(frozen=True)
class Plan:
    """The kernel's launch for one (Q, N) tile."""
    path: str           # "persistent" (a block a row) or "cluster"
    threads: int        # a block
    keys_per_thread: int    # per sweep; kept in registers when resident
    cluster: int        # blocks a row takes (1: the persistent path)
    clusters: int       # clusters launched; they walk the rows
    grid: int           # blocks launched
    slice: int          # columns a block holds
    keys_in: str        # "registers", "shared" (re-read each sweep) or
                        # "device" (re-read from L2 each sweep)
    buffers: int        # shared row buffers filled by bulk copies (0: the
                        # threads load the row themselves)
    smem_bytes: int     # dynamic shared memory a block


@functools.lru_cache(maxsize=256)
def plan(q: int, n: int, k: int, sms: int = 132,
         aligned: bool = True) -> Plan:
    """The kernel's launch for a (q, n) tile at this k on a card of `sms`
    SMs (`aligned`: the tile's base address is 16-byte aligned).

    A row takes one block where the tile has rows enough to give every SM
    one (about BLOCKS_PER_SM blocks an SM then walk the rows), a slice of
    at most TILE columns held in registers. Otherwise it takes a cluster of
    C blocks (at most 8): as many as spread the rows over the SMs (while
    each block keeps MIN_CLUSTER_COLUMNS columns), at least as many as cut
    the row into slices of SHARED_COLUMNS, and two at least where the row
    is wider than TILE. Cluster barriers and reads of other blocks' shared
    memory cost microseconds, so C stays the least that fills the card.
    Rows a multiple of 16 bytes long (n % 4 == 0) at an aligned address
    come in by bulk copies: two shared buffers where the slice sits in
    registers (the next row in flight), one where it is read from shared
    memory on every sweep, none where it does not fit (every sweep reads
    L2). Raises where the kernel cannot take the shape."""
    if not 1 <= k <= n:
        raise ValueError(f"k={k} outside [1, {n}]")
    if n >= 2 ** 31:
        raise ValueError(f"{n} columns exceed the kernel's 32-bit positions")
    if margin_for(n, k) > MAX_MARGIN:
        raise ValueError(f"k={k}: {margin_for(n, k)} candidates exceed the "
                         f"kernel's {MAX_MARGIN}")
    if q < 1 or sms < 1:
        raise ValueError(f"q={q}, sms={sms}: nothing to plan")
    fill = -(-sms // q)
    cluster = max(-(-n // SHARED_COLUMNS),
                  min(fill, n // MIN_CLUSTER_COLUMNS),
                  2 if n > TILE else 1)
    cluster = min(MAX_CLUSTER, cluster)
    slice_ = -(-(-(-n // cluster)) // 4) * 4
    while slice_ * (cluster - 1) >= n:      # every block holds columns
        cluster -= 1
        slice_ = -(-(-(-n // cluster)) // 4) * 4
    fixed = candidate_capacity(margin_for(n, k)) * 16 + _FIXED_BYTES
    resident = slice_ <= TILE
    row_bytes = -(-slice_ * 4 // 16) * 16
    if n % 4 or not aligned:
        buffers = 0
    elif resident:
        buffers = 2
    else:
        buffers = 1 if row_bytes + fixed <= SMEM_LIMIT else 0
    smem = buffers * row_bytes + fixed
    if smem > SMEM_LIMIT:
        raise ValueError(f"plan needs {smem} bytes of shared memory, above "
                         f"{SMEM_LIMIT}")
    per_sm = min(BLOCKS_PER_SM, SMEM_PER_SM // (smem + SMEM_RESERVED))
    clusters = max(1, min(q, sms * per_sm // cluster))
    return Plan(path="cluster" if cluster > 1 else "persistent",
                threads=THREADS,
                keys_per_thread=(-(-slice_ // THREADS) if resident
                                 else KEYS_PER_THREAD),
                cluster=cluster, clusters=clusters, grid=clusters * cluster,
                slice=slice_,
                keys_in=("registers" if resident else
                         "shared" if buffers else "device"),
                buffers=buffers, smem_bytes=smem)


def top_margin(d, margin: int):
    """The candidate stage of the plain version: the margin smallest of each
    row by (value, position), from a stable sort."""
    sd, pos = torch.sort(d, dim=1, stable=True)
    return sd[:, :margin], pos[:, :margin]


def _without_column(col: int):
    """A candidate stage that never proposes column `col` (the kernel's
    `exclude`): a planted candidate set for the proof to catch."""
    def candidates(d, margin):
        keep = torch.ones(d.shape[1], dtype=torch.bool, device=d.device)
        keep[col] = False
        cols = torch.nonzero(keep)[:, 0]
        sd, pos = top_margin(d[:, cols], margin)
        return sd, cols[pos]
    return candidates


def verified_select_plain(d, k: int, candidates=top_margin):
    """(Q, N) f32 -> ((Q, k) f32 ascending, (Q, k) int64 positions, (Q,)
    bool proof verdict). `candidates(d, margin)` returns (values, int64
    positions) of `margin` entries per row, in any order."""
    global _failed_host
    margin = margin_for(d.shape[1], k)
    cd, ci = candidates(d, margin)
    # the k best by (value, position): positions first, then a stable sort
    by_pos = torch.sort(ci, dim=1, stable=True).indices
    cd, ci = torch.gather(cd, 1, by_pos), torch.gather(ci, 1, by_pos)
    order = torch.sort(cd, dim=1, stable=True).indices[:, :k]
    sd, si = torch.gather(cd, 1, order), torch.gather(ci, 1, order)
    tau = sd[:, k - 1:k]
    ok = (d < tau).sum(1) == (sd < tau).sum(1)
    if not bool(ok.all()):
        bad = torch.nonzero(~ok)[:, 0]
        sd[bad], si[bad] = smallest_k(d[bad], k)
        _failed_host += len(bad)
    return sd, si, ok


def load_library():
    """Build (at first use) and load csrc/verified_select.cu."""
    from neighborhoodwatch_tpu_torch.utils import cuda_build
    lib = cuda_build.load("verified_select")
    if not getattr(lib, "_nw_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.verified_select_adaptive_launch.argtypes = [
            p, i, i, i, i, i, p, p, p, p, i, i, i, i, i,
            ctypes.POINTER(i), p]
        lib.verified_select_adaptive_launch.restype = i
        lib._nw_typed = True
    return lib


_sms: dict[torch.device, int] = {}


def _sm_count(device) -> int:
    n = _sms.get(device)
    if n is None:
        n = _sms[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


def _failed_counter(device) -> torch.Tensor:
    t = _failed.get(device)
    if t is None:
        t = _failed[device] = torch.zeros(1, dtype=torch.int32,
                                          device=device)
    return t


def _launch(lib, args, stream, sms: int, aligned: bool):
    """Launch the kernel with `args` (the tile's pointer, Q, N, k, margin,
    exclude, the outputs' pointers and the counter's) on its plan. A
    refused launch raises; nothing else is tried."""
    pl = plan(args[1], args[2], args[3], sms, aligned)
    active = ctypes.c_int(0)
    err = lib.verified_select_adaptive_launch(
        *args, pl.cluster, pl.clusters, pl.slice, pl.buffers,
        pl.smem_bytes, ctypes.byref(active), stream)
    verified_select.last_plan = (pl, active.value)
    if err != 0:
        raise RuntimeError(f"verified_select kernel launch failed: CUDA "
                           f"error {err}")


def verified_select(d, k: int, exclude: int = -1):
    """Per-row k smallest of a (Q, N) f32 distance tile with the count
    proof: ((Q, k) f32 ascending, (Q, k) int64 positions, (Q,) bool proof
    verdict). `exclude` >= 0 drops that column from the candidate stage
    (a planted proof failure, for the tests). CPU tensors take the plain
    version; CUDA tensors launch the kernel (and count the launch) or
    raise."""
    q_count, n = d.shape
    if not 1 <= k <= n:
        raise ValueError(f"k={k} outside [1, {n}]")
    if 0 <= exclude < n and margin_for(n, k) > n - 1:
        raise ValueError(f"exclude={exclude} leaves fewer than "
                         f"{margin_for(n, k)} candidates")
    if d.device.type == "cpu":
        cands = _without_column(exclude) if 0 <= exclude < n else top_margin
        return verified_select_plain(d, k, cands)
    if d.device.type != "cuda":
        raise ValueError(f"unsupported device {d.device}")
    if d.dtype != torch.float32 or not d.is_contiguous():
        raise ValueError(f"d: expected contiguous float32, got {d.dtype}"
                         f"{'' if d.is_contiguous() else ' (strided)'}")
    margin = margin_for(n, k)
    if margin > MAX_MARGIN:
        raise ValueError(f"k={k}: {margin} candidates exceed the kernel's "
                         f"{MAX_MARGIN}")
    dev = d.device
    plan(max(q_count, 1), n, k)     # refuses a shape even at q = 0
    out_d = torch.empty((q_count, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((q_count, k), dtype=torch.int64, device=dev)
    ok = torch.empty(q_count, dtype=torch.bool, device=dev)
    if q_count == 0:
        return out_d, out_i, ok
    failed = _failed_counter(dev)
    with torch.cuda.device(dev):
        _launch(load_library(),
                (d.data_ptr(), q_count, n, k, margin, exclude,
                 out_d.data_ptr(), out_i.data_ptr(), ok.data_ptr(),
                 failed.data_ptr()),
                torch.cuda.current_stream(dev).cuda_stream, _sm_count(dev),
                d.data_ptr() % 16 == 0)
    verified_select.launches += 1
    return out_d, out_i, ok


verified_select.launches = 0
# the last launch: (its plan, clusters the card holds at once)
verified_select.last_plan = None


def failed_rows() -> int:
    """Rows that failed the proof since the last reset, over every device
    (one device-to-host copy per card)."""
    return _failed_host + sum(int(t.item()) for t in _failed.values())


def reset_failed_rows() -> None:
    global _failed_host
    _failed_host = 0
    for t in _failed.values():
        t.zero_()
