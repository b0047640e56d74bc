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
hand-written Hopper kernel in csrc/verified_select.cu (one block a row,
radix select + ordered compaction + bitonic sort + proof + fallback in one
launch, no host sync) and counts the launch; on CPU tensors it runs
`verified_select_plain`, the same three stages in PyTorch, whose candidate
stage a test can replace. Rows that failed the proof are added to a
counter per device (a device tensor for the kernel), read by
`failed_rows()`: the engines never read it, so they add no host sync.
"""

import ctypes

import torch

from neighborhoodwatch_tpu_torch.ops.topk import smallest_k

# candidates the kernel sorts in shared memory (margin <= this, k <= 6553)
MAX_MARGIN = 8192

_failed: dict[torch.device, torch.Tensor] = {}
_failed_host = 0


def margin_for(n: int, k: int) -> int:
    """Candidates per row: k + 28 or 5k/4, whichever is larger, at most n
    (the JAX function's margin)."""
    return min(n, max(k + 28, (k * 5) // 4))


def supports(n: int, k: int) -> bool:
    """Whether the kernel takes a row of n entries at this k."""
    return 1 <= k <= n and margin_for(n, k) <= MAX_MARGIN


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
        lib.verified_select_launch.argtypes = [p, i, i, i, i, i, p, p, p, p,
                                               p]
        lib.verified_select_launch.restype = i
        lib._nw_typed = True
    return lib


def _failed_counter(device) -> torch.Tensor:
    t = _failed.get(device)
    if t is None:
        t = _failed[device] = torch.zeros(1, dtype=torch.int32,
                                          device=device)
    return t


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
    out_d = torch.empty((q_count, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((q_count, k), dtype=torch.int64, device=dev)
    ok = torch.empty(q_count, dtype=torch.bool, device=dev)
    failed = _failed_counter(dev)
    with torch.cuda.device(dev):
        err = load_library().verified_select_launch(
            d.data_ptr(), q_count, n, k, margin, exclude, out_d.data_ptr(),
            out_i.data_ptr(), ok.data_ptr(), failed.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"verified_select kernel launch failed: CUDA "
                           f"error {err}")
    verified_select.launches += 1
    return out_d, out_i, ok


verified_select.launches = 0


def failed_rows() -> int:
    """Rows that failed the proof since the last reset, over every device
    (one device-to-host copy per card)."""
    return _failed_host + sum(int(t.item()) for t in _failed.values())


def reset_failed_rows() -> None:
    global _failed_host
    _failed_host = 0
    for t in _failed.values():
        t.zero_()
