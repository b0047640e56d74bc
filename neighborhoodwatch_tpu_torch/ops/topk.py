"""Top-k selection and (distance, index) list merging (counterpart of
ops/topk.py).

Tie-breaking: lowest position wins, like `lax.top_k`. `torch.topk` does not
promise any order among ties, so every selection here is a stable sort
followed by a slice. Concatenating [running, new] with running entries from
earlier (smaller) base offsets therefore keeps "lowest index wins".
Indices leave as int32.
"""

import numpy as np
import torch


def smallest_k(distances, k: int):
    """Per-row k smallest of a (Q, N) matrix -> ((Q, k) dist, (Q, k) int64
    positions), ascending, ties by position."""
    d, sel = torch.sort(distances, dim=1, stable=True)
    return d[:, :k], sel[:, :k]


def merge_topk(dist_a, idx_a, dist_b, idx_b, k: int):
    """Merge two candidate lists into the k best; on ties list `a` wins."""
    cat_d = torch.cat([dist_a, dist_b], dim=1)
    cat_i = torch.cat([idx_a, idx_b], dim=1)
    d, sel = smallest_k(cat_d, k)
    return d, torch.gather(cat_i, 1, sel).to(torch.int32)


def merge_topk_many(dists, idxs, k: int):
    """(F, Q, k) lists in ascending base-offset order -> (Q, k)."""
    q = dists.shape[1]
    cat_d = dists.permute(1, 0, 2).reshape(q, -1)
    cat_i = idxs.permute(1, 0, 2).reshape(q, -1)
    d, sel = smallest_k(cat_d, k)
    return d, torch.gather(cat_i, 1, sel).to(torch.int32)


def sort_topk(dist, idx):
    """Sort a (Q, k) candidate list ascending by distance (stable)."""
    d, order = torch.sort(dist, dim=1, stable=True)
    return d, torch.gather(idx, 1, order)


def check_monotonic(dist) -> bool:
    """Host-side monotonic nondecreasing check used after merges."""
    if isinstance(dist, torch.Tensor):
        dist = dist.cpu().numpy()
    dist = np.asarray(dist)
    return bool(np.all(np.diff(dist, axis=1) >= -1e-6))
