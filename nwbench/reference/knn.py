"""Plain references of exact k nearest neighbours under squared Euclidean
distance, and the numbers that judge a served answer by them.

`exact_kth` and `pair_distances` work in float64, a block of base rows at
a time, so their own rounding is far below float32's. `tf32_knn` is the
control: the same brute force with its products taken from operands
rounded to TF32 (10 mantissa bits), as a tensor core's TF32 mode takes
them, accumulated in float32.
"""

import torch

BLOCK_ROWS = 65536


def _plain_matmuls():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def exact_kth(queries, base, k: int, block_rows: int = BLOCK_ROWS):
    """(N,) float64: each query's k-th smallest squared distance to the
    base rows."""
    _plain_matmuls()
    q = queries.double()
    qn = (q * q).sum(1)
    best = None
    for s in range(0, base.shape[0], block_rows):
        b = base[s:s + block_rows].double()
        d = qn[:, None] + (b * b).sum(1)[None, :] - 2.0 * (q @ b.T)
        if best is not None:
            d = torch.cat([best, d], dim=1)
        best = torch.topk(d, k, dim=1, largest=False, sorted=True).values
    return best[:, k - 1]


def pair_distances(queries, base, ids, block: int = 64):
    """(N, k) float64 squared distances of queries[t] to base[ids[t]], each
    the sum of its own squared differences; ids outside the base read
    +inf."""
    out = torch.empty(ids.shape, dtype=torch.float64, device=queries.device)
    n_base = base.shape[0]
    for s in range(0, ids.shape[0], block):
        i = ids[s:s + block].long()
        valid = (i >= 0) & (i < n_base)
        rows = base[i.clamp(0, n_base - 1)].double()
        diff = rows - queries[s:s + block, None, :].double()
        d = (diff * diff).sum(-1)
        out[s:s + block] = torch.where(valid, d, torch.inf)
    return out


def round_tf32(x):
    """float32 -> the nearest TF32 value (10 mantissa bits, ties to even),
    kept in float32."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def tf32_knn(queries, base, k: int, block_rows: int = BLOCK_ROWS):
    """The control: ((N, k) float32 distances, (N, k) int64 ids) of a brute
    force whose products run in TF32."""
    _plain_matmuls()
    q = queries.float()
    qn = (q * q).sum(1)
    qt = round_tf32(q)
    best_d = best_i = None
    for s in range(0, base.shape[0], block_rows):
        b = base[s:s + block_rows].float()
        d = qn[:, None] + (b * b).sum(1)[None, :] - 2.0 * (qt @ round_tf32(b).T)
        i = torch.arange(s, s + b.shape[0], device=q.device).expand_as(d)
        if best_d is not None:
            d = torch.cat([best_d, d], dim=1)
            i = torch.cat([best_i, i], dim=1)
        best_d, pos = torch.topk(d, k, dim=1, largest=False, sorted=True)
        best_i = torch.gather(i, 1, pos)
    return best_d.clamp_min(0.0), best_i


def judge(queries, base, dist, ids, k: int) -> dict:
    """The numbers that decide a kNN answer, for N sampled queries and the
    (N, k) distances and ids served for them:
      dist_err   largest |served distance - float64 distance of its id|;
      excess     largest amount by which a served id's float64 distance
                 passes the query's true k-th distance (0 for an exact
                 answer up to the served distances' own rounding);
      bad_rows   rows with an id outside the base, an id twice, a distance
                 that is not finite, or distances out of ascending order.
    """
    dist = dist.to(queries.device).double()
    ids = ids.to(queries.device).long()
    n_base = base.shape[0]
    ref = pair_distances(queries, base, ids)
    kth = exact_kth(queries, base, k)
    sorted_ids = torch.sort(ids, dim=1).values
    bad = ((ids < 0) | (ids >= n_base)).any(1) \
        | (sorted_ids[:, 1:] == sorted_ids[:, :-1]).any(1) \
        | ~torch.isfinite(dist).all(1) \
        | (dist[:, 1:] < dist[:, :-1]).any(1)
    ok = ~bad
    gap = (dist - ref).abs()[ok]
    over = (ref - kth[:, None])[ok]
    return {
        "dist_err": float(gap.max()) if gap.numel() else 0.0,
        "excess": max(0.0, float(over.max())) if over.numel() else 0.0,
        "bad_rows": int(bad.sum()),
    }
