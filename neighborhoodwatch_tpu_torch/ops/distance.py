"""Pairwise distances (counterpart of ops/distance.py).

Conventions ("smaller is better"): sqeuclidean = squared L2, euclidean =
its sqrt, cosine = 1 - cos(q, b), dot = 1 - <q, b>. Every non-finite
distance is set to +inf so garbage rows lose in every engine.

Product precision, with the TPU's meaning of the JAX package's names:
  "default": one product of bf16-rounded operands, fp32 accumulation;
  "high":    bf16x3, hi.hi + hi.lo + lo.hi with hi = bf16(x) and
             lo = bf16(x - hi), fp32 accumulation (lo.lo and the rounding
             of lo, dropped, are each at most ~2^-16 |q| |b|);
  "highest": fp32 (callers run under resolve_device, which disables TF32).
On the card the bf16 products are one library product of bf16 tensors
with an fp32 result (the JAX package leaves them to XLA, outside any
Pallas kernel); on the CPU the bf16-rounded operands are multiplied in
fp32, where every product is exact, so the two differ only in the order
of addition. Norms are fp32 from the fp32 inputs at every precision.
"""

import torch

METRICS = ("sqeuclidean", "euclidean", "cosine", "dot")
PRECISIONS = ("default", "high", "highest")


def _safe_normalize(x):
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.where(norm == 0.0, torch.ones_like(norm), norm)


def products(query, base, precision: str = "highest"):
    """(Q, d) x (B, d) -> (Q, B) fp32 dot products at `precision`."""
    if precision == "highest":
        return query @ base.T
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; must be one of "
                         f"{PRECISIONS}")
    # the conversion rounds to nearest even
    a, b = query.to(torch.bfloat16), base.to(torch.bfloat16)
    if precision == "high":
        a, b = (torch.cat([a, a, (query - a.float()).to(torch.bfloat16)], 1),
                torch.cat([b, (base - b.float()).to(torch.bfloat16), b], 1))
    if a.device.type == "cuda":
        return torch.mm(a, b.T, out_dtype=torch.float32)
    return a.float() @ b.float().T


def pairwise_distance(query, base, metric: str = "sqeuclidean",
                      precision: str = "highest"):
    """(Q, d) x (B, d) -> (Q, B) fp32 distance matrix; `precision` as in
    the module doc."""
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}; must be one of "
                         f"{METRICS}")
    query = query.float()
    base = base.float()
    if metric == "cosine":
        query = _safe_normalize(query)
        base = _safe_normalize(base)
    dots = products(query, base, precision)
    if metric in ("sqeuclidean", "euclidean"):
        qn = (query * query).sum(1, keepdim=True)
        bn = (base * base).sum(1, keepdim=True)
        d = torch.clamp_min(qn + bn.T - 2.0 * dots, 0.0)
        if metric == "euclidean":
            d = torch.sqrt(d)
    else:
        d = 1.0 - dots
    return torch.where(torch.isfinite(d), d, torch.full_like(d, float("inf")))


def similarity_from_distance(distance, metric: str):
    """Invert a distance back to dot/cosine similarity, where defined (the
    validators' convention); `distance` is an array or a tensor."""
    if metric == "sqeuclidean":
        return 1.0 - distance / 2.0  # valid for normalized vectors
    if metric in ("cosine", "dot"):
        return 1.0 - distance
    raise ValueError(f"no similarity inversion for metric {metric!r}")
