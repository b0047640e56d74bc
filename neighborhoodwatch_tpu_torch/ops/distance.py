"""Pairwise distances in full fp32 (counterpart of ops/distance.py).

Conventions ("smaller is better"): sqeuclidean = squared L2, euclidean =
its sqrt, cosine = 1 - cos(q, b), dot = 1 - <q, b>. Every non-finite
distance is set to +inf so garbage rows lose in every engine.
"""

import torch

METRICS = ("sqeuclidean", "euclidean", "cosine", "dot")


def _safe_normalize(x):
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.where(norm == 0.0, torch.ones_like(norm), norm)


def pairwise_distance(query, base, metric: str = "sqeuclidean"):
    """(Q, d) x (B, d) -> (Q, B) fp32 distance matrix (full-fp32 matmul:
    callers run under resolve_device, which disables TF32)."""
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}; must be one of "
                         f"{METRICS}")
    query = query.float()
    base = base.float()
    if metric == "cosine":
        query = _safe_normalize(query)
        base = _safe_normalize(base)
    dots = query @ base.T
    if metric in ("sqeuclidean", "euclidean"):
        qn = (query * query).sum(1, keepdim=True)
        bn = (base * base).sum(1, keepdim=True)
        d = torch.clamp_min(qn + bn.T - 2.0 * dots, 0.0)
        if metric == "euclidean":
            d = torch.sqrt(d)
    else:
        d = 1.0 - dots
    return torch.where(torch.isfinite(d), d, torch.full_like(d, float("inf")))
