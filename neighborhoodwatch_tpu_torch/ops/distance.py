"""Pairwise distances (counterpart of ops/distance.py).

Conventions ("smaller is better"): sqeuclidean = squared L2, euclidean =
its sqrt, cosine = 1 - cos(q, b), dot = 1 - <q, b>. Every non-finite
distance is set to +inf so garbage rows lose in every engine.

Product precision, with the TPU's meaning of the JAX package's names:
  "default": one product of bf16-rounded operands, fp32 accumulation;
  "high":    bf16x3, hi.hi + hi.lo + lo.hi with hi = bf16(x) and
             lo = bf16(x - hi), fp32 accumulation (lo.lo and the rounding
             of lo, dropped, are each at most ~2^-16 |q| |b|);
  "highest": fp32 accuracy. On the CPU fp32 products (callers run under
             resolve_device, which disables TF32). On the card, wherever
             ops/fused_core.py:split_plan takes the tile's shape, bf16x6
             as the JAX package defines "highest": each fp32 operand cut
             into three bf16 pieces, the six products of order <= 2 on the
             tensor cores, within fused_core.split_error_bound (at most
             dim 2^-24 of sum_k |q_k b_k|, an fp32 dot's budget), not bit
             for bit the fp32 product; the library's fp32 product for
             every other shape.
On the card the bf16 products are one library product of bf16 tensors
with an fp32 result (the JAX package leaves them to XLA, outside any
Pallas kernel); on the CPU the bf16-rounded operands are multiplied in
fp32, where every product is exact, so the two differ only in the order
of addition. Norms are fp32 from the fp32 inputs at every precision.

The epilogue after the product is one pass, the counterpart of the XLA
fusion around the JAX package's product: on the card the hand-written
ops/fused_core.py:distance_tile (F2), with the norms from sq_norms (F1's
norms), or, at "highest" where the split takes the tile, inside F4
(fused_core.split_distance), which writes the distances and never the
products; on the CPU their plain versions, op by op. Under a recording
profiler `tile_distance` counts its "highest" tiles by route:
`dist.split_tiles` (F4) and `dist.fp32_tiles` (the fp32 product).
"""

import torch

from neighborhoodwatch_tpu_torch.ops import fused_core
from neighborhoodwatch_tpu_torch.utils.profiling import count

METRICS = ("sqeuclidean", "euclidean", "cosine", "dot")
PRECISIONS = ("default", "high", "highest")


def _safe_normalize(x):
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.where(norm == 0.0, torch.ones_like(norm), norm)


def bf16_operands(query, base, precision: str):
    """The bf16 operands (a, b) of the product at "default" (the roundings
    of the fp32 rows) or "high" (hi, hi, lo and hi, lo, hi concatenated
    along the last axis, so a . b = hi.hi + hi.lo + lo.hi)."""
    if precision not in ("default", "high"):
        raise ValueError(f"no bf16 operands at precision {precision!r}")
    # the conversion rounds to nearest even
    a, b = query.to(torch.bfloat16), base.to(torch.bfloat16)
    if precision == "high":
        a, b = (torch.cat([a, a, (query - a.float()).to(torch.bfloat16)], -1),
                torch.cat([b, (base - b.float()).to(torch.bfloat16), b], -1))
    return a, b


def products(query, base, precision: str = "highest"):
    """(Q, d) x (B, d) -> (Q, B) fp32 dot products at `precision`."""
    if precision == "highest":
        return query @ base.T
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; must be one of "
                         f"{PRECISIONS}")
    a, b = bf16_operands(query, base, precision)
    if a.device.type == "cuda":
        return torch.mm(a, b.T, out_dtype=torch.float32)
    return a.float() @ b.float().T


def _check_metric(metric: str) -> None:
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}; must be one of "
                         f"{METRICS}")


def query_operand(query, metric: str):
    """(query rows as the products take them, their squared norms or None):
    computed once per call and shared by every tile. Cosine normalizes the
    rows; only the (sq)euclidean metrics read norms."""
    _check_metric(metric)
    query = query.float()
    if metric == "cosine":
        return _safe_normalize(query), None
    if metric in ("sqeuclidean", "euclidean"):
        return query, fused_core.sq_norms(query)
    return query, None


def base_norms(base, metric: str):
    """The base rows' squared norms where `metric` reads them, else None
    (one pass over the base per call, not one per tile)."""
    if metric in ("sqeuclidean", "euclidean"):
        return fused_core.sq_norms(base.float())
    return None


def query_pieces(q, tile, precision: str):
    """The bf16 pieces of the prepared query rows `q` (query_operand) where
    F4 takes their tiles shaped as `tile` at `precision` (on the card), else
    None: a scan cuts them once a call and passes them to each
    tile_distance."""
    if precision != "highest":
        return None
    pl = fused_core.planned_split(q, tile)
    if pl is None or pl.route != "split":
        return None
    return fused_core.split_pieces(q)


def tile_distance(q, qn, tile, bn, metric: str, precision: str = "highest",
                  lo: int = 0, hi: int | None = None, q_pieces=None):
    """(Q, T) distances of the prepared query rows `q` (query_operand)
    against the base rows `tile` (T, d) whose squared norms are `bn` (T,)
    (None: computed here; the cosine and dot metrics read none): the
    product at `precision`, then the one-pass epilogue with columns outside
    [lo, hi) masked to +inf. At "highest" on the card, F4 on the shapes
    its plan takes (product and epilogue in one kernel), on the query's
    pieces `q_pieces` where the caller has them (query_pieces)."""
    tile = tile.float()
    if metric == "cosine":
        tile = _safe_normalize(tile)
    elif bn is None:
        bn = base_norms(tile, metric)
    if precision == "highest":
        pl = fused_core.planned_split(q, tile)
        if pl is not None and pl.route == "split":
            count("dist.split_tiles", 1)
            return fused_core.split_distance(q, qn, tile, bn, metric, lo, hi,
                                             pl, q_pieces)
        count("dist.fp32_tiles", 1)
    dots = products(q, tile, precision)
    return fused_core.distance_tile(dots, qn, bn, metric, lo, hi)


def pairwise_distance(query, base, metric: str = "sqeuclidean",
                      precision: str = "highest"):
    """(Q, d) x (B, d) -> (Q, B) fp32 distance matrix; `precision` as in
    the module doc."""
    q, qn = query_operand(query, metric)
    return tile_distance(q, qn, base, None, metric, precision)


def similarity_from_distance(distance, metric: str):
    """Invert a distance back to dot/cosine similarity, where defined (the
    validators' convention); `distance` is an array or a tensor."""
    if metric == "sqeuclidean":
        return 1.0 - distance / 2.0  # valid for normalized vectors
    if metric in ("cosine", "dot"):
        return 1.0 - distance
    raise ValueError(f"no similarity inversion for metric {metric!r}")
