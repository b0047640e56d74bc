"""Post-generation validators over the written fvec/ivec files
(counterpart of validate.py; the MaxSim validator is not ported yet).

- v0: for every query, recompute similarities against the indexed base
  vectors and check the raft metric convention `1 - sim == distance / 2`
  (reference :373): three bulk fvec reads + one batched float64 product
  on the device.
- v1: additionally checks per-row monotonic nondecreasing distances
  (reference :419-421) and the cosine convention `1-sim == 1-distance`
  with atol 1e-4 (reference :417,:425); on mismatch, cross-checks with
  independent engines (full kNN recompute + pairwise distance) like the
  reference's 4-engine fallback (:427-466).

Both skip zero query vectors (failed-embedding sentinels, reference
:363-366) and report mismatch counts.
"""

import numpy as np
import torch

from neighborhoodwatch_tpu_torch import resolve_device
from neighborhoodwatch_tpu_torch.io import fvec
from neighborhoodwatch_tpu_torch.ops.distance import pairwise_distance
from neighborhoodwatch_tpu_torch.ops.knn import knn


def _read(data_dir, filename):
    from neighborhoodwatch_tpu_torch.utils.naming import get_full_filename
    return fvec.read_vectors(get_full_filename(data_dir, filename))


# above this base row count the validators gather only the referenced rows
# (one sequential chunked scan) instead of loading the whole base fvec —
# the 10M x 1536 target would otherwise need 61GB of host memory
_SELECTED_READ_ROWS = 1 << 19


def _base_neighbor_vectors(data_dir, base_fvec, indices):
    """(Q, k, d) base vectors for every index; the full base matrix too
    when it is small enough to keep (else None)."""
    from neighborhoodwatch_tpu_torch.utils.naming import get_full_filename
    n = fvec.count_vectors(data_dir, base_fvec)
    if n > _SELECTED_READ_ROWS:
        full = get_full_filename(data_dir, base_fvec)
        return fvec.read_selected(full, indices), None
    base = _read(data_dir, base_fvec)
    return base[indices], base


def _gathered_similarities(queries, neighbors, device, batch=1024):
    """sim[q, j] = <queries[q], neighbors[q, j]> in float64 on `device`,
    in query batches."""
    out = np.empty(neighbors.shape[:2], dtype=np.float32)
    for s in range(0, len(queries), batch):
        qb = torch.from_numpy(queries[s:s + batch]).to(device, torch.float64)
        nb = torch.from_numpy(neighbors[s:s + batch]).to(device,
                                                         torch.float64)
        out[s:s + batch] = torch.bmm(nb, qb[:, :, None])[:, :, 0] \
            .float().cpu().numpy()
    return out


def _expected_one_minus_sim(distances, metric):
    """Map a written distance back to the `1 - similarity` value each
    metric convention implies (on normalized vectors): raft sqeuclidean
    d == 2(1-sim) (reference parquet_to_format.py:373), euclidean is its
    sqrt, cosine/dot d == 1-sim (reference :417,:425)."""
    if metric == "sqeuclidean":
        return distances / 2.0
    if metric == "euclidean":
        return np.square(distances.astype(np.float64)) / 2.0
    if metric in ("cosine", "dot"):
        return distances
    raise ValueError(f"no validation convention for metric {metric!r}")


def validate_files_v0(data_dir, query_vector_fvec, base_vector_fvec,
                      indices_ivec, distances_fvec, atol=1e-4,
                      metric="sqeuclidean", device=None) -> int:
    """Recompute similarities and check the metric's distance convention
    (reference: parquet_to_format.py:351-383, raft `1-sim == d/2`; here
    dispatched on the generation metric). Returns mismatch count."""
    dev = resolve_device(device)
    queries = _read(data_dir, query_vector_fvec)
    indices = _read(data_dir, indices_ivec).astype(np.int64)
    distances = _read(data_dir, distances_fvec)
    neighbors, _ = _base_neighbor_vectors(data_dir, base_vector_fvec, indices)

    nonzero = np.any(queries != 0, axis=1)
    skipped = int((~nonzero).sum())
    if skipped:
        print(f"Skipping {skipped} zero query vectors")

    sims = _gathered_similarities(queries, neighbors, dev)
    expected = _expected_one_minus_sim(distances, metric)
    mismatch = ~np.isclose(1.0 - sims, expected, atol=atol)
    mismatch &= nonzero[:, None]
    total_mismatch = int(mismatch.sum())
    for qi, col in zip(*np.nonzero(mismatch)):
        if total_mismatch <= 20 or col == 0:
            print(f"Expected '1 - similarity' ({1 - sims[qi, col]}) equal to "
                  f"{metric}-implied value ({expected[qi, col]}) for query "
                  f"vector {qi} and base vector {indices[qi, col]}")
    print(f"Total mismatch count: {total_mismatch}")
    return total_mismatch


def _numpy_knn_f64(queries, base, k, metric):
    """Third independent engine: float64 numpy brute force — shares no code
    with the PyTorch engines (analog of the reference's torch matmul/topk
    fallback, parquet_to_format.py:460-466)."""
    q = np.asarray(queries, dtype=np.float64)
    b = np.asarray(base, dtype=np.float64)
    if metric == "cosine":
        q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-30)
        b = b / np.maximum(np.linalg.norm(b, axis=1, keepdims=True), 1e-30)
    dots = q @ b.T
    if metric in ("sqeuclidean", "euclidean"):
        d = np.maximum((q * q).sum(1)[:, None] + (b * b).sum(1)[None, :]
                       - 2.0 * dots, 0.0)
        if metric == "euclidean":
            d = np.sqrt(d)
    else:
        d = 1.0 - dots
    idx = np.argsort(d, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(d, idx, axis=1), idx


def validate_files(data_dir, query_vector_fvec, base_vector_fvec, indices_ivec,
                   distances_fvec, atol=1e-4, metric="cosine",
                   device=None) -> int:
    """Metric-convention check + monotonicity + FOUR-engine independent
    cross-check on mismatch (reference: parquet_to_format.py:386-491,
    whose mismatch escalation runs 4 engines :427-466). The four labeled
    counterparts here: exact device rebuild (engine="exact", full fp32),
    screened device engine (engine="screened" — the screen kernel plus the
    certified re-rank, a different device code path; it stands in for the
    JAX package's approximate-min-k "verified" engine, which rests on a
    TPU operation), float64 numpy brute force (host, no torch), and
    pairwise distance on the mismatching neighbor vectors.
    Returns mismatch count."""
    dev = resolve_device(device)
    queries = _read(data_dir, query_vector_fvec)
    indices = _read(data_dir, indices_ivec).astype(np.int64)
    distances = _read(data_dir, distances_fvec)
    neighbors, base = _base_neighbor_vectors(data_dir, base_vector_fvec,
                                             indices)

    nonzero = np.any(queries != 0, axis=1)

    # per-row monotonic nondecreasing distances (reference :419-421)
    mono_viol = np.diff(distances, axis=1) < -1e-6
    assert not mono_viol[nonzero].any(), \
        f"distances not monotonically nondecreasing for rows {np.nonzero(mono_viol.any(1))[0][:10]}"

    sims = _gathered_similarities(queries, neighbors, dev)
    expected = _expected_one_minus_sim(distances, metric)
    mismatch = ~np.isclose(1.0 - sims, expected, atol=atol)
    mismatch &= nonzero[:, None]
    total_mismatch = int(mismatch.sum())

    if total_mismatch:
        # FOUR independent mismatch cross-check engines, labeled — full
        # parity with the reference's 4-engine escalation
        # (parquet_to_format.py:427-466):
        #   1/4 exact device rebuild (fp32 matmul + stable top-k)
        #                              ≙ cuvs full-corpus rebuild :435-449
        #   2/4 screened device engine (screen kernel + certificate
        #       — a DIFFERENT device selection path)
        #                              ≙ cuvs single-vector :450-456
        #   3/4 float64 numpy brute force (host, shares no code with the
        #       PyTorch engines)       ≙ torch matmul/topk :460-466
        #   4/4 pairwise distance on the mismatching neighbor vectors
        #                              ≙ cuvs pairwise_distance :427-433
        bad_rows = np.unique(np.nonzero(mismatch)[0])[:8]
        k = indices.shape[1]
        if base is not None:
            ex_d, _ = knn(queries[bad_rows], base, k=k, metric=metric,
                          engine="exact", precision="highest", device=dev)
            ex_d = ex_d.cpu().numpy()
            sc_d, _ = knn(queries[bad_rows], base, k=k, metric=metric,
                          engine="screened", device=dev)
            sc_d = sc_d.cpu().numpy()
            np_d, _ = _numpy_knn_f64(queries[bad_rows], base, k, metric)
        else:   # base too large to re-rank fully; pairwise check only
            ex_d = sc_d = np_d = None
        for r, qi in enumerate(bad_rows):
            pw = pairwise_distance(
                torch.from_numpy(queries[qi:qi + 1]).to(dev),
                torch.from_numpy(neighbors[qi][mismatch[qi]][:4]).to(dev),
                metric=metric).cpu().numpy()
            exact = ex_d[r][:5] if ex_d is not None else "(skipped)"
            screened = sc_d[r][:5] if sc_d is not None else "(skipped)"
            numpy64 = np_d[r][:5] if np_d is not None else "(skipped)"
            print(f"query {qi} vs file {distances[qi][:5]}: "
                  f"[1/4 exact-device] {exact}; "
                  f"[2/4 screened-device] {screened}; "
                  f"[3/4 float64-numpy] {numpy64}; "
                  f"[4/4 pairwise] {pw[0]}")
    print(f"Total mismatch count: {total_mismatch}")
    return total_mismatch
