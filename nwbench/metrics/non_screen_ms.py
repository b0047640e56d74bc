"""Device milliseconds a kNN call spends in every kernel other than the
screen K1: the base's preparation (F1), the select and re-rank (F3, K7),
the repairs and any exact fallback (cuBLAS products, F2, K7)."""

UNIT = "ms"


def read(rec):
    c, tr = rec["counters"], rec["trace"]
    if rec["driver"] != "knn" or not c["calls"] or not tr.kernels:
        return None
    other = tr.kernel_seconds(lambda n: "screen_keys" not in n)
    return 1e3 * other / c["calls"]
