"""Share of the queries that the kNN engine's certificate proves with no
repair: neither a class-A nor a class-B repair, a whole-batch
recomputation counting every query of its call as failed. Read from the
engine's own (class A, class B, whole batch) diagnostics of every call in
the window."""

UNIT = "%"


def read(rec):
    c = rec["counters"]
    if rec["driver"] != "knn" or not c.get("repairs"):
        return None
    q = c["queries"]
    failed = sum(q if whole else a + b for a, b, whole in c["repairs"])
    return 100.0 * (1.0 - failed / (q * len(c["repairs"])))
