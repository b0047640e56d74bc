"""Device milliseconds a kNN call spends in exact rescans: the whole
batch's fallback and the class-B rescan within its budget, the program's
spans `knn.fallback` and `knn.repair_b` (ops/knn.py:screened_knn_traced,
CUDA events around each), over the calls (`knn.screened`) in the traced
window; 0 where no call rescanned."""

from nwbench import program_records

UNIT = "ms"


def read(rec):
    return program_records.device_ms_a_call(
        rec, ("knn.fallback", "knn.repair_b"))
