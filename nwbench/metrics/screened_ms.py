"""Device milliseconds a kNN call spends on the screened path: the screen
K1, the select (F3, the top-m, the certificate) and the class-A repair,
the program's spans `knn.screen`, `knn.select` and `knn.repair_a`
(ops/knn.py:screened_knn_traced, CUDA events around each), over the calls
(`knn.screened`) in the traced window. Where the whole batch falls back,
this work is thrown away."""

from nwbench import program_records

UNIT = "ms"


def read(rec):
    return program_records.device_ms_a_call(
        rec, ("knn.screen", "knn.select", "knn.repair_a"))
