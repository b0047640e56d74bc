"""The program's own spans and counters of the traced window, for the
per-layer readers that read them: `records()` of the port's
utils/profiling.py, or None where the program keeps none (a port without
`records`).

A reader reads them only in a run on the card (a trace with kernels in
it), as the readers of the device trace do.
"""

import importlib


def records():
    try:
        profiling = importlib.import_module(
            "neighborhoodwatch_tpu_torch.utils.profiling")
    except ImportError:
        return None
    read = getattr(profiling, "records", None)
    return read() if read is not None else None


def of_driver(rec, driver: str):
    """The program's records where the run is of `driver` on the card,
    else None."""
    if rec["driver"] != driver or not rec["trace"].kernels:
        return None
    return records()


def device_ms_a_call(rec, stages) -> float | None:
    """Device milliseconds of the `stages` spans (those absent count 0)
    per `knn.screened` call, or None where no call was recorded or the
    spans hold no device time."""
    got = of_driver(rec, "knn")
    if not got:
        return None
    spans = got["spans"]
    calls = spans.get("knn.screened", {}).get("count", 0)
    if not calls:
        return None
    total = 0.0
    for name in stages:
        s = spans.get(name)
        if s is None:
            continue
        if s["device_s"] is None:
            return None
        total += s["device_s"]
    return 1e3 * total / calls
