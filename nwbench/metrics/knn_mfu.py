"""The whole kNN call's share of the card's bf16 peak: one product of
every query with every base row (2 Q B D FLOPs) a call, over the traced
window's seconds at 989 TFLOP/s. The step's share beside the screen's
roofline: a kernel taken off the path leaves its roofline silent, and
this still bounds the call."""

from nwbench import yardstick

UNIT = "%"


def read(rec):
    c = rec["counters"]
    if rec["driver"] != "knn" or not c["calls"] or not rec["trace"].kernels:
        return None
    flops = c["calls"] * yardstick.knn_flops(c["queries"], c["base_rows"],
                                             c["dim"])
    return 100.0 * flops / (rec["window_s"] * yardstick.PEAK_BF16_FLOPS)
