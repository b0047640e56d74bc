"""The screen kernel K1 (csrc/screen_keys.cu) against its roofline: the
least time of each call's screen (one bf16 product at the tensor-core
peak, or its operands read and keys written once at the HBM rate, the
larger) over the K1 kernels' device time in the trace."""

from nwbench import yardstick

UNIT = "%"


def is_screen(name: str) -> bool:
    return "screen_keys" in name


def read(rec):
    c, tr = rec["counters"], rec["trace"]
    if rec["driver"] != "knn" or not c["calls"]:
        return None
    spent = tr.kernel_seconds(is_screen)
    if spent <= 0:
        return None
    bound = yardstick.screen_bound_s(c["queries"], c["base_rows"], c["dim"])
    return 100.0 * bound * c["calls"] / spent
