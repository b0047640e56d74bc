"""The whole encoder step's share of the card's bf16 peak: the model FLOPs
of the real (unpadded) tokens served in the traced window, each text at
its own length, over the window's seconds at 989 TFLOP/s. Split by the
end-to-end metric it moves: `encoder_mfu` (sentences),
`encoder_mfu.passages`."""

from nwbench import yardstick

UNIT = "%"


def read(rec):
    c, cfg = rec["counters"], rec["config"]
    if rec["driver"] != "encode" or not len(c["tokens"]) \
            or not rec["trace"].kernels:
        return None
    flops = yardstick.text_flops(cfg["hidden_size"], cfg["intermediate_size"],
                                 cfg["num_hidden_layers"], c["tokens"])
    return 100.0 * flops / (rec["window_s"] * yardstick.PEAK_BF16_FLOPS)
