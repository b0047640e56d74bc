"""The decoder embedder's whole step against the card's bf16 peak: the
model FLOPs of the real (unpadded) tokens served in the traced window,
each text at its own length (the projections and MLP, 13.96 GFLOP a
token at e5-mistral's widths, plus its causal attention), over the
window's seconds at 989 TFLOP/s (decoder_yardstick.py)."""

from nwbench import decoder_yardstick

UNIT = "%"


def read(rec):
    c = rec["counters"]
    if rec["driver"] != "encode_decoder" or not len(c["tokens"]) \
            or not rec["trace"].kernels:
        return None
    flops = decoder_yardstick.text_flops(rec["config"], c["tokens"])
    return 100.0 * flops / (rec["window_s"]
                            * decoder_yardstick.PEAK_BF16_FLOPS)
