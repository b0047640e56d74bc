"""K6's causal grouped-query mode (csrc/masked_attention.cu) against its
roofline in the decoder embedder's cell: the least time of the causal
products of every forward the driver issued in the traced window (its
rows x bucket, worked out from the served texts' lengths:
decoder_yardstick.causal_attn_bound_s) over the device time of the K6
kernels in the trace. Read only where the program counted one causal
launch a layer a forward (`attn.causal_launches`), so that the kernels
timed are the causal ones the bound counts."""

from nwbench import decoder_yardstick, program_records

UNIT = "%"


def is_attention(name: str) -> bool:
    return "masked_attention" in name


def read(rec):
    got = program_records.of_driver(rec, "encode_decoder")
    c, cfg = rec["counters"], rec["config"]
    if not got or not c["forwards"]:
        return None
    layers = cfg["num_hidden_layers"]
    launches = got["counters"].get("attn.causal_launches", 0)
    if launches != layers * len(c["forwards"]):
        return None
    spent = rec["trace"].kernel_seconds(is_attention)
    if spent <= 0:
        return None
    bound = sum(decoder_yardstick.causal_attn_bound_s(cfg, rows, seq)
                for rows, seq in c["forwards"])
    return 100.0 * bound / spent
