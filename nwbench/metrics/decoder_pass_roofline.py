"""The decoder embedder's three row passes (csrc/decoder_passes.cu: the
add-and-RMSNorm, RoPE and SwiGLU kernels) against their roofline: the
bytes of every forward the driver issued in the traced window, each
operand read once and written once at the forward's rows x bucket slots
(decoder_yardstick.pass_bytes), at 3.35 TB/s, over those kernels'
device time in the trace. Read only where the program counted a
decoder forward for each the driver issued (`decoder.forwards`)."""

from nwbench import decoder_yardstick, program_records

UNIT = "%"
NAMES = ("add_rmsnorm_kernel", "rope_kernel", "swiglu_kernel")


def is_pass(name: str) -> bool:
    return any(k in name for k in NAMES)


def read(rec):
    got = program_records.of_driver(rec, "encode_decoder")
    c, cfg = rec["counters"], rec["config"]
    if not got or not c["forwards"]:
        return None
    if got["counters"].get("decoder.forwards", 0) != len(c["forwards"]):
        return None
    spent = rec["trace"].kernel_seconds(is_pass)
    if spent <= 0:
        return None
    bound = sum(decoder_yardstick.pass_bound_s(cfg, rows, seq)
                for rows, seq in c["forwards"])
    return 100.0 * bound / spent
