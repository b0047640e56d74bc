"""Share of the card's busy time in the encoder's fused passes E1-E3
(csrc/embed_layernorm.cu, add_layernorm.cu, masked_softmax.cu). Split by
the end-to-end metric it moves: `fused_pass_share` (sentences),
`fused_pass_share.passages`."""

UNIT = "%"
NAMES = ("embed_layernorm", "add_layernorm", "masked_softmax")


def read(rec):
    tr = rec["trace"]
    if rec["driver"] != "encode" or tr.busy_s <= 0:
        return None
    spent = tr.kernel_seconds(lambda n: any(k in n for k in NAMES))
    return 100.0 * spent / tr.busy_s if spent > 0 else None
