"""Share of the traced window in which no kernel, copy or memset ran on
the card: where the host (the kNN engine's Python between its syncs, the
readback; the encoder's tokenizing, padding and launching) keeps the card
waiting. One quantity, split by the end-to-end metric it moves:
`idle_share.knn`, `idle_share.encode`, `idle_share.passages`."""

UNIT = "%"


def read(rec):
    tr = rec["trace"]
    if tr.busy_s <= 0 or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
