"""Share of the token slots the encoder's forwards compute that are
padding: 100 x (1 - real tokens / rows x bucket) over every forward issued
in the traced window, the pad rows of each call's ragged last chunk
counted as slots. Read from the program's counters `graph.tokens` and
`graph.token_slots` (models/graphed.py). Split by the end-to-end metric it
moves: `pad_share` (sentences), `pad_share.passages`."""

from nwbench import program_records

UNIT = "%"


def read(rec):
    got = program_records.of_driver(rec, "encode")
    if not got:
        return None
    c = got["counters"]
    slots = c.get("graph.token_slots", 0)
    if not slots:
        return None
    return 100.0 * (1.0 - c.get("graph.tokens", 0) / slots)
