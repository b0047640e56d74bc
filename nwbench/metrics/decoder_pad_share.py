"""Share of the token slots the decoder embedder's forwards compute that
are padding: 100 x (1 - real tokens / rows x bucket) over every forward
issued in the traced window, from the program's counters `graph.tokens`
and `graph.token_slots` (models/graphed.py) of the `encode_decoder`
driver's run (metrics/pad_share.py reads the `encode` driver's)."""

from nwbench import program_records

UNIT = "%"


def read(rec):
    got = program_records.of_driver(rec, "encode_decoder")
    if not got:
        return None
    c = got["counters"]
    slots = c.get("graph.token_slots", 0)
    if not slots:
        return None
    return 100.0 * (1.0 - c.get("graph.tokens", 0) / slots)
