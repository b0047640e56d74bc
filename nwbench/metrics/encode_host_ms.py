"""Host milliseconds of one 64-text chunk of the encoder: tokenizing,
padding, pinning, the copies and the clone issued, from the program's
span `e5.chunk` (models/e5.py), less the graph's launch call
(`graph.launch`, models/graphed.py), in which the host waits for room in
the card's launch queue once it runs ahead of the card; host seconds
over the chunks in the traced window. Split by the end-to-end metric it
moves: `encode_host_ms` (sentences), `encode_host_ms.passages`."""

from nwbench import program_records

UNIT = "ms"


def read(rec):
    got = program_records.of_driver(rec, "encode")
    if not got:
        return None
    spans = got["spans"]
    chunk = spans.get("e5.chunk")
    if not chunk or not chunk["count"]:
        return None
    launch = spans.get("graph.launch", {}).get("host_s", 0.0)
    return 1e3 * (chunk["host_s"] - launch) / chunk["count"]
