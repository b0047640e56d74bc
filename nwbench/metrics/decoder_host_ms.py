"""Host milliseconds of one 64-text chunk of the decoder embedder:
tokenizing with BOS and EOS, padding, pinning, the copies and the clone
issued, from the program's span `e5.chunk`
(models/e5.py), less the graph's launch call (`graph.launch`,
models/graphed.py), in which the host waits for room in the card's
launch queue once it runs ahead of the card; host seconds over the
chunks in the traced window of the `encode_decoder` driver's run
(metrics/encode_host_ms.py reads the `encode` driver's)."""

from nwbench import program_records

UNIT = "ms"


def read(rec):
    got = program_records.of_driver(rec, "encode_decoder")
    if not got:
        return None
    spans = got["spans"]
    chunk = spans.get("e5.chunk")
    if not chunk or not chunk["count"]:
        return None
    launch = spans.get("graph.launch", {}).get("host_s", 0.0)
    return 1e3 * (chunk["host_s"] - launch) / chunk["count"]
