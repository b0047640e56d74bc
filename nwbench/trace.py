"""The traced run's records: a torch.profiler trace (CUPTI on the card) of
the measured window, reduced to what the per-layer readers and the
result's `device` and `breakdown` need.

The harness marks its own spans with record_function; the window is the
span `nwbench.window`. Device time is every kernel, copy and memset in
it; busy time is their union; an idle gap is a stretch of the window with
none of them, labelled by the harness span and the innermost host
operation that were open at its middle.
"""

import contextlib
import heapq
import json
import os
import tempfile

import torch

WINDOW = "nwbench.window"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
TOP = 10


def span(name: str, on: bool):
    """A harness span, recorded only in a traced run."""
    return torch.profiler.record_function(name) if on \
        else contextlib.nullcontext()


@contextlib.contextmanager
def profiled(on: bool, holder: dict):
    """Profile the region when `on`; on exit put its Summary under
    holder["trace"]."""
    if not on:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    holder["trace"] = Summary(events)


def _union(intervals):
    """(total length, merged intervals) of a set of intervals."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), merged


def _innermost(events, points):
    """For each point (ascending), the name of the innermost event open at
    it (the open one that started last), or None."""
    events = sorted(events)
    out, heap, j = [], [], 0
    for p in points:
        while j < len(events) and events[j][0] <= p:
            a, b, name = events[j]
            heapq.heappush(heap, (-a, b, name))
            j += 1
        while heap and heap[0][1] <= p:
            heapq.heappop(heap)
        out.append(heap[0][2] if heap else None)
    return out


class Summary:
    """Kernels, busy and window seconds, top device operations and idle
    gaps of one profiled window (times in seconds)."""

    def __init__(self, events):
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        win = [e for e in xs if e.get("name") == WINDOW
               and e.get("cat") == "user_annotation"]
        if win:
            w0 = float(win[0]["ts"])
            w1 = w0 + float(win[0]["dur"])
        else:
            w0 = min((float(e["ts"]) for e in xs), default=0.0)
            w1 = max((float(e["ts"]) + float(e["dur"]) for e in xs),
                     default=0.0)
        self.window_s = (w1 - w0) * 1e-6
        dev = []
        for e in xs:
            if e.get("cat") not in _DEVICE_CATS:
                continue
            a = max(float(e["ts"]), w0)
            b = min(float(e["ts"]) + float(e["dur"]), w1)
            if b > a:
                dev.append((a, b, e["name"], e.get("cat")))
        # (name, seconds) of every kernel in the window
        self.kernels = [(n, (b - a) * 1e-6) for a, b, n, c in dev
                        if c == "kernel"]
        busy, merged = _union([(a, b) for a, b, _, _ in dev])
        self.busy_s = busy * 1e-6
        by_name = {}
        for a, b, n, _ in dev:
            by_name[n] = by_name.get(n, 0.0) + (b - a) * 1e-6
        self.device_ops = sorted(by_name.items(), key=lambda x: -x[1])[:TOP]
        gaps, t = [], w0
        for a, b in merged:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if w1 > t:
            gaps.append((t, w1))
        mids = sorted(((a + b) / 2, b - a) for a, b in gaps)
        spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                  e["name"]) for e in xs if e.get("cat") == "user_annotation"
                 and e["name"].startswith("nwbench.")
                 and e["name"] != WINDOW]
        ops = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
               for e in xs if e.get("cat") in _HOST_CATS]
        points = [m for m, _ in mids]
        labels = {}
        for (m, d), s, o in zip(mids, _innermost(spans, points),
                                _innermost(ops, points)):
            key = f"{s or 'nwbench.loop'} / {o or 'python'}"
            labels[key] = labels.get(key, 0.0) + d * 1e-6
        self.idle_gaps = sorted(labels.items(), key=lambda x: -x[1])[:TOP]

    def kernel_seconds(self, pred) -> float:
        return sum(s for n, s in self.kernels if pred(n))

    def breakdown(self) -> dict:
        return {"device_ops": [[n, s] for n, s in self.device_ops],
                "idle_gaps": [[n, s] for n, s in self.idle_gaps]}
