"""Per-stage timing, the program's spans and counters, and optional
torch.profiler tracing (counterpart of utils/profiling.py, whose
`device_trace` wraps jax.profiler).

Spans and counters record only while a torch profiler records
(`recording()`), so a traced region, `nw --trace-dir`'s or a benchmark's
window, gets them and an untraced run pays one flag check a call:
- `span(name)` enters `torch.profiler.record_function(name)`, so the span
  sits in the profiler's trace on its clock with the kernels it issued,
  and adds to the in-memory records under `name` its count, its host
  seconds and, where CUDA is in use, its device seconds (a pair of CUDA
  events on the current stream, resolved when the records are read);
- `count(name, n)` adds `n` to a counter;
- `records()` returns what the current or the last recording session
  added. The first span or count after a stretch without a recording
  profiler starts the records afresh.
No span may be opened inside a CUDA graph capture: events recorded there
would belong to the graph. A capture's counts are taken aside instead
(`collected_counts()`, which models/graphed.py opens around a capture)
and added at each replay of the graph, where the work runs. The records
assume one thread issues the spans; a lock keeps concurrent counts whole.
"""

import contextlib
import json
import os
import threading
import time
from dataclasses import dataclass, field

import torch

_profiler_enabled = torch.autograd._profiler_enabled


def recording() -> bool:
    """True while a torch profiler records."""
    return _profiler_enabled()


_NOOP = contextlib.nullcontext()
_sink = None       # a capture's counts, while collected_counts() is open
# pending event pairs a span name keeps before finished ones are folded in
_FOLD_AT = 256


class _Span:
    """Records of one span name."""
    __slots__ = ("count", "host_s", "device_s", "timed", "pending")

    def __init__(self):
        self.count, self.host_s, self.device_s = 0, 0.0, 0.0
        self.timed = False
        self.pending = []        # (start, end) CUDA events not yet read

    def fold(self, wait: bool):
        """Add the device seconds of the pending pairs that have finished
        (of every pair with `wait`)."""
        keep = []
        for start, end in self.pending:
            if wait:
                end.synchronize()
            elif not end.query():
                keep.append((start, end))
                continue
            self.device_s += start.elapsed_time(end) * 1e-3
        self.pending = keep


class _Records:
    def __init__(self):
        self.lock = threading.Lock()
        self.spans = {}
        self.counters = {}
        self.stale = False

    def fresh(self):
        """Forget an earlier session's records."""
        if self.stale:
            self.clear()

    def clear(self):
        self.spans, self.counters = {}, {}
        self.stale = False


_REC = _Records()


def _event():
    """A timing event recorded on the current CUDA stream, or None where
    CUDA is not in use or the stream is being captured into a graph."""
    if not torch.cuda.is_initialized() \
            or torch.cuda.is_current_stream_capturing():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class _Open:
    """One recording span, from enter to exit."""
    __slots__ = ("name", "fn", "start", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.fn = torch.profiler.record_function(self.name)
        self.fn.__enter__()
        self.start = _event()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        host_s = time.perf_counter() - self.t0
        end = _event() if self.start is not None else None
        self.fn.__exit__(*exc)
        with _REC.lock:
            _REC.fresh()
            rec = _REC.spans.get(self.name)
            if rec is None:
                rec = _REC.spans[self.name] = _Span()
            rec.count += 1
            rec.host_s += host_s
            if end is not None:
                rec.timed = True
                rec.pending.append((self.start, end))
                if len(rec.pending) >= _FOLD_AT:
                    rec.fold(wait=False)
        return False


def span(name: str):
    """A context that marks one stage of the program under `name` while a
    profiler records (see the module's docstring); otherwise a shared
    no-op context."""
    if not _profiler_enabled():
        _REC.stale = True
        return _NOOP
    return _Open(name)


def count(name: str, n) -> None:
    """Add `n` to the counter `name` while a profiler records, or, inside
    `collected_counts()`, to its collection whether or not one records.
    Compute an `n` that costs work only under `recording()`."""
    if _sink is not None:
        _sink[name] = _sink.get(name, 0) + n
        return
    if not _profiler_enabled():
        _REC.stale = True
        return
    with _REC.lock:
        _REC.fresh()
        _REC.counters[name] = _REC.counters.get(name, 0) + n


@contextlib.contextmanager
def collected_counts():
    """Collect the counts of the region into the dict it yields instead of
    the records (a CUDA graph capture: what the captured work counts is
    added at each replay, `count(name, n)` for each entry)."""
    global _sink
    before, _sink = _sink, {}
    try:
        yield _sink
    finally:
        _sink = before


def records() -> dict:
    """{"spans": {name: {"count", "host_s", "device_s"}}, "counters":
    {name: n}} of the current or the last recording session; `device_s` is
    None for a span that recorded no CUDA events. Waits for the device to
    pass every recorded span's end."""
    if not recording():
        _REC.stale = True
    with _REC.lock:
        spans = {}
        for name, rec in _REC.spans.items():
            rec.fold(wait=True)
            spans[name] = {"count": rec.count, "host_s": rec.host_s,
                           "device_s": rec.device_s if rec.timed else None}
        return {"spans": spans, "counters": dict(_REC.counters)}


def records_table(recs: dict) -> str:
    """`records()` as a printable table: spans (count, host s, device s),
    then counters."""
    lines = [f"  {'span':<28s} {'count':>8s} {'host s':>10s} "
             f"{'device s':>10s}"]
    for name, s in recs["spans"].items():
        dev = "-" if s["device_s"] is None else f"{s['device_s']:10.4f}"
        lines.append(f"  {name:<28s} {s['count']:8d} {s['host_s']:10.4f} "
                     f"{dev:>10s}")
    for name, n in recs["counters"].items():
        lines.append(f"  {name:<28s} {n:>8}")
    return "\n".join(lines)


@dataclass
class StageTimer:
    """Collects named stage durations; printable and JSON-serializable.
    Each stage is also the span `nw.<stage>`."""
    stages: dict = field(default_factory=dict)
    _t0: float = field(default_factory=time.perf_counter)

    @contextlib.contextmanager
    def stage(self, name: str):
        start = time.perf_counter()
        try:
            with span(f"nw.{name}"):
                yield
        finally:
            self.stages[name] = self.stages.get(name, 0.0) + \
                time.perf_counter() - start

    def total(self) -> float:
        return time.perf_counter() - self._t0

    def report(self) -> str:
        lines = [f"  {name:<28s} {secs:9.2f} s" for name, secs in self.stages.items()]
        lines.append(f"  {'TOTAL':<28s} {self.total():9.2f} s")
        return "\n".join(lines)

    def to_json(self) -> str:
        return json.dumps({**self.stages, "total": self.total()})


@contextlib.contextmanager
def device_trace(trace_dir: str | None):
    """Record a torch.profiler trace of the region (CPU activity, and CUDA
    activity where a card is present) and write it into `trace_dir` as a
    Chrome trace, `device_trace_<pid>_<unix ms>.json`, when `trace_dir` is
    set; then print the region's program spans and counters (`records()`).

    A profiler that fails to start or to stop must not kill a long
    generation run: the failure is reported and the run goes on untraced.
    That tolerance covers the profiler only; an error raised inside the
    region propagates."""
    if not trace_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        prof = torch.profiler.profile(activities=activities)
        with _REC.lock:
            _REC.clear()
        prof.start()
    except Exception as e:  # environment dependent (CUPTI, permissions)
        print(f"[warn] profiler trace unavailable ({e}); continuing untraced")
        yield
        return
    try:
        yield
    finally:
        try:
            prof.stop()
            os.makedirs(trace_dir, exist_ok=True)
            path = os.path.join(
                trace_dir, f"device_trace_{os.getpid()}_"
                           f"{int(time.time() * 1000)}.json")
            prof.export_chrome_trace(path)
            print(f"device trace written to {path}")
            print("program spans and counters of the traced region:")
            print(records_table(records()))
        except Exception as e:  # environment dependent
            print(f"[warn] profiler stop/export failed: {e}")
