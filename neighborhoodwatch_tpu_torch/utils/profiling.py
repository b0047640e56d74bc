"""Per-stage timing + optional torch.profiler tracing (counterpart of
utils/profiling.py, whose `device_trace` wraps jax.profiler)."""

import contextlib
import json
import os
import time
from dataclasses import dataclass, field


@dataclass
class StageTimer:
    """Collects named stage durations; printable and JSON-serializable."""
    stages: dict = field(default_factory=dict)
    _t0: float = field(default_factory=time.time)

    @contextlib.contextmanager
    def stage(self, name: str):
        start = time.time()
        try:
            yield
        finally:
            self.stages[name] = self.stages.get(name, 0.0) + time.time() - start

    def total(self) -> float:
        return time.time() - self._t0

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
    set.

    A profiler that fails to start or to stop must not kill a long
    generation run: the failure is reported and the run goes on untraced.
    That tolerance covers the profiler only; an error raised inside the
    region propagates."""
    if not trace_dir:
        yield
        return
    import torch
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        prof = torch.profiler.profile(activities=activities)
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
        except Exception as e:  # environment dependent
            print(f"[warn] profiler stop/export failed: {e}")
