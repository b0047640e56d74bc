"""Per-stage wall-clock timing (counterpart of the JAX package's
utils/profiling.py; its `device_trace` profiler wrapper is not ported yet)."""

import contextlib
import json
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
