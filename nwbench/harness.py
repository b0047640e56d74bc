"""One run of one cell: set-up, the measured window, the metrics, the check
against the plain reference, and the result line.

The pieces are found by name (see the package's docstring). A driver
module defines `Driver(run)` with:
  setup()                  make the inputs and the system under test, warm
                           every shape the cell's traffic uses;
  step()                   one call of the entry point (the window repeats
                           it until `seconds` have passed);
  end_to_end(kinds, window_s) -> {metric: (value, unit)}, for the cell's
                           {metric: kind} (its `end_to_end`);
  counters() -> dict       what the per-layer readers read besides the
                           trace;
  attempted, failed        answers asked for and answers that failed;
  free_program()           drop the program's state;
  check(control=False) -> {number: value}, judged by the plain reference
                           (the control, in the program's place, with
                           control=True).
A cell's per-layer metrics are those that BENCHMARK.json gives it (see
`per_layer_metrics`). A metric's reader is `metrics/<metric>.py` or, for a
quantity split by the end-to-end metric it moves (`idle_share.knn`,
`idle_share.encode`), `metrics/<quantity>.py`; it defines UNIT and
`read(rec)`, which returns a number or None where it finds nothing to
read.
"""

import gc
import importlib.util
import json
import math
import contextlib
import os
import sys
import time
from dataclasses import dataclass

import torch

from nwbench import trace

HERE = os.path.dirname(os.path.abspath(__file__))
BENCHMARK = os.path.join(os.path.dirname(HERE), "BENCHMARK.json")
FORBIDDEN = ("jax", "jaxlib", "flax", "neighborhoodwatch_tpu")


def load_json(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, f"{name}.json")) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    path = os.path.join(HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"nwbench_{kind}_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def per_layer_metrics(cell_name: str, reported) -> list:
    """The per-layer metrics of BENCHMARK.json that a cell reports: those
    that list it under `workloads`, and those without that key whose
    `moves` is among the cell's end-to-end metrics `reported`."""
    with open(BENCHMARK) as f:
        entries = json.load(f)["per_layer"]
    return [m["name"] for m in entries
            if cell_name in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in reported)]


def reader(metric: str):
    """The reader module of a per-layer metric, found by its name."""
    for name in (metric, metric.split(".")[0]):
        if os.path.exists(os.path.join(HERE, "metrics", f"{name}.py")):
            return load_module("metrics", name)
    raise FileNotFoundError(f"no reader for the per-layer metric {metric!r}")


def forbidden_modules(modules) -> list:
    """Loaded modules whose top-level name is jax, jaxlib, flax or the
    JAX package (whole names: the port's own name begins with the JAX
    package's)."""
    return sorted({m.split(".")[0] for m in modules}
                  & set(FORBIDDEN))


@dataclass
class Run:
    """What a driver is given."""
    cell_name: str
    cell: dict
    config: dict
    mix: dict
    traffic: object          # the mix's generator module
    seed: int
    seconds: float           # the window's length
    traced: bool
    device: torch.device

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def stage(self, name: str):
        """A set-up stage, its seconds written to standard error."""
        t0 = time.perf_counter()
        yield
        self.sync()
        print(f"setup {name} {time.perf_counter() - t0:.3f} s",
              file=sys.stderr)


def load_cell(name: str):
    """(cell, config, mix) of a cell by name."""
    cell = load_json("workloads", name)
    return cell, load_json("configs", cell["config"]), \
        load_json("traffic", cell["traffic"])


def judge(checks: dict, limits: dict) -> bool:
    """Every number within its limit (a NaN is never within)."""
    return all(not math.isnan(checks[k]) and checks[k] <= limits[k]
               for k in limits)


def run_cell(name: str, cell: dict, config: dict, mix: dict, seed: int,
             seconds: float, traced: bool, device, t_start: float):
    """Set up, measure, check. Returns (result without `device`'s card
    fields, checks as {name: (value, limit)}, the driver)."""
    dev = torch.device(device)
    window = min(seconds, cell.get("trace_seconds") or seconds) if traced \
        else seconds
    run = Run(name, cell, config, mix,
              load_module("traffic", mix["generator"]), seed, window,
              traced, dev)
    driver = load_module("drivers", cell["driver"]).Driver(run)
    driver.setup()
    run.sync()
    setup_s = time.perf_counter() - t_start
    holder = {}
    with trace.profiled(traced, holder):
        with trace.span(trace.WINDOW, traced):
            t0 = time.perf_counter()
            while True:
                driver.step()
                if time.perf_counter() - t0 >= window:
                    break
            run.sync()
            window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    result = {"correct": False, "attempted": driver.attempted,
              "failed": driver.failed, "metrics": {},
              "device": {"memory_peak_bytes": int(peak)}}
    if traced:
        summary = holder["trace"]
        rec = {"driver": cell["driver"], "cell": cell, "config": config,
               "counters": driver.counters(), "trace": summary,
               "window_s": window_s}
        for metric in per_layer_metrics(name, cell["end_to_end"]):
            mod = reader(metric)
            value = mod.read(rec)
            if value is not None:
                result["metrics"][metric] = {"value": value,
                                             "unit": mod.UNIT}
        result["device"].update(busy_s=summary.busy_s,
                                window_s=summary.window_s)
        result["breakdown"] = summary.breakdown()
    else:
        for metric, (value, unit) in driver.end_to_end(
                cell["end_to_end"], window_s).items():
            result["metrics"][metric] = {"value": value, "unit": unit}
        result["metrics"]["setup_s"] = {"value": setup_s, "unit": "s"}
    driver.free_program()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    values = driver.check()
    limits = cell["limits"]
    result["attempted"], result["failed"] = driver.attempted, driver.failed
    result["correct"] = bool(judge(values, limits) and driver.failed == 0
                             and driver.attempted > 0)
    checks = {k: (values[k], limits[k]) for k in limits}
    return result, checks, driver
