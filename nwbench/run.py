"""Run one cell of the benchmark once, on the card this process runs on:

    python3 -m nwbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
--trace 1 its per-layer ones), `device` (the card's name and power limit
beside it) and, traced, `breakdown`; last, `checks`: each number compared
with the plain reference beside its limit, which also end standard error.
Exits non-zero, with no result, without a CUDA card (or fewer cards than
the cell asks for), and when jax, jaxlib, flax or the JAX package was
loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(CHECKOUT, ".nwbench_cache")


def _environment():
    """Caches at fixed paths inside the checkout; no library may load JAX
    or reach for a network."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE,
                                                      "torch_extensions")
    for key in ("USE_FLAX", "USE_JAX", "USE_TF"):
        os.environ[key] = "0"
    os.environ["HF_HUB_OFFLINE"] = "1"
    os.environ["TRANSFORMERS_OFFLINE"] = "1"


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.splitlines()[0] if out else "unknown"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _environment()

    import torch
    from nwbench import harness

    cell, config, mix = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"nwbench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, checks, _ = harness.run_cell(
        args.workload, cell, config, mix, args.seed, args.seconds,
        bool(args.trace), "cuda", T_START)
    found = harness.forbidden_modules(sys.modules)
    if found:
        print(f"nwbench: forbidden modules were loaded: {found}",
              file=sys.stderr)
        return 3
    result["device"] = {"platform": "gpu",
                        "kind": torch.cuda.get_device_name(0),
                        "count": cell["chips"],
                        "power_limit": power_limit(),
                        **result["device"]}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    print(json.dumps(result), flush=True)
    for k, (v, lim) in checks.items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
