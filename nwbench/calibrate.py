"""The readings that a cell's limits are set from, on the card at the
cell's own size: for each seed, a short window of the program at the
cell's load, then the numbers of its served answers and of the control's
answers for the same sample (the reference in the program's place, one
precision below the configuration's: TF32 products for the kNN cells,
fp8 products for the encoder's), both judged by the reference. One process
reads every seed, so the set-up is paid once a seed and never twice.

    python3 -m nwbench.calibrate --workload <cell> --seeds 11,12,13 --seconds 3

Prints one JSON line a seed and, last, the largest program reading and the
smallest control reading of each number. The benchmark's runs never run
the control.
"""

import argparse
import gc
import json
import sys
import time

from nwbench.run import _environment


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    _environment()

    import torch
    from nwbench import harness

    cell, config, mix = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("nwbench.calibrate needs a CUDA card", file=sys.stderr)
        return 2
    low, high = {}, {}
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        result, checks, driver = harness.run_cell(
            args.workload, cell, config, mix, seed, args.seconds, False,
            "cuda", t)
        control = driver.check(control=True)
        program = {k: v for k, (v, _) in checks.items()}
        print(json.dumps({"seed": seed, "correct": result["correct"],
                          "attempted": result["attempted"],
                          "program": program, "control": control,
                          "metrics": result["metrics"]}), flush=True)
        for k, v in program.items():
            low[k] = max(low.get(k, v), v)
        for k, v in control.items():
            high[k] = min(high.get(k, v), v)
        del driver
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "program_max": low,
                      "control_min": high,
                      "card": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
