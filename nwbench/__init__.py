"""The benchmark of neighborhoodwatch_tpu_torch, the PyTorch/CUDA port.

One command runs one cell once on the card it is started on:

    python3 -m nwbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name: a cell in `workloads/<cell>.json` names its
configuration (`configs/<config>.json`), its traffic mix
(`traffic/<mix>.json`, read by the generator `traffic/<generator>.py`)
and its driver (`drivers/<driver>.py`, one per entry point the window
drives); each per-layer metric is a reader of its own in
`metrics/<metric>.py`, or `metrics/<quantity>.py` for a quantity split
by the end-to-end metric it moves (`idle_share.knn`, `idle_share.encode`),
and a cell reports those that BENCHMARK.json lists for it. The plain references that decide `correct` live in
`reference/`. Nothing here imports jax, jaxlib, flax or the JAX package.
"""
