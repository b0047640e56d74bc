"""Deterministic device-memory batch/tile planner (counterpart of
core/tuner.py).

The tile/batch sizes are computed from the device's memory budget and the
workload's known footprint:

    base batch:  batch * d * 4 bytes          (copied to the device per step)
    scan tile:   Q * tile * 4 bytes           (distance matrix slice)
    top-k state: Q * k * 8 bytes              (dist f32 + idx i32)
    + double-buffering factor for overlap.
"""

from dataclasses import dataclass

import torch

from neighborhoodwatch_tpu_torch.utils.misc import round_up

# host budget used off the accelerator (the JAX package's fallback when a
# backend exposes no memory stats)
_DEFAULT_BYTES_LIMIT = 8 << 30


def device_memory_budget(device=None) -> int:
    """Usable device memory in bytes: the card's total memory for a CUDA
    device (torch.cuda.mem_get_info), the fixed host budget on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        _, total = torch.cuda.mem_get_info(dev)
        return int(total)
    return _DEFAULT_BYTES_LIMIT


@dataclass
class KnnPlan:
    batch_size: int     # base rows fetched from parquet per host->device step
    tile_size: int      # base rows per MXU tile inside the device scan
    query_block: int    # query rows per kernel launch (all queries if small)
    bytes_limit: int
    est_bytes: int


def plan_knn(query_count: int, dimensions: int, k: int,
             base_count: int | None = None,
             max_memory_threshold: float = 0.5,
             initial_batch_size: int = 100_000,
             device=None) -> KnnPlan:
    """Compute batch/tile sizes that fit `max_memory_threshold` of HBM.

    Unlike the reference's multiplicative probe loop, this is a closed-form
    calculation — same inputs always give the same plan."""
    bytes_limit = device_memory_budget(device)
    budget = int(bytes_limit * max_memory_threshold)

    # Query matrix is resident for the whole run.
    query_bytes = query_count * dimensions * 4
    # Running top-k state: dist f32 + idx i32.
    state_bytes = query_count * k * 8
    remaining = max(budget - query_bytes - 2 * state_bytes, 64 << 20)

    # Per base row cost: the row itself (d*4, double-buffered host->device)
    # plus one distance-matrix column per resident query row (Q*4) while its
    # tile is live. Tiles are transient so weight them at 2 slots.
    tile_row_cost = dimensions * 4 + query_count * 4
    tile_size = remaining // (4 * tile_row_cost)
    tile_size = int(min(max(tile_size, 1024), 65536))
    tile_size = round_up(tile_size, 1024)

    # Host->device batch: a multiple of the tile, capped by remaining HBM
    # after the transient tile buffers.
    batch_rows = remaining // (2 * dimensions * 4)
    batch_size = int(min(max(batch_rows, tile_size), 4_000_000))
    batch_size = max(round_up(batch_size, tile_size) - tile_size, tile_size)
    if initial_batch_size:
        batch_size = min(batch_size, round_up(initial_batch_size, tile_size))
    if base_count is not None:
        batch_size = min(batch_size, round_up(base_count, tile_size))
        tile_size = min(tile_size, batch_size)

    est = (query_bytes + 2 * state_bytes
           + 2 * batch_size * dimensions * 4
           + 2 * query_count * tile_size * 4)
    # the floors above (64 MB remaining, 1024-row tile) can push est past
    # the budget the caller asked for — say so instead of letting the run
    # discover it as an opaque out-of-memory error
    if est > bytes_limit:
        print(f"   [warn] plan_knn: minimal plan needs ~{est / 2**30:.1f} "
              f"GiB vs device limit {bytes_limit / 2**30:.1f} GiB — the "
              f"resident query/state set does not fit; split the query set "
              f"or lower k")
    elif est > budget:
        print(f"   [warn] plan_knn: plan uses ~{est / 2**30:.1f} GiB, above "
              f"the {max_memory_threshold:.0%} HBM threshold "
              f"({budget / 2**30:.1f} GiB) — floor sizes exceed the "
              f"requested budget")
    return KnnPlan(batch_size=batch_size, tile_size=tile_size,
                   query_block=query_count, bytes_limit=bytes_limit,
                   est_bytes=est)


def tune_memory(num_rows: int, query_count: int, dimensions: int, k: int,
                initial_batch_size: int, max_memory_threshold: float,
                device=None) -> int:
    """The batch size of plan_knn (base rows per host-to-device step) for a
    base of `num_rows`, on `device` (None = "cuda")."""
    plan = plan_knn(query_count, dimensions, k, base_count=num_rows,
                    max_memory_threshold=max_memory_threshold,
                    initial_batch_size=initial_batch_size, device=device)
    return min(plan.batch_size, num_rows) if num_rows else plan.batch_size
