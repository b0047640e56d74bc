"""kNN compute orchestration (counterpart of core/pipeline.py).

- `compute_knn` (table path): loads the query and base matrices, batches
  the base axis, runs the kNN engine per batch and writes per-batch
  partial parquet files (`partial/indices{i}.parquet`,
  `partial/distances{i}.parquet`), merged later by core/merge.py.
- `compute_knn_ds` (dataset path): streams base batches from disk with a
  background prefetch thread, folds them into a device-resident running
  top-k (ops/knn.StreamingKNN, or parallel/sharded_knn.ShardedStreamingKNN
  over a mesh) and writes the final results directly. Every
  `checkpoint_every` batches the running state is saved to
  `partial/stream_state.npz` in the JAX package's format, so a run
  started by either package resumes in the other, with or without a mesh
  of the same padded shape.

Host batches are decoded column-major (sequential writes on the host) and
transposed on the device: `.to(device).T.contiguous()`.
"""

import math
import os
import queue
import threading
import time

import numpy as np
import torch

from neighborhoodwatch_tpu_torch import resolve_device
from neighborhoodwatch_tpu_torch.core.tuner import plan_knn
from neighborhoodwatch_tpu_torch.io.parquet_io import (
    read_embeddings, read_embeddings_colmajor, iter_embedding_batches,
    write_matrix_to_parquet, parquet_row_count,
)
from neighborhoodwatch_tpu_torch.ops.knn import knn, StreamingKNN
from neighborhoodwatch_tpu_torch.ops.topk import check_monotonic
from neighborhoodwatch_tpu_torch.parallel.mesh import check_mesh
from neighborhoodwatch_tpu_torch.utils.naming import (
    get_partial_indices_filename, get_partial_distances_filename,
    get_full_filename,
)
from neighborhoodwatch_tpu_torch.utils.profiling import StageTimer


def _prefetch(iterator, depth: int = 2):
    """Run `iterator` in a background thread with a bounded queue so host
    parquet decode overlaps device compute. If the consumer raises, the
    finally block stops the worker, drains the queue (unblocking a worker
    parked on q.put) and joins it, so no decoded batches stay pinned."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    sentinel = object()
    err: list[BaseException] = []
    stop = threading.Event()

    def worker():
        try:
            for item in iterator:
                if stop.is_set():
                    break
                q.put(item)
        except BaseException as e:  # surfaced on the consumer side
            err.append(e)
        finally:
            q.put(sentinel)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
        if err:
            raise err[0]
    finally:
        stop.set()
        while t.is_alive():
            try:                    # unblock a q.put on the full queue
                q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=0.1)


def _colmajor_to_device(base_t: np.ndarray, device) -> torch.Tensor:
    """(d, n) host column block -> (n, d) contiguous device tensor."""
    return torch.from_numpy(np.ascontiguousarray(base_t)).to(device).T \
        .contiguous()


def compute_knn(data_dir: str,
                model_name: str,
                dimensions: int,
                query_filename: str,
                query_count: int,
                base_filename: str,
                base_count: int,
                mem_tune: bool = False,
                k: int = 100,
                initial_batch_size: int = 100_000,
                max_memory_threshold: float = 0.1,
                split: bool = True,
                metric: str = "sqeuclidean",
                precision: str = "highest",
                query_split_rows: int | None = None,
                engine: str = "auto",
                screen_precision: str = "auto",
                device=None) -> StageTimer:
    """Table path: per-base-batch partial top-k files + a later merge.
    `split` chunks the query axis per base batch so giant query sets never
    need to be resident on the device at once."""
    dev = resolve_device(device)
    timer = StageTimer()
    with timer.stage("load_query"):
        query = read_embeddings(data_dir, query_filename, query_count,
                                dimensions)
    with timer.stage("load_base"):
        # host-resident (d, n) matrix; each batch is copied as a column
        # slice and transposed on the device
        base_t = read_embeddings_colmajor(data_dir, base_filename, base_count,
                                          dimensions)

    n_base = base_t.shape[1]
    threshold = max_memory_threshold if mem_tune else 0.5
    plan = plan_knn(query.shape[0], query.shape[1], k, base_count=n_base,
                    max_memory_threshold=threshold,
                    initial_batch_size=initial_batch_size, device=dev)
    batch_size = max(min(plan.batch_size, n_base), k)
    batch_count = math.ceil(n_base / batch_size)
    # every batch must hold at least k rows so partial files share one width
    assert (n_base % batch_size == 0) or k <= (n_base % batch_size), \
        f"Cannot generate k of {k} with only {n_base} rows and batch_size {batch_size}."

    q_rows = query.shape[0]
    if not split:
        q_chunk = q_rows
    elif query_split_rows is not None:
        q_chunk = query_split_rows
    else:
        q_chunk = min(q_rows, max(1024, (1 << 28) // (4 * query.shape[1])))

    with timer.stage("knn_batches"):
        for b in range(batch_count):
            off = b * batch_size
            chunk = _colmajor_to_device(base_t[:, off: off + batch_size], dev)
            parts = []
            for qs in range(0, q_rows, q_chunk):
                d, i = knn(query[qs: qs + q_chunk], chunk, k=k, metric=metric,
                           precision=precision, tile_size=plan.tile_size,
                           base_offset=off, engine=engine,
                           screen_precision=screen_precision, device=dev)
                parts.append((d.cpu().numpy(), i.cpu().numpy()))
            d = np.vstack([p[0] for p in parts])
            i = np.vstack([p[1] for p in parts])
            write_matrix_to_parquet(get_partial_distances_filename(data_dir, b), d)
            write_matrix_to_parquet(get_partial_indices_filename(data_dir, b),
                                    i.astype(np.int32))
    return timer


def _stream_ckpt_path(data_dir: str) -> str:
    return f"{data_dir}/partial/stream_state.npz"


def _save_stream_ckpt(path: str, acc, fingerprint: dict) -> None:
    """Atomic checkpoint of the running top-k (same keys and layout as the
    JAX package's)."""
    dist, idx, seen = acc.state_arrays()
    tmp = path + ".tmp.npz"      # np.savez appends .npz unless present
    np.savez(tmp, dist=dist, idx=idx, seen=seen, **fingerprint)
    os.replace(tmp, path)


def _load_stream_ckpt(path: str, fingerprint: dict):
    """(dist, idx, seen) if a checkpoint exists and matches the workload
    fingerprint, else None."""
    if not os.path.exists(path):
        return None
    try:
        with np.load(path, allow_pickle=False) as z:
            for key, val in fingerprint.items():
                if str(z[key]) != str(val):
                    print(f"stream checkpoint ignored: {key} mismatch "
                          f"({z[key]} != {val})")
                    return None
            return z["dist"], z["idx"], int(z["seen"])
    except (OSError, ValueError, KeyError) as e:
        print(f"stream checkpoint unreadable, starting fresh: {e}")
        return None


def compute_knn_ds(data_dir: str,
                   dimensions: int,
                   query_filename: str,
                   query_count: int,
                   base_filename: str,
                   base_count: int,
                   mem_tune: bool = False,
                   k: int = 100,
                   initial_batch_size: int = 1_000_000,
                   max_memory_threshold: float = 0.2,
                   metric: str = "sqeuclidean",
                   precision: str = "highest",
                   mesh=None,
                   checkpoint_every: int = 10,
                   engine: str = "auto",
                   screen_precision: str = "auto",
                   device=None) -> StageTimer:
    """Dataset path: out-of-core streaming + device-resident running top-k;
    writes final_{indices,distances}.parquet directly.

    With `mesh` (parallel/mesh.make_mesh), every rank runs this function:
    each streamed batch is row-split over the mesh's "mp" axis, each rank
    ships only its own column range of the col-major batch to its device
    (the mesh's device, not `device`), and the per-shard top-k lists merge
    over the mp line. Checkpoints and the final files are written by rank 0
    alone; every rank joins the collectives that gather them. Every
    `checkpoint_every` batches the running (dist, idx, rows_seen) state is
    checkpointed; an interrupted run resumes from it, re-reading only the
    unseen base rows (0 disables).

    Backpressure: after each batch's update a CUDA event is recorded, and
    the host waits on the PREVIOUS batch's event before decoding further,
    so at most one batch is in flight on the device while the prefetch
    thread decodes the next one."""
    check_mesh(mesh)
    dev = resolve_device(device) if mesh is None else mesh.device
    writer = mesh is None or mesh.rank == 0
    timer = StageTimer()
    with timer.stage("load_query"):
        query = read_embeddings(data_dir, query_filename, query_count,
                                dimensions)

    n_base = min(base_count, parquet_row_count(data_dir, base_filename))
    assert k <= n_base, f"k={k} exceeds base row count {n_base}"
    threshold = max_memory_threshold if mem_tune else 0.5
    # batches split over the mp axis only: scaling by dp * mp would over-
    # fill each device by dp
    mp = 1 if mesh is None else mesh.mp
    plan = plan_knn(query.shape[0], query.shape[1], k, base_count=n_base,
                    max_memory_threshold=threshold,
                    initial_batch_size=initial_batch_size * mp, device=dev)
    batch_size = min(plan.batch_size, n_base)

    with timer.stage("knn_stream"):
        if mesh is None:
            acc = StreamingKNN(query, k=k, metric=metric,
                               precision=precision, tile_size=plan.tile_size,
                               engine=engine,
                               screen_precision=screen_precision, device=dev)
            q_pad = query.shape[0]
        else:
            from neighborhoodwatch_tpu_torch.parallel.sharded_knn import (
                ShardedStreamingKNN,
            )
            acc = ShardedStreamingKNN(query, k=k, mesh=mesh, metric=metric,
                                      precision=precision,
                                      tile_size=plan.tile_size,
                                      engine=engine,
                                      screen_precision=screen_precision)
            q_pad = acc.q_pad
        ckpt_path = _stream_ckpt_path(data_dir)
        st = os.stat(get_full_filename(data_dir, base_filename))
        stq = os.stat(get_full_filename(data_dir, query_filename))
        fingerprint = {"f_k": k, "f_metric": metric, "f_dims": dimensions,
                       "f_base": base_filename, "f_nbase": n_base,
                       "f_q": query.shape[0],
                       # the exact engine's arithmetic regime
                       "f_prec": precision,
                       # content identity of the base and query files
                       "f_bsize": st.st_size,
                       "f_bmtime": round(st.st_mtime, 3),
                       "f_qsize": stq.st_size,
                       "f_qmtime": round(stq.st_mtime, 3),
                       # a mesh pads the state's query rows to dp: only a
                       # run of the same padded shape can restore
                       "f_qpad": q_pad}
        if checkpoint_every:
            saved = _load_stream_ckpt(ckpt_path, fingerprint)
            if saved is not None:
                acc.restore(*saved)
                print(f"resuming kNN stream from checkpoint: "
                      f"{acc.rows_seen}/{n_base} base rows done")

        done = acc.rows_seen
        batches = iter_embedding_batches(data_dir, base_filename,
                                         batch_size=batch_size, count=n_base,
                                         layout="col", start_row=done)
        prev_event = None
        t_start = time.time()
        for b, (offset, chunk_t) in enumerate(_prefetch(batches)):
            if offset + chunk_t.shape[1] <= done:
                continue                       # fully covered by checkpoint
            if offset < done:                  # partial overlap: trim
                chunk_t = chunk_t[:, done - offset:]
                offset = done
            n_batch = chunk_t.shape[1]
            if mesh is None:
                acc.update(_colmajor_to_device(chunk_t, dev), offset)
            else:
                lo, hi = acc.local_update_range(n_batch)
                acc.update_colmajor(chunk_t[:, lo:hi], offset,
                                    global_rows=n_batch)
            t_f = time.time()
            if dev.type == "cuda":
                event = torch.cuda.Event()
                event.record()
                if prev_event is not None:
                    prev_event.synchronize()
                prev_event = event
            print(f"  knn stream: {offset + n_batch}/{n_base} rows "
                  f"({time.time() - t_start:.0f}s, wait "
                  f"{time.time() - t_f:.2f}s)", flush=True)
            if checkpoint_every and (b + 1) % checkpoint_every == 0:
                # state_arrays gathers over the mesh: every rank calls it
                if writer:
                    _save_stream_ckpt(ckpt_path, acc, fingerprint)
                else:
                    acc.state_arrays()
        dist, idx = acc.finalize()

    with timer.stage("write_final"):
        assert check_monotonic(dist)
        if writer:
            write_matrix_to_parquet(
                get_partial_distances_filename(data_dir, -1), dist)
            write_matrix_to_parquet(get_partial_indices_filename(data_dir, -1),
                                    idx.astype(np.int32))
            if checkpoint_every and os.path.exists(ckpt_path):
                os.remove(ckpt_path)
    return timer
