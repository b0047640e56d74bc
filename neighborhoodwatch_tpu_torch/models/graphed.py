"""The encoders' compiled forward: one captured CUDA graph per padded input
shape, replayed for every chunk of that shape. This is the card's
counterpart of the `jax.jit` that the JAX package wraps around the e5 and
ColBERT forwards (models/e5_flax.py:44-49, models/colbert_flax.py:139-143),
where each padded shape compiles once into one XLA executable that is
dispatched asynchronously. Run op by op from Python, a BERT forward is
about 20 kernel launches a layer, each through nn.Module dispatch; a
replay is one launch of all of them.

`GraphRunner(fn, device, max_graphs)` runs `fn(ids, mask)`, a function of
the (rows, bucket) int64 token ids and int32 attention mask alone (the
weights it closes over do not change), on host arrays:

- "graph", the default on CUDA: the first chunk of a (rows, bucket) shape
  captures a graph (WARMUP forwards on a side stream, then the capture
  under torch.no_grad(); every graph of one runner shares one memory
  pool, and the runner keeps each graph's static inputs and output for
  the graph's lifetime, so a later capture cannot take their memory).
  Each chunk is copied from pinned host memory into the static inputs
  with non_blocking=True (PyTorch's caching host allocator records the
  event that keeps the pinned block until the copy is done), the graph is
  replayed on the current stream, and the first `rows` rows of the static
  output are cloned before the next replay of that graph can overwrite
  them. Nothing in this synchronizes the stream. Under a recording
  profiler (utils/profiling.py) the copies, the replay and the clone are
  the span `graph.replay`, the replay's launch call alone `graph.launch`
  (where the host runs ahead of the card it waits there for room in the
  launch queue), a capture the span `graph.capture`; the spans stay in
  the host code around the graph, never inside a capture.
- "eager": `fn` op by op on the inputs copied as the generators copied
  them before graphs (`.to(device)`, which synchronizes): a comparison
  run, chosen only with `forced_variant("eager")`.

CPU tensors run `fn` op by op: the device decides this, as it decides the
plain version of a kernel; it is not a fallback. On CUDA a failed warm-up,
capture or replay raises GraphError, and so does a capture beyond the
runner's `max_graphs`; the runner never runs eager instead.

Counts, across every runner, as the kernel wrappers keep theirs:
`GraphRunner.launches` (forwards), `launches_by_variant` ("graph" are
replays, "eager" forwards op by op, on either device) and `captures`. A
kernel wrapper counts on the host where its launch is issued, so a launch
recorded into a graph would count once at capture and never at replay.
The runner therefore takes what a capture counts aside into one record
kept with the graph (`_Held`), and adds it at every replay: the launches
taken back out of each counted wrapper (`counted_kernels()`: K6's
`masked_attention`, and E1-E3 and D1-D3 of ops/encoder_fused.py), and the
profiler counters the captured forward counts (`attn.causal_*`,
`decoder.*`, collected by utils/profiling.collected_counts), those under
a recording profiler only. Launches of the warm-up forwards ran on the
card and stay counted. Under a recording
profiler every forward issued, on either variant, adds its real tokens
(the mask's sum) to the counter `graph.tokens` and its rows x bucket, pad
rows included, to `graph.token_slots`.
"""

import contextlib

import numpy as np
import torch

from neighborhoodwatch_tpu_torch.utils.profiling import (
    collected_counts, count, recording, span,
)

VARIANTS = ("graph", "eager")
WARMUP = 2               # side-stream forwards before a capture
_forced_variant = None


class GraphError(RuntimeError):
    """A graph's warm-up, capture or replay failed, or a capture would pass
    the runner's bound. A fault of the shape, never a chunk's."""


@contextlib.contextmanager
def forced_variant(name: str):
    """Run CUDA forwards as `name` ("graph" or "eager") instead of the
    default "graph", for tests and timings that hold the two against each
    other."""
    global _forced_variant
    if name not in VARIANTS:
        raise ValueError(f"variant {name!r} not in {VARIANTS}")
    before = _forced_variant
    _forced_variant = name
    try:
        yield
    finally:
        _forced_variant = before


def counted_kernels():
    """The kernel wrappers whose launches a captured forward may hold."""
    from neighborhoodwatch_tpu_torch.ops.attention_kernel import (
        masked_attention,
    )
    from neighborhoodwatch_tpu_torch.ops.encoder_fused import (
        add_layernorm, add_rmsnorm, embed_layernorm, masked_softmax, rope,
        swiglu,
    )
    return (masked_attention, embed_layernorm, add_layernorm,
            masked_softmax, add_rmsnorm, rope, swiglu)


def _counts():
    """Each counted wrapper's launches, in all and per variant (D1-D3 have
    one kernel each and no variants: {})."""
    return [(w.launches, dict(getattr(w, "launches_by_variant", {})))
            for w in counted_kernels()]


def _restore(counts):
    for w, (n, by) in zip(counted_kernels(), counts):
        w.launches = n
        if by:
            w.launches_by_variant = by


class _Held:
    """What a captured forward counts, added at each replay: `launches`,
    per counted wrapper (launches, {variant: launches}); `counters`, the
    profiler counters {name: n}."""
    __slots__ = ("launches", "counters")


@contextlib.contextmanager
def _held_counts():
    """Take what the region counts aside: yields a _Held filled on exit,
    the wrappers' launch counts set back to theirs before the region."""
    held, before = _Held(), _counts()
    try:
        with collected_counts() as held.counters:
            yield held
        held.launches = [
            (n1 - n0, {v: by1[v] - by0.get(v, 0) for v in by1})
            for (n1, by1), (n0, by0) in zip(_counts(), before)]
    finally:
        _restore(before)


def _add(held):
    for w, (n, by) in zip(counted_kernels(), held.launches):
        w.launches += n
        for v, c in by.items():
            w.launches_by_variant[v] += c
    if recording():
        for name, n in held.counters.items():
            count(name, n)


class _Graph:
    __slots__ = ("graph", "ids", "mask", "out", "held")


class GraphRunner:
    """`fn`'s forwards on `device`, one CUDA graph per (rows, bucket)
    there; at most `max_graphs` graphs. `name` labels its errors."""

    launches = 0
    launches_by_variant = {v: 0 for v in VARIANTS}
    captures = 0

    def __init__(self, fn, device, max_graphs: int, name: str = "encoder"):
        self.fn = fn
        self.device = torch.device(device)
        self.max_graphs = max_graphs
        self.name = name
        self.graphs = {}          # (rows, bucket) -> _Graph
        self.pool = None
        # the device decides: graphs on the card, op by op on the CPU
        self.graphed = self.device.type == "cuda"

    @staticmethod
    def _count(variant):
        GraphRunner.launches += 1
        GraphRunner.launches_by_variant[variant] += 1

    @torch.no_grad()
    def __call__(self, ids, mask, rows=None):
        """The first `rows` rows (default: all) of `fn` over the (R, T)
        host arrays `ids` and `mask`, on the device, not synchronized."""
        rows = ids.shape[0] if rows is None else rows
        if recording():
            count("graph.tokens", int(mask.sum()))
            count("graph.token_slots", int(np.prod(mask.shape)))
        if self.graphed and _forced_variant != "eager":
            return self._graphed(ids, mask, rows)
        ids = torch.from_numpy(ids).to(self.device, torch.long)
        mask = torch.from_numpy(mask).to(self.device)
        out = self.fn(ids, mask)[:rows]
        self._count("eager")
        return out

    def _graphed(self, ids, mask, rows):
        ids = torch.from_numpy(np.asarray(ids, np.int64)).pin_memory()
        mask = torch.from_numpy(np.asarray(mask, np.int32)).pin_memory()
        key = tuple(ids.shape)
        g = self.graphs.get(key)
        if g is None:
            with span("graph.capture"):
                g = self._capture(ids, mask)
        try:
            with span("graph.replay"):
                g.ids.copy_(ids, non_blocking=True)
                g.mask.copy_(mask, non_blocking=True)
                with span("graph.launch"):
                    g.graph.replay()
                out = g.out[:rows].clone()
        except Exception as e:
            raise GraphError(f"{self.name}: replay of the {key} graph "
                             f"failed: {e}") from e
        _add(g.held)
        self._count("graph")
        return out

    def _capture(self, ids, mask):
        key = tuple(ids.shape)
        if len(self.graphs) >= self.max_graphs:
            raise GraphError(
                f"{self.name}: a graph for {key} would be graph "
                f"{len(self.graphs) + 1}, above the bound of "
                f"{self.max_graphs} (shapes captured: {sorted(self.graphs)})")
        g = _Graph()
        try:
            g.ids = torch.empty(key, dtype=torch.long, device=self.device)
            g.mask = torch.empty(key, dtype=torch.int32, device=self.device)
            g.ids.copy_(ids, non_blocking=True)
            g.mask.copy_(mask, non_blocking=True)
            main = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                for _ in range(WARMUP):
                    self.fn(g.ids, g.mask)
            main.wait_stream(side)
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            g.graph = torch.cuda.CUDAGraph()
            with _held_counts() as g.held, \
                    torch.cuda.graph(g.graph, pool=self.pool):
                g.out = self.fn(g.ids, g.mask)
        except Exception as e:
            raise GraphError(f"{self.name}: warm-up or capture of the "
                             f"{key} graph failed: {e}") from e
        self.graphs[key] = g
        GraphRunner.captures += 1
        return g


def row_counts(batch_size: int):
    """The padded row counts of batches of at most `batch_size` rows: the
    powers of two below it, and `batch_size` itself."""
    out, r = [], 1
    while r < batch_size:
        out.append(r)
        r *= 2
    return out + [batch_size]


def padded_rows(rows: int, batch_size: int) -> int:
    """`rows` padded to the next power of two, at most `batch_size`."""
    return min(1 << max(rows - 1, 0).bit_length(), batch_size)


def pad_rows(ids, mask, rows: int):
    """(n, T) ids and mask padded with zero rows (padding tokens, all
    masked) to `rows` rows, as e5_flax.py:68-74 pads a ragged tail."""
    pad = rows - ids.shape[0]
    if pad <= 0:
        return ids, mask
    return (np.pad(ids, ((0, pad), (0, 0))),
            np.pad(mask, ((0, pad), (0, 0))))
