"""Device mesh over torch.distributed ranks (counterpart of parallel/mesh.py).

A 2-D (dp, mp) mesh of ranks, one device per rank:

- axis "dp": query parallelism: each row of the mesh owns a contiguous
  slice of the query set;
- axis "mp": base-corpus parallelism: the base axis is split into
  contiguous row shards over the ranks of a row, and the per-shard top-k
  lists are merged with an all-gather over that row.

Rank r sits at (r // mp, r % mp). The collectives are the transport: they
carry the (queries, k) top-k payloads, the repair diagnostics and, in the
ring, the base shards.

Backends: NCCL for CUDA devices, one card per rank; gloo on the CPU. NCCL
refuses two ranks on one card, so several ranks that share a card run a
gloo group, chosen when the group is made (`init_distributed(backend=
"gloo")`); the helpers below then stage their CUDA tensors through host
memory. The staging follows from the group's backend alone: a CUDA tensor
on an NCCL group never touches the host, and a failed collective raises.

One rank drives one device: `cuda:LOCAL_RANK` unless the caller names one.
Launch one process per device (`torchrun --nproc-per-node N`); without a
launcher a single-rank group is made in process.
"""

import os

import torch
import torch.distributed as dist

from neighborhoodwatch_tpu_torch import resolve_device

DP_AXIS = "dp"
MP_AXIS = "mp"


def _launcher_world() -> int | None:
    """World size a launcher (torchrun) put in the environment, if any."""
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        return int(os.environ["WORLD_SIZE"])
    return None


def init_distributed(coordinator=None, num_processes=None, process_id=None,
                     device=None, backend=None, timeout=None) -> None:
    """Create the default process group unless one exists:
    - `num_processes` > 1: at tcp://`coordinator` ("host:port") as rank
      `process_id`;
    - under a launcher (torchrun's WORLD_SIZE, RANK, MASTER_ADDR,
      MASTER_PORT): from the environment;
    - otherwise a single-rank group in this process (an in-process store,
      no socket).
    `backend` None means NCCL for a CUDA `device` and gloo otherwise;
    `timeout` (a timedelta) bounds every collective, torch's default when
    None."""
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    kw = {} if timeout is None else {"timeout": timeout}
    if num_processes is not None and num_processes > 1:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id,
                                **kw)
    elif _launcher_world() is not None:
        dist.init_process_group(backend, init_method="env://", **kw)
    else:
        dist.init_process_group(backend, store=dist.HashStore(),
                                world_size=1, rank=0, **kw)


class Mesh:
    """A (dp, mp) mesh over every rank of the default group: this rank's
    coordinates and device, the group of each axis line through it, and
    whether its collectives stage CUDA tensors through the host (a gloo
    group on the card)."""

    def __init__(self, device_mesh, device: torch.device):
        self.device_mesh = device_mesh
        self.device = device
        self.dp, self.mp = (int(x) for x in device_mesh.mesh.shape)
        self.rank = dist.get_rank()
        self.dp_rank, self.mp_rank = device_mesh.get_coordinate()
        self.groups = {axis: device_mesh.get_group(axis)
                       for axis in (DP_AXIS, MP_AXIS)}
        self.backend = dist.get_backend()
        self.stage = self.backend != "nccl" and device.type == "cuda"

    @property
    def shape(self) -> dict:
        return {DP_AXIS: self.dp, MP_AXIS: self.mp}

    def mp_line(self) -> list[int]:
        """Global ranks of this rank's mp line (its mesh row), in order."""
        return self.device_mesh.mesh[self.dp_rank].tolist()

    def barrier(self) -> None:
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()


def check_mesh(mesh) -> None:
    """Raise unless `mesh` is None or a Mesh (make_mesh)."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a Mesh from make_mesh, not "
                        f"{type(mesh).__name__}")


def _rank_device(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return dev


def make_mesh(n_devices: int | None = None, dp: int | None = None,
              device=None, timeout=None) -> Mesh:
    """Build a (dp, mp) mesh over the ranks of the default group, creating
    the group first when there is none (see init_distributed). By default
    every rank goes to the base axis ("mp"): ground-truth generation is
    dominated by the base scan. `n_devices` must equal the world size."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = _rank_device(device)
    if dist.is_initialized():
        world = dist.get_world_size()
    else:
        world = _launcher_world() or 1
    if n_devices is None:
        n_devices = world
    if n_devices > world:
        raise ValueError(
            f"asked for a {n_devices}-device mesh but the process group has "
            f"{world} rank(s): start one process per device, e.g. `torchrun "
            f"--nproc-per-node {n_devices} -m neighborhoodwatch_tpu_torch.cli "
            f"... --mesh {n_devices}`")
    if n_devices != world:
        raise ValueError(f"a {n_devices}-device mesh needs every rank of the "
                         f"{world}-rank group on it")
    dp = 1 if dp is None else dp
    if n_devices % dp:
        raise ValueError(f"{n_devices} devices not divisible by dp={dp}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init_distributed(device=dev, timeout=timeout)
    # an NCCL group's lines are NCCL groups; a gloo group's are gloo
    # groups, whatever the device
    mesh_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    device_mesh = init_device_mesh(mesh_type, (dp, n_devices // dp),
                                   mesh_dim_names=(DP_AXIS, MP_AXIS))
    return Mesh(device_mesh, dev)


def _axis_rows(mesh: Mesh, n_rows: int, axis: str) -> tuple[int, int]:
    size = mesh.shape[axis]
    if n_rows % size:
        raise ValueError(f"{n_rows} rows not divisible by {axis}={size}")
    per = n_rows // size
    idx = mesh.dp_rank if axis == DP_AXIS else mesh.mp_rank
    return idx * per, (idx + 1) * per


def query_rows(mesh: Mesh, n_rows: int) -> tuple[int, int]:
    """[lo, hi) of the query rows this rank holds: contiguous over dp."""
    return _axis_rows(mesh, n_rows, DP_AXIS)


def base_rows(mesh: Mesh, n_rows: int) -> tuple[int, int]:
    """[lo, hi) of the base rows this rank holds: contiguous over mp."""
    return _axis_rows(mesh, n_rows, MP_AXIS)


def result_rows(mesh: Mesh, n_rows: int) -> tuple[int, int]:
    """[lo, hi) of the result rows this rank holds: over dp, as queries."""
    return _axis_rows(mesh, n_rows, DP_AXIS)


# ---- collectives (the group's backend decides the host staging) ----

def _staged(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    return t.cpu() if mesh.stage else t


def all_gather(mesh: Mesh, t: torch.Tensor, axis: str) -> torch.Tensor:
    """(n_axis, *t.shape): `t` of every rank of this rank's `axis` line, in
    axis order, on t's device."""
    src = _staged(mesh, t)
    parts = [torch.empty_like(src) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, src, group=mesh.groups[axis])
    return torch.stack(parts).to(device=t.device, dtype=t.dtype)


def all_reduce_max(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Elementwise max of `t` over every rank of the mesh."""
    src = _staged(mesh, t).clone()
    dist.all_reduce(src, op=dist.ReduceOp.MAX)
    return src.to(device=t.device, dtype=t.dtype)


class _Shift:
    def __init__(self, reqs, recv, device):
        self._reqs, self._recv, self._device = reqs, recv, device

    def wait(self) -> torch.Tensor:
        for r in self._reqs:
            r.wait()
        return self._recv.to(self._device)


def ring_shift(mesh: Mesh, t: torch.Tensor) -> _Shift:
    """Post the send of `t` to the next rank of this rank's mp line and the
    receive from the previous one; `.wait()` returns the received tensor."""
    line = mesh.mp_line()
    me = mesh.mp_rank
    src = _staged(mesh, t)
    recv = torch.empty_like(src)
    group = mesh.groups[MP_AXIS]
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, src, line[(me + 1) % mesh.mp], group),
        dist.P2POp(dist.irecv, recv, line[(me - 1) % mesh.mp], group)])
    return _Shift(reqs, recv, t.device)
