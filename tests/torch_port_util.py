"""Shared helpers of the tests/test_torch_port_*.py files."""

import os
import socket
import subprocess
import sys
import time

import numpy as np


def assert_ids_tie_tolerant(got, want, oracle_sorted, tol):
    """Neighbour ids of two engines, (Q, k) each, held against each other
    with ties allowed: ids must be equal at every position whose float64
    oracle value differs from both of its neighbours' by more than `tol`
    (the stated value tolerance); where it does not, the two sides may
    list the tied ids in another order. The id sets of every row must be
    equal, except for a row whose k-th and (k+1)-th oracle values tie
    within `tol`: there either side may hold any member of the tie, so the
    sets are compared over the positions before the last separated gap
    only. `oracle_sorted` holds the oracle's values, best first: (Q, k + 1)
    or wider to see that boundary, (Q, k) where the candidate set has no
    (k+1)-th member or the caller cannot give one."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    k = got.shape[1]
    o = np.asarray(oracle_sorted, dtype=np.float64)
    assert o.shape[1] >= k
    # gap[:, j]: the values at j and j + 1 are separated
    gap = np.abs(np.diff(o[:, :k + 1], axis=1)) > tol
    if gap.shape[1] < k:                    # no (k+1)-th value: closed set
        gap = np.concatenate([gap, np.ones((len(o), 1), dtype=bool)], axis=1)
    sep = gap.copy()                        # separated from the next ...
    sep[:, 1:] &= gap[:, :-1]               # ... and from the one before
    np.testing.assert_array_equal(got[sep], want[sep])
    for r in range(len(got)):
        # positions 0..n-1 form a closed set when gap n-1 is separated
        closed = np.nonzero(gap[r])[0]
        n = int(closed[-1]) + 1 if len(closed) else 0
        assert set(got[r, :n].tolist()) == set(want[r, :n].tolist()), r


def maxsim_oracle_wide(q, qm, d, dm, k):
    """The float64 MaxSim oracle's (scores (Q, k), ids (Q, k), scores
    (Q, min(k + 1, D))): the last is what assert_ids_tie_tolerant needs to
    see a tie across the k-th boundary."""
    from neighborhoodwatch_tpu.ops.maxsim import maxsim_oracle
    wide, idx = maxsim_oracle(q, qm, d, dm, min(k + 1, len(d)))
    return wide[:, :k], idx[:, :k], wide


WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_port_mesh_worker.py")


def start_mesh_ranks(suite, world, dp, out_dir):
    """Start `world` gloo ranks of tests/torch_port_mesh_worker.py on the
    CPU; returns the processes (see wait_mesh_ranks)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
    return [subprocess.Popen(
        [sys.executable, WORKER, suite, str(rank), str(world), str(dp),
         str(port), str(out_dir)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env)
        for rank in range(world)]


def wait_mesh_ranks(procs, timeout=400):
    """Wait for every rank; a rank that fails or outlives `timeout`
    seconds fails the caller, and no rank is left running."""
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"


def load_rank_results(out_dir, name, world):
    """[dict of arrays per rank] of one case."""
    res = []
    for rank in range(world):
        with np.load(os.path.join(str(out_dir), f"{name}.r{rank}.npz")) as z:
            res.append({k: z[k] for k in z.files})
    return res
