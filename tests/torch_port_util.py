"""Shared helper of the tests/test_torch_port_*.py files."""

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
