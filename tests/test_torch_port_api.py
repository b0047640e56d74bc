"""PyTorch port's small API pieces against their JAX counterparts on the
same inputs: similarity_from_distance, read_hdf5_group, find_duplicates,
tune_memory, dot_product, _filter_dataset_by_title and the streaming
accumulators' force_state."""

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neighborhoodwatch_tpu.core import tuner as jtuner
from neighborhoodwatch_tpu.data import sources as jsources
from neighborhoodwatch_tpu.io import hdf5_io as jhdf5
from neighborhoodwatch_tpu.ops import distance as jdistance
from neighborhoodwatch_tpu.ops import knn as jknn
from neighborhoodwatch_tpu.ops import maxsim as jmaxsim
from neighborhoodwatch_tpu import validate as jvalidate

from neighborhoodwatch_tpu_torch.core import tuner as ttuner
from neighborhoodwatch_tpu_torch.data import sources as tsources
from neighborhoodwatch_tpu_torch.io import hdf5_io as thdf5
from neighborhoodwatch_tpu_torch.ops import distance as tdistance
from neighborhoodwatch_tpu_torch.ops import knn as tknn
from neighborhoodwatch_tpu_torch.ops import maxsim as tmaxsim
from neighborhoodwatch_tpu_torch import validate as tvalidate


@pytest.mark.parametrize("metric", ["sqeuclidean", "cosine", "dot"])
def test_similarity_from_distance(metric):
    d = np.random.default_rng(0).random((5, 7)).astype(np.float32) * 2
    want = np.asarray(jdistance.similarity_from_distance(jnp.asarray(d),
                                                         metric))
    np.testing.assert_array_equal(tdistance.similarity_from_distance(d,
                                                                     metric),
                                  want)
    got = tdistance.similarity_from_distance(torch.from_numpy(d), metric)
    np.testing.assert_array_equal(got.numpy(), want)


def test_similarity_from_distance_rejects_euclidean():
    for mod in (jdistance, tdistance):
        with pytest.raises(ValueError, match="euclidean"):
            mod.similarity_from_distance(np.ones(3), "euclidean")


@pytest.fixture()
def h5_file(tmp_path):
    """train with planted duplicate rows, test without, an int group."""
    rng = np.random.default_rng(1)
    train = rng.standard_normal((50, 6)).astype(np.float32)
    train[[3, 9, 40]] = train[1]
    train[22] = train[21]
    path = tmp_path / "x.hdf5"
    with h5py.File(path, "w") as f:
        f.create_dataset("train", data=train)
        f.create_dataset("test", data=rng.standard_normal((10, 6))
                         .astype(np.float32))
        f.create_dataset("neighbors", data=rng.integers(0, 50, (10, 4))
                         .astype(np.int32))
    return path


@pytest.mark.parametrize("group", ["train", "test", "neighbors"])
def test_read_hdf5_group(h5_file, group):
    got = thdf5.read_hdf5_group(str(h5_file.parent), h5_file.name, group)
    want = jhdf5.read_hdf5_group(str(h5_file.parent), h5_file.name, group)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_find_duplicates(h5_file):
    for groups in (("train", "test"), ("train", "missing", "neighbors")):
        got = thdf5.find_duplicates(str(h5_file), groups)
        assert got == jhdf5.find_duplicates(str(h5_file), groups)
    assert got["train"] == {"rows": 50, "duplicate_groups": 2,
                            "duplicate_rows": 4}
    assert thdf5.find_duplicates(str(h5_file)) == \
        jhdf5.find_duplicates(str(h5_file))


@pytest.mark.parametrize("args", [
    (5000, 100, 384, 10, 100_000, 0.1),
    (10_000_000, 10_000, 1536, 100, 500_000, 0.5),
    (0, 1000, 768, 100, 100_000, 0.5),
    (3_000_000, 200_000, 3072, 1000, 0, 0.9),
])
def test_tune_memory(args):
    """The CPU budget is the same fixed host budget in both packages."""
    assert ttuner.tune_memory(*args, device="cpu") == \
        jtuner.tune_memory(*args)


def test_dot_product():
    rng = np.random.default_rng(2)
    a, b = rng.standard_normal(384), rng.standard_normal(384)
    for x, y in ((a, b), (a.astype(np.float32), b.astype(np.float32)),
                 ([1, 2, 3], [4, 5, 6])):
        got = tvalidate.dot_product(x, y)
        assert isinstance(got, float)
        assert got == jvalidate.dot_product(x, y)


@pytest.mark.parametrize("keep_in", [True, False])
def test_filter_dataset_by_title(keep_in):
    import datasets as hfds
    titles = [f"Topic_{i % 7}" for i in range(300)]
    ds = hfds.Dataset.from_dict({"title": titles,
                                 "text": [f"body {i}" for i in range(300)]})
    view = ds.select(range(0, 300, 2))     # an _indices mapping
    qset = {"Topic 1", "Topic 4"}
    # HF datasets (the arrow mask, a view through its mapping) and the
    # synthetic list source (two .filter passes; titles "Topic 0".."23")
    for src in (ds, view, tsources.synthetic_dataset("base", 120, seed=3)):
        got = tsources._filter_dataset_by_title(src, qset, keep_in)
        want = jsources._filter_dataset_by_title(src, qset, keep_in)
        assert [dict(r) for r in got] == [dict(r) for r in want]
        assert len(got) > 0


def test_force_state():
    rng = np.random.default_rng(4)
    q = rng.standard_normal((6, 8)).astype(np.float32)
    b = rng.standard_normal((50, 8)).astype(np.float32)
    t = tknn.StreamingKNN(q, k=5, device="cpu")
    j = jknn.StreamingKNN(q, k=5)
    for acc in (t, j):
        acc.update(b, 0)
        before = [np.array(x) for x in acc.state]
        assert acc.force_state(acc.state) is None
        for x, y in zip(before, acc.state):
            np.testing.assert_array_equal(x, np.asarray(y))
    np.testing.assert_array_equal(t.state[1].numpy(), np.asarray(j.state[1]))

    qt = rng.standard_normal((2, 3, 8)).astype(np.float32)
    qm = np.ones((2, 3), bool)
    docs = rng.standard_normal((40, 4, 8)).astype(np.float32)
    dm = np.ones((40, 4), bool)
    t = tmaxsim.StreamingMaxSim(qt, qm, k=3, device="cpu")
    j = jmaxsim.StreamingMaxSim(qt, qm, k=3)
    for acc in (t, j):
        acc.update(docs, dm, 0)
        before = [np.array(x) for x in acc.state]
        assert acc.force_state(acc.state) is None
        for x, y in zip(before, acc.state):
            np.testing.assert_array_equal(x, np.asarray(y))
    np.testing.assert_array_equal(t.state[1].numpy(), np.asarray(j.state[1]))
