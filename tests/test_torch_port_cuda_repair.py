"""The port's host-repair engine `ops/knn.py:screened_knn` on the card: it
launches the screen kernel and matches the exact engine.

This file imports neither jax nor the JAX package, so it runs where the
card is and JAX is not installed:

    python -m pytest --noconftest tests/test_torch_port_cuda_repair.py -q

Without a card its tests skip (the kernel has no CPU mode);
tests/test_torch_port_screened.py holds the engine against the JAX
package on the CPU."""

import pytest
import torch

from neighborhoodwatch_tpu_torch.ops import knn as tknn
from neighborhoodwatch_tpu_torch.ops import screen_kernel as tsk

MEGA = tsk.MEGA


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["auto", "high"])
def test_host_repair_engine_launches_the_kernel(cuda, precision):
    """screened_knn on CUDA tensors launches the kernel once (the base is
    one mega plus a ragged tail) and matches the exact engine, a planted
    five-row bin collision repaired on the host included; a tiny base
    launches nothing."""
    g = torch.Generator(device=cuda).manual_seed(6)
    q = torch.randn(40, 64, device=cuda, generator=g)
    b = torch.randn(MEGA + 1000, 64, device=cuda, generator=g)
    for j in range(5):
        b[7 + j * 128] = q[0] + 1e-6 * j
    before = tsk.screen_keys.launches
    d, i = tknn.screened_knn(q, b, 10, screen_precision=precision,
                             base_offset=3)
    assert tsk.screen_keys.launches == before + 1
    de, ie = tknn.knn(q, b, 10, engine="exact", base_offset=3)
    # the five planted rows tie at distance ~0: row 0 as a set
    assert torch.equal(i[1:], ie[1:])
    assert set(i[0].tolist()) == set(ie[0].tolist())
    assert {7 + j * 128 + 3 for j in range(5)} <= set(i[0].tolist())
    assert float((d - de).abs().max()) <= 1e-4
    tknn.screened_knn(q, b[:1000], 10)
    assert tsk.screen_keys.launches == before + 1
