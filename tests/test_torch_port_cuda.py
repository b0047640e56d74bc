"""The port's CUDA kernel against its plain PyTorch version, on the card.

This file imports neither jax nor the JAX package, so it runs where the
card is and JAX is not installed:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q

Without a card its tests skip (the kernel has no CPU mode); the CPU tests
hold the plain version against the JAX reference."""

import numpy as np
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


def _operands(q, b):
    qh = tsk.bf16_round(q)
    bhi = tsk.bf16_round(b).to(torch.bfloat16)
    return dict(qhi=qh.to(torch.bfloat16), qlo=(q - qh).to(torch.bfloat16),
                bhi=bhi, blo=(b - bhi.float()).to(torch.bfloat16),
                qn=(q * q).sum(1), bn=(b * b).sum(1))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [200, 45])
def test_screen_kernel_matches_plain(cuda, d):
    """passes 1/2/3 x l2/dot/rdot on ragged Q and B; D=200 takes the
    16-byte cp.async path, D=45 the scalar one. Tolerance as in
    tests/test_torch_port_screen.py: masked entries masked on both sides,
    every distance within (PACK_EPS_REL + 4 acc_rel(D)) x scale, and row
    ids different only between rows that close."""
    rng = np.random.default_rng(29)
    q = torch.from_numpy(rng.standard_normal((70, d)).astype(np.float32))
    b = torch.from_numpy(
        rng.standard_normal((MEGA + 555, d)).astype(np.float32))
    q, b = q.to(cuda), b.to(cuda)
    ops = _operands(q, b)
    q64, b64 = q.double(), b.double()
    qn, bn_max = (q64 ** 2).sum(1), (b64 ** 2).sum(1).max()
    scales = {"l2": qn + bn_max, "dot": qn.sqrt() * bn_max.sqrt(),
              "rdot": qn.sqrt()}
    before = tsk.screen_keys.launches
    for passes in (1, 2, 3):
        for epi in tsk.EPILOGUES:
            k = tsk.screen_keys(**ops, mega_rows=MEGA, passes=passes,
                                epilogue=epi)
            kp = tsk.screen_keys_plain(**ops, mega_rows=MEGA, passes=passes,
                                       epilogue=epi)
            dk, ik = tsk._decode_keys(k, epi, MEGA)
            dp, ip = tsk._decode_keys(kp, epi, MEGA)
            fin = torch.isfinite(dp)
            assert torch.equal(torch.isfinite(dk), fin)
            tol = (tsk.PACK_EPS_REL + 4 * tknn._acc_rel(d)) \
                * scales[epi][:, None]
            diff = torch.where(fin, (dk.double() - dp.double()).abs(),
                               torch.zeros_like(tol))
            assert bool((diff <= tol).all()), (passes, epi)
            swapped = fin & (ik != ip)
            assert bool((diff[swapped] <= tol.expand_as(diff)[swapped])
                        .all())
    assert tsk.screen_keys.launches == before + 9


@pytest.mark.cuda
def test_wrapper_checks_its_inputs(cuda):
    q = torch.zeros((4, 16), dtype=torch.bfloat16, device=cuda)
    qn = torch.zeros(4, device=cuda)
    with pytest.raises(TypeError):
        tsk.screen_keys(q.float(), q, q, q, qn, qn, MEGA, 1, "l2")
    with pytest.raises(ValueError, match="contiguous"):
        tsk.screen_keys(q.T.contiguous().T, q, q, q, qn, qn, MEGA, 1, "l2")


@pytest.mark.cuda
def test_auto_engine_launches_the_kernel(cuda):
    """knn(engine="auto") on CUDA tensors of >= 2 megas picks the screened
    engine, launches the kernel and matches the exact engine."""
    g = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn(40, 96, device=cuda, generator=g)
    b = torch.randn(2 * MEGA + 100, 96, device=cuda, generator=g)
    before = tsk.screen_keys.launches
    d, i = tknn.knn(q, b, 20)
    assert tsk.screen_keys.launches == before + 1
    de, ie = tknn.knn(q, b, 20, engine="exact")
    assert torch.equal(i, ie)
    assert float((d - de).abs().max()) <= 1e-4
