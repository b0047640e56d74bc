"""PyTorch/CUDA port of neighborhoodwatch_tpu for one NVIDIA H100.

Same exact-kNN ground-truth pipeline as the JAX package beside it (the
reference), written in PyTorch: plain functions on tensors, an explicit
`device` argument on every entry point, and hand-written Hopper kernels
(`csrc/`) where the JAX package wrote Pallas kernels for the TPU.

Device rule: every entry point takes `device=None`, meaning "cuda". With no
card present the entry point raises unless the caller passed
`device="cpu"` explicitly; there is no silent CPU fallback.

This package imports neither jax nor neighborhoodwatch_tpu.
"""

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """`device` (None = "cuda") -> torch.device; raises when CUDA is asked
    for and no card is present. Also pins full-fp32 matmuls: the exact
    engine, the certificate's re-rank and the validators assume them (TF32
    keeps ~10 mantissa bits, which would void the certificate's eps)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the host")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    assert not torch.backends.cuda.matmul.allow_tf32
    return dev
