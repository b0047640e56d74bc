"""Derived seeds: every random stream of a run comes from (--seed, tags),
so the same seed gives the same inputs, and streams never overlap."""

import numpy as np
import torch

# tags of the streams
BASE, QUERY, WEIGHTS, TEXT, SAMPLE, WARM = 1, 2, 3, 4, 5, 6


def derive(seed: int, *tags: int) -> int:
    """A 63-bit seed from a run's seed (any whole number) and tags."""
    seq = np.random.SeedSequence([seed % (1 << 64), *tags])
    return int(seq.generate_state(1, np.uint64)[0]) & ((1 << 63) - 1)


def numpy_rng(seed: int, *tags: int) -> np.random.Generator:
    return np.random.default_rng(derive(seed, *tags))


def torch_gen(device, seed: int, *tags: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, *tags))
