"""The benchmark's fixed arithmetic: the card's published peaks and the
operations and bytes of the measured calls, worked out from shapes alone.

Frozen here so that a change to the program cannot move them.
"""

import math

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

# the screen kernel's key layout (neighborhoodwatch_tpu_torch at its first
# benchmark): a mega-tile of 112 x 1,024 base rows for a base of at least
# 16 x 1,024 x 56 rows and k <= 150, 28 x 1,024 below that; 4 x 128 int32
# keys a (query, mega-tile)
_TB = 1024
_BIG_BASE = 16 * _TB * 56
_KEYS_PER_MEGA = 4 * 128


def flops_per_token(hidden: int, intermediate: int, layers: int,
                    seq: int) -> int:
    """BERT forward FLOPs per token at sequence length `seq`: per layer the
    QKVO projections (4 h^2 multiply-adds), the MLP (2 h i) and the
    attention scores and probabilities (2 seq h); 2 FLOPs a multiply-add.
    (The arithmetic of the port's probes/encoder_probe.py, copied.)"""
    per_layer = 4 * hidden ** 2 + 2 * hidden * intermediate + 2 * seq * hidden
    return 2 * per_layer * layers


def text_flops(hidden: int, intermediate: int, layers: int,
               tokens) -> float:
    """Model FLOPs of texts of the given real token counts, each at its
    own length (no padding)."""
    return float(sum(t * flops_per_token(hidden, intermediate, layers, t)
                     for t in tokens))


def knn_flops(q: int, b: int, d: int) -> float:
    """One product of every query with every base row: 2 Q B D."""
    return 2.0 * q * b * d


def screen_bytes(q: int, b: int, d: int) -> float:
    """The screen's least traffic: the bf16 operands read once and its
    int32 keys written once."""
    mega = _TB * (112 if b >= _BIG_BASE else 28)
    keys = q * math.ceil(b / mega) * _KEYS_PER_MEGA * 4
    return 2.0 * (q + b) * d + keys


def screen_bound_s(q: int, b: int, d: int) -> float:
    """The least time of one screen: the larger of its one bf16 product at
    the tensor-core peak and its bytes at the HBM rate."""
    return max(knn_flops(q, b, d) / PEAK_BF16_FLOPS,
               screen_bytes(q, b, d) / PEAK_HBM_BYTES)
