"""Small shared utilities (counterpart of neighborhoodwatch_tpu/utils/misc.py)."""

import numpy as np


def is_zero_embedding(embedding) -> bool:
    """True if every component is zero. Zero vectors mark failed
    embedding-API calls and are skipped downstream."""
    return not np.any(np.asarray(embedding))


def output_dimension_validity_check(model_name: str, given_dimension: int,
                                    actual_dimension: int) -> bool:
    """Binary-packed Voyage embeddings store 8 dims per output byte."""
    pass_check = actual_dimension == given_dimension
    if model_name == "voyage-3-large":
        pass_check = pass_check or given_dimension == 8 * actual_dimension
    return pass_check


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m
