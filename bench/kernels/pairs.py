"""Visible (query, key) pairs of an attention call, per (batch, head)."""

import numpy as np


def attention_pairs(sq: int, sk: int, causal: bool, window) -> int:
    """Key ``j`` is seen by query ``i`` iff ``j <= i`` (causal) and
    ``j > i - window`` (a window), queries and keys from position 0."""
    i = np.arange(sq, dtype=np.int64)
    hi = np.minimum(sk, i + 1) if causal else np.full(sq, sk)
    lo = np.maximum(0, i - window + 1) if window is not None else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo, 0).sum())
