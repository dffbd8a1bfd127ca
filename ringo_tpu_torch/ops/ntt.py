"""Host helpers of the negacyclic NTT that the matmul-NTT tables need."""

from __future__ import annotations

import numpy as np


def bit_reverse_permutation(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    out = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        out |= ((idx >> b) & 1) << (bits - 1 - b)
    return out
