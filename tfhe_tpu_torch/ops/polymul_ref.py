"""Exact schoolbook negacyclic polynomial multiplication (test oracle).

The port's copy of tfhe_tpu/ops/polymul_ref.py: arbitrary-precision
(Python int) arithmetic, the analog of the reference's deterministic
Karatsuba path (karatsuba_pbs.rs), against which the CRT-NTT products are
held bit for bit (K7's plain version, ops/server.py glwe_keyswitch_sum,
among them).  O(N^2): tests only.
"""

from __future__ import annotations

import numpy as np


def negacyclic_polymul_signed_exact(a_signed, b: np.ndarray, bits: int = 64) -> np.ndarray:
    """Negacyclic product mod 2^bits of ``a`` given as signed Python ints
    (decomposition digits, say) and a uint coefficient vector ``b``."""
    n = len(a_signed)
    bi = [int(x) for x in b]
    out = [0] * n
    for i in range(n):
        ai = int(a_signed[i])
        if ai == 0:
            continue
        for j in range(n):
            k = i + j
            if k < n:
                out[k] += ai * bi[j]
            else:
                out[k - n] -= ai * bi[j]
    mask = (1 << bits) - 1
    return np.array([x & mask for x in out], dtype=np.uint64)


def negacyclic_polymul_exact(a: np.ndarray, b: np.ndarray, bits: int = 64) -> np.ndarray:
    """Negacyclic product mod 2^bits of two uint coefficient vectors."""
    return negacyclic_polymul_signed_exact([int(x) for x in a], b, bits)
