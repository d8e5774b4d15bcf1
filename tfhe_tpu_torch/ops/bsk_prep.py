"""Host-side preparation of the coefficient-domain bootstrapping key for the
v7 and v9 blind rotations: mask flooring at key generation, centered
rounding, and the multi-bit rounding rule.

Counterpart: tfhe_tpu/ops/mxu.py ``mask_floor_bsk`` and ``round_bsk``
(:201-274).  Both packages must hold the same key bytes, so the flooring
keeps tfhe_tpu's float64 matrix product, which is exact here
(|sum| <= N * 2^rb < 2^53).  A multi-bit key is floored and rounded
flattened to (n/g 2^g, l, k+1, k+1, N).
"""

from __future__ import annotations

import math

import numpy as np

from ..core.entities import LweBootstrapKey

# the first three of tfhe_tpu's 28-bit MXU primes (tfhe_tpu/ops/mxu.py:44):
# the v9 rounding is sized for its 3-prime product
MXU_PRIMES_3 = (268369921, 268361729, 268271617)


def mask_floor_bsk(bsk: LweBootstrapKey, glwe_sk, round_bits: int) -> LweBootstrapKey:
    """Exact, phase-preserving move of each GLWE row's low mask bits into its
    body: r_j = a_j mod 2^rb, a'_j = a_j - r_j, b' = b - sum_j r_j (*) s_j
    (negacyclic, mod 2^64).  b' - <a', s> = b - <a, s>, so no noise is added
    and a later ``round_bsk`` only perturbs the body.  Needs the GLWE secret
    key, so it runs at key generation."""
    data = np.asarray(bsk.data)
    n = data.shape[-1]
    k = data.shape[3] - 1
    low = data[..., :k, :] & np.uint64((1 << round_bits) - 1)
    out = data.copy()
    out[..., :k, :] -= low
    corr = np.zeros(data.shape[:3] + (n,), dtype=np.uint64)
    idx = np.arange(n)
    assert round_bits + 11 < 52
    for j in range(k):
        s = glwe_sk.data[j].astype(np.int64)
        # negacyclic circulant: mat[i, o] = sign * s[o - i mod n]
        mat = s[(idx[None, :] - idx[:, None]) % n].astype(np.float64)
        mat = mat * np.where(idx[None, :] < idx[:, None], -1.0, 1.0)
        r = low[..., j, :].reshape(-1, n).astype(np.float64)
        prod = r @ mat
        corr += prod.astype(np.int64).astype(np.uint64).reshape(corr.shape)
    out[..., k, :] -= corr
    return LweBootstrapKey(out, bsk.decomp)


def mb_round_bits(p) -> int:
    """The multi-bit key rounding of the v9 blind rotation: the least rb in
    [10, 25) at which the CRT product of tfhe_tpu's first three MXU primes
    exceeds twice the summed-pattern bound 2^g l (k+1) N (B/2) 2^(63-rb)
    (tfhe_tpu/shortint/server_key.py:183-203 with its defaults); 0 if none.
    18 at GROUP_4 2_2, 16 at tfhe_tpu's GROUP_2 set."""
    prod = math.prod(MXU_PRIMES_3)
    for rb in range(10, 25):
        bmax = ((1 << 63) >> rb) + 1
        max_x = ((1 << p.grouping_factor) * p.pbs_level * (p.glwe_dimension + 1)
                 * p.polynomial_size * (1 << (p.pbs_base_log - 1)) * bmax)
        if prod > 2 * max_x:
            return rb
    return 0


def round_bsk(bsk: LweBootstrapKey, round_bits: int) -> LweBootstrapKey:
    """Centered-round every coefficient to a multiple of 2^round_bits (mod
    2^64): the v7 and v9 keys.  The exact external product on this key is
    what the TPU's 3-prime rounded-key kernels compute."""
    half = np.uint64(1 << (round_bits - 1))
    mask = np.uint64((1 << round_bits) - 1)
    with np.errstate(over="ignore"):
        d = (bsk.data.astype(np.uint64) + half) & ~mask
    return LweBootstrapKey(d, bsk.decomp)
