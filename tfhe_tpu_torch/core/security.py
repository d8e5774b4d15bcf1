"""Security check of a noise distribution against the lattice-estimator
fits (port of tfhe_tpu/core/security.py, the TUniform part).

The server key uses it to decide whether flooring the BSK masks keeps a
parameter set above the minimal-noise-for-security curve the reference
records from the lattice estimator
(core_crypto/commons/noise_formulas/secure_noise.rs — fits at 132-bit
classical security).  The curve constants are those recorded fits.
"""

from __future__ import annotations

import math

from ..utils.csprng import TUniform

LOG2_E = math.log2(math.e)


def minimal_lwe_bound_tuniform(lwe_dimension: int, modulus: float) -> int:
    """Minimal TUniform bound log2 for 132-bit security
    (secure_noise.rs:88-96)."""
    return math.ceil(-0.025167785 * lwe_dimension
                     + LOG2_E * math.log(modulus) + 4.10067100000001)


def check_lwe_noise_secure(dist, lwe_dimension: int,
                           modulus_log2_shrink: int = 0) -> tuple:
    """(ok, detail) — does `dist` meet 132-bit security at this dimension?

    modulus_log2_shrink: effective ciphertext modulus 2^(64 - shrink) with
    the SAME absolute noise (the mask-floored BSK case,
    ops/bsk_prep.mask_floor_bsk).
    """
    q = 2.0 ** (64 - modulus_log2_shrink)
    if isinstance(dist, TUniform):
        # absolute bound 2^b at 2^64 == bound 2^(b - shrink) at the
        # shrunk modulus (flooring divides the whole sample grid)
        eff_bound = dist.bound_log2 - modulus_log2_shrink
        need = minimal_lwe_bound_tuniform(lwe_dimension, q)
        return eff_bound >= need, (
            f"TUniform bound 2^{eff_bound} vs minimal 2^{need} "
            f"at n={lwe_dimension}, q=2^{64 - modulus_log2_shrink}")
    raise TypeError(dist)

