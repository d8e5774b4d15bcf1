"""Security validation of parameter sets against the lattice-estimator fits
(port of tfhe_tpu/core/security.py).

Analog of the reference's CI parameter check
(scripts/execute_lattice_estimator.sh + parameters_check.yml): a parameter
set passes when its noise distribution's variance (or TUniform bound) is at
least the minimum the lattice estimator requires for its LWE dimension and
ciphertext modulus (core_crypto/commons/noise_formulas/secure_noise.rs —
autogenerated fits at 132-bit classical security, the margin backing the
"128-bit" claim).  The curve constants are those recorded fits.  The server
key also uses it to decide whether flooring the BSK masks keeps a set above
the curve.
"""

from __future__ import annotations

import math

from ..utils.csprng import Gaussian, TUniform

LOG2_E = math.log2(math.e)


def minimal_lwe_variance_gaussian(lwe_dimension: int, modulus: float) -> float:
    """Minimal RELATIVE variance (torus units) for 132-bit security with
    Gaussian noise (secure_noise.rs:28-34)."""
    return (2.0 ** (4.0 - 2.88539008177793 * math.log(modulus))
            + 2.0 ** (5.31469187675068 - 0.0497829131652661 * lwe_dimension))


def minimal_lwe_bound_tuniform(lwe_dimension: int, modulus: float) -> int:
    """Minimal TUniform bound log2 for 132-bit security
    (secure_noise.rs:88-96)."""
    return math.ceil(-0.025167785 * lwe_dimension
                     + LOG2_E * math.log(modulus) + 4.10067100000001)


def minimal_lwe_variance_tuniform(lwe_dimension: int, modulus: float) -> float:
    """Minimal RELATIVE variance for 132-bit security with TUniform noise
    (secure_noise.rs:55-69)."""
    b = minimal_lwe_bound_tuniform(lwe_dimension, modulus)
    return (2.0 ** (4.44 - 2.88539008177793 * math.log(modulus))
            + (1.0 / 3.0) * modulus ** -2.0 * (2.0 ** (2 * b) + 0.5))


def check_lwe_noise_secure(dist, lwe_dimension: int, bits: int = 64,
                           modulus_log2_shrink: int = 0) -> tuple:
    """(ok, detail) — does `dist` meet 132-bit security at this dimension?

    modulus_log2_shrink: effective ciphertext modulus 2^(bits - shrink) with
    the SAME absolute noise (the mask-floored BSK case,
    ops/bsk_prep.mask_floor_bsk — a strictly easier requirement, since
    relative noise grows as the modulus shrinks).
    """
    q = 2.0 ** (bits - modulus_log2_shrink)
    if isinstance(dist, TUniform):
        # absolute bound 2^b at 2^bits == bound 2^(b - shrink) at the
        # shrunk modulus (flooring divides the whole sample grid)
        eff_bound = dist.bound_log2 - modulus_log2_shrink
        need = minimal_lwe_bound_tuniform(lwe_dimension, q)
        return eff_bound >= need, (
            f"TUniform bound 2^{eff_bound} vs minimal 2^{need} "
            f"at n={lwe_dimension}, q=2^{bits - modulus_log2_shrink}")
    if isinstance(dist, Gaussian):
        # dist.std is relative to 2^bits; relative to the shrunk modulus it
        # grows by 2^shrink
        rel_var = (dist.std * 2.0 ** modulus_log2_shrink) ** 2
        need = minimal_lwe_variance_gaussian(lwe_dimension, q)
        return rel_var >= need, (
            f"Gaussian var 2^{math.log2(rel_var):.2f} vs minimal "
            f"2^{math.log2(need):.2f} at n={lwe_dimension}")
    raise TypeError(dist)


def check_shortint_params_secure(p) -> list:
    """All security assertions for one ShortintParams-like set; returns a
    list of (name, ok, detail)."""
    out = []
    ok, d = check_lwe_noise_secure(p.lwe_noise, p.lwe_dimension, p.bits)
    out.append(("lwe", ok, d))
    ok, d = check_lwe_noise_secure(
        p.glwe_noise, p.glwe_dimension * p.polynomial_size, p.bits)
    out.append(("glwe", ok, d))
    return out
