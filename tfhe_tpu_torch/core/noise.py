"""Closed-form noise-variance formulas and symbolic noise simulation (port
of tfhe_tpu/core/noise.py, the same formulas).

Analog of core_crypto/commons/noise_formulas/ (SURVEY.md §2.2): per-primitive
output-noise variance used by the statistical test harness
(mean_and_variance_check) and by parameter validation.  Variances are in
absolute torus-squared units scaled to the ciphertext modulus q = 2^bits
(i.e. "modular variance" = Var * q^2 convention of the reference).

The NTT path is *exact*, so the FFT-mantissa error terms of the reference
(PBS_FFT_64_MANTISSA_SIZE = 53 in noise_simulation/mod.rs:29) vanish here:
the exact rotation's PBS noise is the pure algorithmic bound — strictly less
noise than the reference's f64-FFT backend for identical parameters; the
rounded-key rotations (v7, v9) add the BSK-rounding term below.
"""

from __future__ import annotations

from dataclasses import dataclass

import math

from ..utils.csprng import Gaussian, TUniform


def distribution_variance(dist, bits: int) -> float:
    """Modular variance (in units of q^2-scaled torus) of a noise sample."""
    if isinstance(dist, Gaussian):
        return (dist.std * 2.0 ** bits) ** 2
    if isinstance(dist, TUniform):
        return (2.0 ** (2 * dist.bound_log2 + 1) + 1.0) / 6.0
    raise TypeError(dist)


def keyswitch_additive_variance(n_in: int, base_log: int, levels: int,
                                var_ksk: float, bits: int = 64) -> float:
    """Additive variance of an LWE keyswitch (binary keys).

    Two terms (lwe_keyswitch noise formula):
      - KSK noise accumulation: n_in * levels * (B^2+2)/12 * var_ksk
        (each KSK noise sample is scaled by a balanced digit with
        E[d^2] = (B^2+2)/12 — same factor as the external product)
      - decomposition rounding: n_in * (q^2 2^-2(b*l) - 1) / 12 * (1/2)
        (residual multiplies a binary key bit, E[s^2] = 1/2).

    Validated against measured production-parameter phases in
    tests/test_noise_pfail.py (the digit factor is invisible at toy
    parameters where the rounding term dominates).
    """
    b = 2.0 ** base_log
    b2l = 2.0 ** (bits - base_log * levels)
    rounding = n_in * (b2l ** 2 / 12.0 - 1.0 / 12.0) * 0.5
    key_noise = n_in * levels * (b * b + 2.0) / 12.0 * var_ksk
    return key_noise + rounding


def modulus_switch_additive_variance(n: int, log_modulus: int, bits: int = 64) -> float:
    """MS rounding variance: (n/2 + 1) * (2^(bits-log) )^2 / 12 (binary key)."""
    step = 2.0 ** (bits - log_modulus)
    return (n / 2.0 + 1.0) * (step ** 2) / 12.0 - (n / 2.0 + 1.0) / 12.0


def centered_ms_additive_variance(n: int, log_modulus: int,
                                  bits: int = 64) -> float:
    """Centered-binary (mean-shifted) modulus-switch additive variance —
    the v1_4 production default (MsNoiseReduction.CENTERED_MEAN).  Modular
    (q^2-scaled) form of the reference's recorded heuristic
    n * (q^-2/24 + q_new^-2/48)
    (noise_formulas/centered_mean_shifted_modulus_switch.rs:27-35): the
    centering halves the plain MS rounding variance."""
    step = 2.0 ** (bits - log_modulus)
    return n * (1.0 / 24.0 + (step ** 2) / 48.0)


def pbs_output_variance(n_in: int, glwe_dim: int, poly_size: int,
                        base_log: int, levels: int, var_bsk: float,
                        bits: int = 64, bsk_round_bits: int = 0,
                        bsk_mask_floored: bool = False) -> float:
    """Variance after a fresh (classic) PBS with an exact polynomial product.

    Standard external-product accumulation bound for binary GLWE keys
    (lwe_programmable_bootstrap formula, minus the FFT-error term which is
    zero on the exact NTT backend):
      n * [ l*(k+1)*N*(B^2+2)/12 * var_bsk
            + (q^2 B^-2l - 1)/24 * (1 + k*N/2)
            + k*N/32 * B^-2l ... ]  (small terms kept for fidelity)

    bsk_round_bits > 0 adds the rounded-BSK truncation term (the production
    3-prime configuration, ops/bsk_prep.py RoundedKeyNtt): each key coefficient
    gains an independent uniform error over a 2^rb-wide step, variance
    2^(2rb)/12, accumulated through the external product exactly like the
    key noise — see bsk_rounding_additive_variance.
    """
    k = glwe_dim
    n_poly = poly_size
    b = 2.0 ** base_log
    b2l = 2.0 ** (2 * base_log * levels)
    q2 = 2.0 ** (2 * bits)
    term_key = levels * (k + 1) * n_poly * (b * b + 2.0) / 12.0 * var_bsk
    term_round = (q2 / b2l - 1.0) / 24.0 * (1.0 + k * n_poly / 2.0)
    term_small = k * n_poly / 32.0 + 1.0 / 16.0 * (1.0 - k * n_poly / 2.0) ** 2 / b2l
    out = n_in * (term_key + term_round + term_small)
    if bsk_round_bits:
        out += bsk_rounding_additive_variance(
            n_in, glwe_dim, poly_size, base_log, levels, bsk_round_bits,
            mask_floored=bsk_mask_floored)
    return out


def multibit_pbs_output_variance(n_in: int, grouping: int, glwe_dim: int,
                                 poly_size: int, base_log: int, levels: int,
                                 var_bsk: float, bits: int = 64,
                                 bsk_round_bits: int = 0,
                                 bsk_mask_floored: bool = True) -> float:
    """Variance after a fresh multi-bit PBS (grouping factor g) on the exact
    NTT backend — reference counterpart (a fitted curve tied to their FFT
    backend): noise_formulas/lwe_multi_bit_programmable_bootstrap.rs.

    Per group of g bits the effective GGSW is sum_u X^{d_u} E_u with the
    E_u encrypting indicator patterns (core/multibit.py, the reference's
    combine_key_bits convention) and monomial weights:
      * key noise: sum_u ||X^{d_u}||^2 = 2^g per group, so the classic
        per-step key term picks up 2^g per group -> n * 2^g/g total (the
        subset-PRODUCT convention with prod(X^{a_i}-1) weights would pay
        sum_V 2^|V| = 3^g — measured and rejected, see
        tests/test_multibit_fused.py);
      * decomposition terms: exactly ONE pattern carries a non-zero gadget
        plaintext per group, so the closest-representable rounding and
        small terms appear once per GROUP — 1/g of the classic count;
      * BSK rounding (rb > 0): the 2^g pattern tensors are rounded
        independently -> 2^g per group (mask-floored: body-only).
    """
    k = glwe_dim
    n_poly = poly_size
    b = 2.0 ** base_log
    b2l = 2.0 ** (2 * base_log * levels)
    q2 = 2.0 ** (2 * bits)
    groups = n_in / grouping
    term_key = (2.0 ** grouping) * levels * (k + 1) * n_poly \
        * (b * b + 2.0) / 12.0 * var_bsk
    term_round = (q2 / b2l - 1.0) / 24.0 * (1.0 + k * n_poly / 2.0)
    term_small = k * n_poly / 32.0 \
        + 1.0 / 16.0 * (1.0 - k * n_poly / 2.0) ** 2 / b2l
    out = groups * (term_key + term_round + term_small)
    if bsk_round_bits:
        var_rnd = 2.0 ** (2 * bsk_round_bits) / 12.0
        amp = 1.0 if bsk_mask_floored else (1.0 + k * n_poly / 2.0)
        out += groups * (2.0 ** grouping) * levels * (k + 1) * n_poly \
            * (b * b + 2.0) / 12.0 * var_rnd * amp
    return out


def bsk_rounding_additive_variance(n_in: int, glwe_dim: int, poly_size: int,
                                   base_log: int, levels: int,
                                   round_bits: int,
                                   mask_floored: bool = False) -> float:
    """Extra PBS output variance from rounding every BSK coefficient to a
    multiple of 2^round_bits (the rounded key of the v7 rotation, ops/bsk_prep.py).

    Each of the n * l*(k+1)*N accumulated products multiplies a balanced
    digit (E[d^2] = (B^2+2)/12) by an independent uniform rounding error in
    (-2^(rb-1), 2^(rb-1)] (variance 2^(2rb)/12).  Unlike the BSK encryption
    noise (body-only), rounding perturbs the GGSW MASK coefficients too, and
    a mask error e_a enters the decrypted phase convolved with the binary
    GLWE secret (e_a (*) s, per-coefficient variance k*N/2 * var_e) — the
    same (1 + k*N/2) amplification as the decomposition-rounding term:

        n * l*(k+1)*N * (B^2+2)/12 * 2^(2rb)/12 * (1 + k*N/2)

    Empirically confirmed (rounded-vs-unrounded key on identical inputs,
    tests/test_noise_rounded_bsk.py): at N=256, k=1 the measured factor is
    ~143 vs the 129 of this formula's tail — within sampling tolerance.

    mask_floored=True: the key was first passed through bsk_prep.mask_floor_bsk
    (masks exact multiples of 2^rb, phase-preserving), so rounding only
    perturbs the BODY coefficient and the (1 + k*N/2) amplification
    vanishes.  This is the production ServerKey configuration.
    """
    b = 2.0 ** base_log
    k = glwe_dim
    var_round = 2.0 ** (2 * round_bits) / 12.0
    amp = 1.0 if mask_floored else (1.0 + k * poly_size / 2.0)
    return (n_in * levels * (k + 1) * poly_size
            * (b * b + 2.0) / 12.0 * var_round * amp)


@dataclass
class NoiseSimulationLwe:
    """Symbolic ciphertext: propagates variance instead of data
    (noise_simulation/mod.rs).  All variances are modular (q^2-scaled)."""

    lwe_dimension: int
    variance: float
    bits: int = 64

    @classmethod
    def encrypt(cls, dist, lwe_dimension: int, bits: int = 64):
        return cls(lwe_dimension, distribution_variance(dist, bits), bits)

    def add(self, other: "NoiseSimulationLwe") -> "NoiseSimulationLwe":
        return NoiseSimulationLwe(self.lwe_dimension, self.variance + other.variance, self.bits)

    def scalar_mul(self, scalar: int) -> "NoiseSimulationLwe":
        return NoiseSimulationLwe(self.lwe_dimension, self.variance * scalar * scalar, self.bits)

    def keyswitch(self, n_out: int, base_log: int, levels: int, ksk_dist) -> "NoiseSimulationLwe":
        var = self.variance + keyswitch_additive_variance(
            self.lwe_dimension, base_log, levels,
            distribution_variance(ksk_dist, self.bits), self.bits)
        return NoiseSimulationLwe(n_out, var, self.bits)

    def pbs(self, params) -> "NoiseSimulationLwe":
        """Fresh PBS output noise for BootstrapParams-like params."""
        var = pbs_output_variance(
            self.lwe_dimension, params.glwe_dimension, params.polynomial_size,
            params.pbs_decomp.base_log, params.pbs_decomp.level_count,
            distribution_variance(params.glwe.noise, self.bits), self.bits)
        return NoiseSimulationLwe(
            params.glwe_dimension * params.polynomial_size, var, self.bits)


def variance_to_std_log2(variance: float) -> float:
    return 0.5 * math.log2(variance) if variance > 0 else float("-inf")


def packing_keyswitch_additive_variance(n_in: int, base_log: int, levels: int,
                                        var_pksk: float, lwe_to_pack: int,
                                        bits: int = 64) -> float:
    """Additive variance of packing LWEs into one GLWE (modular form of
    noise_formulas/lwe_packing_keyswitch.rs:39-61 with the actual PKSK noise
    in place of the minimal-security curve):

        l * n_in * packed * (B^2+2)/12 * var_pksk
        + n_in/2 * (1/6 + (q B^-l)^2 / 12)
    """
    b = 2.0 ** base_log
    b2l = 2.0 ** (bits - base_log * levels)
    key = levels * n_in * lwe_to_pack * (b * b + 2.0) / 12.0 * var_pksk
    rounding = 0.5 * n_in * (1.0 / 6.0 + (b2l ** 2) / 12.0)
    return key + rounding
