"""Core parameter types.

Mirrors tfhe/src/core_crypto/commons/parameters.rs conceptually: instead of
one newtype per quantity, a small set of frozen dataclasses captures the
LWE/GLWE/PBS parameter bundles used across layers.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..utils.csprng import TUniform

# the noise distributions the port's parameter sets use (Gaussian sets come
# with the slices that port them)
NoiseDistribution = TUniform


@dataclass(frozen=True)
class CiphertextModulus:
    """Native power-of-two ciphertext modulus 2^bits for bits in {32, 64}.

    (Non-native moduli — e.g. the 2N modulus after a modulus switch — are
    handled locally by the ops that need them, as in the reference's
    power-of-two encoding convention.)
    """

    bits: int = 64

    @property
    def modulus(self) -> int:
        return 1 << self.bits


@dataclass(frozen=True)
class LweParams:
    dimension: int
    noise: NoiseDistribution
    modulus: CiphertextModulus = CiphertextModulus(64)


@dataclass(frozen=True)
class GlweParams:
    dimension: int  # k
    polynomial_size: int  # N
    noise: NoiseDistribution
    modulus: CiphertextModulus = CiphertextModulus(64)

    @property
    def equivalent_lwe_dimension(self) -> int:
        return self.dimension * self.polynomial_size


@dataclass(frozen=True)
class DecompParams:
    base_log: int
    level_count: int

    @property
    def base(self) -> int:
        return 1 << self.base_log


@dataclass(frozen=True)
class BootstrapParams:
    """Everything needed for the classic KS->PBS atomic pattern at core level.

    Mirrors the test-vector parameter bundles and shortint's
    ClassicPBSParameters (shortint/parameters/classic.rs:37).
    """

    lwe: LweParams          # small key (n), and its noise for KSK
    glwe: GlweParams        # big key (k, N), and its noise for BSK
    pbs_decomp: DecompParams
    ks_decomp: DecompParams

    @property
    def lwe_dimension(self) -> int:
        return self.lwe.dimension

    @property
    def glwe_dimension(self) -> int:
        return self.glwe.dimension

    @property
    def polynomial_size(self) -> int:
        return self.glwe.polynomial_size

    @property
    def big_lwe_dimension(self) -> int:
        return self.glwe.equivalent_lwe_dimension

    @property
    def bits(self) -> int:
        return self.glwe.modulus.bits
