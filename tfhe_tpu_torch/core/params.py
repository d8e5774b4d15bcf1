"""Core parameter types.

Mirrors tfhe/src/core_crypto/commons/parameters.rs conceptually: instead of
one newtype per quantity, a small set of frozen dataclasses captures the
LWE/GLWE/PBS parameter bundles used across layers.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..utils.csprng import Gaussian, TUniform

# the noise distributions of the parameter sets
NoiseDistribution = TUniform | Gaussian


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


# The test-vector sets of apps/test-vectors/src/main.rs:17-43
# (tfhe_tpu/core/params.py:99-111): a realistic set and a noiseless toy set.
TEST_VECTOR_VALID_PARAMS = BootstrapParams(
    lwe=LweParams(833, Gaussian(3.6158408373309336e-06)),
    glwe=GlweParams(1, 2048, Gaussian(2.845267479601915e-15)),
    pbs_decomp=DecompParams(23, 1),
    ks_decomp=DecompParams(3, 5),
)

TEST_VECTOR_TOY_PARAMS = BootstrapParams(
    lwe=LweParams(10, Gaussian(0.0)),
    glwe=GlweParams(1, 256, Gaussian(0.0)),
    pbs_decomp=DecompParams(24, 1),
    ks_decomp=DecompParams(37, 1),
)
