"""shortint parameter sets: every set of tfhe_tpu/shortint/params.py (the
classic KS->PBS sets, KS32, PBS->KS, the multi-bit sets, and the dedicated
compact-public-key (PKE) and casting sets), with the same values.

Message space = MessageModulus x CarryModulus (+1 padding bit) in one LWE
(SURVEY.md §2.3).  Numeric values mirror the reference's versioned parameter
tables (tfhe/src/shortint/parameters/v1_4/classic/tuniform/p_fail_2_minus_128/
ks_pbs.rs:29-47 for the canonical 2_2 set).
"""

from __future__ import annotations

import enum
import dataclasses as _dc
from dataclasses import dataclass

from ..core.params import (
    BootstrapParams,
    CiphertextModulus,
    DecompParams,
    GlweParams,
    LweParams,
)
from ..utils.csprng import Gaussian, TUniform


class EncryptionKeyChoice(enum.Enum):
    BIG = "big"
    SMALL = "small"


class MsNoiseReduction(enum.Enum):
    NONE = "none"
    CENTERED_MEAN = "centered_mean"
    # drift technique (modulus_switch_noise_reduction.rs:202): the server
    # adds the best of a public list of zero-encryptions before the MS
    DRIFT = "drift"


@dataclass(frozen=True)
class ShortintParams:
    lwe_dimension: int
    glwe_dimension: int
    polynomial_size: int
    lwe_noise: object
    glwe_noise: object
    pbs_base_log: int
    pbs_level: int
    ks_base_log: int
    ks_level: int
    message_modulus: int
    carry_modulus: int
    max_noise_level: int
    log2_p_fail: float
    encryption_key_choice: EncryptionKeyChoice = EncryptionKeyChoice.BIG
    ms_noise_reduction: MsNoiseReduction = MsNoiseReduction.CENTERED_MEAN
    bits: int = 64
    # AtomicPatternKind: False = Standard KS->PBS (u64 keyswitch);
    # True = KeySwitch32 (u32 KSK, half the keyswitch bytes —
    # shortint/atomic_pattern/ks32.rs, the HPU-native pattern)
    ks32: bool = False
    # drift-technique MS parameters (ModulusSwitchNoiseReductionParams:
    # v1_3 2_2 values: zeros_count=1449, bound=2^58, r_sigma=13.18)
    drift_zeros_count: int = 64
    drift_ms_bound: float = 288230376151711744.0
    drift_r_sigma: float = 13.179852282053789
    drift_input_variance: float = 2.63039184094559e-7

    @property
    def core(self) -> BootstrapParams:
        return BootstrapParams(
            lwe=LweParams(self.lwe_dimension, self.lwe_noise, CiphertextModulus(self.bits)),
            glwe=GlweParams(self.glwe_dimension, self.polynomial_size, self.glwe_noise,
                            CiphertextModulus(self.bits)),
            pbs_decomp=DecompParams(self.pbs_base_log, self.pbs_level),
            ks_decomp=DecompParams(self.ks_base_log, self.ks_level),
        )

    @property
    def big_lwe_dimension(self) -> int:
        return self.glwe_dimension * self.polynomial_size

    @property
    def total_modulus(self) -> int:
        """Plaintext space without the padding bit (msg * carry)."""
        return self.message_modulus * self.carry_modulus

    @property
    def delta(self) -> int:
        """Scaling factor q / (2 * msg * carry) — one padding bit."""
        return (1 << self.bits) // (2 * self.total_modulus)

    @property
    def msg_bits(self) -> int:
        return (self.total_modulus - 1).bit_length()


# Canonical production 2_2 parameters
# (v1_4/classic/tuniform/p_fail_2_minus_128/ks_pbs.rs:29-47)
V1_4_PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128 = ShortintParams(
    lwe_dimension=918,
    glwe_dimension=1,
    polynomial_size=2048,
    lwe_noise=TUniform(45),
    glwe_noise=TUniform(17),
    pbs_base_log=23,
    pbs_level=1,
    ks_base_log=4,
    ks_level=4,
    message_modulus=4,
    carry_modulus=4,
    max_noise_level=5,
    log2_p_fail=-129.58,
)

# 1_1 parameters (v1_4/classic/tuniform/p_fail_2_minus_128/ks_pbs.rs:8-26)
V1_4_PARAM_MESSAGE_1_CARRY_1_KS_PBS_TUNIFORM_2M128 = ShortintParams(
    lwe_dimension=879,
    glwe_dimension=4,
    polynomial_size=512,
    lwe_noise=TUniform(46),
    glwe_noise=TUniform(17),
    pbs_base_log=23,
    pbs_level=1,
    ks_base_log=5,
    ks_level=3,
    message_modulus=2,
    carry_modulus=2,
    max_noise_level=3,
    log2_p_fail=-144.322,
)

# 3_3 parameters (ks_pbs.rs:50-68)
V1_4_PARAM_MESSAGE_3_CARRY_3_KS_PBS_TUNIFORM_2M128 = ShortintParams(
    lwe_dimension=1077,
    glwe_dimension=1,
    polynomial_size=8192,
    lwe_noise=TUniform(41),
    glwe_noise=TUniform(3),
    pbs_base_log=15,
    pbs_level=2,
    ks_base_log=4,
    ks_level=5,
    message_modulus=8,
    carry_modulus=8,
    max_noise_level=9,
    log2_p_fail=-128.992,
)

# 4_4 parameters (ks_pbs.rs:71-89)
V1_4_PARAM_MESSAGE_4_CARRY_4_KS_PBS_TUNIFORM_2M128 = ShortintParams(
    lwe_dimension=1117,
    glwe_dimension=1,
    polynomial_size=65536,
    lwe_noise=TUniform(40),
    glwe_noise=TUniform(3),
    pbs_base_log=11,
    pbs_level=3,
    ks_base_log=3,
    ks_level=7,
    message_modulus=16,
    carry_modulus=16,
    max_noise_level=17,
    log2_p_fail=-141.559,
)

# Insecure fast parameters for unit tests (small N and n; tiny noise so the
# functional semantics — degree bookkeeping, LUT rounds — are exercised
# quickly; NOT secure).  Analog of the reference's toy test configs.
TEST_PARAM_MESSAGE_2_CARRY_2 = ShortintParams(
    lwe_dimension=16,
    glwe_dimension=1,
    polynomial_size=512,
    lwe_noise=TUniform(3),
    glwe_noise=TUniform(3),
    pbs_base_log=23,
    pbs_level=1,
    ks_base_log=4,
    ks_level=4,
    message_modulus=4,
    carry_modulus=4,
    max_noise_level=5,
    log2_p_fail=-40.0,
    ms_noise_reduction=MsNoiseReduction.NONE,
)

# KS32 variant of the test parameters (KeySwitch32 atomic pattern)
TEST_PARAM_MESSAGE_2_CARRY_2_KS32 = _dc.replace(
    TEST_PARAM_MESSAGE_2_CARRY_2, ks32=True, ks_base_log=4, ks_level=3)

# v1_4 KS32 2_2 analog: same compute dims, u32 keyswitch with deeper
# decomposition to keep the (coarser) u32 torus rounding inside budget.  Its
# KSK noise TUniform(45) drawn at 32 bits and masked to 32 bits is uniform
# on the u32 torus, as in tfhe_tpu: its ciphertexts decrypt at random
# (copied for word parity; ROADMAP.md queue 3)
V1_4_PARAM_MESSAGE_2_CARRY_2_KS32_PBS_TUNIFORM_2M128 = _dc.replace(
    V1_4_PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128, ks32=True,
    ks_base_log=4, ks_level=5)


# ---------------------------------------------------------------------------
# pfail tiers (v1_4/classic/tuniform/p_fail_2_minus_{64,40}/ks_pbs.rs — the
# reference versions these via v1_1 aliases; numeric values preserved)
# ---------------------------------------------------------------------------

V1_4_PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M64 = ShortintParams(
    lwe_dimension=879,
    glwe_dimension=1,
    polynomial_size=2048,
    lwe_noise=TUniform(46),
    glwe_noise=TUniform(17),
    pbs_base_log=23,
    pbs_level=1,
    ks_base_log=3,
    ks_level=5,
    message_modulus=4,
    carry_modulus=4,
    max_noise_level=5,
    log2_p_fail=-72.178,
)

V1_4_PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M40 = ShortintParams(
    lwe_dimension=839,
    glwe_dimension=1,
    polynomial_size=2048,
    lwe_noise=TUniform(47),
    glwe_noise=TUniform(17),
    pbs_base_log=23,
    pbs_level=1,
    ks_base_log=3,
    ks_level=5,
    message_modulus=4,
    carry_modulus=4,
    max_noise_level=5,
    log2_p_fail=-57.015,
)

# Gaussian-noise family (v1_4/classic/gaussian/p_fail_2_minus_128/ks_pbs.rs)
V1_4_PARAM_MESSAGE_2_CARRY_2_KS_PBS_GAUSSIAN_2M128 = ShortintParams(
    lwe_dimension=866,
    glwe_dimension=1,
    polynomial_size=2048,
    lwe_noise=Gaussian(2.046151696979124e-06),
    glwe_noise=Gaussian(2.845267479601915e-15),
    pbs_base_log=23,
    pbs_level=1,
    ks_base_log=3,
    ks_level=5,
    message_modulus=4,
    carry_modulus=4,
    max_noise_level=5,
    log2_p_fail=-128.377,
)


# ---------------------------------------------------------------------------
# Multi-bit PBS parameters (shortint/parameters/multi_bit.rs
# MultiBitPBSParameters; values from v1_4/multi_bit/tuniform/
# p_fail_2_minus_128/ks_pbs_gpu.rs, the reference's GPU-default family)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MultiBitPBSParameters(ShortintParams):
    grouping_factor: int = 2
    deterministic_execution: bool = False


V1_4_PARAM_GPU_MULTI_BIT_GROUP_2_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128 = \
    MultiBitPBSParameters(
        lwe_dimension=918,
        glwe_dimension=1,
        polynomial_size=4096,
        lwe_noise=TUniform(45),
        glwe_noise=TUniform(3),
        pbs_base_log=21,
        pbs_level=1,
        ks_base_log=3,
        ks_level=5,
        message_modulus=4,
        carry_modulus=4,
        max_noise_level=5,
        log2_p_fail=-140.341,
        grouping_factor=2,
    )

V1_4_PARAM_GPU_MULTI_BIT_GROUP_3_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128 = \
    MultiBitPBSParameters(
        lwe_dimension=879,
        glwe_dimension=1,
        polynomial_size=2048,
        lwe_noise=TUniform(46),
        glwe_noise=TUniform(17),
        pbs_base_log=14,
        pbs_level=2,
        ks_base_log=2,
        ks_level=8,
        message_modulus=4,
        carry_modulus=4,
        max_noise_level=5,
        log2_p_fail=-128.29,
        grouping_factor=3,
    )

V1_4_PARAM_GPU_MULTI_BIT_GROUP_4_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128 = \
    MultiBitPBSParameters(
        lwe_dimension=920,
        glwe_dimension=1,
        polynomial_size=2048,
        lwe_noise=TUniform(45),
        glwe_noise=TUniform(17),
        pbs_base_log=22,
        pbs_level=1,
        ks_base_log=3,
        ks_level=5,
        message_modulus=4,
        carry_modulus=4,
        max_noise_level=5,
        log2_p_fail=-134.345,
        grouping_factor=4,
    )

# tfhe_tpu's own multi-bit set (not a reference set): grouping 2 at N = 2048,
# pbs_base_log 22 so the summed-pattern CRT bound fits three primes at rb 16
TPU_PARAM_MULTI_BIT_GROUP_2_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128 = \
    MultiBitPBSParameters(
        lwe_dimension=918,
        glwe_dimension=1,
        polynomial_size=2048,
        lwe_noise=TUniform(45),
        glwe_noise=TUniform(17),
        pbs_base_log=22,
        pbs_level=1,
        ks_base_log=3,
        ks_level=5,
        message_modulus=4,
        carry_modulus=4,
        max_noise_level=5,
        log2_p_fail=-137.46,
        grouping_factor=2,
    )

V1_4_PARAM_GPU_MULTI_BIT_GROUP_4_MESSAGE_1_CARRY_1_KS_PBS_TUNIFORM_2M128 = \
    MultiBitPBSParameters(
        lwe_dimension=760,
        glwe_dimension=1,
        polynomial_size=2048,
        lwe_noise=TUniform(49),
        glwe_noise=TUniform(17),
        pbs_base_log=22,
        pbs_level=1,
        ks_base_log=3,
        ks_level=4,
        message_modulus=2,
        carry_modulus=2,
        max_noise_level=3,
        log2_p_fail=-145.020,
        grouping_factor=4,
    )

# fast insecure multi-bit test set (grouping must divide lwe_dimension)
TEST_PARAM_MULTI_BIT_GROUP_2_MESSAGE_2_CARRY_2 = MultiBitPBSParameters(
    lwe_dimension=16,
    glwe_dimension=1,
    polynomial_size=512,
    lwe_noise=TUniform(3),
    glwe_noise=TUniform(3),
    pbs_base_log=23,
    pbs_level=1,
    ks_base_log=4,
    ks_level=4,
    message_modulus=4,
    carry_modulus=4,
    max_noise_level=5,
    log2_p_fail=-40.0,
    ms_noise_reduction=MsNoiseReduction.NONE,
    grouping_factor=2,
)

PARAM_MESSAGE_2_CARRY_2_KS_PBS = V1_4_PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128
DEFAULT_PARAMS = V1_4_PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128


# ---------------------------------------------------------------------------
# Dedicated compact-public-key (PKE) parameter sets + casting parameters
# (v1_4/compact_public_key_only/p_fail_2_minus_128/ks_pbs.rs,
#  v1_4/key_switching/p_fail_2_minus_128/ks_pbs.rs)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CompactPublicKeyEncryptionParameters:
    """CompactPublicKeyEncryptionParameters (shortint/parameters/
    compact_public_key_only.rs): compact lists are encrypted under this
    DEDICATED instance and cast into the compute set during expansion
    (expansion_kind = RequiresCasting)."""

    encryption_lwe_dimension: int
    encryption_noise: object
    message_modulus: int
    carry_modulus: int
    zk_scheme: int = 2            # SupportedCompactPkeZkScheme::V{1,2}
    bits: int = 64
    # the compact PK is GLWE-shaped: k=1, N = encryption_lwe_dimension
    # (derived views so the compact-list machinery can consume this set)

    @property
    def polynomial_size(self) -> int:
        return self.encryption_lwe_dimension

    @property
    def glwe_dimension(self) -> int:
        return 1

    @property
    def glwe_noise(self):
        return self.encryption_noise

    @property
    def total_modulus(self) -> int:
        return self.message_modulus * self.carry_modulus

    @property
    def delta(self) -> int:
        return (1 << self.bits) // (2 * self.total_modulus)


@dataclass(frozen=True)
class ShortintKeySwitchingParameters:
    """shortint/parameters/key_switching.rs: casting-key decomposition +
    which compute key the cast lands on ("small" needs a PBS to reach the
    big key; "big" is directly usable)."""

    ks_base_log: int
    ks_level: int
    destination_key: str = "small"      # "small" | "big"


V1_4_PARAM_PKE_TO_SMALL_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128_ZKV2 = \
    CompactPublicKeyEncryptionParameters(
        encryption_lwe_dimension=2048,
        encryption_noise=TUniform(17),
        message_modulus=4,
        carry_modulus=4,
        zk_scheme=2,
    )

V1_4_PARAM_PKE_TO_BIG_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128_ZKV2 = \
    V1_4_PARAM_PKE_TO_SMALL_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128_ZKV2

V1_4_PARAM_PKE_TO_SMALL_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128_ZKV1 = \
    CompactPublicKeyEncryptionParameters(
        encryption_lwe_dimension=1024,
        encryption_noise=TUniform(43),
        message_modulus=4,
        carry_modulus=4,
        zk_scheme=1,
    )

# the reference's default PKE alias points at the TO_SMALL ZKV2 set
V1_4_PARAM_PKE_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128 = \
    V1_4_PARAM_PKE_TO_SMALL_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128_ZKV2
V1_4_PARAM_PKE_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128_ZKV2 = \
    V1_4_PARAM_PKE_TO_SMALL_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128_ZKV2
V1_4_PARAM_PKE_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128_ZKV1 = \
    V1_4_PARAM_PKE_TO_SMALL_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128_ZKV1

V1_4_PARAM_KEYSWITCH_PKE_TO_SMALL_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128_ZKV2 = \
    ShortintKeySwitchingParameters(ks_base_log=4, ks_level=4,
                                   destination_key="small")
V1_4_PARAM_KEYSWITCH_PKE_TO_BIG_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128_ZKV2 = \
    ShortintKeySwitchingParameters(ks_base_log=24, ks_level=1,
                                   destination_key="big")
V1_4_PARAM_KEYSWITCH_PKE_TO_SMALL_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128 = \
    V1_4_PARAM_KEYSWITCH_PKE_TO_SMALL_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128_ZKV2
V1_4_PARAM_KEYSWITCH_PKE_TO_BIG_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128 = \
    V1_4_PARAM_KEYSWITCH_PKE_TO_BIG_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128_ZKV2


# PBS->KS ordering family (PBSOrder::BootstrapKeyswitch — ciphertexts under
# the SMALL key; v1_4/classic/gaussian/p_fail_2_minus_128/pbs_ks.rs:33-55).
# tfhe_tpu multiplies the stds by 2^64 and its sampler scales by 2^64 again,
# so this set's noise is uniform on the torus and it decrypts at random: the
# values are copied for word parity (ROADMAP.md queue 3)
V1_4_PARAM_MESSAGE_2_CARRY_2_PBS_KS_GAUSSIAN_2M128 = ShortintParams(
    lwe_dimension=978,
    glwe_dimension=1,
    polynomial_size=2048,
    lwe_noise=Gaussian(2.962875621642539e-07 * 2.0 ** 64),
    glwe_noise=Gaussian(2.845267479601915e-15 * 2.0 ** 64),
    pbs_base_log=23,
    pbs_level=1,
    ks_base_log=3,
    ks_level=6,
    message_modulus=4,
    carry_modulus=4,
    max_noise_level=5,
    log2_p_fail=-128.05,
    encryption_key_choice=EncryptionKeyChoice.SMALL,
)

TEST_PARAM_MESSAGE_2_CARRY_2_PBS_KS = _dc.replace(
    TEST_PARAM_MESSAGE_2_CARRY_2,
    encryption_key_choice=EncryptionKeyChoice.SMALL)
