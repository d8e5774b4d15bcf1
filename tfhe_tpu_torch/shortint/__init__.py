"""shortint on PyTorch: keygen and encryption on the host, the batched
KS->PBS, ciphertext compression and noise squashing on the device (port of
tfhe_tpu.shortint: the classic KS->PBS, KS32, PBS->KS and multi-bit atomic
patterns, many-LUT), with the dedicated compact-public-key (PKE) and
casting sets."""

from .ciphertext import Ciphertext
from .client_key import ClientKey
from .compression import (
    TEST_COMP_PARAM,
    V1_4_COMP_PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128,
    CompressedCiphertextList,
    CompressionKey,
    CompressionParameters,
    decompress,
)
from .noise_squashing import (
    TEST_NOISE_SQUASHING_PARAM,
    V1_4_NOISE_SQUASHING_PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128,
    NoiseSquashingKey,
    NoiseSquashingParams,
    NoiseSquashingPrivateKey,
    SquashedNoiseCiphertext,
)
from .params import (
    DEFAULT_PARAMS,
    PARAM_MESSAGE_2_CARRY_2_KS_PBS,
    TEST_PARAM_MESSAGE_2_CARRY_2,
    TEST_PARAM_MESSAGE_2_CARRY_2_KS32,
    TEST_PARAM_MULTI_BIT_GROUP_2_MESSAGE_2_CARRY_2,
    TPU_PARAM_MULTI_BIT_GROUP_2_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128,
    V1_4_PARAM_GPU_MULTI_BIT_GROUP_2_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128,
    V1_4_PARAM_GPU_MULTI_BIT_GROUP_3_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128,
    V1_4_PARAM_GPU_MULTI_BIT_GROUP_4_MESSAGE_1_CARRY_1_KS_PBS_TUNIFORM_2M128,
    V1_4_PARAM_GPU_MULTI_BIT_GROUP_4_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128,
    V1_4_PARAM_MESSAGE_1_CARRY_1_KS_PBS_TUNIFORM_2M128,
    V1_4_PARAM_MESSAGE_2_CARRY_2_KS32_PBS_TUNIFORM_2M128,
    V1_4_PARAM_MESSAGE_2_CARRY_2_KS_PBS_GAUSSIAN_2M128,
    V1_4_PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128,
    V1_4_PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M40,
    V1_4_PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M64,
    V1_4_PARAM_MESSAGE_3_CARRY_3_KS_PBS_TUNIFORM_2M128,
    V1_4_PARAM_MESSAGE_4_CARRY_4_KS_PBS_TUNIFORM_2M128,
    V1_4_PARAM_KEYSWITCH_PKE_TO_BIG_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128,
    V1_4_PARAM_KEYSWITCH_PKE_TO_BIG_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128_ZKV2,
    V1_4_PARAM_KEYSWITCH_PKE_TO_SMALL_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128,
    V1_4_PARAM_KEYSWITCH_PKE_TO_SMALL_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128_ZKV2,
    V1_4_PARAM_PKE_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128,
    V1_4_PARAM_PKE_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128_ZKV1,
    V1_4_PARAM_PKE_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128_ZKV2,
    V1_4_PARAM_PKE_TO_BIG_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128_ZKV2,
    V1_4_PARAM_PKE_TO_SMALL_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128_ZKV1,
    V1_4_PARAM_PKE_TO_SMALL_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128_ZKV2,
    CompactPublicKeyEncryptionParameters,
    EncryptionKeyChoice,
    MsNoiseReduction,
    MultiBitPBSParameters,
    ShortintKeySwitchingParameters,
    ShortintParams,
)
from .server_key import (CarryFullError, CompressedModulusSwitchedCiphertext,
                         LookupTable, ServerKey)


def gen_keys(params=DEFAULT_PARAMS, seed=None, device="cuda"):
    ck = ClientKey(params, seed)
    return ck, ServerKey(ck, seed, device=device)
