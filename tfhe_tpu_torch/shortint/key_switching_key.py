"""Casting keys between shortint parameter sets.

Port of tfhe_tpu/shortint/key_switching_key.py (shortint/key_switching_key/):
a KeySwitchingKey holds an LWE keyswitch key from the source params'
encryption key to the destination params' big key, letting ciphertexts
encrypted under one parameter set be cast into another.  Message/carry
moduli must match (the reference refuses mismatched moduli too).  The key
is generated on the host as tfhe_tpu generates it (same seed, same words),
uploaded once, with K1's byte layout built on the card where its shape takes
the tensor-core kernel (ops/kernels.py keyswitch_key); a cast is one K1
launch.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass

from ..core import keygen as kg
from ..core.params import DecompParams
from ..ops import kernels, torus
from ..utils.csprng import DeterministicSeeder, EncryptionRandomGenerator
from ..utils.device import resolve_device
from .server_key import lazy_outputs, upload_batch


@dataclass(frozen=True)
class ShortintKeySwitchingParams:
    """shortint/parameters/key_switching.rs ShortintKeySwitchingParameters."""

    ks_base_log: int
    ks_level: int


class KeySwitchingKey:
    def __init__(self, src_client_key, dst_client_key,
                 params: ShortintKeySwitchingParams | None = None,
                 seed: int | None = None, device="cuda"):
        device = resolve_device(device)
        sp, dp = src_client_key.params, dst_client_key.params
        if (sp.message_modulus, sp.carry_modulus) != (dp.message_modulus, dp.carry_modulus):
            raise ValueError("mismatched message/carry moduli between parameter sets")
        if params is None:
            params = ShortintKeySwitchingParams(dp.ks_base_log, dp.ks_level)
        self.params = params
        self.dst_params = dp
        self.device = device
        if seed is None:
            seed = secrets.randbits(128)
        gen = EncryptionRandomGenerator(seed, DeterministicSeeder(seed ^ 0xCA57))
        ksk = kg.generate_lwe_keyswitch_key(
            src_client_key.encryption_key, dst_client_key.big_lwe_secret_key,
            DecompParams(params.ks_base_log, params.ks_level), dp.glwe_noise, gen)
        self.ksk = torus.from_u64(ksk.data, device)
        self.ks_key = kernels.keyswitch_key(self.ksk, params.ks_base_log, params.ks_level)

    def cast_batch(self, cts: list) -> list:
        """Keyswitch a batch of source-set ciphertexts into the destination
        set: one K1 launch; the outputs stay on the device."""
        out = kernels.keyswitch(upload_batch([c.data for c in cts], self.device),
                                self.ks_key, self.params.ks_base_log, self.params.ks_level)
        return lazy_outputs(out, [c.degree for c in cts], cts)

    def cast(self, ct):
        return self.cast_batch([ct])[0]
