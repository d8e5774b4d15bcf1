"""Boolean client key: +-q/8 encoding (boolean/mod.rs:72-78; port of
tfhe_tpu/boolean/client_key.py, the same keys and ciphertexts from the same
seeds)."""

from __future__ import annotations

import secrets
from dataclasses import dataclass

import numpy as np

from ..core import keygen as kg
from ..core.encrypt import decrypt_lwe, encrypt_lwe
from ..core.entities import LweCiphertext
from ..utils.csprng import DeterministicSeeder, EncryptionRandomGenerator, SecretRandomGenerator
from .params import BooleanParameters

PLAINTEXT_TRUE = 1 << 61       # q/8
PLAINTEXT_FALSE = (7 << 61) % (1 << 64)  # -q/8


@dataclass
class Ciphertext:
    """Encrypted bool; `trivial` short-circuits gates (Ciphertext::Trivial).
    A gate's output keeps its words on the device (a shortint LazyLweData)
    until something reads them on the host."""

    data: object | None     # (n+1,) uint64 array or LazyLweData
    trivial: bool | None = None

    @classmethod
    def new_trivial(cls, value: bool) -> "Ciphertext":
        return cls(data=None, trivial=bool(value))


class ClientKey:
    def __init__(self, params: BooleanParameters, seed: int | None = None):
        self.params = params
        if seed is None:
            seed = secrets.randbits(128)
        sec = SecretRandomGenerator(seed)
        self.glwe_secret_key = kg.generate_binary_glwe_secret_key(
            params.glwe_dimension, params.polynomial_size, sec
        )
        self.lwe_secret_key = kg.generate_binary_lwe_secret_key(params.lwe_dimension, sec)
        self.big_lwe_secret_key = self.glwe_secret_key.as_lwe_secret_key()
        self.encryption_generator = EncryptionRandomGenerator(
            seed ^ 0x243F6A8885A308D3, DeterministicSeeder(seed ^ 0x13198A2E03707344)
        )

    def encrypt(self, value: bool) -> Ciphertext:
        encoded = PLAINTEXT_TRUE if value else PLAINTEXT_FALSE
        ct = encrypt_lwe(self.big_lwe_secret_key, encoded, self.params.glwe_noise,
                         self.encryption_generator)
        return Ciphertext(ct.data)

    def decrypt(self, ct: Ciphertext) -> bool:
        if ct.trivial is not None:
            return ct.trivial
        pt = decrypt_lwe(self.big_lwe_secret_key, LweCiphertext(np.asarray(ct.data)))
        return pt < (1 << 63)  # sign bit: phase in (0, q/2) = true
