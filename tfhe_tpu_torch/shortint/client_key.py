"""shortint client key: secret keys + encryption (port of
tfhe_tpu/shortint/client_key.py; host numpy, byte-identical keys and
ciphertexts from the same seeds).

Mirrors shortint/client_key/mod.rs + engine/client_side.rs: the GLWE secret
key doubles as the big LWE key; encryption uses the engine's seeded
generators.  Encoding: delta = q / (2 * msg * carry) (shortint/encoding.rs).
"""

from __future__ import annotations

import secrets

import numpy as np

from ..core import keygen as kg
from ..core.encrypt import decrypt_lwe, encrypt_lwe
from ..core.entities import GlweSecretKey, LweCiphertext, LweSecretKey
from ..utils.csprng import DeterministicSeeder, EncryptionRandomGenerator, SecretRandomGenerator
from .ciphertext import NOMINAL_NOISE, Ciphertext
from .params import EncryptionKeyChoice, ShortintParams


class ClientKey:
    def __init__(self, params: ShortintParams, seed: int | None = None):
        if seed is None:
            seed = secrets.randbits(128)
        sec = SecretRandomGenerator(seed)
        glwe_sk = kg.generate_binary_glwe_secret_key(
            params.glwe_dimension, params.polynomial_size, sec)
        lwe_sk = kg.generate_binary_lwe_secret_key(params.lwe_dimension, sec)
        self._init_keys(params, lwe_sk, glwe_sk, seed)

    @classmethod
    def from_raw_keys(cls, params: ShortintParams, lwe_secret_key,
                      glwe_secret_key, seed: int | None = None) -> "ClientKey":
        """Build from secret-key arrays: lwe (n,) and glwe (k, N) binary.
        ``seed`` seeds the encryption generators as ``ClientKey(params,
        seed)`` does, so a key carried in from elsewhere encrypts the same
        ciphertexts as the key generated from that seed."""
        obj = cls.__new__(cls)
        obj._init_keys(
            params, LweSecretKey(np.asarray(lwe_secret_key)),
            GlweSecretKey(np.asarray(glwe_secret_key)),
            secrets.randbits(128) if seed is None else seed)
        return obj

    def _init_keys(self, params, lwe_sk, glwe_sk, seed: int) -> None:
        self.params = params
        self._seed = seed
        self.glwe_secret_key = glwe_sk
        self.lwe_secret_key = lwe_sk
        # big key = flattened GLWE key (KS->PBS atomic pattern encrypts big)
        self.big_lwe_secret_key = glwe_sk.as_lwe_secret_key()
        self.encryption_generator = EncryptionRandomGenerator(
            seed ^ 0x9E3779B97F4A7C15,
            DeterministicSeeder(seed ^ 0x6A09E667F3BCC908),
        )

    @property
    def encryption_key(self):
        if self.params.encryption_key_choice == EncryptionKeyChoice.BIG:
            return self.big_lwe_secret_key
        return self.lwe_secret_key

    def encrypt(self, message: int) -> Ciphertext:
        p = self.params
        encoded = (message % p.total_modulus) * p.delta
        noise = p.glwe_noise if p.encryption_key_choice == EncryptionKeyChoice.BIG else p.lwe_noise
        ct = encrypt_lwe(self.encryption_key, encoded, noise,
                         self.encryption_generator)
        return Ciphertext(ct.data, degree=p.message_modulus - 1,
                          noise_level=NOMINAL_NOISE,
                          message_modulus=p.message_modulus,
                          carry_modulus=p.carry_modulus)

    def encrypt_without_padding_value(self, value: int) -> Ciphertext:
        """Encrypt an arbitrary value in [0, 2*msg*carry) (uses the padding bit)."""
        p = self.params
        encoded = (value % (2 * p.total_modulus)) * p.delta
        ct = encrypt_lwe(self.encryption_key, encoded, p.glwe_noise,
                         self.encryption_generator)
        return Ciphertext(ct.data, degree=value, noise_level=NOMINAL_NOISE,
                          message_modulus=p.message_modulus,
                          carry_modulus=p.carry_modulus)

    def decrypt_raw(self, ct: Ciphertext) -> int:
        """Decrypt to the full (msg*carry) plaintext space value."""
        p = self.params
        pt = decrypt_lwe(self.encryption_key, LweCiphertext(np.asarray(ct.data)))
        half = p.delta // 2
        return ((pt + half) // p.delta) % (2 * p.total_modulus) % p.total_modulus

    def decrypt(self, ct: Ciphertext) -> int:
        """Decrypt the message part (mod message_modulus)."""
        return self.decrypt_raw(ct) % self.params.message_modulus
