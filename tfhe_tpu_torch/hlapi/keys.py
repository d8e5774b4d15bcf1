"""Key types and generate_keys (high_level_api/keys/mod.rs:44).

Port of tfhe_tpu/hlapi/keys.py: the same keys from the same seeds (the
squashing keys' seed XORs included).  A ServerKey lives on a device, CUDA
unless the caller asks for the CPU; every hlapi op runs there."""

from __future__ import annotations

import secrets

import numpy as np

from ..integer.client_key import ClientKey as IntegerClientKey
from ..integer.server_key import ServerKey as IntegerServerKey
from ..shortint.ciphertext import NOMINAL_NOISE, Ciphertext
from .config import Config


class ClientKey:
    def __init__(self, config: Config, seed: int | None = None):
        self.config = config
        self.seed = secrets.randbits(128) if seed is None else seed
        self.integer_key = IntegerClientKey(config.shortint_params, self.seed)
        self.noise_squashing_private_key = None
        if config.enable_noise_squashing:
            from ..integer.noise_squashing import NoiseSquashingPrivateKey

            self.noise_squashing_private_key = NoiseSquashingPrivateKey(
                config.noise_squashing_params, self.seed ^ 0x5C0A5)

    def decrypt_squashed(self, ct) -> int:
        """Decrypt a SquashedNoiseRadixCiphertext (requires noise squashing
        enabled in the config)."""
        if self.noise_squashing_private_key is None:
            raise ValueError("noise squashing not enabled in Config")
        inner = ct.inner if hasattr(ct, "inner") else ct
        return self.noise_squashing_private_key.decrypt_radix(inner)

    @classmethod
    def generate(cls, config: Config, seed: int | None = None) -> "ClientKey":
        return cls(config, seed)


class ServerKey:
    def __init__(self, client_key: ClientKey, device="cuda"):
        self.integer_key = IntegerServerKey(client_key.integer_key, device=device)
        self.config = client_key.config
        self.noise_squashing_key = None
        if client_key.noise_squashing_private_key is not None:
            from ..integer.noise_squashing import NoiseSquashingKey

            self.noise_squashing_key = NoiseSquashingKey(
                client_key.integer_key, client_key.noise_squashing_private_key,
                client_key.seed ^ 0x5C0A6, device=device)

    @classmethod
    def from_raw_parts(cls, config: Config, integer_key: IntegerServerKey,
                       noise_squashing_key=None) -> "ServerKey":
        """An hlapi key over an integer server key (ServerKey::from_raw_parts),
        e.g. one built from another package's key words."""
        obj = cls.__new__(cls)
        obj.config = config
        obj.integer_key = integer_key
        obj.noise_squashing_key = noise_squashing_key
        return obj

    @property
    def device(self):
        return self.integer_key.key.device


class CompressedServerKey:
    """Compressed (seeded) server key: seeded BSK/KSK bodies whose public
    mask halves regenerate from 128-bit seeds (SeededLweBootstrapKey /
    SeededLweKeyswitchKey, seeded_*_decompression.rs)."""

    def __init__(self, client_key: ClientKey, seed: int | None = None):
        from ..shortint.compressed_key import CompressedServerKey as ShortintCompressed

        self.config = client_key.config
        self._compressed = ShortintCompressed(client_key.integer_key.key, seed)

    def decompress(self, device="cuda") -> ServerKey:
        """The server key on the device (no noise-squashing key: it is not
        part of the compressed key)."""
        return ServerKey.from_raw_parts(self.config, IntegerServerKey.from_shortint_key(
            self._compressed.decompress(device=device)))


class PublicKey:
    """Classic LWE public key (list of encryptions of zero).

    encrypt(value) = random subset-sum of zero-encryptions + encoded message
    (core_crypto/algorithms/lwe_public_key_generation.rs semantics).  Two of
    tfhe_tpu's choices are kept for the same bytes (ROADMAP queue 3): n bits
    + 128 encryptions of zero, and the GLWE noise for every key choice.
    """

    def __init__(self, client_key: ClientKey, zero_count: int | None = None):
        ck = client_key.integer_key.key
        p = ck.params
        n = ck.encryption_key.dimension
        # lwe_public_key_zero_encryption_count = n*ceil(log2 q) + 128: the
        # count the leftover-hash-lemma argument needs.  A custom smaller
        # count may be passed for tests only.
        self.zero_count = zero_count or (n * p.bits + 128)
        self.params = p
        # chunked generation: one mask-stream block and one noise block per
        # chunk draw the bytes of the sequential per-row encrypt_lwe loop
        # (mask and noise generators are independent); the binary-key
        # multisum runs vectorized
        gen = ck.encryption_generator
        ones = np.nonzero(np.asarray(ck.encryption_key.data))[0]
        out = np.empty((self.zero_count, n + 1), dtype=np.uint64)
        chunk = max(1, (64 << 20) // (8 * n))      # ~64 MB of mask per chunk
        with np.errstate(over="ignore"):
            for s in range(0, self.zero_count, chunk):
                c = min(chunk, self.zero_count - s)
                mask = gen.mask.uniform_u64(c * n).reshape(c, n)
                noise = p.glwe_noise.sample(gen.noise, c)
                out[s:s + c, :n] = mask
                out[s:s + c, n] = mask[:, ones].sum(axis=1, dtype=np.uint64) + noise
        self._zeros = out

    def encrypt_block(self, message: int) -> Ciphertext:
        p = self.params
        mask_bits = np.frombuffer(secrets.token_bytes(self.zero_count), dtype=np.uint8) & 1
        acc = self._zeros[mask_bits.astype(bool)].sum(axis=0, dtype=np.uint64)
        with np.errstate(over="ignore"):
            acc[-1] = acc[-1] + np.uint64((message % p.total_modulus) * p.delta)
        return Ciphertext(acc, degree=p.message_modulus - 1,
                          noise_level=NOMINAL_NOISE,
                          message_modulus=p.message_modulus,
                          carry_modulus=p.carry_modulus)


def generate_keys(config: Config | None = None, seed: int | None = None,
                  device="cuda"):
    config = config or Config()
    ck = ClientKey(config, seed)
    return ck, ServerKey(ck, device=device)
