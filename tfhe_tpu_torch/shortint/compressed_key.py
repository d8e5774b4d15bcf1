"""Compressed (seeded) shortint keys and ciphertexts (port of
tfhe_tpu/shortint/compressed_key.py; host numpy, the same bytes from the
same seeds).

Mirrors shortint CompressedServerKey / CompressedCiphertext: the KSK, BSK
and ciphertext mask halves regenerate from stored 128-bit seeds, so the
stored form carries bodies only ((n+1) -> 1 for LWE, (k+1) -> 1 a GLWE
row).  Decompression builds the server key on the device, as
``ServerKey.from_raw_keys`` does.
"""

from __future__ import annotations

import dataclasses
import secrets

import numpy as np

from ..core import seeded as sd
from ..core.entities import LweBootstrapKey
from ..ops.bsk_prep import mask_floor_bsk
from ..utils.csprng import ByteStream, DeterministicSeeder
from .ciphertext import NOMINAL_NOISE, Ciphertext
from .client_key import ClientKey
from .params import ShortintParams
from .server_key import ROUND_BITS, ServerKey, _floor_rounds_securely, _v7_family


def _check_seedable(p) -> None:
    """A seeded server key is drawn at 64 bits: a KS32 set's u32 keyswitch
    key is not (tfhe_tpu draws its seeded KSK at 64 bits there, a key the
    u32 keyswitch cannot use), nor is a multi-bit set's key."""
    if getattr(p, "grouping_factor", None) is not None:
        raise ValueError("seeded server keys: classic KS->PBS sets only")
    if p.ks32:
        raise ValueError("seeded server keys: the KS32 pattern's u32 keyswitch key "
                         "is not seeded")


class CompressedServerKey:
    def __init__(self, client_key: ClientKey, seed: int | None = None):
        p = client_key.params
        _check_seedable(p)
        self.params = p
        if seed is None:
            seed = secrets.randbits(128)
        seeder = DeterministicSeeder(seed)
        noise_stream = ByteStream(seeder.seed())
        core = p.core
        self.seeded_ksk = sd.seed_generate_lwe_keyswitch_key(
            client_key.big_lwe_secret_key, client_key.lwe_secret_key,
            core.ks_decomp, p.lwe_noise, seeder, noise_stream)
        self.seeded_bsk = sd.seed_generate_lwe_bootstrap_key(
            client_key.lwe_secret_key, client_key.glwe_secret_key,
            core.pbs_decomp, p.glwe_noise, seeder, noise_stream)
        # the v7 family's masks are floored as ServerKey.__init__ floors
        # them: the stored bodies take the dropped mask bits' convolution and
        # the floor is recorded, so the decompressed key IS the floored key
        if _v7_family(p):
            _floor_rounds_securely(p, ROUND_BITS)
            full = LweBootstrapKey(self.seeded_bsk.decompress(), core.pbs_decomp)
            floored = mask_floor_bsk(full, client_key.glwe_secret_key, ROUND_BITS, "cpu")
            self.seeded_bsk = dataclasses.replace(
                self.seeded_bsk, mask_floor_rb=ROUND_BITS,
                bodies=np.ascontiguousarray(floored.data[..., p.glwe_dimension, :]))

    @classmethod
    def from_raw_parts(cls, params: ShortintParams, ksk_seed: int, ksk_bodies,
                       bsk_seed: int, bsk_bodies, mask_floor_rb: int = 0
                       ) -> "CompressedServerKey":
        """Carry a seeded key in from its seeds and stored bodies: KSK bodies
        (n_big, l_ks), BSK bodies (n, l_pbs, k+1, N) u64, and the rb its BSK
        masks are floored to."""
        _check_seedable(params)
        core = params.core
        obj = cls.__new__(cls)
        obj.params = params
        obj.seeded_ksk = sd.SeededLweKeyswitchKey(
            int(ksk_seed), np.asarray(ksk_bodies, dtype=np.uint64),
            params.big_lwe_dimension, params.lwe_dimension, core.ks_decomp)
        obj.seeded_bsk = sd.SeededLweBootstrapKey(
            int(bsk_seed), np.asarray(bsk_bodies, dtype=np.uint64), params.glwe_dimension,
            params.polynomial_size, core.pbs_decomp, mask_floor_rb)
        return obj

    @property
    def nbytes(self) -> int:
        """Stored bytes: the bodies and the two 16-byte seeds."""
        return self.seeded_ksk.bodies.nbytes + self.seeded_bsk.bodies.nbytes + 32

    def decompress(self, device="cuda") -> ServerKey:
        return ServerKey.from_raw_keys(
            self.params, self.seeded_ksk.decompress(), self.seeded_bsk.decompress(),
            bsk_floored=self.seeded_bsk.mask_floor_rb, device=device)


class CompressedCiphertext:
    """Seeded LWE encryption of one shortint message."""

    def __init__(self, client_key: ClientKey, message: int, seed: int | None = None):
        p = client_key.params
        self.params = p
        if seed is None:
            seed = secrets.randbits(128)
        seeder = DeterministicSeeder(seed)
        noise_stream = ByteStream(seeder.seed())
        encoded = (message % p.total_modulus) * p.delta
        self.inner = sd.seed_encrypt_lwe_list(
            client_key.encryption_key, [encoded], p.glwe_noise, seeder, noise_stream)
        self.degree = p.message_modulus - 1

    def decompress(self) -> Ciphertext:
        p = self.params
        return Ciphertext(self.inner.decompress()[0], degree=self.degree,
                          noise_level=NOMINAL_NOISE, message_modulus=p.message_modulus,
                          carry_modulus=p.carry_modulus)
