"""Host-side LWE encryption and decryption (numpy, exact wrapping).

LWE: mask <- uniform from the mask stream; body = <mask, sk> + encoded +
noise (tfhe/src/core_crypto/algorithms/lwe_encryption.rs:99-113).  The
keys' GLWE rows (glwe_encryption.rs:99-118, assign form) are encrypted in
batches by keygen.draw_ggsw_rows and keygen.add_mask_times_secret.
"""

from __future__ import annotations

import numpy as np

from ..utils.csprng import EncryptionRandomGenerator
from .entities import LweCiphertext, LweSecretKey


def encrypt_lwe(
    sk: LweSecretKey,
    encoded: int,
    noise_distribution,
    gen: EncryptionRandomGenerator,
) -> LweCiphertext:
    mask = gen.mask.uniform_u64(sk.dimension)
    noise = int(noise_distribution.sample(gen.noise, 1)[0])
    skd = sk.data.astype(np.uint64)
    with np.errstate(over="ignore"):  # wrapping torus arithmetic is intended
        body = (
            np.sum(mask * skd, dtype=np.uint64)
            + np.uint64(encoded % (1 << 64))
            + np.uint64(noise % (1 << 64))
        )
    return LweCiphertext(np.concatenate([mask, np.array([body], dtype=np.uint64)]))


def decrypt_lwe(sk: LweSecretKey, ct: LweCiphertext) -> int:
    skd = sk.data.astype(np.uint64)
    dot = np.sum(ct.mask * skd, dtype=np.uint64)
    return int(ct.body - dot)
