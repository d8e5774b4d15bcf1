"""Host-side LWE/GLWE encryption and decryption (numpy, exact wrapping).

Algorithms mirror tfhe/src/core_crypto/algorithms/{lwe,glwe}_encryption.rs:
  - LWE: mask <- uniform from the mask stream; body = <mask, sk> + encoded +
    noise (lwe_encryption.rs:99-113).
  - GLWE (assign form): mask <- uniform; body += per-coefficient noise; then
    body += sum_i mask_i (*) sk_i, negacyclic (glwe_encryption.rs:99-118).

The negacyclic multisum uses the exact CRT-NTT engine (binary secret keys:
bound N * 2^64 ~ 2^75 << P/2).
"""

from __future__ import annotations

import numpy as np

from ..ops import ntt
from ..utils.csprng import EncryptionRandomGenerator
from .entities import GlweCiphertext, GlweSecretKey, LweCiphertext, LweSecretKey


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


def encrypt_glwe_assign(
    sk: GlweSecretKey,
    body_init: np.ndarray,
    noise_distribution,
    gen: EncryptionRandomGenerator,
) -> GlweCiphertext:
    """GLWE-encrypt with a pre-filled body polynomial (GGSW row encryption).

    body_init is consumed as the plaintext-carrying body content; returns the
    full (k+1, N) ciphertext.
    """
    k = sk.glwe_dimension
    n_poly = sk.polynomial_size
    mask = gen.mask.uniform_u64(k * n_poly).reshape(k, n_poly)
    noise = noise_distribution.sample(gen.noise, n_poly)
    body = body_init.astype(np.uint64) + noise
    plan = ntt.make_plan(n_poly)
    for i in range(k):
        prod = ntt.negacyclic_polymul_u64(
            mask[i].astype(np.uint64), sk.data[i].astype(np.uint64), plan
        )
        body = body + prod.astype(np.uint64)
    return GlweCiphertext(np.concatenate([mask, body[None, :]], axis=0))
