"""Host-side LWE encryption and decryption (numpy, exact wrapping).

LWE: mask <- uniform from the mask stream; body = <mask, sk> + encoded +
noise (tfhe/src/core_crypto/algorithms/lwe_encryption.rs:99-113).  The
keys' GLWE rows (glwe_encryption.rs:99-118, assign form) are encrypted in
batches by keygen.draw_ggsw_rows and keygen.add_mask_times_secret;
``encrypt_glwe_assign`` encrypts one GLWE (a compact public key).
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
    bits: int = 64,
) -> LweCiphertext:
    """One LWE of the bits-wide torus (64, or 32 for the KS32 keyswitch
    key's rows: a u32 mask draw, noise masked to 32 bits, the body wrapped
    mod 2^32), as uint64 words (tfhe_tpu/core/encrypt.py:19)."""
    mask = gen.mask.uniform_scalar(sk.dimension, bits)
    noise = int(noise_distribution.sample(gen.noise, 1, bits)[0])
    skd = sk.data.astype(np.uint64)
    with np.errstate(over="ignore"):  # wrapping torus arithmetic is intended
        body = (
            np.sum(mask * skd, dtype=np.uint64)
            + np.uint64(encoded % (1 << 64))
            + np.uint64(noise % (1 << 64))
        )
    if bits == 32:
        body &= np.uint64(0xFFFFFFFF)
    return LweCiphertext(np.concatenate([mask, np.array([body], dtype=np.uint64)]))


def decrypt_lwe(sk: LweSecretKey, ct: LweCiphertext) -> int:
    skd = sk.data.astype(np.uint64)
    dot = np.sum(ct.mask * skd, dtype=np.uint64)
    return int(ct.body - dot)


def decode(plaintext: int, msg_bits: int, bits: int = 64) -> int:
    """Round to the top msg_bits + 1 bits and return the message
    (tfhe_tpu/core/encrypt.py:54; SignedDecomposer(msg_bits + 1, 1)
    .decode_plaintext): round to nearest at bit bits - msg_bits - 1; the
    padding bit folds away mod 2^msg_bits."""
    shift = bits - msg_bits - 1
    rounded = ((plaintext >> (shift - 1)) + 1) >> 1
    return rounded % (1 << msg_bits)


def encode(msg: int, msg_bits: int, bits: int = 64) -> int:
    """Delta scaling with one padding bit: msg 2^(bits - msg_bits - 1) mod
    2^bits (tfhe_tpu/core/encrypt.py:66)."""
    return (msg << (bits - msg_bits - 1)) % (1 << bits)


def encrypt_glwe_assign(sk: GlweSecretKey, body_init: np.ndarray, noise_distribution,
                        gen: EncryptionRandomGenerator) -> GlweCiphertext:
    """GLWE-encrypt a pre-filled body polynomial (tfhe_tpu/core/encrypt.py:71):
    mask uniform, body = body_init + noise + sum_i mask_i (*) sk_i."""
    k, n_poly = sk.data.shape
    mask = gen.mask.uniform_u64(k * n_poly).reshape(k, n_poly)
    body = np.asarray(body_init, dtype=np.uint64).copy()
    plan = ntt.make_plan(n_poly)
    with np.errstate(over="ignore"):
        body = body + noise_distribution.sample(gen.noise, n_poly)
        for i in range(k):
            body = body + ntt.negacyclic_polymul_u64(
                mask[i], sk.data[i].astype(np.uint64), plan)
    return GlweCiphertext(np.concatenate([mask, body[None, :]], axis=0))


def decrypt_glwe(sk: GlweSecretKey, ct: GlweCiphertext) -> np.ndarray:
    """body - sum_i mask_i (*) sk_i, (N,) uint64."""
    plan = ntt.make_plan(sk.data.shape[1])
    acc = np.asarray(ct.body, dtype=np.uint64).copy()
    with np.errstate(over="ignore"):
        for i in range(sk.data.shape[0]):
            acc = acc - ntt.negacyclic_polymul_u64(
                np.asarray(ct.mask[i], dtype=np.uint64), sk.data[i].astype(np.uint64), plan)
    return acc
