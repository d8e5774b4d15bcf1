"""Seeded (compressed) entities: bodies and a 128-bit seed; the public mask
halves regenerate from the seed's AES-CTR stream on decompression (port of
tfhe_tpu/core/seeded.py, the 2^64 torus; host numpy, the same bytes from
the same seeds).

Mirrors core_crypto/entities/seeded_* (SeededLweCiphertext(List),
SeededLweKeyswitchKey, SeededLweBootstrapKey, seeded_*_decompression.rs):
compression factor (n+1) -> 1 for LWE, (k+1) -> 1 for GLWE rows.  The mask
is pure public randomness; stored bodies already hold mask·s + message +
noise.

tfhe_tpu forks the mask stream once an input element (KSK), a GGSW, a level
and a row (BSK), each child one row's mask bytes.  The children are
consecutive windows of the parent, so the masks of a whole key are one
draw of the parent stream in that order; the noise stream is never forked,
so a key's noise is one draw too.  Both are drawn here at once.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils.csprng import ByteStream
from . import keygen as kg
from .params import DecompParams


# ---------------------------------------------------------------------------
# Seeded LWE ciphertext list
# ---------------------------------------------------------------------------


@dataclass
class SeededLweCiphertextList:
    """bodies: (count,) u64; masks regenerate from seed (one n-element draw
    per ciphertext, in order)."""

    seed: int
    bodies: np.ndarray
    lwe_dimension: int

    def decompress(self) -> np.ndarray:
        """(count, n+1) u64 full ciphertexts."""
        count, n = len(self.bodies), self.lwe_dimension
        out = np.empty((count, n + 1), dtype=np.uint64)
        out[:, :n] = ByteStream(self.seed).uniform_u64(count * n).reshape(count, n)
        out[:, n] = self.bodies
        return out


def _masked_bodies(masks: np.ndarray, key: np.ndarray, plain: np.ndarray,
                   noise: np.ndarray) -> np.ndarray:
    """mask·key + plaintext + noise, wrapping mod 2^64, row by row."""
    with np.errstate(over="ignore"):
        return (masks * key.astype(np.uint64)).sum(axis=-1, dtype=np.uint64) + plain + noise


def seed_encrypt_lwe_list(sk, encoded: list, noise_distribution, seeder,
                          noise_stream: ByteStream) -> SeededLweCiphertextList:
    """Encrypt a list with a fresh mask seed; store bodies only
    (lwe_encryption.rs seeded variants)."""
    seed = seeder.seed()
    n, count = sk.dimension, len(encoded)
    masks = ByteStream(seed).uniform_u64(count * n).reshape(count, n)
    plain = np.array([int(m) % (1 << 64) for m in encoded], dtype=np.uint64)
    noise = noise_distribution.sample(noise_stream, count)
    return SeededLweCiphertextList(seed, _masked_bodies(masks, sk.data, plain, noise), n)


# ---------------------------------------------------------------------------
# Seeded keyswitch key
# ---------------------------------------------------------------------------


@dataclass
class SeededLweKeyswitchKey:
    seed: int
    bodies: np.ndarray  # (n_in, levels)
    input_dimension: int
    output_dimension: int
    decomp: DecompParams

    def decompress(self) -> np.ndarray:
        """(n_in, levels, n_out+1) u64: the masks one draw of the seed's
        stream, in tfhe_tpu's fork order (input element, then level)."""
        n_in, levels = self.bodies.shape
        n_out = self.output_dimension
        out = np.empty((n_in, levels, n_out + 1), dtype=np.uint64)
        out[..., :n_out] = ByteStream(self.seed).uniform_u64(
            n_in * levels * n_out).reshape(n_in, levels, n_out)
        out[..., n_out] = self.bodies
        return out


def seed_generate_lwe_keyswitch_key(input_sk, output_sk, decomp: DecompParams,
                                    noise_distribution, seeder,
                                    noise_stream: ByteStream) -> SeededLweKeyswitchKey:
    seed = seeder.seed()
    n_in, n_out = input_sk.dimension, output_sk.dimension
    levels = decomp.level_count
    masks = ByteStream(seed).uniform_u64(n_in * levels * n_out).reshape(
        n_in, levels, n_out)
    # stored level j <-> decomposition level levels - j
    plain = np.array([[(int(s) << (64 - decomp.base_log * (levels - j))) % (1 << 64)
                       for j in range(levels)] for s in input_sk.data], dtype=np.uint64)
    noise = noise_distribution.sample(noise_stream, n_in * levels).reshape(n_in, levels)
    bodies = _masked_bodies(masks, output_sk.data, plain, noise)
    return SeededLweKeyswitchKey(seed, bodies, n_in, n_out, decomp)


# ---------------------------------------------------------------------------
# Seeded bootstrap key
# ---------------------------------------------------------------------------


@dataclass
class SeededLweBootstrapKey:
    """bodies: (n_in, levels, k+1, N), the body polynomial of every GLWE row;
    the k mask polynomials a row regenerate from the seed."""

    seed: int
    bodies: np.ndarray
    glwe_dimension: int
    polynomial_size: int
    decomp: DecompParams
    # masks floored to multiples of 2^rb on decompression (the bodies were
    # adjusted at generation by ops/bsk_prep.mask_floor_bsk, so the
    # regenerated key IS the floored key: see shortint/compressed_key)
    mask_floor_rb: int = 0

    def decompress(self) -> np.ndarray:
        """(n_in, levels, k+1, k+1, N) u64 standard-domain BSK."""
        n_in, levels, glwe_size, n_poly = self.bodies.shape
        k = self.glwe_dimension
        out = np.empty((n_in, levels, glwe_size, glwe_size, n_poly), dtype=np.uint64)
        masks = ByteStream(self.seed).uniform_u64(n_in * levels * glwe_size * k * n_poly)
        masks = masks.reshape(n_in, levels, glwe_size, k, n_poly)
        if self.mask_floor_rb:
            masks &= ~np.uint64((1 << self.mask_floor_rb) - 1)
        out[..., :k, :] = masks
        out[..., k, :] = self.bodies
        return out


def seed_generate_lwe_bootstrap_key(input_sk, glwe_sk, decomp: DecompParams,
                                    noise_distribution, seeder,
                                    noise_stream: ByteStream) -> SeededLweBootstrapKey:
    """The math of keygen.generate_lwe_bootstrap_key with the mask drawn from
    a recorded seed; stores row bodies only."""
    seed = seeder.seed()
    n_in = input_sk.dimension
    k, n_poly = glwe_sk.glwe_dimension, glwe_sk.polynomial_size
    levels = decomp.level_count
    glwe_size = k + 1
    rows = np.zeros((n_in, levels, glwe_size, glwe_size, n_poly), dtype=np.uint64)
    rows[..., :k, :] = ByteStream(seed).uniform_u64(
        n_in * levels * glwe_size * k * n_poly).reshape(n_in, levels, glwe_size, k, n_poly)
    rows[..., k, :] = noise_distribution.sample(
        noise_stream, n_in * levels * glwe_size * n_poly).reshape(
        n_in, levels, glwe_size, n_poly)
    with np.errstate(over="ignore"):
        for i in range(n_in):
            for j in range(levels):
                factor = kg._ggsw_factor(int(input_sk.data[i]), levels - j, decomp.base_log)
                for r in range(k):
                    rows[i, j, r, k] += glwe_sk.data[r].astype(np.uint64) * np.uint64(factor)
                rows[i, j, k, k, 0] += np.uint64((-factor) % (1 << 64))
    flat = rows.reshape(-1, glwe_size, n_poly)
    kg.add_mask_times_secret(flat, glwe_sk, "cpu")
    return SeededLweBootstrapKey(seed, np.ascontiguousarray(rows[..., k, :]), k, n_poly,
                                 decomp)
