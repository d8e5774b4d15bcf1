"""Key generation: secret keys, KSK, BSK; draws on the host (numpy), the
GLWE bodies' secret products and the NTT-domain key on the key's device
(the torch half of ops/ntt.py).

Byte-stream consumption replicates the reference's generator fork tree so
that keys are bit-identical to tfhe-rs given the same seeds:
  - secret keys: sequential binary fill (lwe_secret_key_generation.rs:55)
  - KSK: per input-key element, an l-ciphertext LWE list encryption which
    forks into l children (lwe_keyswitch_key_generation.rs:168-198,
    lwe_encryption.rs:708)
  - BSK: fork per GGSW, then per level matrix, then per row
    (lwe_bootstrap_key_generation.rs:122-138, ggsw_encryption.rs:132-159,
    280-315); parallel and sequential generation are stream-identical by
    construction, so every row's randomness is drawn first and the bodies
    are computed in batches.
  - GLWE KSK: one GLWE a (input polynomial, level), all from one generator
    without forks (glwe_keyswitch_key_generation.rs): the mask and noise
    streams are drawn whole, in that order, and the bodies' secret products
    computed in batches on the key's device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import ntt, torus
from ..utils.csprng import EncryptionRandomGenerator, SecretRandomGenerator
from ..utils.device import resolve_device
from .encrypt import encrypt_lwe
from .entities import (
    GlweSecretKey,
    LweBootstrapKey,
    LweKeyswitchKey,
    LweSecretKey,
)
from .params import DecompParams

# GLWE rows whose mask-times-secret products run in one batch (bounds the
# memory of keygen at N = 2048 to a few hundred MB)
ROWS_PER_BATCH = 512


def generate_binary_lwe_secret_key(dim: int, gen: SecretRandomGenerator) -> LweSecretKey:
    return LweSecretKey(gen.binary_key(dim))


def generate_binary_glwe_secret_key(
    k: int, n_poly: int, gen: SecretRandomGenerator
) -> GlweSecretKey:
    return GlweSecretKey(gen.binary_key(k * n_poly).reshape(k, n_poly))


def generate_lwe_keyswitch_key(
    input_sk: LweSecretKey,
    output_sk: LweSecretKey,
    decomp: DecompParams,
    noise_distribution,
    gen: EncryptionRandomGenerator,
    bits: int = 64,
) -> LweKeyswitchKey:
    """(n_in, l, n_out+1) uint64: level l first, input element i's row j the
    encryption of s_i 2^(bits - base_log (l - j)).  bits = 32 is the KS32
    key (tfhe_tpu/core/keygen.py:49-72): u32 words, 4 mask bytes a word."""
    n_in = input_sk.dimension
    n_out = output_sk.dimension
    levels = decomp.level_count
    out = np.zeros((n_in, levels, n_out + 1), dtype=np.uint64)
    for i in range(n_in):
        key_elem = int(input_sk.data[i])
        # messages: level l first — key_elem << (bits - base_log * level)
        children = gen.fork(levels, mask_elements=n_out, noise_elements=1,
                            noise_distribution=noise_distribution, bits=bits)
        for j, child in enumerate(children):
            level = levels - j
            encoded = (key_elem << (bits - decomp.base_log * level)) % (1 << bits)
            ct = encrypt_lwe(output_sk, encoded, noise_distribution, child, bits)
            out[i, j] = ct.data
    return LweKeyswitchKey(out, decomp)


def _ggsw_factor(cleartext: int, level: int, base_log: int) -> int:
    """(-cleartext) * 2^(64 - base_log*level) mod 2^64
    (ggsw_encryption.rs:20-44)."""
    neg = (-cleartext) % (1 << 64)
    return (neg << (64 - base_log * level)) % (1 << 64)


def draw_ggsw_rows(out: np.ndarray, cleartext: int, glwe_sk: GlweSecretKey,
                   decomp: DecompParams, noise_distribution, lev_gens) -> None:
    """Fill one GGSW, out (l, k+1, k+1, N), with each row's mask, noise and
    plaintext, drawn from the per-row forks of its level generators in the
    reference's order (ggsw_encryption.rs:132-159).  The bodies still lack
    the mask-times-secret term: add_mask_times_secret adds it for many
    rows at once, which gives the bytes of encrypting row by row."""
    k, n_poly = glwe_sk.glwe_dimension, glwe_sk.polynomial_size
    levels = len(lev_gens)
    for lev, lev_gen in enumerate(lev_gens):
        # stored level index lev <-> decomposition level l - lev
        factor = _ggsw_factor(cleartext, levels - lev, decomp.base_log)
        rows = out[lev]
        for r, row_gen in enumerate(lev_gen.fork(k + 1, k * n_poly, n_poly,
                                                 noise_distribution)):
            rows[r, :k] = row_gen.mask.uniform_u64(k * n_poly).reshape(k, n_poly)
            rows[r, k] = noise_distribution.sample(row_gen.noise, n_poly)
            if r < k:
                rows[r, k] += glwe_sk.data[r].astype(np.uint64) * np.uint64(factor)
            else:
                rows[r, k, 0] += np.uint64((-factor) % (1 << 64))


def add_mask_times_secret(rows: np.ndarray, glwe_sk: GlweSecretKey, device="cuda") -> None:
    """rows (R, k+1, N) GLWEs whose bodies lack the secret term: body +=
    sum_i mask_i * s_i (negacyclic, wrapping), in place, the products taken
    with the torch half of the CRT-NTT on ``device``, ROWS_PER_BATCH rows a
    batch (exact integer arithmetic: the words of the host half)."""
    k = glwe_sk.glwe_dimension
    dp = ntt.device_plan(ntt.make_plan(glwe_sk.polynomial_size), str(resolve_device(device)))
    key = ntt.key_ntt(glwe_sk.data.astype(np.uint64), dp).to(torch.int64)
    with np.errstate(over="ignore"):
        for s in range(0, rows.shape[0], ROWS_PER_BATCH):
            part = rows[s:s + ROWS_PER_BATCH]
            masks = torch.from_numpy(np.ascontiguousarray(part[:, :k]).view(np.int64))
            part[:, k] += torus.to_u64(ntt.mask_times_binary_key(masks.to(dp.ps.device), key,
                                                                 dp))


def _bsk_ggsws(input_sk: LweSecretKey, glwe_sk: GlweSecretKey, decomp: DecompParams,
               noise_distribution, gen: EncryptionRandomGenerator, start: int, count: int,
               device) -> np.ndarray:
    """GGSWs [start, start + count) of the BSK, (count, l, k+1, k+1, N): one
    fork of ``gen`` per GGSW of the whole key, then per level, then per row
    (lwe_bootstrap_key_generation.rs:122-138), so any slice has the words
    of the same slice of the whole key; the bodies' secret products taken
    on ``device``."""
    if not (0 <= start and start + count <= input_sk.dimension):
        raise ValueError(f"GGSWs [{start}, {start + count}) of {input_sk.dimension}")
    k = glwe_sk.glwe_dimension
    n_poly = glwe_sk.polynomial_size
    levels = decomp.level_count
    k1 = k + 1
    out = np.zeros((count, levels, k1, k1, n_poly), dtype=np.uint64)
    ggsw_gens = gen.fork(input_sk.dimension, levels * k1 * k * n_poly, levels * k1 * n_poly,
                         noise_distribution)
    with np.errstate(over="ignore"):
        for i in range(count):
            lev_gens = ggsw_gens[start + i].fork(levels, k1 * k * n_poly, k1 * n_poly,
                                                 noise_distribution)
            draw_ggsw_rows(out[i], int(input_sk.data[start + i]), glwe_sk, decomp,
                           noise_distribution, lev_gens)
    add_mask_times_secret(out.reshape(-1, k1, n_poly), glwe_sk, resolve_device(device))
    return out


def generate_lwe_bootstrap_key(
    input_sk: LweSecretKey,
    glwe_sk: GlweSecretKey,
    decomp: DecompParams,
    noise_distribution,
    gen: EncryptionRandomGenerator,
    device="cuda",
) -> LweBootstrapKey:
    """One GGSW of each input key bit, from one fork per GGSW, then per
    level, then per row (lwe_bootstrap_key_generation.rs:122-138); the
    bodies' secret products taken on ``device``."""
    return LweBootstrapKey(_bsk_ggsws(input_sk, glwe_sk, decomp, noise_distribution, gen,
                                      0, input_sk.dimension, device), decomp)


def generate_lwe_bootstrap_key_chunk(
    input_sk: LweSecretKey,
    glwe_sk: GlweSecretKey,
    decomp: DecompParams,
    noise_distribution,
    gen: EncryptionRandomGenerator,
    chunk_start: int,
    chunk_count: int,
    device="cuda",
) -> np.ndarray:
    """GGSWs [chunk_start, chunk_start + chunk_count) of the BSK as a
    (count, l, k+1, k+1, N) uint64 array (tfhe_tpu/core/keygen.py:187;
    entities/lwe_bootstrap_key_chunk.rs): the words of the same slice of
    ``generate_lwe_bootstrap_key`` from a generator seeded alike, so a key
    can be generated piecewise from one seed."""
    return _bsk_ggsws(input_sk, glwe_sk, decomp, noise_distribution, gen, chunk_start,
                      chunk_count, device)


def bootstrap_key_to_ntt(bsk: LweBootstrapKey, num_primes: int = 4):
    """Convert a standard-domain BSK to the NTT domain (Montgomery form).

    The analog of par_convert_standard_lwe_bootstrap_key_to_fourier
    (lwe_bootstrap_key_conversion.rs): each polynomial's residues mod each
    prime are forward-transformed; values stored in Montgomery form so the
    external product's pointwise multiply is a single REDC.

    Returns (ntt_data uint32 (n, l, k+1, k+1, num_primes, N), plan), taken
    on the CPU; the key owners convert on their device (``ntt.key_ntt``).
    """
    plan = ntt.make_plan(bsk.polynomial_size, num_primes)
    key = ntt.key_ntt(bsk.data.astype(np.uint64), ntt.device_plan(plan, "cpu"))
    return key.numpy().view(np.uint32), plan


class NttKey(NamedTuple):
    """An NTT-domain key on a device: ``data`` (..., P, N) int32 in
    Montgomery form on the P primes of ``dp``, the plan on the key's device.
    tfhe_tpu returns such keys as a (uint32 array, plan) pair: the GLWE
    keyswitch key (keygen.py:75), a pseudo-GGSW (experimental.py:208) and
    the CM bootstrap key (cm.py:291)."""

    data: torch.Tensor
    dp: ntt.DevicePlan

    @classmethod
    def from_raw_keys(cls, mont, device="cuda") -> "NttKey":
        """tfhe_tpu's (..., P, N) uint32 Montgomery words, on ``device``."""
        mont = np.ascontiguousarray(mont, dtype=np.uint32)
        dp = ntt.device_plan(ntt.make_plan(mont.shape[-1], mont.shape[-2]),
                             str(resolve_device(device)))
        return cls(torch.from_numpy(mont.view(np.int32)).to(dp.ps.device), dp)


def words_to_ntt_key(words: np.ndarray, num_primes: int = 4, device="cuda") -> NttKey:
    """Standard-domain (..., N) uint64 key words -> their NttKey on
    ``device``: tfhe_tpu's ``to_mont_all(forward_all(words))``, taken on the
    device (ntt.key_ntt)."""
    dp = ntt.device_plan(ntt.make_plan(words.shape[-1], num_primes),
                         str(resolve_device(device)))
    return NttKey(ntt.key_ntt(words, dp), dp)


def generate_glwe_keyswitch_key(
    input_sk: GlweSecretKey,
    output_sk: GlweSecretKey,
    decomp: DecompParams,
    noise_distribution,
    gen: EncryptionRandomGenerator,
    device="cuda",
) -> NttKey:
    """GLWE keyswitch key (tfhe_tpu/core/keygen.py:75;
    glwe_keyswitch_key_generation.rs): for input polynomial i and level l a
    GLWE encryption under output_sk of S_in_i(X) q / B^level, from one
    generator, row after row.  Returns the (k_in, l, k_out+1, P, N) 4-prime
    Montgomery NTT key on ``device`` (tfhe_tpu's words) with its plan: what
    ops/server.py glwe_keyswitch takes."""
    k_in, n_poly = input_sk.data.shape
    k_out = output_sk.glwe_dimension
    levels = decomp.level_count
    rows = np.zeros((k_in, levels, k_out + 1, n_poly), dtype=np.uint64)
    rows[:, :, :k_out] = gen.mask.uniform_u64(k_in * levels * k_out * n_poly).reshape(
        k_in, levels, k_out, n_poly)
    noise = noise_distribution.sample(gen.noise, k_in * levels * n_poly)
    shifts = np.array([64 - decomp.base_log * (levels - j) for j in range(levels)],
                      dtype=np.uint64)
    with np.errstate(over="ignore"):
        rows[:, :, k_out] = ((input_sk.data.astype(np.uint64)[:, None, :] << shifts[None, :, None])
                             + noise.reshape(k_in, levels, n_poly))
    dev = resolve_device(device)
    add_mask_times_secret(rows.reshape(-1, k_out + 1, n_poly), output_sk, dev)
    return words_to_ntt_key(rows, 4, dev)
