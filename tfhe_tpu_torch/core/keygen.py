"""Host-side key generation: secret keys, KSK, BSK (numpy).

Byte-stream consumption replicates the reference's generator fork tree so
that keys are bit-identical to tfhe-rs given the same seeds:
  - secret keys: sequential binary fill (lwe_secret_key_generation.rs:55)
  - KSK: per input-key element, an l-ciphertext LWE list encryption which
    forks into l children (lwe_keyswitch_key_generation.rs:168-198,
    lwe_encryption.rs:708)
  - BSK: fork per GGSW, then per level matrix, then per row
    (lwe_bootstrap_key_generation.rs:122-138, ggsw_encryption.rs:132-159,
    280-315); parallel and sequential generation are stream-identical by
    construction.
"""

from __future__ import annotations

import numpy as np

from ..ops import ntt
from ..utils.csprng import EncryptionRandomGenerator, SecretRandomGenerator
from .encrypt import encrypt_glwe_assign, encrypt_lwe
from .entities import (
    GlweSecretKey,
    LweBootstrapKey,
    LweKeyswitchKey,
    LweSecretKey,
)
from .params import DecompParams


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
) -> LweKeyswitchKey:
    n_in = input_sk.dimension
    n_out = output_sk.dimension
    levels = decomp.level_count
    out = np.zeros((n_in, levels, n_out + 1), dtype=np.uint64)
    for i in range(n_in):
        key_elem = int(input_sk.data[i])
        # messages: level l first — key_elem << (64 - base_log * level)
        children = gen.fork(levels, mask_elements=n_out, noise_elements=1,
                            noise_distribution=noise_distribution)
        for j, child in enumerate(children):
            level = levels - j
            encoded = (key_elem << (64 - decomp.base_log * level)) % (1 << 64)
            ct = encrypt_lwe(output_sk, encoded, noise_distribution, child)
            out[i, j] = ct.data
    return LweKeyswitchKey(out, decomp)


def _ggsw_factor(cleartext: int, level: int, base_log: int) -> int:
    """(-cleartext) * 2^(64 - base_log*level) mod 2^64
    (ggsw_encryption.rs:20-44)."""
    neg = (-cleartext) % (1 << 64)
    return (neg << (64 - base_log * level)) % (1 << 64)


def generate_lwe_bootstrap_key(
    input_sk: LweSecretKey,
    glwe_sk: GlweSecretKey,
    decomp: DecompParams,
    noise_distribution,
    gen: EncryptionRandomGenerator,
) -> LweBootstrapKey:
    n_in = input_sk.dimension
    k = glwe_sk.glwe_dimension
    n_poly = glwe_sk.polynomial_size
    levels = decomp.level_count
    glwe_size = k + 1
    out = np.zeros((n_in, levels, glwe_size, glwe_size, n_poly), dtype=np.uint64)
    ggsw_gens = _fork_bsk_ggsws(input_sk, glwe_sk, decomp, noise_distribution, gen)
    for i in range(n_in):
        out[i] = _generate_bsk_ggsw(int(input_sk.data[i]), glwe_sk, decomp,
                                    noise_distribution, ggsw_gens[i])
    return LweBootstrapKey(out, decomp)


def _fork_bsk_ggsws(input_sk, glwe_sk, decomp, noise_distribution, gen):
    """One child generator per GGSW (per input-key bit) — the determinism
    boundary that makes chunked generation bit-identical to monolithic."""
    k = glwe_sk.glwe_dimension
    n_poly = glwe_sk.polynomial_size
    levels = decomp.level_count
    glwe_size = k + 1
    ggsw_mask_elems = levels * glwe_size * k * n_poly
    ggsw_noise_elems = levels * glwe_size * n_poly
    return gen.fork(input_sk.dimension, ggsw_mask_elems, ggsw_noise_elems,
                    noise_distribution)


def _generate_bsk_ggsw(cleartext, glwe_sk, decomp, noise_distribution, ggsw_gen):
    k = glwe_sk.glwe_dimension
    n_poly = glwe_sk.polynomial_size
    levels = decomp.level_count
    glwe_size = k + 1
    out = np.zeros((levels, glwe_size, glwe_size, n_poly), dtype=np.uint64)
    lev_gens = ggsw_gen.fork(levels, glwe_size * k * n_poly,
                             glwe_size * n_poly, noise_distribution)
    for j in range(levels):
        level = levels - j  # stored level index j <-> decomposition level l-j
        factor = _ggsw_factor(cleartext, level, decomp.base_log)
        row_gens = lev_gens[j].fork(glwe_size, k * n_poly, n_poly,
                                    noise_distribution)
        for r in range(glwe_size):
            body_init = np.zeros(n_poly, dtype=np.uint64)
            if r < glwe_size - 1:
                # body = sk_poly_r * factor (wrapping scalar mul)
                body_init = glwe_sk.data[r].astype(np.uint64) * np.uint64(factor)
            else:
                body_init[0] = (-factor) % (1 << 64)
            ct = encrypt_glwe_assign(glwe_sk, body_init, noise_distribution,
                                     row_gens[r])
            out[j, r] = ct.data
    return out


def bootstrap_key_to_ntt(bsk: LweBootstrapKey, num_primes: int = 4):
    """Convert a standard-domain BSK to the NTT domain (Montgomery form).

    The analog of par_convert_standard_lwe_bootstrap_key_to_fourier
    (lwe_bootstrap_key_conversion.rs): each polynomial's residues mod each
    prime are forward-transformed; values stored in Montgomery form so the
    external product's pointwise multiply is a single REDC.

    Returns (ntt_data uint32 (n, l, k+1, k+1, num_primes, N), plan).
    """
    n_poly = bsk.polynomial_size
    plan = ntt.make_plan(n_poly, num_primes)
    data = bsk.data.astype(np.uint64)
    with np.errstate(over="ignore"):
        fwd = ntt.forward_all(data, plan)          # (..., num_primes, N) normal
        mont = ntt.to_mont_all(fwd, plan)          # Montgomery form
    return mont.astype(np.uint32), plan
