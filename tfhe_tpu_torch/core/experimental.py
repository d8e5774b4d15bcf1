"""Experimental core_crypto features (ref: tfhe/src/core_crypto/experimental/).

The port of tfhe_tpu/core/experimental.py, the same words:

- partial / shared secret-key generation
  (partial_glwe_secret_key_generation.rs, shared_lwe_secret_key_generation.rs,
  shared_glwe_secret_key_generation.rs)
- the shrinking keyswitch: a large LWE key to its prefix, with key material
  only for the non-shared tail (lwe_shrinking_keyswitch.rs): K1 on the tail
- pseudo-GGSW encryption and the GLWE fast keyswitch
  (pseudo_ggsw_encryption.rs, glwe_fast_keyswitch.rs): K7 with the sum
  added, the pseudo-GGSW encrypting -S_in
- partial sample extraction and partial constant-GLWE conversion
  (glwe_partial_sample_extraction.rs): gathers on the device
- the extended PBS (lwe_extended_programmable_bootstrapping.rs, eprint
  2025/2214): a LUT of size N E evaluated with the size-N bootstrap key as
  E interleaved accumulators, all steps in one launch of K8.

Server-side functions take int64 torus tensors (ops/torus.py) with a
leading batch axis and run on their device; keygens and encryptions draw on
the host and take the secret products on ``device`` (CUDA unless the caller
passes "cpu").
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import kernels, torus
from ..ops import server as srv
from ..utils.csprng import EncryptionRandomGenerator, SecretRandomGenerator
from ..utils.device import resolve_device
from .entities import GlweSecretKey, LweKeyswitchKey, LweSecretKey
from .keygen import NttKey, add_mask_times_secret, generate_lwe_keyswitch_key, words_to_ntt_key
from .params import DecompParams

M64 = 1 << 64


# ---------------------------------------------------------------------------
# Partial / shared secret keys (tfhe_tpu/core/experimental.py:51-82)
# ---------------------------------------------------------------------------


def generate_partial_binary_glwe_secret_key(k: int, n_poly: int, fill_count: int,
                                            gen: SecretRandomGenerator) -> GlweSecretKey:
    """GLWE key with only the first ``fill_count`` flattened coefficients
    random, the rest 0 (partial_glwe_secret_key_generation.rs:16-38)."""
    assert 0 <= fill_count <= k * n_poly
    data = np.zeros(k * n_poly, dtype=np.uint64)
    data[:fill_count] = gen.binary_key(fill_count)
    return GlweSecretKey(data.reshape(k, n_poly))


def generate_fully_shared_binary_lwe_secret_key(large_sk: LweSecretKey,
                                                small_dim: int) -> LweSecretKey:
    """The small LWE key is the large key's prefix
    (shared_lwe_secret_key_generation.rs)."""
    assert small_dim <= large_sk.dimension
    return LweSecretKey(large_sk.data[:small_dim].copy())


def generate_shared_glwe_secret_key_from_glwe_secret_key(
        large_sk: GlweSecretKey, k_out: int, n_poly_out: int) -> GlweSecretKey:
    """A GLWE key sharing its flattened prefix with a larger GLWE key
    (shared_glwe_secret_key_generation.rs:5)."""
    assert k_out * n_poly_out <= large_sk.glwe_dimension * large_sk.polynomial_size
    flat = large_sk.data.reshape(-1)[:k_out * n_poly_out]
    return GlweSecretKey(flat.reshape(k_out, n_poly_out).copy())


# ---------------------------------------------------------------------------
# Shrinking keyswitch (tfhe_tpu/core/experimental.py:91-138), on K1
# ---------------------------------------------------------------------------


@dataclass
class LweShrinkingKeyswitchKey:
    """A keyswitch key from the tail of a large key to its shared prefix
    (entities/lwe_shrinking_keyswitch_key.rs): ``ksk`` switches the
    (n_in - shared) tail coefficients to the prefix key of dimension
    ``shared_randomness``; ``key`` is its words on the device as K1 takes
    them (kernels.keyswitch_key)."""

    ksk: LweKeyswitchKey
    shared_randomness: int
    key: object

    @classmethod
    def from_raw_keys(cls, ksk_data, decomp: DecompParams, shared_randomness: int,
                      device="cuda") -> "LweShrinkingKeyswitchKey":
        """tfhe_tpu's (n_in - shared, l, shared + 1) uint64 key words."""
        ksk = LweKeyswitchKey(np.asarray(ksk_data, dtype=np.uint64), decomp)
        key = kernels.keyswitch_key(torus.from_u64(ksk.data, resolve_device(device)),
                                    decomp.base_log, decomp.level_count)
        return cls(ksk, shared_randomness, key)

    @property
    def input_lwe_dimension(self) -> int:
        return self.shared_randomness + self.ksk.input_lwe_dimension

    @property
    def output_lwe_dimension(self) -> int:
        return self.shared_randomness


def generate_lwe_shrinking_keyswitch_key(input_sk: LweSecretKey, shared_coef_count: int,
                                         decomp: DecompParams, noise_distribution,
                                         gen: EncryptionRandomGenerator,
                                         device="cuda") -> LweShrinkingKeyswitchKey:
    """lwe_shrinking_keyswitch_key_generation.rs:16-47: a standard keyswitch
    key from input_sk[shared:] to input_sk[:shared], the same generator
    stream; kept on ``device`` in K1's layout."""
    assert shared_coef_count <= input_sk.dimension
    ksk = generate_lwe_keyswitch_key(LweSecretKey(input_sk.data[shared_coef_count:]),
                                     LweSecretKey(input_sk.data[:shared_coef_count]),
                                     decomp, noise_distribution, gen)
    return LweShrinkingKeyswitchKey.from_raw_keys(ksk.data, decomp, shared_coef_count, device)


def shrinking_keyswitch(ct, sksk: LweShrinkingKeyswitchKey):
    """Batched shrinking keyswitch (lwe_shrinking_keyswitch.rs:96): ct (B,
    n_in+1) under the large key; the tail ct[:, n2:-1] and the body through
    K1, then the shared prefix of the mask added through.  Returns (B,
    n2+1) under the prefix key."""
    n2 = sksk.shared_randomness
    tail = torch.cat([ct[:, n2:-1], ct[:, -1:]], dim=1)
    decomp = sksk.ksk.decomp
    out = kernels.keyswitch(tail, sksk.key, decomp.base_log, decomp.level_count)
    out[:, :n2] += ct[:, :n2]
    return out


# ---------------------------------------------------------------------------
# Pseudo-GGSW and the GLWE fast keyswitch (experimental.py:146-242), on K7
# ---------------------------------------------------------------------------


@dataclass
class PseudoGgswCiphertext:
    """A GGSW with non-square level matrices: one row per input mask
    polynomial, no row for the body (entities/pseudo_ggsw_ciphertext.rs):
    ``data`` (k_in, l, k_out+1, N) uint64, standard domain."""

    data: np.ndarray
    decomp: DecompParams

    @classmethod
    def from_raw_keys(cls, data, decomp: DecompParams) -> "PseudoGgswCiphertext":
        """tfhe_tpu's PseudoGgswCiphertext.data (k_in, l, k_out+1, N)."""
        return cls(np.asarray(data, dtype=np.uint64).copy(), decomp)

    @property
    def input_glwe_dimension(self) -> int:
        return self.data.shape[0]

    @property
    def output_glwe_dimension(self) -> int:
        return self.data.shape[2] - 1

    @property
    def polynomial_size(self) -> int:
        return self.data.shape[-1]


def encrypt_pseudo_ggsw(glwe_sk_out: GlweSecretKey, glwe_sk_in: GlweSecretKey,
                        decomp: DecompParams, noise_distribution,
                        gen: EncryptionRandomGenerator, device="cuda") -> PseudoGgswCiphertext:
    """pseudo_ggsw_encryption.rs:17-110: row (level j, input polynomial i)
    is a GLWE under sk_out of -S_in_i(X) 2^(64 - base_log (l - j)), from
    forks of levels, then of rows, in that order; the secret products
    taken on ``device``."""
    k_in, n_poly = glwe_sk_in.data.shape
    k_out = glwe_sk_out.glwe_dimension
    assert n_poly == glwe_sk_out.polynomial_size
    levels = decomp.level_count
    out = np.zeros((k_in, levels, k_out + 1, n_poly), dtype=np.uint64)
    lev_gens = gen.fork(levels, k_in * k_out * n_poly, k_in * n_poly, noise_distribution)
    with np.errstate(over="ignore"):
        for j, lev_gen in enumerate(lev_gens):
            factor = np.uint64((-1 << (64 - decomp.base_log * (levels - j))) % M64)
            for i, row_gen in enumerate(lev_gen.fork(k_in, k_out * n_poly, n_poly,
                                                     noise_distribution)):
                row = out[i, j]
                row[:k_out] = row_gen.mask.uniform_u64(k_out * n_poly).reshape(k_out, n_poly)
                row[k_out] = (glwe_sk_in.data[i].astype(np.uint64) * factor
                              + noise_distribution.sample(row_gen.noise, n_poly))
    add_mask_times_secret(out.reshape(-1, k_out + 1, n_poly), glwe_sk_out,
                          resolve_device(device))
    return PseudoGgswCiphertext(out, decomp)


def pseudo_ggsw_to_ntt(pggsw: PseudoGgswCiphertext, num_primes: int = 4,
                       device="cuda") -> NttKey:
    """The (k_in, l, k_out+1, P, N) Montgomery NTT-domain pseudo-GGSW on
    ``device`` (pseudo_ggsw_conversion.rs analog; tfhe_tpu's words)."""
    return words_to_ntt_key(pggsw.data, num_primes, device)


def glwe_fast_keyswitch(glwe, pggsw_ntt, dp, base_log: int, levels: int):
    """Batched GLWE fast keyswitch (glwe_fast_keyswitch.rs:173-297) through
    K7: only the input mask polynomials are decomposed and multiplied by the
    pseudo-GGSW's rows, and the body is added through: sum + (0, body).
    glwe (B, k_in+1, N); pggsw_ntt (k_in, l, k_out+1, P, N).  Returns
    (B, k_out+1, N) under the output key."""
    return kernels.glwe_keyswitch(glwe, pggsw_ntt, dp, base_log, levels, add_sum=True)


# ---------------------------------------------------------------------------
# Partial sample extraction (experimental.py:250-289)
# ---------------------------------------------------------------------------


def _partial_positions(phi: int, n_poly: int) -> tuple:
    """For flattened mask coefficients i < phi: their position alpha N + beta
    (alpha = i // N, beta = (N - i) mod N) and whether beta != 0."""
    i = np.arange(phi)
    beta = (n_poly - i) % n_poly
    return (i // n_poly) * n_poly + beta, beta != 0


def partial_extract_lwe_sample(glwe, nth: int, phi: int):
    """glwe_partial_sample_extraction.rs:96: coefficient ``nth``'s body and
    the first phi mask coefficients under the flattened-prefix key (a
    partial key's tail is zero).  glwe (B, k+1, N) -> (B, phi+1)."""
    b, _, n_poly = glwe.shape
    src, flip = _partial_positions(phi, n_poly)
    picked = glwe[:, :-1].reshape(b, -1)[:, torch.from_numpy(src).to(glwe.device)]
    mask = torch.where(torch.from_numpy(flip).to(glwe.device), -picked, picked)
    return torch.cat([mask, glwe[:, -1, nth, None]], dim=1)


def partial_convert_lwe_to_constant_glwe(lwe, k: int, n_poly: int):
    """glwe_partial_sample_extraction.rs:237: an LWE under a flattened-prefix
    key embedded in a GLWE whose constant coefficient is its plaintext.
    lwe (B, phi+1) -> (B, k+1, N)."""
    b, phi = lwe.shape[0], lwe.shape[1] - 1
    assert phi <= k * n_poly
    dst, flip = _partial_positions(phi, n_poly)
    vals = torch.where(torch.from_numpy(flip).to(lwe.device), -lwe[:, :phi], lwe[:, :phi])
    out = torch.zeros((b, (k + 1) * n_poly), dtype=lwe.dtype, device=lwe.device)
    out[:, torch.from_numpy(dst).to(lwe.device)] = vals
    out[:, k * n_poly] = lwe[:, -1]
    return out.reshape(b, k + 1, n_poly)


# ---------------------------------------------------------------------------
# Extended PBS (experimental.py:297-361), on K8
# ---------------------------------------------------------------------------


def split_extended_lut(ext_lut, ext_factor: int):
    """(B, k+1, N E) -> (B, E, k+1, N): small LUT j takes coefficients j,
    j+E, j+2E, ... (lwe_extended_programmable_bootstrapping.rs:72-85)."""
    b, k1, n_ext = ext_lut.shape
    return ext_lut.reshape(b, k1, n_ext // ext_factor, ext_factor).permute(0, 3, 1, 2)


def extended_blind_rotate(msed_mask, msed_body, ext_lut, bsk_ntt, dp, base_log: int,
                          levels: int, ext_factor: int):
    """Blind rotation of a size-N E LUT with a size-N bootstrap key, all n
    steps in one launch of K8: msed_mask (B, n) in [0, 2 N E); msed_body
    (B,); ext_lut (B, k+1, N E); bsk_ntt (n, l, k+1, k+1, P, N).  The
    initial accumulator LUT / X^body is taken on the extended polynomial
    and split into the E slots.  Returns the final slot-0 accumulator
    (B, k+1, N)."""
    assert ext_factor & (ext_factor - 1) == 0, "extension factor power of 2"
    acc = split_extended_lut(srv.monomial_div(ext_lut, msed_body[:, None, None]), ext_factor)
    return kernels.blind_rotate_extended(msed_mask, acc, bsk_ntt, dp, base_log, levels)[:, 0]


def extended_pbs_batch(ct, ext_lut, bsk_ntt, dp, base_log: int, levels: int,
                       ext_factor: int):
    """The extended PBS (lwe_extended_programmable_bootstrapping.rs:165):
    the plain modulus switch to 2 N E (not the centered one), the extended
    blind rotation, sample extraction at 0.  ct (B, n+1); ext_lut (B, k+1,
    N E).  Returns (B, k N + 1) under the flattened GLWE key."""
    log_mod = (2 * ext_lut.shape[2]).bit_length() - 1
    msed = srv.modulus_switch(ct, log_mod)
    acc = extended_blind_rotate(msed[:, :-1], msed[:, -1], ext_lut, bsk_ntt, dp, base_log,
                                levels, ext_factor)
    return srv.sample_extract(acc)
