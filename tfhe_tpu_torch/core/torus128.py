"""u128 torus primitives for noise squashing (port of
tfhe_tpu/core/torus128.py; keys byte-identical from the same seeds).

The reference's 128-bit path runs split-double f64 FFTs
(core_crypto/fft_impl/fft128/, fft128_pbs.rs); tfhe_tpu, and so the port,
takes the exact 6-prime CRT-NTT instead (ops/ntt.py, 2^179 against the
2^166 external-product bound), so the u128 words are exact.

All u128 arrays are (lo, hi) uint64 pairs on the host; scalars are Python
ints.  The bootstrapping key's GGSW rows are drawn through tfhe_tpu's fork
tree at 128 bits and their bodies computed in batches, as the u64 keys'
are (core/keygen.py add_mask_times_secret), with the torch half of the
u128 CRT-NTT on the key's device: exact integer arithmetic, the same words
as the host half, which the tests hold against tfhe_tpu.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import ntt, torus
from ..utils.csprng import EncryptionRandomGenerator
from .params import DecompParams

M128 = 1 << 128
M64 = (1 << 64) - 1
# GLWE rows whose mask-times-secret products run in one batch, and key
# polynomials a batch of the NTT-domain conversion (bounds host and device
# memory at N = 2048 to a few hundred MB)
ROWS_PER_BATCH = 256
POLYS_PER_BATCH = 2048


def _split(x: int) -> tuple:
    x %= M128
    return np.uint64(x & M64), np.uint64(x >> 64)


def uniform_u128_pairs(stream, count: int) -> tuple:
    """``count`` uniform u128 draws as (lo, hi) uint64 arrays: 16
    little-endian bytes a value, as tfhe-csprng draws a u128."""
    words = stream.take(count * 16).view("<u8")
    return words[0::2].copy(), words[1::2].copy()


def tuniform_pairs(dist, stream, count: int) -> tuple:
    """TUniform torus noise on u128: the u64 sample sign-extended."""
    lo = dist.sample(stream, count)
    return lo, (lo.view(np.int64) >> np.int64(63)).view(np.uint64)


class GlweSecretKey128:
    """Binary GLWE key over the u128 torus (the key bits are still 0/1)."""

    def __init__(self, data: np.ndarray):
        self.data = data  # (k, N) uint64 of 0/1

    @property
    def glwe_dimension(self) -> int:
        return self.data.shape[0]

    @property
    def polynomial_size(self) -> int:
        return self.data.shape[1]

    def to_lwe_key_bits(self) -> np.ndarray:
        """Flattened bits for sample-extracted LWE decryption."""
        return self.data.reshape(-1)


def generate_binary_glwe_secret_key128(k: int, n_poly: int, gen) -> GlweSecretKey128:
    return GlweSecretKey128(gen.binary_key(k * n_poly).reshape(k, n_poly))


def _draw_row(row_lo, row_hi, k: int, n_poly: int, noise_distribution,
              gen: EncryptionRandomGenerator) -> None:
    """One GLWE row's mask and noise into row (k+1, N) pairs: the mask from
    the mask stream, then the noise, added to the body already there."""
    m_lo, m_hi = uniform_u128_pairs(gen.mask, k * n_poly)
    row_lo[:k], row_hi[:k] = m_lo.reshape(k, n_poly), m_hi.reshape(k, n_poly)
    e_lo, e_hi = tuniform_pairs(noise_distribution, gen.noise, n_poly)
    row_lo[k], row_hi[k] = ntt.add128_np(row_lo[k], row_hi[k], e_lo, e_hi)


def add_mask_times_secret128(rows_lo, rows_hi, sk: GlweSecretKey128, dp) -> None:
    """rows (R, k+1, N) pairs whose bodies lack the secret term: body +=
    sum_i mask_i * s_i mod (X^N + 1, 2^128), in place, the products taken
    with the torch half on dp's device, ROWS_PER_BATCH rows a batch (exact
    integer arithmetic: the words of the host half)."""
    k = sk.glwe_dimension
    device = dp.psi.device
    key = torch.from_numpy(sk.data.astype(np.int64)).to(device)
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int64)).to(device)  # noqa: E731
    with np.errstate(over="ignore"):
        for s in range(0, rows_lo.shape[0], ROWS_PER_BATCH):
            lo, hi = rows_lo[s:s + ROWS_PER_BATCH], rows_hi[s:s + ROWS_PER_BATCH]
            p_lo, p_hi = ntt.mask_times_binary_key_u128(up(lo[:, :k]), up(hi[:, :k]),
                                                         key, dp)
            lo[:, k], hi[:, k] = ntt.add128_np(lo[:, k], hi[:, k], torus.to_u64(p_lo),
                                               torus.to_u64(p_hi))


def encrypt_glwe_assign128(sk: GlweSecretKey128, body_lo, body_hi,
                           noise_distribution, gen: EncryptionRandomGenerator,
                           dp) -> tuple:
    """GLWE-encrypt over u128 a pre-filled body (a GGSW row), the secret
    product taken on dp's device.  Returns ((k+1, N) lo, (k+1, N) hi)."""
    k, n_poly = sk.glwe_dimension, sk.polynomial_size
    lo = np.zeros((1, k + 1, n_poly), dtype=np.uint64)
    hi = np.zeros_like(lo)
    lo[0, k], hi[0, k] = body_lo, body_hi
    with np.errstate(over="ignore"):
        _draw_row(lo[0], hi[0], k, n_poly, noise_distribution, gen)
    add_mask_times_secret128(lo, hi, sk, dp)
    return lo[0], hi[0]


def generate_bootstrap_key128(input_sk, glwe_sk: GlweSecretKey128,
                              decomp: DecompParams, noise_distribution,
                              gen: EncryptionRandomGenerator, dp) -> tuple:
    """BSK over u128: GGSW(s_i) per input key bit, from one fork per GGSW,
    then per level, then per row, with 16-byte mask elements
    (tfhe_tpu/core/torus128.py:92-134, lwe_bootstrap_key_generation.rs).
    Every row's mask, noise and plaintext are drawn first, in that tree;
    the bodies' secret products are then added in batches on dp's device (a
    6-prime DevicePlan), which gives the words of encrypting row by row.

    Returns (lo, hi) arrays of shape (n_in, l, k+1, k+1, N)."""
    n_in = input_sk.dimension
    k, n_poly = glwe_sk.glwe_dimension, glwe_sk.polynomial_size
    levels = decomp.level_count
    k1 = k + 1
    out_lo = np.zeros((n_in, levels, k1, k1, n_poly), dtype=np.uint64)
    out_hi = np.zeros_like(out_lo)
    ggsw_gens = gen.fork(n_in, levels * k1 * k * n_poly, levels * k1 * n_poly,
                         noise_distribution, 128)
    with np.errstate(over="ignore"):
        for i, ggsw_gen in enumerate(ggsw_gens):
            cleartext = int(input_sk.data[i])
            lev_gens = ggsw_gen.fork(levels, k1 * k * n_poly, k1 * n_poly,
                                     noise_distribution, 128)
            for j, lev_gen in enumerate(lev_gens):
                # stored level j <-> decomposition level l - j
                level = levels - j
                factor = (-cleartext % M128) * (1 << (128 - decomp.base_log * level)) % M128
                f_lo, f_hi = _split(factor)
                rows_lo, rows_hi = out_lo[i, j], out_hi[i, j]
                for r in range(k):
                    bits = glwe_sk.data[r]
                    rows_lo[r, k], rows_hi[r, k] = bits * f_lo, bits * f_hi
                rows_lo[k, k, 0], rows_hi[k, k, 0] = _split(-factor)
                for r, row_gen in enumerate(lev_gen.fork(k1, k * n_poly, n_poly,
                                                         noise_distribution, 128)):
                    _draw_row(rows_lo[r], rows_hi[r], k, n_poly, noise_distribution,
                              row_gen)
    add_mask_times_secret128(out_lo.reshape(-1, k1, n_poly),
                             out_hi.reshape(-1, k1, n_poly), glwe_sk, dp)
    return out_lo, out_hi


def bootstrap_key128_to_ntt(bsk_lo, bsk_hi, plan) -> np.ndarray:
    """Residues, forward NTT and Montgomery form for every prime, on the
    host.  Returns uint32 (n, l, k+1, k+1, P, N)."""
    shape = bsk_lo.shape
    lo, hi = bsk_lo.reshape(-1, shape[-1]), bsk_hi.reshape(-1, shape[-1])
    out = np.empty((lo.shape[0], plan.num_primes, shape[-1]), dtype=np.uint32)
    with np.errstate(over="ignore"):
        for s in range(0, lo.shape[0], POLYS_PER_BATCH):
            e = s + POLYS_PER_BATCH
            out[s:e] = ntt.to_mont_all(ntt.forward_all_u128(lo[s:e], hi[s:e], plan), plan)
    return out.reshape(shape[:-1] + (plan.num_primes, shape[-1]))


def bootstrap_key128_to_ntt_on(bsk_lo, bsk_hi, dp) -> torch.Tensor:
    """bootstrap_key128_to_ntt with the torch half on dp's device (the same
    words, exact integer arithmetic): int32 (n, l, k+1, k+1, P, N) there,
    the host arrays uploaded a batch at a time."""
    shape = bsk_lo.shape
    lo = bsk_lo.reshape(-1, shape[-1]).view(np.int64)
    hi = bsk_hi.reshape(-1, shape[-1]).view(np.int64)
    device = dp.psi.device
    out = torch.empty((lo.shape[0], dp.num_primes, shape[-1]), dtype=torch.int32,
                      device=device)
    for s in range(0, lo.shape[0], POLYS_PER_BATCH):
        e = s + POLYS_PER_BATCH
        part = ntt.forward_u128_mont(torch.from_numpy(lo[s:e]).to(device),
                                     torch.from_numpy(hi[s:e]).to(device), dp)
        out[s:e] = part.to(torch.int32)
    return out.reshape(tuple(shape[:-1]) + (dp.num_primes, shape[-1]))


def decrypt_lwe128(key_bits: np.ndarray, ct_lo: np.ndarray, ct_hi: np.ndarray) -> int:
    """b - <a, s> mod 2^128, exact: the selected mask words summed as 32-bit
    limbs in uint64 (no carry is lost below 2^32 terms)."""
    n = len(key_bits)
    sel = np.asarray(key_bits).astype(bool)
    acc = 0
    for w, words in enumerate((ct_lo[:n][sel], ct_hi[:n][sel])):
        acc += int((words & np.uint64(0xFFFFFFFF)).sum(dtype=np.uint64)) << (64 * w)
        acc += int((words >> np.uint64(32)).sum(dtype=np.uint64)) << (64 * w + 32)
    body = int(ct_lo[n]) | (int(ct_hi[n]) << 64)
    return (body - acc) % M128


def decode128(plaintext: int, msg_bits: int) -> int:
    """Round to the top (msg_bits+1) bits of the u128 torus."""
    shift = 128 - msg_bits - 1
    rounded = ((plaintext >> (shift - 1)) + 1) >> 1
    return rounded % (1 << msg_bits)
