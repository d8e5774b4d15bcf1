"""Multi-bit bootstrapping key: generation, NTT-domain conversion and the
NTT-domain monomial tables (port of tfhe_tpu/core/multibit.py).

For a group of g secret bits the key stores one GGSW per INDICATOR pattern
u: GGSW(prod_i (s_i if bit_i(u) else 1 - s_i)), exactly one of which
encrypts 1 (lwe_multi_bit_bootstrap_key_generation.rs:504-530
combine_key_bits).  Selection bits are big-endian: the group's first key
bit is u's most significant bit.  At rotation time the effective GGSW is
sum_u X^{d_u} E_u (ops/server.py blind_rotate_multibit), or each monomial
moves onto the data side (blind_rotate_multibit_v9).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from ..ops import ntt
from ..utils.csprng import EncryptionRandomGenerator
from ..utils.device import resolve_device
from .entities import GlweSecretKey, LweSecretKey
from .keygen import add_mask_times_secret, draw_ggsw_rows
from .params import DecompParams


def generate_multibit_bootstrap_key(
    input_sk: LweSecretKey,
    glwe_sk: GlweSecretKey,
    decomp: DecompParams,
    grouping_factor: int,
    noise_distribution,
    gen: EncryptionRandomGenerator,
    device="cuda",
) -> np.ndarray:
    """Returns the (n/g, 2^g, l, k+1, k+1, N) uint64 standard-domain key.

    The generator forks as tfhe_tpu's does: one child per (group, pattern)
    in sequence, then one per level, then one per row.  Every row's mask and
    noise are drawn first, in that order; the bodies (body_init + noise +
    sum_i mask_i * s_i, wrapping) are then computed in batches, which gives
    the same bytes as encrypting row by row."""
    g = grouping_factor
    n_in = input_sk.dimension
    if n_in % g:
        raise ValueError("lwe_dimension must be divisible by grouping_factor")
    device = resolve_device(device)
    k = glwe_sk.glwe_dimension
    n_poly = glwe_sk.polynomial_size
    levels = decomp.level_count
    k1 = k + 1
    out = np.zeros((n_in // g, 1 << g, levels, k1, k1, n_poly), dtype=np.uint64)
    with np.errstate(over="ignore"):
        for j in range(n_in // g):
            bits_g = [int(input_sk.data[g * j + i]) for i in range(g)]
            for u in range(1 << g):
                cleartext = 1
                for i in range(g):
                    sel = (u >> (g - 1 - i)) & 1
                    cleartext *= bits_g[i] if sel else 1 - bits_g[i]
                lev_gens = gen.fork(levels, k1 * k * n_poly, k1 * n_poly,
                                    noise_distribution)
                draw_ggsw_rows(out[j, u], cleartext, glwe_sk, decomp,
                               noise_distribution, lev_gens)
    add_mask_times_secret(out.reshape(-1, k1, n_poly), glwe_sk, device)
    return out


def multibit_bsk_to_ntt(bsk: np.ndarray, num_primes: int = 4):
    """(..., N) uint64 key -> ((..., P, N) uint32 Montgomery NTT domain,
    plan), converted in slices (``ntt.key_ntt`` on the CPU)."""
    plan = ntt.make_plan(bsk.shape[-1], num_primes)
    key = ntt.key_ntt(np.asarray(bsk, dtype=np.uint64), ntt.device_plan(plan, "cpu"))
    return key.numpy().view(np.uint32), plan


@lru_cache(maxsize=None)
def monomial_ntt_tables(n: int, num_primes: int = 4):
    """(psi_pows_mont (P, 4N) uint64, bitrev (N,) int64): NTT(X^a)[t] =
    psi^{(2 br(t) + 1) a mod 4N} in Montgomery form, for the plan's psi."""
    plan = ntt.make_plan(n, num_primes)
    tables = []
    for p in plan.primes:
        psi = pow(ntt._find_generator(p), (p - 1) // (2 * n), p)
        r = (1 << 32) % p
        pows = np.zeros(4 * n, dtype=np.uint64)
        acc = 1
        for e in range(4 * n):
            pows[e] = acc * r % p
            acc = acc * psi % p
        tables.append(pows)
    return np.stack(tables), ntt._bitrev_indices(n)
