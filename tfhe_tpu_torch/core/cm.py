"""Common-mask (CM) ciphertexts and algorithms (ref:
tfhe/src/core_crypto/experimental/{entities,algorithms}/common_mask_*).

The port of tfhe_tpu/core/cm.py, the same words.  A CM ciphertext shares
ONE mask across C = cm_dimension bodies, each under a different secret key:
body_j = <mask, s_j> + m_j + e_j (cm_lwe_encryption.rs:13-69), so one blind
rotation bootstraps all slots: the CM bootstrap key's GGSW for input
position i encrypts the slots' key bits [s^in_1[i], .., s^in_C[i]]
(cm_bootstrap.rs:75-171).

Layouts as tfhe_tpu's: a CmLwe batch is (B, n + C) [mask | bodies], a
CmGlwe batch (B, k + C, N), the CM GGSW level matrices (k + C, k + C)
squares, so K2 runs them at k+1 = k + C: the CM CMux and external product
on its CMux entry (kernels.cmux: at k = 1, N = 2048, l = 1 its "cluster"
route, the cluster kernel's one-step CMux mode, at C = 2 .. 7; its
generic kernel at C = 1), the CM rotation on its
exact rotation of a given accumulator (kernels.rotate_accumulator: the
lazy kernel at C = 1 on the 2_2 shape, the cluster kernel at k + C = 3 ..
8, N = 2048, l = 1, so C <= 7 at the 2_2 widths, the generic kernel at
other shapes up to k + C = GENERIC_MAX_K1 within a block's shared
memory).  The CM keyswitch and
packing run K1 on (mask, 0) with n_out + C key columns.

Server-side functions take int64 torus tensors (ops/torus.py) and run on
their device; encryption and decryption run on the host (numpy uint64);
keygens draw on the host in tfhe_tpu's stream order and take the secret
products on ``device`` (CUDA unless the caller passes "cpu").
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import kernels, ntt, torus
from ..ops import server as srv
from ..utils.csprng import EncryptionRandomGenerator
from ..utils.device import resolve_device
from .entities import LweSecretKey
from .keygen import NttKey, add_mask_times_secret, words_to_ntt_key
from .params import DecompParams

M64 = 1 << 64


# ---------------------------------------------------------------------------
# CM LWE: encryption, decryption, linear algebra (cm.py:42-77)
# ---------------------------------------------------------------------------


def encrypt_cm_lwe(sks: list, encoded: list, noise_distribution,
                   gen: EncryptionRandomGenerator) -> np.ndarray:
    """One shared uniform mask, one body a key (cm_lwe_encryption.rs:13).
    Returns (n + C,) uint64, [mask | bodies]."""
    assert len(sks) == len(encoded)
    n = sks[0].dimension
    mask = gen.mask.uniform_u64(n)
    noise = noise_distribution.sample(gen.noise, len(sks))
    with np.errstate(over="ignore"):
        bodies = [np.sum(mask * sk.data.astype(np.uint64), dtype=np.uint64)
                  + np.uint64(m % M64) + e for sk, m, e in zip(sks, encoded, noise)]
    return np.concatenate([mask, np.array(bodies, dtype=np.uint64)])


def decrypt_cm_lwe(sks: list, ct: np.ndarray) -> list:
    """The C plaintexts body_j - <mask, s_j> of one CmLwe (n + C,)."""
    n = sks[0].dimension
    mask = np.asarray(ct[:n], dtype=np.uint64)
    with np.errstate(over="ignore"):
        return [int(np.uint64(ct[n + j]) - np.sum(mask * sk.data.astype(np.uint64),
                                                   dtype=np.uint64))
                for j, sk in enumerate(sks)]


def cm_lwe_add(a, b):
    """cm_lwe_linear_algebra.rs: slot-wise wrapping add (the masks add too);
    numpy uint64 or int64 torus tensors."""
    return a + b


def cm_lwe_scalar_mul(a, scalar: int):
    """Wrapping multiplication of every word by a cleartext."""
    if isinstance(a, torch.Tensor):
        return a * torus.s64(scalar)
    return a * np.uint64(scalar % M64)


def encrypt_cm_lwe_batch(sks: list, encoded: np.ndarray, noise_distribution,
                         gen: EncryptionRandomGenerator, device="cuda") -> np.ndarray:
    """R CmLwes, row r encrypting encoded[r] (R, C): the words of
    encrypt_cm_lwe called row after row on gen (n mask words, then C noise
    samples a row: the mask and noise streams drawn whole, in order), the
    bodies' dot products taken on ``device``.  Returns (R, n + C) uint64."""
    msgs = np.asarray(encoded, dtype=np.uint64)
    rows, c = msgs.shape
    n = sks[0].dimension
    mask = gen.mask.uniform_u64(rows * n).reshape(rows, n)
    noise = noise_distribution.sample(gen.noise, rows * c).reshape(rows, c)
    keys = torch.from_numpy(np.stack([sk.data.astype(np.int64) for sk in sks], axis=1))
    dev = resolve_device(device)
    dots = srv._matmul_wrapping(torus.from_u64(mask, dev), keys.to(dev))
    with np.errstate(over="ignore"):
        bodies = torus.to_u64(dots) + msgs + noise
    return np.concatenate([mask, bodies], axis=1)


# ---------------------------------------------------------------------------
# CM keyswitch (cm.py:86-138), on K1
# ---------------------------------------------------------------------------


@dataclass
class CmLweKeyswitchKey:
    """(n_in, l, n_out + C) uint64: row (i, lev) a CmLwe encrypting, in slot
    j, input key j's element i (cm_lwe_keyswitch_key_generation.rs:15-100);
    ``key`` the words on the device as K1 takes them
    (kernels.keyswitch_key)."""

    data: np.ndarray
    decomp: DecompParams
    key: object

    @classmethod
    def from_raw_keys(cls, data, decomp: DecompParams, device="cuda") -> "CmLweKeyswitchKey":
        """tfhe_tpu's CmLweKeyswitchKey.data."""
        data = np.asarray(data, dtype=np.uint64)
        return cls(data, decomp, kernels.keyswitch_key(
            torus.from_u64(data, resolve_device(device)), decomp.base_log, decomp.level_count))

    @property
    def input_lwe_dimension(self) -> int:
        return self.data.shape[0]


def _level_shifts(decomp: DecompParams) -> np.ndarray:
    """64 - base_log (l - j) for stored level j."""
    levels = decomp.level_count
    return np.array([64 - decomp.base_log * (levels - j) for j in range(levels)],
                    dtype=np.uint64)


def generate_cm_lwe_keyswitch_key(input_sks: list, output_sks: list, decomp: DecompParams,
                                  noise_distribution, gen: EncryptionRandomGenerator,
                                  device="cuda") -> CmLweKeyswitchKey:
    """Row (i, lev), in that order, one CmLwe of [s^in_j[i] 2^(64 -
    base_log (l - lev))]_j under the output keys, from one generator."""
    assert len(input_sks) == len(output_sks)
    n_in, levels, c = input_sks[0].dimension, decomp.level_count, len(input_sks)
    bits = np.stack([sk.data.astype(np.uint64) for sk in input_sks], axis=1)   # (n_in, C)
    with np.errstate(over="ignore"):
        msgs = bits[:, None, :] << _level_shifts(decomp)[None, :, None]
    dev = resolve_device(device)
    rows = encrypt_cm_lwe_batch(output_sks, msgs.reshape(-1, c), noise_distribution, gen, dev)
    return CmLweKeyswitchKey.from_raw_keys(rows.reshape(n_in, levels, -1), decomp, dev)


def _keyswitch_mask(mask, key, decomp: DecompParams):
    """-sum decomp(mask_i) key[i] through K1, fed (mask, 0)."""
    ext = torch.cat([mask, mask.new_zeros((mask.shape[0], 1))], dim=1)
    return kernels.keyswitch(ext, key, decomp.base_log, decomp.level_count)


def cm_keyswitch(ct, cksk: CmLweKeyswitchKey):
    """Batched CM keyswitch (cm_lwe_keyswitch.rs:12): (B, n_in + C) ->
    (B, n_out + C): out = (0, bodies) - sum decomp(mask_i) ksk[i], the sum
    one K1 launch over the n_out + C key columns."""
    n_in = cksk.data.shape[0]
    c = ct.shape[1] - n_in
    out = _keyswitch_mask(ct[:, :n_in], cksk.key, cksk.decomp)
    out[:, -c:] += ct[:, n_in:]
    return out


# ---------------------------------------------------------------------------
# CM GLWE and GGSW (cm.py:146-254)
# ---------------------------------------------------------------------------


def _add_cm_secret_products(rows: np.ndarray, sks: list, device) -> None:
    """rows (R, k + C, N) CmGlwes whose bodies lack the secret term: body j
    += sum_i mask_i (*) s_j[i], in place, on ``device`` (keygen's
    add_mask_times_secret, one key a slot)."""
    k = sks[0].glwe_dimension
    for j, sk in enumerate(sks):
        part = np.ascontiguousarray(np.concatenate([rows[:, :k], rows[:, k + j, None]], axis=1))
        add_mask_times_secret(part, sk, device)
        rows[:, k + j] = part[:, k]


def _draw_cm_glwe(row: np.ndarray, body_inits: np.ndarray, noise_distribution,
                  gen: EncryptionRandomGenerator) -> None:
    """Fill one CmGlwe row (k + C, N) but its secret products: the shared
    mask, then one noise polynomial a slot (cm_glwe_encryption.rs:18-116)."""
    c, n_poly = body_inits.shape
    k = row.shape[0] - c
    row[:k] = gen.mask.uniform_u64(k * n_poly).reshape(k, n_poly)
    with np.errstate(over="ignore"):
        for j in range(c):
            row[k + j] = (body_inits[j].astype(np.uint64)
                          + noise_distribution.sample(gen.noise, n_poly))


def encrypt_cm_glwe(sks: list, body_inits: np.ndarray, noise_distribution,
                    gen: EncryptionRandomGenerator, device="cuda") -> np.ndarray:
    """A shared k-polynomial mask, one body polynomial a GLWE key; body_inits
    (C, N) the bodies' plaintext content.  Returns (k + C, N) uint64."""
    k, n_poly = sks[0].data.shape
    out = np.zeros((1, k + len(sks), n_poly), dtype=np.uint64)
    _draw_cm_glwe(out[0], body_inits, noise_distribution, gen)
    _add_cm_secret_products(out, sks, resolve_device(device))
    return out[0]


def decrypt_cm_glwe(sks: list, ct: np.ndarray) -> np.ndarray:
    """(k + C, N) -> the (C, N) plaintexts (cm_glwe_encryption.rs:237)."""
    k, n_poly = sks[0].data.shape
    plan = ntt.make_plan(n_poly)
    out = []
    with np.errstate(over="ignore"):
        for j, sk in enumerate(sks):
            acc = np.asarray(ct[k + j], dtype=np.uint64).copy()
            for i in range(k):
                acc = acc - ntt.negacyclic_polymul_u64(np.asarray(ct[i], dtype=np.uint64),
                                                       sk.data[i].astype(np.uint64), plan)
            out.append(acc)
    return np.stack(out)


def _draw_cm_ggsw(out: np.ndarray, sks: list, cleartexts: list, decomp: DecompParams,
                  noise_distribution, gen: EncryptionRandomGenerator) -> None:
    """Fill one CM GGSW out (l, k + C, k + C, N) but its secret products,
    from forks of levels, then of rows (cm_ggsw_encryption.rs:17-235): mask
    row r < k encrypts [factor_j s_j[r]]_j, body row k + i [-factor_i X^0 in
    slot i], factor_j = -cleartext_j 2^(64 - base_log level)."""
    k, n_poly = sks[0].data.shape
    c = len(sks)
    rows, levels = k + c, decomp.level_count
    lev_gens = gen.fork(levels, rows * k * n_poly, rows * c * n_poly, noise_distribution)
    with np.errstate(over="ignore"):
        for j, lev_gen in enumerate(lev_gens):
            shift = 64 - decomp.base_log * (levels - j)
            factors = [(((-m) % M64) << shift) % M64 for m in cleartexts]
            row_gens = lev_gen.fork(rows, k * n_poly, c * n_poly, noise_distribution)
            for r, row_gen in enumerate(row_gens):
                body_inits = np.zeros((c, n_poly), dtype=np.uint64)
                if r < k:
                    for slot, sk in enumerate(sks):
                        body_inits[slot] = sk.data[r].astype(np.uint64) * np.uint64(factors[slot])
                else:
                    body_inits[r - k, 0] = (-factors[r - k]) % M64
                _draw_cm_glwe(out[j, r], body_inits, noise_distribution, row_gen)


def encrypt_cm_ggsw(sks: list, cleartexts: list, decomp: DecompParams, noise_distribution,
                    gen: EncryptionRandomGenerator, device="cuda") -> np.ndarray:
    """The CM GGSW of per-slot cleartexts (cm_ggsw_encryption.rs:17-235):
    (l, k + C, k + C, N) uint64, the square layout of a standard GGSW, its
    secret products taken on ``device``."""
    k, n_poly = sks[0].data.shape
    rows = k + len(sks)
    assert len(cleartexts) == len(sks)
    out = np.zeros((decomp.level_count, rows, rows, n_poly), dtype=np.uint64)
    _draw_cm_ggsw(out, sks, cleartexts, decomp, noise_distribution, gen)
    _add_cm_secret_products(out.reshape(-1, rows, n_poly), sks, resolve_device(device))
    return out


def cm_ggsw_to_ntt(ggsw: np.ndarray, num_primes: int = 4, device="cuda") -> NttKey:
    """A standard-domain CM GGSW -> its Montgomery NTT form on ``device``."""
    return words_to_ntt_key(ggsw, num_primes, device)


def cm_external_product(cm_glwe, ggsw_ntt, dp, base_log: int, levels: int):
    """cm_ggsw_external_product.rs:45: the standard external product at
    glwe_size k + C, batched (B, k + C, N); K2's CMux entry on (0, glwe),
    by kernels.cmux_route."""
    return kernels.cmux(torch.zeros_like(cm_glwe), cm_glwe, ggsw_ntt, dp, base_log, levels)


def cm_cmux(ct0, ct1, ggsw_ntt, dp, base_log: int, levels: int):
    """ct0 + GGSW (x) (ct1 - ct0), each slot selected by its cleartext bit
    (cm_ggsw_external_product.rs:184): K2's CMux entry at k+1 = k + C, by
    kernels.cmux_route."""
    return kernels.cmux(ct0, ct1, ggsw_ntt, dp, base_log, levels)


# ---------------------------------------------------------------------------
# CM bootstrap (cm.py:262-359), on K2
# ---------------------------------------------------------------------------


def generate_cm_lwe_bootstrap_key(input_sks: list, glwe_sks: list, decomp: DecompParams,
                                  noise_distribution, gen: EncryptionRandomGenerator,
                                  device="cuda") -> np.ndarray:
    """Entry i the CM GGSW of [s^in_1[i], .., s^in_C[i]], one fork a GGSW
    (cm_lwe_bootstrap_key_generation.rs:70); the secret products of all
    rows taken in batches on ``device``.  Returns (n_in, l, k + C, k + C,
    N) uint64, standard domain."""
    assert len(input_sks) == len(glwe_sks)
    n_in = input_sks[0].dimension
    k, n_poly = glwe_sks[0].data.shape
    c = len(glwe_sks)
    rows, levels = k + c, decomp.level_count
    out = np.zeros((n_in, levels, rows, rows, n_poly), dtype=np.uint64)
    ggsw_gens = gen.fork(n_in, levels * rows * k * n_poly, levels * rows * c * n_poly,
                         noise_distribution)
    for i, ggsw_gen in enumerate(ggsw_gens):
        _draw_cm_ggsw(out[i], glwe_sks, [int(sk.data[i]) for sk in input_sks], decomp,
                      noise_distribution, ggsw_gen)
    _add_cm_secret_products(out.reshape(-1, rows, n_poly), glwe_sks, resolve_device(device))
    return out


def cm_bootstrap_key_to_ntt(cm_bsk: np.ndarray, num_primes: int = 4, device="cuda") -> NttKey:
    """The (n, l, k + C, k + C, P, N) Montgomery NTT-domain CM bootstrap
    key on ``device`` (cm_lwe_bootstrap_key_conversion.rs analog)."""
    return words_to_ntt_key(cm_bsk, num_primes, device)


def cm_blind_rotate(ct, lut, bsk_ntt, dp, base_log: int, levels: int, k: int):
    """cm_blind_rotate_assign (cm_bootstrap.rs:75): the modulus switch to
    2N, zero mask rows and row k + j the LUT divided by X^{body_j}, then one
    shared-mask CMux chain for every slot through K2
    (kernels.rotate_accumulator at k+1 = k + C).  ct (B, n + C); lut (N,)
    int64, shared by the slots.  Returns the accumulator (B, k + C, N)."""
    b = ct.shape[0]
    c_dim = ct.shape[1] - bsk_ntt.shape[0]
    n_poly = lut.shape[-1]
    msed = srv.modulus_switch(ct, (2 * n_poly).bit_length() - 1)
    acc = torch.zeros((b, k + c_dim, n_poly), dtype=torch.int64, device=ct.device)
    acc[:, k:] = srv.monomial_div(lut.expand(b, c_dim, n_poly), msed[:, -c_dim:, None])
    return kernels.rotate_accumulator(acc, msed[:, :-c_dim], bsk_ntt, dp, base_log, levels)


def cm_sample_extract(acc, k: int):
    """cm_glwe_sample_extraction.rs: coefficient 0 of each slot, in the
    shared-mask form (B, k+C, N) -> (B, k N + C): the standard extraction's
    mask, shared, and the slots' constant coefficients."""
    b, _, n_poly = acc.shape
    mask = acc[:, :k]
    rev = torch.cat([mask[:, :, :1], -torch.flip(mask[:, :, 1:], dims=[-1])], dim=-1)
    return torch.cat([rev.reshape(b, k * n_poly), acc[:, k:, 0]], dim=1)


def cm_bootstrap(ct, lut, bsk_ntt, dp, base_log: int, levels: int, k: int):
    """The CM PBS (cm_bootstrap.rs:171): blind rotation and per-slot
    extraction.  Returns (B, k N + C) under the flattened GLWE keys."""
    return cm_sample_extract(cm_blind_rotate(ct, lut, bsk_ntt, dp, base_log, levels, k), k)


# ---------------------------------------------------------------------------
# CM packing (cm.py:368-418), on K1; the CM drift measure (cm.py:421-445)
# ---------------------------------------------------------------------------


@dataclass
class CmLwePackingKey:
    """(C, n_in, l, n_out + C) uint64: part i switches standard LWEs under
    one input key into slot i of a CmLwe (cm_lwe_packing_key_generation.rs:
    16); ``keys`` the C parts on the device as K1 takes them."""

    data: np.ndarray
    decomp: DecompParams
    keys: list

    @classmethod
    def from_raw_keys(cls, data, decomp: DecompParams, device="cuda") -> "CmLwePackingKey":
        """tfhe_tpu's CmLwePackingKey.data."""
        data = np.asarray(data, dtype=np.uint64)
        dev = resolve_device(device)
        return cls(data, decomp, [kernels.keyswitch_key(torus.from_u64(part, dev),
                                                        decomp.base_log, decomp.level_count)
                                  for part in data])


def generate_cm_lwe_packing_key(input_sk: LweSecretKey, output_sks: list,
                                decomp: DecompParams, noise_distribution,
                                gen: EncryptionRandomGenerator,
                                device="cuda") -> CmLwePackingKey:
    """Row (part, i, lev), in that order, one CmLwe of s_in[i] 2^(64 -
    base_log (l - lev)) in slot ``part`` and 0 elsewhere, from one
    generator."""
    n_in, levels, c = input_sk.dimension, decomp.level_count, len(output_sks)
    with np.errstate(over="ignore"):
        v = input_sk.data.astype(np.uint64)[:, None] << _level_shifts(decomp)[None, :]
    msgs = np.zeros((c, n_in, levels, c), dtype=np.uint64)
    for part in range(c):
        msgs[part, :, :, part] = v
    dev = resolve_device(device)
    rows = encrypt_cm_lwe_batch(output_sks, msgs.reshape(-1, c), noise_distribution, gen, dev)
    return CmLwePackingKey.from_raw_keys(rows.reshape(c, n_in, levels, -1), decomp, dev)


def pack_lwe_ciphertexts_into_cm(cts, pk: CmLwePackingKey):
    """cm_lwe_packing.rs:12: C standard LWEs (B, C, n_in + 1) under one key
    -> (B, n_out + C), slot i holding ciphertext i's message: a K1 launch a
    part, its body added into column n_out + i."""
    c = cts.shape[1]
    n_out = pk.data.shape[-1] - c
    out = None
    for part in range(c):
        term = _keyswitch_mask(cts[:, part, :-1], pk.keys[part], pk.decomp)
        term[:, n_out + part] += cts[:, part, -1]
        out = term if out is None else out + term
    return out


def cm_drift_ms_improve(ct, zeros, log_modulus: int, r_sigma: float,
                        input_variance_mod: float, c_dim: int):
    """The CM drift-technique noise reduction of the modulus switch
    (cm_modulus_switch_noise_reduction.rs:14-107): the measure over the
    shared mask only (no body term), in float32, then the best of {0,
    zeros} added to the whole [mask | bodies] vector.  ct (B, n + C); zeros
    (Z, n + C) CmLwe encryptions of zero.  The float32 sums run column after
    column, as ops/server.py drift_ms_improve's (tfhe_tpu's XLA CPU sums in
    that order up to n = 32); the argmin takes the first smallest."""
    shift = 64 - log_modulus
    half = 1 << (shift - 1)
    cands = torch.cat([torch.zeros_like(zeros[:1]), zeros])
    c = ct[None, :, :] + cands[:, None, :]                   # (Z+1, B, n+C)
    err = ((torus.shr(c[..., :-c_dim] + half, shift) << shift)
           - c[..., :-c_dim]).to(torch.float32)
    total = torch.zeros(err.shape[:-1], dtype=torch.float32, device=ct.device)
    squares = torch.zeros_like(total)
    for i in range(err.shape[-1]):
        total = total + err[..., i]
        squares = squares + err[..., i] * err[..., i]
    f32 = dict(dtype=torch.float32, device=ct.device)
    measure = (-total / 2.0).abs() + torch.sqrt(
        squares / 4.0 + torch.tensor(input_variance_mod, **f32)) * torch.tensor(r_sigma, **f32)
    best = torch.argmin(measure, dim=0)
    return torch.gather(c, 0, best[None, :, None].expand(1, -1, c.shape[-1]))[0]
