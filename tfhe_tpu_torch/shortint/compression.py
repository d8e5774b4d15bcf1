"""Ciphertext list compression with dedicated compression parameters (port
of tfhe_tpu/shortint/compression.py; the reference's
shortint/list_compression: CompressionParameters, CompressionPrivateKeys,
the CompressionKey's packing keyswitch and the DecompressionKey's blind
rotation).

  compress:   the whole list through one packing keyswitch (kernel K4),
              up to lwe_per_glwe LWEs into each GLWE under the dedicated
              storage key (small N_c, larger k_c), then every coefficient
              modulus-switched to storage_log_modulus bits (u16).
  decompress: sample extract in the switched domain; the storage modulus
              is the compute blind rotation's input modulus 2N, so every
              extracted LWE feeds one blind rotation (kernel K2) under the
              storage -> compute bootstrapping key with the identity LUT.

Keys are generated on the host exactly as tfhe_tpu generates them (same
seeds, same order of draws, the same mask flooring) and uploaded to the
device once.  On a CUDA device with a floored decompression key of the v7
shape, decompression runs K2 in v7 mode: the function of tfhe_tpu's v8
Pallas kernel, which is the v7 function in a TPU macro-step layout.
Otherwise it runs the exact rotation, as tfhe_tpu does on the CPU.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass

import numpy as np
import torch

from ..core import keygen as kg
from ..core import security
from ..core.entities import GlweSecretKey, LweBootstrapKey, LweSecretKey
from ..core.params import DecompParams
from ..ops import kernels, ntt, torus
from ..ops import server as srv
from ..ops.bsk_prep import mask_floor_bsk, rounded_key_ntt
from ..utils import hbm
from ..utils.csprng import (DeterministicSeeder, EncryptionRandomGenerator,
                            SecretRandomGenerator, TUniform)
from ..utils.device import resolve_device
from .client_key import ClientKey
from .server_key import ROUND_BITS, lazy_outputs, upload_batch


@dataclass(frozen=True)
class CompressionParameters:
    """shortint/parameters/list_compression.rs ClassicCompressionParameters."""

    br_level: int
    br_base_log: int
    packing_ks_level: int
    packing_ks_base_log: int
    packing_ks_polynomial_size: int
    packing_ks_glwe_dimension: int
    lwe_per_glwe: int
    storage_log_modulus: int
    packing_ks_key_noise: object  # noise distribution of the storage key's encs


# v1_4/list_compression/p_fail_2_minus_128/mod.rs:8 (TUniform 2M128 2_2)
V1_4_COMP_PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128 = CompressionParameters(
    br_level=1,
    br_base_log=23,
    packing_ks_level=3,
    packing_ks_base_log=4,
    packing_ks_polynomial_size=256,
    packing_ks_glwe_dimension=4,
    lwe_per_glwe=256,
    storage_log_modulus=12,
    packing_ks_key_noise=TUniform(43),
)

# pairs with TEST_PARAM_MESSAGE_2_CARRY_2 (compute N=512 -> storage mod 2^10)
TEST_COMP_PARAM = CompressionParameters(
    br_level=1,
    br_base_log=23,
    packing_ks_level=3,
    packing_ks_base_log=4,
    packing_ks_polynomial_size=256,
    packing_ks_glwe_dimension=1,
    lwe_per_glwe=256,
    storage_log_modulus=10,
    packing_ks_key_noise=TUniform(3),
)


def default_compression_parameters(compute_params) -> CompressionParameters:
    if compute_params.polynomial_size >= 2048:
        return V1_4_COMP_PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128
    return TEST_COMP_PARAM


@dataclass
class CompressedCiphertextList:
    """Storage-domain GLWEs: coefficients hold storage_log_modulus-bit
    values (u16), exactly the blind-rotation input domain."""

    glwes: np.ndarray  # (G, k_c+1, N_c) u16, values < 2^storage_log
    storage_log_modulus: int
    count: int
    degrees: list
    message_modulus: int
    carry_modulus: int


class CompressionPrivateKeys:
    """Dedicated storage GLWE secret key (CompressionPrivateKeys)."""

    def __init__(self, comp_params: CompressionParameters, seed: int):
        self.params = comp_params
        gen = SecretRandomGenerator(seed ^ 0x1F3D5B79)
        self.post_packing_ks_key = kg.generate_binary_glwe_secret_key(
            comp_params.packing_ks_glwe_dimension,
            comp_params.packing_ks_polynomial_size, gen)


def generate_packing_keyswitch_key(input_sk: LweSecretKey, glwe_sk: GlweSecretKey,
                                   base_log: int, levels: int, noise_distribution,
                                   gen: EncryptionRandomGenerator, device="cuda") -> np.ndarray:
    """The (n, l, k+1, N) uint64 packing keyswitch key: row (i, j) encrypts
    the constant polynomial s_i 2^(64 - base_log (l - j)) under glwe_sk.

    tfhe_tpu encrypts the n l rows one by one from one generator
    (compression.py:185-194): mask, then noise, each from its own stream.
    Drawing every row's mask and every row's noise in that order takes the
    same bytes, and the bodies (plaintext + noise + sum_i mask_i * s_i,
    wrapping) are then computed in batches."""
    device = resolve_device(device)
    n_in = input_sk.dimension
    k, n_poly = glwe_sk.glwe_dimension, glwe_sk.polynomial_size
    key = np.zeros((n_in, levels, k + 1, n_poly), dtype=np.uint64)
    key[:, :, :k] = gen.mask.uniform_u64(n_in * levels * k * n_poly).reshape(
        n_in, levels, k, n_poly)
    key[:, :, k] = noise_distribution.sample(gen.noise, n_in * levels * n_poly).reshape(
        n_in, levels, n_poly)
    shifts = np.array([64 - base_log * (levels - j) for j in range(levels)], dtype=np.uint64)
    with np.errstate(over="ignore"):
        key[:, :, k, 0] += input_sk.data.astype(np.uint64)[:, None] << shifts[None, :]
    kg.add_mask_times_secret(key.reshape(n_in * levels, k + 1, n_poly), glwe_sk, device)
    return key


def _check_storage_modulus(p, cp: CompressionParameters) -> None:
    if cp.storage_log_modulus != p.polynomial_size.bit_length():
        raise ValueError("storage modulus must equal the compute blind-rotation "
                         "input modulus log2(2N)")


def _v7_shape(p, cp: CompressionParameters) -> bool:
    """The decompression key's v7 shape: the test of tfhe_tpu's flooring
    rule (compression.py:209-211) and of its ``use_mxu`` (:302-303)."""
    return (p.polynomial_size == 2048 and p.glwe_dimension == 1
            and cp.br_level == 1 and cp.br_base_log <= 23)


def decompression_uses_v7(device: torch.device, p, cp: CompressionParameters,
                          bsk_floored: int) -> bool:
    """Whether decompression runs K2 in v7 mode: tfhe_tpu's ``use_mxu`` test
    (compression.py:297-304, the v8 kernel on its 3-prime rb-15 plan) with
    the device in place of the backend test, and a key floored at
    ROUND_BITS (an unfloored key takes the exact rotation)."""
    return device.type == "cuda" and _v7_shape(p, cp) and bsk_floored >= ROUND_BITS


class DecompressionKey:
    """BSK from the storage key (as an LWE key) to the compute GLWE key,
    on the device in K2's layout: in v7 mode (``trunc_acc``) the rounded
    key (ops/bsk_prep.py RoundedKeyNtt, rounded to 2^ROUND_BITS, built on
    the device), otherwise the exact NTT-domain key."""

    def __init__(self, bsk: LweBootstrapKey, bsk_floored: int, params,
                 comp_params: CompressionParameters, device: torch.device):
        self.br_base_log = comp_params.br_base_log
        self.br_level = comp_params.br_level
        self.device = device
        self.trunc_acc = decompression_uses_v7(device, params, comp_params, bsk_floored)
        if self.trunc_acc:
            self.bsk_ntt = rounded_key_ntt(bsk.data, ROUND_BITS, self.br_base_log, device)
            plan = ntt.make_plan(bsk.polynomial_size)
        else:
            plan = ntt.make_plan(bsk.polynomial_size)
            self.bsk_ntt = ntt.key_ntt(bsk.data, ntt.device_plan(plan, str(device)))
        self.dp = ntt.device_plan(plan, str(device))
        self._bsk_coeff = bsk
        self._bsk_floored = bsk_floored


class CompressionKey:
    """Packing keyswitch key (big compute LWE key -> storage GLWE key) plus
    the paired decompression key; built from the client key on the host and
    kept on ``device`` (CUDA unless the caller asks for the CPU)."""

    def __init__(self, client_key: ClientKey, seed: int | None = None,
                 comp_params: CompressionParameters | None = None, device="cuda"):
        device = resolve_device(device)
        p = client_key.params
        cp = comp_params or default_compression_parameters(p)
        _check_storage_modulus(p, cp)
        if seed is None:
            seed = secrets.randbits(128)
        priv = CompressionPrivateKeys(cp, seed)
        self.private_keys = priv
        storage_sk = priv.post_packing_ks_key
        gen = EncryptionRandomGenerator(seed ^ 0x452821E638D01377,
                                        DeterministicSeeder(seed ^ 0xBE5466CF34E90C6C))
        pksk = generate_packing_keyswitch_key(
            client_key.big_lwe_secret_key, storage_sk, cp.packing_ks_base_log,
            cp.packing_ks_level, cp.packing_ks_key_noise, gen, device)
        gen2 = EncryptionRandomGenerator(seed ^ 0x9216D5D98979FB1B,
                                         DeterministicSeeder(seed ^ 0xD1310BA698DFB5AC))
        bsk = kg.generate_lwe_bootstrap_key(
            storage_sk.as_lwe_secret_key(), client_key.glwe_secret_key,
            DecompParams(cp.br_base_log, cp.br_level), p.glwe_noise, gen2, device)
        # mask flooring under tfhe_tpu's rule (compression.py:209-225): the
        # v7 shape, and the estimator guard; where the guard fails tfhe_tpu
        # keeps the unfloored key without raising, and so does the port
        floored = 0
        if _v7_shape(p, cp):
            kn = p.glwe_dimension * p.polynomial_size
            ok_f, _ = security.check_lwe_noise_secure(p.glwe_noise, kn,
                                                      modulus_log2_shrink=ROUND_BITS)
            ok_p, _ = security.check_lwe_noise_secure(p.glwe_noise, kn)
            if ok_f or not ok_p:
                bsk = mask_floor_bsk(bsk, client_key.glwe_secret_key, ROUND_BITS, device)
                floored = ROUND_BITS
        self._init_from_raw(p, cp, pksk, bsk, floored, device)

    @classmethod
    def from_raw_keys(cls, params, comp_params: CompressionParameters, pksk_data,
                      bsk_data, bsk_floored: int = 0, device="cuda") -> "CompressionKey":
        """Build from a standard-domain packing key (n_big, l, k_c+1, N_c) and
        decompression BSK (k_c N_c, l, k+1, k+1, N) uint64.  bsk_floored: the
        rb its masks are floored to (0 for a key that was not floored, which
        never takes the v7 rotation)."""
        _check_storage_modulus(params, comp_params)
        obj = cls.__new__(cls)
        obj.private_keys = None
        obj._init_from_raw(params, comp_params, np.asarray(pksk_data),
                           LweBootstrapKey(np.asarray(bsk_data),
                                           DecompParams(comp_params.br_base_log,
                                                        comp_params.br_level)),
                           bsk_floored, resolve_device(device))
        return obj

    def _init_from_raw(self, p, cp: CompressionParameters, pksk: np.ndarray,
                       bsk: LweBootstrapKey, bsk_floored: int,
                       device: torch.device) -> None:
        self.params = p
        self.comp = cp
        self.device = device
        # uploaded once: the standard-domain u64 words and, on the card at a
        # shape of K4's tensor-core kernel, their byte layout beside them
        # (kernels.PackingKeyswitchKeyLimbs; else the words themselves)
        self.pksk = torus.from_u64(pksk, device)
        self.pks_key = kernels.packing_keyswitch_key(self.pksk, cp.packing_ks_base_log,
                                                     cp.packing_ks_level)
        self.decompression = DecompressionKey(bsk, bsk_floored, p, cp, device)

    def compress(self, cts: list) -> CompressedCiphertextList:
        """Pack the list: one K4 launch for all of it, then the switch to
        storage_log_modulus bits.  Device-resident ciphertexts (a round's
        lazy outputs) are gathered on the device."""
        cp = self.comp
        batch = upload_batch([c.data for c in cts], self.device)
        glwes = kernels.packing_keyswitch(batch, self.pks_key, cp.packing_ks_base_log,
                                          cp.packing_ks_level, cp.lwe_per_glwe)
        msed = srv.modulus_switch(glwes, cp.storage_log_modulus)
        first = cts[0]
        packed = CompressedCiphertextList(
            msed.cpu().numpy().astype(np.uint16), cp.storage_log_modulus, len(cts),
            [c.degree for c in cts], first.message_modulus, first.carry_modulus)
        packed._decompression_key = self.decompression
        packed._compute_params = self.params
        return packed

    def decompress(self, packed: CompressedCiphertextList, indices=None) -> list:
        return decompress(packed, indices, self.decompression, self.params)


def extract_switched(glwes, indices, log_mod: int):
    """Slots ``indices`` of storage-domain GLWEs (G, k+1, N_c) as switched
    LWEs (B, k N_c + 1): monomial_div by X^j then sample extract, composed
    (a[l] = m[j - l] for l <= j, -m[N_c + j - l] for l > j, mod 2^log_mod;
    body = b[j]), as tfhe_tpu/shortint/compression.py:277-294 does it."""
    n_c = glwes.shape[-1]
    idx = torch.as_tensor(indices, dtype=torch.int64, device=glwes.device)
    g, j = idx // n_c, idx % n_c
    masks = glwes[g, :-1, :]                                   # (B, k, N_c)
    b, k = masks.shape[:2]
    ll = torch.arange(n_c, device=glwes.device)
    src = torch.remainder(j[:, None] - ll[None, :], n_c)       # (B, N_c)
    a = torch.gather(masks, -1, src[:, None, :].expand(b, k, n_c))
    neg = (ll[None, :] > j[:, None])[:, None, :]
    a = torch.where(neg, (-a) & ((1 << log_mod) - 1), a)
    return torch.cat([a.reshape(b, -1), glwes[g, -1, j][:, None]], dim=1)


def decompress(packed: CompressedCiphertextList, indices=None,
               key: DecompressionKey | None = None, compute_params=None) -> list:
    """Extract slots from the storage domain and refresh each through the
    decompression blind rotation with the identity LUT: one launch of K2
    for the whole batch, on the key's device.  The outputs stay there, as
    a server round's do."""
    key = key or getattr(packed, "_decompression_key", None)
    compute_params = compute_params or getattr(packed, "_compute_params", None)
    if key is None or compute_params is None:
        raise ValueError("decompression requires the DecompressionKey "
                         "(use CompressionKey.decompress or pass key=)")
    p = compute_params
    indices = list(range(packed.count)) if indices is None else list(indices)
    glwes = torch.from_numpy(packed.glwes.astype(np.int64)).to(key.device)
    msed = extract_switched(glwes, indices, packed.storage_log_modulus)
    lut = torus.from_u64(srv.generate_lut(p.polynomial_size, p.glwe_dimension + 1,
                                          p.total_modulus, p.delta, lambda x: x), key.device)
    # device-memory admission (tfhe_tpu/shortint/compression.py:306-319):
    # a chunk of the batch a K2 launch where the batch outgrows the card
    chunk = hbm.admit_chunk(len(indices), decompression_bytes_per_item(p, msed.shape[1]),
                            min_items=1, device=key.device)
    outs = [srv.pbs_from_switched_batch(msed[s:s + chunk],
                                        lut.expand(min(chunk, len(indices) - s), -1, -1),
                                        key.bsk_ntt, key.dp, key.br_base_log, key.br_level,
                                        key.trunc_acc)
            for s in range(0, len(indices), chunk)]
    return lazy_outputs(outs[0] if len(outs) == 1 else torch.cat(outs),
                        [packed.degrees[i] for i in indices], [packed] * len(indices))


def decompression_bytes_per_item(p, width: int) -> int:
    """The decompression's device working set a ciphertext: its switched
    LWE (width words), the K2 accumulator and its padded copy, and the
    extracted output."""
    k1, n_poly = p.glwe_dimension + 1, p.polynomial_size
    return (width + 2 * k1 * n_poly + p.glwe_dimension * n_poly + 1) * 8
