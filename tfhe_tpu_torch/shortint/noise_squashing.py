"""Noise squashing: re-encrypt a shortint ciphertext on the u128 torus
(port of tfhe_tpu/shortint/noise_squashing.py:1-189).

Mirrors shortint/noise_squashing/ (server_key.rs squash_ciphertext_noise,
private_key.rs): what a threshold-decryption deployment runs on every
result it releases, so that the partial decryptions shared afterwards leak
nothing of the compute noise.  Pipeline (atomic_pattern/standard.rs): the
u64 keyswitch with the compute key (K1), the plain modulus switch to
log 2N, then the 128-bit PBS with the identity LUT over the msg * carry
space (K5) and sample extract; the result is an LWE under a dedicated
u128 GLWE key.

The bootstrapping key is generated exactly as tfhe_tpu generates it (same
seeds, same bytes; core/torus128.py) and uploaded once, in K5's
NTT-domain layout.

Squashed-noise compression (tfhe_tpu/shortint/noise_squashing.py:194-342;
shortint/list_compression/noise_squashing_compression.rs): up to
lwe_per_glwe squashed LWEs packed into one u128 GLWE by a u128 packing
keyswitch, K6 (csrc/packing_keyswitch128.cu), on the key's standard-domain
words kept on the device; ``decrypt_list`` runs on the host (numpy), for a
client without a GPU.  A threshold-decryption server runs it on every
batch of squashed results it releases.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass

import numpy as np
import torch

from ..core import torus128
from ..core.params import DecompParams
from ..ops import kernels, ntt, server128, torus
from ..utils import hbm
from ..utils.csprng import (DeterministicSeeder, EncryptionRandomGenerator,
                            SecretRandomGenerator, TUniform)
from ..utils.device import resolve_device
from .ciphertext import Ciphertext
from .server_key import upload_batch


@dataclass(frozen=True)
class NoiseSquashingParams:
    """shortint/parameters/noise_squashing.rs NoiseSquashingClassicParameters."""

    glwe_dimension: int
    polynomial_size: int
    glwe_noise_bound_log2: int  # TUniform bound on the u128 torus
    decomp_base_log: int
    decomp_level_count: int
    message_modulus: int
    carry_modulus: int

    @property
    def total_modulus(self) -> int:
        return self.message_modulus * self.carry_modulus

    @property
    def delta128(self) -> int:
        return (1 << 128) // (2 * self.total_modulus)


# v1_4/noise_squashing/p_fail_2_minus_128/mod.rs:8
V1_4_NOISE_SQUASHING_PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128 = NoiseSquashingParams(
    glwe_dimension=2,
    polynomial_size=2048,
    glwe_noise_bound_log2=30,
    decomp_base_log=24,
    decomp_level_count=3,
    message_modulus=4,
    carry_modulus=4,
)

# fast insecure test set (pairs with shortint TEST_PARAM_MESSAGE_2_CARRY_2)
TEST_NOISE_SQUASHING_PARAM = NoiseSquashingParams(
    glwe_dimension=1,
    polynomial_size=512,
    glwe_noise_bound_log2=3,
    decomp_base_log=24,
    decomp_level_count=3,
    message_modulus=4,
    carry_modulus=4,
)


@dataclass
class SquashedNoiseCiphertext:
    """shortint/ciphertext/squashed_noise.rs: a u128 LWE as its (lo, hi) u64
    words, int64 tensors of k N + 1 on the squashing key's device."""

    lo: torch.Tensor
    hi: torch.Tensor
    degree: int
    message_modulus: int
    carry_modulus: int


class NoiseSquashingPrivateKey:
    """Dedicated u128 GLWE secret key (noise_squashing/private_key.rs)."""

    def __init__(self, params: NoiseSquashingParams, seed: int | None = None):
        if seed is None:
            seed = secrets.randbits(128)
        sec = SecretRandomGenerator(seed ^ 0x128128128)
        self._init_key(params, torus128.generate_binary_glwe_secret_key128(
            params.glwe_dimension, params.polynomial_size, sec))

    @classmethod
    def from_raw_keys(cls, params: NoiseSquashingParams,
                      glwe_key_bits) -> "NoiseSquashingPrivateKey":
        """Build from the binary GLWE key bits (k N values, any shape)."""
        obj = cls.__new__(cls)
        bits = np.asarray(glwe_key_bits, dtype=np.uint64).reshape(
            params.glwe_dimension, params.polynomial_size)
        obj._init_key(params, torus128.GlweSecretKey128(bits))
        return obj

    def _init_key(self, params: NoiseSquashingParams,
                  key: torus128.GlweSecretKey128) -> None:
        self.params = params
        self.glwe_secret_key = key
        self._key_bits = key.to_lwe_key_bits()

    def decrypt_squashed_noise_ciphertext(self, ct: SquashedNoiseCiphertext) -> int:
        pt = torus128.decrypt_lwe128(self._key_bits, torus.to_u64(ct.lo),
                                     torus.to_u64(ct.hi))
        total = ct.message_modulus * ct.carry_modulus
        # decode128 rounds at the padding bit: msg_bits = log2(msg * carry)
        return torus128.decode128(pt, (total - 1).bit_length()) % total


class NoiseSquashingKey:
    """BSK128 over the compute small LWE key (noise_squashing/server_key.rs),
    built on the host and kept on ``device`` (CUDA unless the caller asks
    for the CPU) in K5's layout: (n, l, k+1, k+1, 6, N) int32, Montgomery
    NTT domain."""

    def __init__(self, client_key, private_key: NoiseSquashingPrivateKey,
                 seed: int | None = None, device="cuda"):
        device = resolve_device(device)
        sp = private_key.params
        dp = self.device_plan(sp, device)
        bsk_lo, bsk_hi = self.generate_standard_key(client_key, private_key, seed, dp)
        self._init_key(sp, torus128.bootstrap_key128_to_ntt_on(bsk_lo, bsk_hi, dp), dp)

    @staticmethod
    def device_plan(sp: NoiseSquashingParams, device) -> ntt.DevicePlan:
        """6 primes: the device external product needs 2^(11+23+128+log2 9)
        ~ 2^166 < P/2, and the keygen's binary-key products (2^140) share
        the tables, as in tfhe_tpu."""
        return ntt.device_plan(ntt.make_plan(sp.polynomial_size, 6), str(device))

    @staticmethod
    def generate_standard_key(client_key, private_key: NoiseSquashingPrivateKey,
                              seed: int | None, dp: ntt.DevicePlan) -> tuple:
        """The standard-domain BSK128 as (lo, hi) uint64 (n, l, k+1, k+1, N),
        tfhe_tpu's words from the same seed, the secret products on dp's
        device."""
        sp = private_key.params
        if seed is None:
            seed = secrets.randbits(128)
        gen = EncryptionRandomGenerator(seed, DeterministicSeeder(seed ^ 0x5175A5))
        return torus128.generate_bootstrap_key128(
            client_key.lwe_secret_key, private_key.glwe_secret_key,
            DecompParams(sp.decomp_base_log, sp.decomp_level_count),
            TUniform(sp.glwe_noise_bound_log2), gen, dp)

    @classmethod
    def from_standard_keys(cls, bsk_lo, bsk_hi, params: NoiseSquashingParams,
                           device="cuda") -> "NoiseSquashingKey":
        """Build from the standard-domain BSK128 (lo, hi) uint64 pair
        (generate_standard_key's; utils/keycache.py stores it): K5's NTT
        layout is built on the device."""
        dp = cls.device_plan(params, resolve_device(device))
        obj = cls.__new__(cls)
        obj._init_key(params, torus128.bootstrap_key128_to_ntt_on(bsk_lo, bsk_hi, dp), dp)
        return obj

    @classmethod
    def from_raw_keys(cls, bsk128_mont, params: NoiseSquashingParams,
                      device="cuda") -> "NoiseSquashingKey":
        """Build from an NTT-domain key (n, l, k+1, k+1, 6, N) uint32 in
        Montgomery form, as tfhe_tpu's NoiseSquashingKey holds it."""
        device = resolve_device(device)
        obj = cls.__new__(cls)
        dp = ntt.device_plan(ntt.make_plan(params.polynomial_size, 6), str(device))
        key = torch.from_numpy(np.array(bsk128_mont, dtype=np.uint32).view(np.int32)).to(device)
        obj._init_key(params, key, dp)
        return obj

    def _init_key(self, sp: NoiseSquashingParams, bsk128_ntt: torch.Tensor,
                  dp: ntt.DevicePlan) -> None:
        self.params = sp
        self.dp128 = dp
        self.plan128 = dp.plan
        self.device = dp.psi.device
        self.bsk128_ntt = bsk128_ntt
        self.message_modulus = sp.message_modulus
        self.carry_modulus = sp.carry_modulus
        lut_lo, lut_hi = server128.generate_lut128(
            sp.polynomial_size, sp.glwe_dimension + 1, sp.total_modulus,
            sp.delta128, lambda x: x)
        self._lut = (torus.from_u64(lut_lo, self.device), torus.from_u64(lut_hi, self.device))

    def squash_ciphertext_noise(self, ct: Ciphertext, server_key) -> SquashedNoiseCiphertext:
        return self.squash_ciphertext_noise_batch([ct], server_key)[0]

    def bytes_per_ciphertext(self, server_key) -> int:
        """The squash's device working set a ciphertext: K5's scratch (6
        (k+1) N int32) and accumulator, the LUT pair's rows, the keyswitch's
        input and output and the extracted pair."""
        sp = self.params
        k1, n_poly = sp.glwe_dimension + 1, sp.polynomial_size
        n_big = server_key.params.glwe_dimension * server_key.params.polynomial_size
        return (self.plan128.num_primes * k1 * n_poly * 4 + 3 * k1 * n_poly * 16
                + (n_big + server_key.params.lwe_dimension + 2) * 8
                + (sp.glwe_dimension * n_poly + 1) * 16)

    def squash_ciphertext_noise_batch(self, cts: list, server_key) -> list:
        """One batched KS -> MS -> PBS128 -> SE for a list of ciphertexts
        (host arrays or a round's device-resident outputs): one K1 and one
        K5 launch on a CUDA device for each chunk that the free device
        memory admits (utils/hbm.py; one chunk unless the batch outgrows
        the card).  The outputs stay on the device."""
        p = server_key.params
        sp = self.params
        if cts[0].message_modulus != self.message_modulus:
            raise ValueError("Mismatched MessageModulus with NoiseSquashingKey")
        n = len(cts)
        chunk = hbm.admit_chunk(n, self.bytes_per_ciphertext(server_key), min_items=1,
                                device=self.device)
        out = []
        for s in range(0, n, chunk):
            part = cts[s:s + chunk]
            batch = upload_batch([c.data for c in part], self.device)
            lut_lo, lut_hi = (t.expand((len(part),) + tuple(t.shape)) for t in self._lut)
            out_lo, out_hi = server128.ks_pbs128_batch(
                batch, lut_lo, lut_hi, server_key.ks_key, self.bsk128_ntt, self.dp128,
                p.ks_base_log, p.ks_level, sp.decomp_base_log, sp.decomp_level_count)
            out += [SquashedNoiseCiphertext(out_lo[i], out_hi[i], c.degree,
                                            self.message_modulus, self.carry_modulus)
                    for i, c in enumerate(part)]
        return out


# ---------------------------------------------------------------------------
# Squashed-noise compression: pack squashed (u128) LWEs into one GLWE by a
# u128 packing keyswitch (tfhe_tpu/shortint/noise_squashing.py:194-342;
# V1_4_NOISE_SQUASHING_COMP params: N = 1024, k = 6, base 2^61, one level)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class NoiseSquashingCompressionParams:
    packing_ks_level: int
    packing_ks_base_log: int
    packing_ks_polynomial_size: int
    packing_ks_glwe_dimension: int
    lwe_per_glwe: int
    packing_noise_bound_log2: int


V1_4_NOISE_SQUASHING_COMP_PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128 = \
    NoiseSquashingCompressionParams(
        packing_ks_level=1, packing_ks_base_log=61,
        packing_ks_polynomial_size=1024, packing_ks_glwe_dimension=6,
        lwe_per_glwe=128, packing_noise_bound_log2=3)

TEST_NOISE_SQUASHING_COMP_PARAM = NoiseSquashingCompressionParams(
    packing_ks_level=1, packing_ks_base_log=61,
    packing_ks_polynomial_size=256, packing_ks_glwe_dimension=2,
    lwe_per_glwe=16, packing_noise_bound_log2=3)

# the CRT-NTT plan of the packing keyswitch's plain version and of
# tfhe_tpu's NTT-domain key: 8 primes hold n l N 2^60 2^128 (2^210 at V1_4)
COMPRESSION_PRIMES = 8


@dataclass
class CompressedSquashedNoiseCiphertextList:
    """The stored form: one u128 GLWE as (lo, hi) numpy uint64 (k+1, N) on
    the host, slots 0 .. count-1 of its body carrying the messages."""

    glwe_lo: np.ndarray
    glwe_hi: np.ndarray
    count: int
    message_modulus: int
    carry_modulus: int


class NoiseSquashingCompressionPrivateKey:
    """The packing GLWE key over the u128 torus; ``decrypt_list`` runs on the
    host (numpy, the 8-prime host half), for a client with no GPU."""

    def __init__(self, params: NoiseSquashingCompressionParams,
                 seed: int | None = None):
        self.params = params
        if seed is None:
            seed = secrets.randbits(128)
        sec = SecretRandomGenerator(seed ^ 0xC0123)
        self.glwe_secret_key = torus128.generate_binary_glwe_secret_key128(
            params.packing_ks_glwe_dimension, params.packing_ks_polynomial_size, sec)

    def decrypt_list(self, packed: CompressedSquashedNoiseCiphertextList) -> list:
        """Decrypt the packed GLWE and decode each slot's message
        (tfhe_tpu/shortint/noise_squashing.py:236-256)."""
        sk = self.glwe_secret_key
        n = self.params.packing_ks_polynomial_size
        plan = ntt.make_plan(n, COMPRESSION_PRIMES)
        with np.errstate(over="ignore"):
            a_lo = packed.glwe_lo[-1].copy()
            a_hi = packed.glwe_hi[-1].copy()
            for i in range(sk.glwe_dimension):
                q_lo, q_hi = ntt.negacyclic_polymul_u128(
                    packed.glwe_lo[i], packed.glwe_hi[i], sk.data[i],
                    np.zeros(n, np.uint64), plan)
                a_lo, a_hi = ntt.sub128_np(a_lo, a_hi, q_lo, q_hi)
        total = packed.message_modulus * packed.carry_modulus
        bits = (total - 1).bit_length()
        return [torus128.decode128(int(a_lo[j]) | (int(a_hi[j]) << 64), bits) % total
                for j in range(packed.count)]


class NoiseSquashingCompressionKey:
    """u128 packing keyswitch key from the squashing GLWE key (as an LWE
    key) to the packing GLWE key, generated with tfhe_tpu's words from the
    same seeds and kept on ``device`` (CUDA unless the caller asks for the
    CPU) as K6 takes it (ops/kernels.py packing_keyswitch128_key): ``pksk``
    the standard-domain words, (n, l, k+1, N, 2) int64, each u128 word's
    (lo, hi), on the CPU, and their (n, l, k+1, 16, N) uint8 byte layout on
    the card (470 MB at V1_4 either way: ``device_bytes``)."""

    def __init__(self, squashing_private_key: NoiseSquashingPrivateKey,
                 comp_private_key: NoiseSquashingCompressionPrivateKey,
                 seed: int | None = None, device="cuda"):
        device = resolve_device(device)
        cp = comp_private_key.params
        if seed is None:
            seed = secrets.randbits(128)
        gen = EncryptionRandomGenerator(seed, DeterministicSeeder(seed ^ 0xC0124))
        noise = TUniform(cp.packing_noise_bound_log2)
        in_bits = squashing_private_key.glwe_secret_key.to_lwe_key_bits()
        n_in, levels = len(in_bits), cp.packing_ks_level
        k_out, n_out = cp.packing_ks_glwe_dimension, cp.packing_ks_polynomial_size
        dp = ntt.device_plan(ntt.make_plan(n_out, COMPRESSION_PRIMES), str(device))
        # one generator, row by row (:262-297): every row's mask and noise
        # drawn in that order, the secret products then added in batches on
        # the key's device (the words of encrypting row by row)
        lo = np.zeros((n_in * levels, k_out + 1, n_out), dtype=np.uint64)
        hi = np.zeros_like(lo)
        with np.errstate(over="ignore"):
            for i in range(n_in):
                for lev in range(levels):
                    # slot lev pairs with decomposition digit lev, level L - lev
                    shift = 128 - cp.packing_ks_base_log * (levels - lev)
                    row = i * levels + lev
                    lo[row, k_out, 0], hi[row, k_out, 0] = torus128._split(int(in_bits[i]) << shift)
                    torus128._draw_row(lo[row], hi[row], k_out, n_out, noise, gen)
        torus128.add_mask_times_secret128(lo, hi, comp_private_key.glwe_secret_key, dp)
        shape = (n_in, levels, k_out + 1, n_out)
        self._init_key(cp, lo.reshape(shape), hi.reshape(shape), dp)

    @classmethod
    def from_raw_keys(cls, pksk_mont, params: NoiseSquashingCompressionParams,
                      device="cuda") -> "NoiseSquashingCompressionKey":
        """Build from tfhe_tpu's stored key: the 8-prime Montgomery NTT
        domain (n, l, k+1, 8, N) uint32 (noise_squashing.py:295-297, cached
        by its keycache.py:141-170), brought back to the standard domain on
        the host by inverse NTT and Garner (exact: the words are below
        2^128, under P/2)."""
        plan = ntt.make_plan(params.packing_ks_polynomial_size, COMPRESSION_PRIMES)
        mont = np.asarray(pksk_mont, dtype=np.uint32).astype(np.uint64)
        with np.errstate(over="ignore"):
            normal = ntt._mont_mul_np(mont, np.uint64(1), plan.ps, plan.pinvs)
            lo, hi = ntt.garner_to_u128_np(ntt._inverse_np(normal, plan), plan)
        return cls.from_standard_keys(lo, hi, params, device)

    @classmethod
    def from_standard_keys(cls, pksk_lo, pksk_hi, params: NoiseSquashingCompressionParams,
                           device="cuda") -> "NoiseSquashingCompressionKey":
        """Build from the standard-domain key (n, l, k+1, N) (lo, hi) uint64
        (utils/keycache.py stores it)."""
        device = resolve_device(device)
        plan = ntt.make_plan(params.packing_ks_polynomial_size, COMPRESSION_PRIMES)
        obj = cls.__new__(cls)
        obj._init_key(params, np.asarray(pksk_lo, dtype=np.uint64),
                      np.asarray(pksk_hi, dtype=np.uint64), ntt.device_plan(plan, str(device)))
        return obj

    def standard_key(self) -> tuple:
        """The key's standard-domain (lo, hi) uint64 words on the host."""
        words = self.pksk
        if words.dtype == torch.uint8:
            words = kernels.packing_keyswitch128_key_words(words)
        words = torus.to_u64(words)
        return words[..., 0].copy(), words[..., 1].copy()

    def _init_key(self, cp: NoiseSquashingCompressionParams, pksk_lo: np.ndarray,
                  pksk_hi: np.ndarray, dp: ntt.DevicePlan) -> None:
        self.params = cp
        self.dp = dp
        self.plan = dp.plan
        self.device = dp.psi.device
        words = np.stack([pksk_lo, pksk_hi], axis=-1).view(np.int64)
        self.pksk = kernels.packing_keyswitch128_key(
            torch.from_numpy(np.ascontiguousarray(words)).to(self.device))

    @property
    def device_bytes(self) -> int:
        return self.pksk.numel() * self.pksk.element_size()

    def bytes_per_list(self, n_in: int) -> int:
        """K6's device working set a list: its input slots, the partial sums
        of its blocks, the output GLWE."""
        cp = self.params
        k1, n_poly = cp.packing_ks_glwe_dimension + 1, cp.packing_ks_polynomial_size
        sms = (torch.cuda.get_device_properties(self.device).multi_processor_count
               if self.device.type == "cuda" else 1)
        chunks = -(-n_in // kernels.k6_imma_chunk(n_in, n_poly, 1, sms))
        return (cp.lwe_per_glwe * (n_in + 1) + (chunks + 1) * k1 * n_poly) * 16

    def compress(self, cts: list) -> CompressedSquashedNoiseCiphertextList:
        """Pack <= lwe_per_glwe squashed LWEs into one u128 GLWE: slot j of
        the output body carries ct_j's plaintext (one K6 launch)."""
        return self.compress_batch([cts])[0]

    def compress_batch(self, lists: list) -> list:
        """compress for many lists at once: one K6 launch for every chunk of
        lists that the free device memory admits (utils/hbm.py; one chunk
        unless the batch outgrows the card).  The inputs are squashed
        ciphertexts on the key's device (a squash's outputs) or on the host."""
        cp = self.params
        limit = min(cp.lwe_per_glwe, cp.packing_ks_polynomial_size)
        for cts in lists:
            if not 1 <= len(cts) <= limit:
                raise ValueError(f"a list of {len(cts)} ciphertexts: 1 to {limit} fit a GLWE")
        n_in = self.pksk.shape[0]
        chunk = hbm.admit_chunk(len(lists), self.bytes_per_list(n_in), min_items=1,
                                device=self.device)
        out = []
        for s in range(0, len(lists), chunk):
            part = lists[s:s + chunk]
            width = max(len(cts) for cts in part)
            lwes = torch.zeros((len(part), width, n_in + 1, 2), dtype=torch.int64,
                               device=self.device)
            for g, cts in enumerate(part):
                for w, attr in enumerate(("lo", "hi")):
                    lwes[g, :len(cts), :, w] = torch.stack(
                        [torch.as_tensor(getattr(c, attr)) for c in cts]).to(self.device)
            glwes = kernels.packing_keyswitch128(lwes, self.pksk, [len(c) for c in part],
                                                 cp.packing_ks_base_log, cp.packing_ks_level,
                                                 self.dp).cpu().numpy().view(np.uint64)
            out += [CompressedSquashedNoiseCiphertextList(
                        glwes[g, ..., 0].copy(), glwes[g, ..., 1].copy(), len(cts),
                        cts[0].message_modulus, cts[0].carry_modulus)
                    for g, cts in enumerate(part)]
        return out
