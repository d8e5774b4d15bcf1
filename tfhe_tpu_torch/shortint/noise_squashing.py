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
NTT-domain layout.  Squashed-noise compression (noise_squashing.py:194-342)
is not ported yet (ROADMAP.md queue 1 item 12).
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass

import numpy as np
import torch

from ..core import torus128
from ..core.params import DecompParams
from ..ops import ntt, server128, torus
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
        if seed is None:
            seed = secrets.randbits(128)
        gen = EncryptionRandomGenerator(seed, DeterministicSeeder(seed ^ 0x5175A5))
        # 6 primes: the device external product needs 2^(11+23+128+log2 9)
        # ~ 2^166 < P/2, and the keygen's binary-key products (2^140) share
        # the tables, as in tfhe_tpu
        dp = ntt.device_plan(ntt.make_plan(sp.polynomial_size, 6), str(device))
        bsk_lo, bsk_hi = torus128.generate_bootstrap_key128(
            client_key.lwe_secret_key, private_key.glwe_secret_key,
            DecompParams(sp.decomp_base_log, sp.decomp_level_count),
            TUniform(sp.glwe_noise_bound_log2), gen, dp)
        self._init_key(sp, torus128.bootstrap_key128_to_ntt_on(bsk_lo, bsk_hi, dp), dp)

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

    def squash_ciphertext_noise_batch(self, cts: list, server_key) -> list:
        """One batched KS -> MS -> PBS128 -> SE for a list of ciphertexts
        (host arrays or a round's device-resident outputs): one K1 and one
        K5 launch on a CUDA device.  The outputs stay on the device."""
        p = server_key.params
        sp = self.params
        if cts[0].message_modulus != self.message_modulus:
            raise ValueError("Mismatched MessageModulus with NoiseSquashingKey")
        n = len(cts)
        batch = upload_batch([c.data for c in cts], self.device)
        lut_lo, lut_hi = (t.expand((n,) + tuple(t.shape)) for t in self._lut)
        out_lo, out_hi = server128.ks_pbs128_batch(
            batch, lut_lo, lut_hi, server_key.ks_key, self.bsk128_ntt, self.dp128,
            p.ks_base_log, p.ks_level, sp.decomp_base_log, sp.decomp_level_count)
        return [SquashedNoiseCiphertext(out_lo[i], out_hi[i], cts[i].degree,
                                        self.message_modulus, self.carry_modulus)
                for i in range(n)]
