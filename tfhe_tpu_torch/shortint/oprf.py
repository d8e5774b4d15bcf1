"""Oblivious pseudo-random function (shortint/oprf.rs:93-331; port of
tfhe_tpu/shortint/oprf.py, the same words from the same seeds).

A pseudorandom LWE is derived from a *public* seed (an XOF keystream as the
mask); under the secret key its phase is pseudorandom, and one PBS maps it
to a uniform value in [0, 2^bits_count).  The server learns nothing about
the output (it only sees the seed).  The XOF is the AES-CTR stream used
everywhere else, domain-separated, as in tfhe_tpu.

``generate_oblivious_pseudo_random`` draws on the compute key: one
pseudorandom big-key LWE through ``ServerKey.apply_lookup_table`` (K1, then
K2).  The dedicated-key path draws its inputs already modulus-switched and
runs only the blind rotation (``ops/server.pbs_from_switched_batch``) in exact
mode: on the card, K2's lazy exact kernel on the exact, unrounded key
(``ServerKey.exact_bsk_ntt`` for the compute key), as tfhe_tpu runs the
exact function on every backend.
"""

from __future__ import annotations

import secrets

import numpy as np
import torch

from ..core import keygen as kg
from ..core.params import DecompParams
from ..ops import ntt, torus
from ..ops import server as srv
from ..utils.csprng import (ByteStream, DeterministicSeeder, EncryptionRandomGenerator,
                            SecretRandomGenerator)
from ..utils.device import resolve_device
from .ciphertext import NOMINAL_NOISE, Ciphertext
from .server_key import ServerKey, lazy_outputs, pad_pow2

OPRF_DOMAIN = 0x4F505246  # "OPRF"


def pseudo_random_lwe(params, seed: int, bits: int = 64) -> np.ndarray:
    """Deterministic pseudorandom LWE (mask + body) from a public seed,
    (big_lwe_dimension + 1,) uint64 words of the bits-wide torus (64 or
    32: ``ByteStream.uniform_scalar``)."""
    return ByteStream(seed ^ (OPRF_DOMAIN << 96)).uniform_scalar(
        params.big_lwe_dimension + 1, bits)


def generate_oblivious_pseudo_random(
    sk: ServerKey, seed: int, random_bits_count: int | None = None
) -> Ciphertext:
    """Server-side: an encryption of a uniform pseudorandom value.

    The pseudorandom phase is uniform on the torus; a PBS with the staircase
    LUT x % 2^bits, whose two halves both enumerate [0, 2^bits), maps it to
    a uniform integer (the padding bit folds away) while normalizing the
    noise.  One KS->PBS round on the compute key; the output stays on the
    device."""
    p = sk.params
    if random_bits_count is None:
        random_bits_count = (p.message_modulus - 1).bit_length()
    out_modulus = 1 << random_bits_count
    if out_modulus > p.total_modulus:
        raise ValueError(f"{random_bits_count} random bits exceed the block's "
                         f"{p.total_modulus} values")
    ct = Ciphertext(pseudo_random_lwe(p, seed, p.bits), degree=p.total_modulus - 1,
                    noise_level=NOMINAL_NOISE, message_modulus=p.message_modulus,
                    carry_modulus=p.carry_modulus)
    out = sk.apply_lookup_table(ct, sk.generate_lookup_table(lambda x: x % out_modulus))
    out.degree = out_modulus - 1
    return out


# ---------------------------------------------------------------------------
# Dedicated OPRF keys (shortint/oprf.rs:93-331): a fresh small-LWE secret key
# plus a bootstrapping key to the target GLWE key.  The pseudorandom input is
# sampled directly in the modulus-switched domain [0, 2N) (the reference's
# PrfSeededModulusSwitched: XOF mask, zero body, no modulus switch), blind-
# rotated with the staircase OPRF LUT, and recentered with a post-PBS
# constant so the output is uniform in [0, 2^bits).
# ---------------------------------------------------------------------------


def generate_oprf_lut(params, random_bits_count: int) -> tuple:
    """(acc (k+1, N) u64, post_pbs_constant): shortint/oprf.rs
    generate_oprf_lut, acc[i] = (2 (i // poly_delta) + 1) delta / 2."""
    n = params.polynomial_size
    p2 = 1 << random_bits_count
    delta = params.delta
    idx = np.arange(n, dtype=np.uint64)
    body = (2 * (idx // np.uint64(2 * n // p2)) + 1) * np.uint64(delta // 2)
    acc = np.zeros((params.glwe_dimension + 1, n), dtype=np.uint64)
    acc[-1] = body
    post = np.uint64(((p2 - 1) * (delta // 2)) % (1 << 64))
    return acc, post


class OprfPrivateKey:
    """Dedicated OPRF secret key: a fresh binary LWE key at the compute
    parameters' small LWE dimension (shortint/oprf.rs OprfPrivateKey)."""

    def __init__(self, client_key, seed: int | None = None):
        p = client_key.params
        assert not p.ks32, "OPRF keys: Standard AP only"
        self.params = p
        if seed is None:
            seed = secrets.randbits(128)
        gen = SecretRandomGenerator(seed ^ OPRF_DOMAIN)
        self.lwe_sk = kg.generate_binary_lwe_secret_key(p.lwe_dimension, gen)


class OprfServerKey:
    """OPRF bootstrapping key on the device: the exact NTT-domain key (int32
    residues on ``dp``'s four primes) from the OPRF LWE key to the target
    client key's GLWE key (shortint/oprf.rs OprfBootstrappingKey)."""

    def __init__(self, bsk_ntt: torch.Tensor, dp: ntt.DevicePlan, params):
        self.bsk_ntt = bsk_ntt
        self.dp = dp
        self.params = params
        self.device = bsk_ntt.device

    @classmethod
    def new(cls, oprf_pk: OprfPrivateKey, target_ck, seed: int | None = None,
            device="cuda") -> "OprfServerKey":
        device = resolve_device(device)
        p = target_ck.params
        if seed is None:
            seed = secrets.randbits(128)
        gen = EncryptionRandomGenerator(seed, DeterministicSeeder(seed ^ 0x9E3779B9))
        bsk = kg.generate_lwe_bootstrap_key(
            oprf_pk.lwe_sk, target_ck.glwe_secret_key,
            DecompParams(p.pbs_base_log, p.pbs_level), p.glwe_noise, gen, device)
        return cls.from_raw_key(bsk.data, p, device)

    @classmethod
    def from_raw_key(cls, bsk, params, device="cuda") -> "OprfServerKey":
        """From a standard-domain OPRF BSK, (n, l, k+1, k+1, N) u64 (as
        tfhe_tpu's ``OprfServerKey.new`` generates it), uploaded to the
        device once in the exact NTT domain."""
        device = resolve_device(device)
        dp = ntt.device_plan(ntt.make_plan(params.polynomial_size), str(device))
        return cls(ntt.key_ntt(np.asarray(bsk, dtype=np.uint64), dp), dp, params)

    @classmethod
    def from_compute_key(cls, sk: ServerKey) -> "OprfServerKey":
        """The compute BSK as an OPRF key (ServerKey::as_oprf_key_view): its
        exact key, which the server key builds once and keeps."""
        return cls(sk.exact_bsk_ntt(), sk.dp, sk.params)

    def switched_inputs(self, seed: int, bits_per_block: list) -> tuple:
        """The rotation's inputs on the device, padded to the batch it runs
        at: the modulus-switched masks (zero bodies) drawn from one
        domain-separated XOF stream, (B, n+1) in [0, 2N), the OPRF LUTs
        (B, k+1, N), and each entry's post-PBS constant."""
        p = self.params
        n_in = self.bsk_ntt.shape[0]
        two_n = 2 * p.polynomial_size
        # the dedicated-key stream: OPRF_DOMAIN and a tag of its own
        stream = ByteStream((seed ^ (OPRF_DOMAIN << 96) ^ (0xD5 << 120))
                            & ((1 << 128) - 1))
        nblk = len(bits_per_block)
        msed = np.zeros((nblk, n_in + 1), dtype=np.uint64)
        for i in range(nblk):
            msed[i, :-1] = stream.uniform_u64(n_in) & np.uint64(two_n - 1)
        luts, posts = zip(*(generate_oprf_lut(p, bits) for bits in bits_per_block))
        n_pad = pad_pow2(nblk)
        msed = np.concatenate([msed, np.repeat(msed[:1], n_pad - nblk, 0)])
        luts = list(luts) + [luts[0]] * (n_pad - nblk)
        return (torus.from_u64(msed, self.device),
                torus.from_u64(np.stack(luts), self.device), posts)

    def generate_bits_blocks(self, seed: int, bits_per_block: list) -> list:
        """One Ciphertext per entry, each uniform in [0, 2^bits), from one
        batched rotation.  The outputs stay on the device."""
        p = self.params
        msed, luts, posts = self.switched_inputs(seed, bits_per_block)
        out = srv.pbs_from_switched_batch(msed, luts, self.bsk_ntt, self.dp,
                                          p.pbs_base_log, p.pbs_level)
        cts = lazy_outputs(out, [(1 << bits) - 1 for bits in bits_per_block],
                           [p] * len(bits_per_block))
        for ct, post in zip(cts, posts):
            ct.data = ServerKey._add_to_body(ct.data, post)
        return cts
