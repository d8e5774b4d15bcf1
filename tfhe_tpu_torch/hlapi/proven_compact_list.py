"""Proven compact ciphertext lists: compact-PKE encryption + ZK proof.

Port of tfhe_tpu/hlapi/proven_compact_list.py (high_level_api/
compact_list.rs:20 ProvenCompactCiphertextList; SURVEY.md §3.5): the client
encrypts up to k messages under the compact public key and attaches a
proof (zk/pke.py v1 or zk/pke_v2.py v2) that (c1, c2) is well-formed with
bounded noise; the server runs verify_and_expand to get per-slot LWE
ciphertexts only if the proof checks out.  Proving and verifying are host
code (the curve's hot loops in csrc/bls446.cpp); the expansion is one
batched extraction on the device.

Encoding follows the proof's convention (proofs/pke/mod.rs): with r' the
encryption polynomial, c1 = a (*) r' + e1 and slot i lives at coefficient
d-1-i of b (*) r', i.e. c2_i = (b (*) r')[d-1-i] + delta*m_i + e2_i.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass

import numpy as np

from ..ops import ntt
from ..utils.csprng import DeterministicSeeder, EncryptionRandomGenerator, SecretRandomGenerator
from ..utils.device import resolve_device
from ..zk import pke, pke_v2
from .compact_list import expanded_slots

M64 = 1 << 64


def _center(x: int, q: int = 0) -> int:
    if q == 0:
        x &= M64 - 1
        return x - M64 if x >= M64 // 2 else x
    r = x % q
    return r - q if 2 * r >= q else r


@dataclass
class CompactPkeCrs:
    """CRS sized for a compact public key (zk::CompactPkeCrs analog).

    scheme: "v1" (pke v1, bit-decomposition proof) or "v2" (pke_v2, the
    reference's default: four-square norm bound + 128-row sketch, smaller
    CRS/proof at production sizes).
    """

    params: object  # pke.PublicParams | pke_v2.PublicParams
    scheme: str = "v1"

    @classmethod
    def new(cls, shortint_params, max_num_messages: int,
            seed: int | None = None, scheme: str = "v1") -> "CompactPkeCrs":
        if scheme not in ("v1", "v2"):
            raise ValueError(f"unknown zk scheme {scheme!r}: use 'v1' or 'v2'")
        p = shortint_params
        d = p.polynomial_size * p.glwe_dimension
        t = 2 * p.total_modulus  # includes the padding bit
        if scheme == "v2":
            # TUniform(b) takes values in [-2^b, 2^b]: inclusive inf-norm bound
            b_inf = 1 << p.glwe_noise.bound_log2
            pp = pke_v2.crs_gen(d, max_num_messages, b_inf, 0, t,
                                msbs_zero_padding_bit_count=1, seed=seed)
        else:
            noise_bound = 1 << (p.glwe_noise.bound_log2 + 1)
            pp = pke.crs_gen(d, max_num_messages, noise_bound, 0, t,
                             msbs_zero_padding_bit_count=1, seed=seed)
        return cls(pp, scheme)

    @property
    def _mod(self):
        return pke_v2 if self.scheme == "v2" else pke


@dataclass
class ProvenCompactCiphertextList:
    c1: np.ndarray      # (d,) u64 mask polynomial
    c2: np.ndarray      # (k,) u64 bodies
    proof: pke.Proof
    message_modulus: int
    carry_modulus: int

    def verify(self, crs: CompactPkeCrs, public_key, metadata: bytes = b"") -> bool:
        pc = _public_commit(public_key, self.c1, self.c2)
        return crs._mod.verify(self.proof, crs.params, pc, metadata)

    def verify_and_expand(self, crs: CompactPkeCrs, public_key,
                          metadata: bytes = b"", device="cuda") -> list:
        """pke_v2-flow analog: pairing-check the proof, then expand each slot
        to an LWE ciphertext under the compute key."""
        if not self.verify(crs, public_key, metadata):
            raise ValueError("invalid compact-PKE proof")
        return self.expand_without_verification(device)

    def expand_without_verification(self, device="cuda") -> list:
        """Every slot as a Ciphertext on ``device``: the GLWE (c1, body)
        with body coefficient d-1-i = c2_i, slot i extracted at coefficient
        d-1-i, all slots in one batched extraction."""
        d, k = len(self.c1), len(self.c2)
        body = np.zeros(d, dtype=np.uint64)
        body[d - 1 - np.arange(k)] = self.c2
        return expanded_slots(np.stack([np.asarray(self.c1, dtype=np.uint64), body]),
                              [d - 1 - i for i in range(k)], self.message_modulus,
                              self.carry_modulus, resolve_device(device))


def _public_commit(public_key, c1, c2) -> pke.PublicCommit:
    a = [_center(int(v)) for v in public_key.a[0]]
    b = [_center(int(v)) for v in public_key.b]
    return pke.PublicCommit(
        a, b, [_center(int(v)) for v in c1], [_center(int(v)) for v in c2])


def build_with_proof(public_key, messages: list, crs: CompactPkeCrs,
                     metadata: bytes = b"", load: str = "proof",
                     seed: int | None = None) -> ProvenCompactCiphertextList:
    """CompactCiphertextList::build_with_proof_packed analog.

    public_key: hlapi CompactPublicKey (glwe_dimension must be 1 so the
    compact mask is a single polynomial: true for the 2_2 families).
    """
    p = public_key.params
    assert p.glwe_dimension == 1, "proven lists need a single-poly compact PK"
    d = p.polynomial_size
    k = len(messages)
    assert k <= crs.params.k
    t = 2 * p.total_modulus
    t_eff = p.total_modulus
    delta = (1 << 64) // t
    if seed is None:
        seed = secrets.randbits(128)
    sec = SecretRandomGenerator(seed)
    r = [int(x) for x in sec.binary_key(d)]
    gen = EncryptionRandomGenerator(seed ^ 0x9E37, DeterministicSeeder(seed ^ 0x7F4A))
    e1 = [int(x) for x in np.asarray(p.glwe_noise.sample(gen.noise, d)).view(np.int64)]
    e2 = [int(x) for x in np.asarray(p.glwe_noise.sample(gen.noise, k)).view(np.int64)]
    m = [int(v) % t_eff for v in messages]

    a = [_center(int(v)) for v in public_key.a[0]]
    b = [_center(int(v)) for v in public_key.b]

    plan = public_key._plan
    r_u = np.asarray(r, dtype=np.uint64)
    with np.errstate(over="ignore"):
        # c1 = a (*) r' + e1  (signed, wrap mod 2^64)
        c1_u = (ntt.negacyclic_polymul_u64(np.asarray(public_key.a[0], dtype=np.uint64),
                                           r_u, plan)
                + np.asarray(e1, dtype=np.int64).view(np.uint64))
        # c2_i = (b (*) r')[d-1-i] + delta*m_i + e2_i
        conv_b = ntt.negacyclic_polymul_u64(np.asarray(public_key.b, dtype=np.uint64),
                                            r_u, plan)
        c2_u = (conv_b[d - 1 - np.arange(k)]
                + np.asarray([delta * mi % M64 for mi in m], dtype=np.uint64)
                + np.asarray(e2, dtype=np.int64).view(np.uint64))

    # the proof operates on centered values with the REVERSED r convention
    pc = pke.PublicCommit(a, b, [_center(int(v)) for v in c1_u],
                          [_center(int(v)) for v in c2_u])
    priv = pke.PrivateCommit(r[::-1], e1, m, e2)
    proof = crs._mod.prove(crs.params, pc, priv, metadata, load,
                           seed.to_bytes(16, "little"))
    return ProvenCompactCiphertextList(np.asarray(c1_u), c2_u, proof,
                                       p.message_modulus, p.carry_modulus)
