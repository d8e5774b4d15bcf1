"""Compact public key + compact ciphertext lists.

Port of tfhe_tpu/hlapi/compact_list.py (core_crypto lwe_compact_public_key /
compact list expansion, SURVEY.md §3.5): the public key is one GLWE-shaped
pair (A, B = A (*) S + E); encryption draws a fresh binary polynomial r and
produces ONE mask polynomial C1 = A (*) r + E1 plus a body polynomial
C2 = B (*) r + E2 + M(X) carrying up to N messages in its coefficients.
Keys and encryption are host NumPy (the same words as tfhe_tpu from the same
seeds).  Expansion is one batched monomial division and sample extraction
over every slot on the device (ops/server.py extract_slots).

Casting (CompactPkeCastingKey) runs on the device: to the big key one K1
launch (base 2^24, l = 1: K1's generic kernel); to the small key K1 (2^4 x 4:
its tensor-core kernel), the compute set's modulus switch, and one exact
blind rotation with the identity table on the server key's exact key (K2's
lazy exact kernel at the 2_2 shape), as tfhe_tpu runs the exact function on
every backend.

ZK proofs of well-formedness (ProvenCompactCiphertextList / tfhe-zk-pok):
`build_with_proof` delegates to hlapi/proven_compact_list.py.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass

import numpy as np

from ..core import keygen as kg
from ..core.encrypt import decrypt_glwe, encrypt_glwe_assign
from ..core.entities import GlweCiphertext, LweSecretKey
from ..core.params import DecompParams
from ..ops import kernels, ntt, torus
from ..ops import server as srv
from ..shortint.ciphertext import Ciphertext
from ..shortint.params import MsNoiseReduction
from ..shortint.server_key import lazy_outputs, upload_batch
from ..utils.csprng import DeterministicSeeder, EncryptionRandomGenerator, SecretRandomGenerator
from ..utils.device import resolve_device

def _shortint_key(key):
    """The shortint key under an hlapi or integer key."""
    if hasattr(key, "integer_key"):
        key = key.integer_key
    return key.key if hasattr(key, "key") else key


def expanded_slots(glwe: np.ndarray, degrees, message_modulus: int, carry_modulus: int,
                   device) -> list:
    """The slots at the given coefficient degrees of a host (k+1, N) GLWE as
    Ciphertexts on the device (one batched extraction), each of degree
    message_modulus - 1."""
    out = srv.extract_slots(torus.from_u64(glwe, device), list(degrees))
    moduli = Ciphertext(None, 0, 0, message_modulus, carry_modulus)  # only its moduli are read
    return lazy_outputs(out, [message_modulus - 1] * len(out), [moduli] * len(out))


@dataclass
class CompactCiphertextList:
    glwe: np.ndarray  # (k+1, N)
    count: int
    message_modulus: int
    carry_modulus: int
    # True when encrypted under dedicated PKE parameters
    # (CompactCiphertextListExpansionKind::RequiresCasting): expansion MUST
    # go through a CompactPkeCastingKey into the compute set
    needs_casting: bool = False

    def expand(self, casting_key=None, device="cuda") -> list:
        """Every slot as a Ciphertext on ``device`` (the casting key's when
        one is given), cast into the compute set through the casting key."""
        if self.needs_casting and casting_key is None:
            raise ValueError(
                "this list was encrypted under dedicated PKE parameters "
                "(RequiresCasting): pass the CompactPkeCastingKey")
        device = casting_key.device if casting_key is not None else resolve_device(device)
        out = expanded_slots(self.glwe, range(self.count), self.message_modulus,
                             self.carry_modulus, device)
        if casting_key is not None:
            out = casting_key.cast_batch(out)
        return out


class CompactPublicKey:
    """Compact public key: under the COMPUTE GLWE key (legacy flow, lists
    expand directly) or under a CompactPrivateKey's dedicated PKE instance
    (the reference default: lists carry needs_casting=True and expansion
    casts into the compute set)."""

    def __init__(self, client_key, seed: int | None = None):
        if isinstance(client_key, CompactPrivateKey):
            ck = client_key
            self._requires_casting = True
        else:
            ck = _shortint_key(client_key)
            self._requires_casting = False
        p = ck.params
        if seed is None:
            seed = secrets.randbits(128)
        gen = EncryptionRandomGenerator(seed ^ 0xC0AC29B7C97C50DD,
                                        DeterministicSeeder(seed ^ 0x3F84D5B5B5470917))
        # pk = GLWE encryption of zero: (A, B = A (*) S + E)
        pk_ct = encrypt_glwe_assign(ck.glwe_secret_key,
                                    np.zeros(p.polynomial_size, dtype=np.uint64),
                                    p.glwe_noise, gen)
        self._init_from_raw(p, pk_ct.data[:-1], pk_ct.data[-1])

    @classmethod
    def from_raw_parts(cls, params, a, b, requires_casting: bool) -> "CompactPublicKey":
        """From the key's words: a (k, N) and b (N,) uint64 (e.g. another
        package's key), under ``params``."""
        obj = cls.__new__(cls)
        obj._requires_casting = requires_casting
        obj._init_from_raw(params, np.asarray(a, dtype=np.uint64),
                           np.asarray(b, dtype=np.uint64))
        return obj

    def _init_from_raw(self, params, a, b) -> None:
        self.params = params
        self.a = a  # (k, N)
        self.b = b  # (N,)
        self._plan = ntt.make_plan(params.polynomial_size, 4)

    def encrypt_glwe(self, body: np.ndarray, seed128: int | None = None) -> np.ndarray:
        """(k+1, N) host GLWE (A (*) r + E1, B (*) r + E2 + body) for a fresh
        binary r; with seed128, r and the noise come from it as tfhe_tpu's
        re-randomization draws them, else from three `secrets` draws as its
        encrypt_list does."""
        p = self.params
        n_poly = p.polynomial_size
        if seed128 is None:
            sec = SecretRandomGenerator(secrets.randbits(128))
            noise_gen = EncryptionRandomGenerator(secrets.randbits(128),
                                                  DeterministicSeeder(secrets.randbits(128)))
        else:
            sec = SecretRandomGenerator(seed128)
            noise_gen = EncryptionRandomGenerator(
                seed128 ^ 0x72657261, DeterministicSeeder(seed128 ^ 0x646F6D31))
        r = sec.binary_key(n_poly)  # fresh binary polynomial
        e1 = p.glwe_noise.sample(noise_gen.noise, p.glwe_dimension * n_poly)
        e2 = p.glwe_noise.sample(noise_gen.noise, n_poly)
        c1 = np.zeros((p.glwe_dimension, n_poly), dtype=np.uint64)
        with np.errstate(over="ignore"):
            for i in range(p.glwe_dimension):
                c1[i] = ntt.negacyclic_polymul_u64(self.a[i], r, self._plan) \
                    + e1[i * n_poly:(i + 1) * n_poly]
            c2 = ntt.negacyclic_polymul_u64(self.b, r, self._plan) + e2 + body
        return np.concatenate([c1, c2[None, :]], axis=0)

    def encrypt_list(self, messages: list) -> CompactCiphertextList:
        p = self.params
        assert len(messages) <= p.polynomial_size
        m_poly = np.zeros(p.polynomial_size, dtype=np.uint64)
        for j, m in enumerate(messages):
            m_poly[j] = np.uint64((int(m) % p.total_modulus) * p.delta)
        return CompactCiphertextList(self.encrypt_glwe(m_poly), len(messages),
                                     p.message_modulus, p.carry_modulus,
                                     needs_casting=self._requires_casting)

    def build_with_proof(self, messages: list, crs, metadata: bytes = b"", load=None):
        """Proven compact list (ProvenCompactCiphertextList): delegates to
        hlapi/proven_compact_list.py build_with_proof."""
        from . import proven_compact_list as pcl

        kwargs = {} if load is None else {"load": load}
        return pcl.build_with_proof(self, messages, crs, metadata, **kwargs)


class CompactPrivateKey:
    """Dedicated compact-public-key encryption secret (the reference's
    CompactPrivateKey): a GLWE secret under
    CompactPublicKeyEncryptionParameters, separate from the compute keys.
    Compact lists encrypted under it REQUIRE CASTING into the compute set
    during expansion (expansion_kind = RequiresCasting,
    v1_4/compact_public_key_only/p_fail_2_minus_128/ks_pbs.rs:8)."""

    def __init__(self, pke_params, seed: int | None = None):
        self.params = pke_params
        if seed is None:
            seed = secrets.randbits(128)
        self.glwe_secret_key = kg.generate_binary_glwe_secret_key(
            pke_params.glwe_dimension, pke_params.polynomial_size,
            SecretRandomGenerator(seed))
        # flattened LWE view (dim = k*N) for building the casting KSK
        self.encryption_key = LweSecretKey(self.glwe_secret_key.data.reshape(-1))

    def decrypt_list(self, lst: CompactCiphertextList) -> list:
        """Client-side decryption of a not-yet-cast list."""
        p = self.params
        pt = decrypt_glwe(self.glwe_secret_key, GlweCiphertext(np.asarray(lst.glwe)))
        return [int(round(int(pt[j]) / p.delta)) % p.total_modulus for j in range(lst.count)]


class CompactPkeCastingKey:
    """Keyswitching material from the dedicated PKE instance into the
    compute parameter set (shortint/key_switching_key/ +
    v1_4/key_switching/p_fail_2_minus_128/ks_pbs.rs).

    destination "big": one keyswitch lands directly on the compute big key
    (base 24 / level 1).  destination "small" (the reference default for
    ZKV2): keyswitch to the small key (base 4 / level 4) and a PBS refresh
    brings the value to the big key; `cast_batch` runs both stages.  The
    key lives on the server key's device (``device`` for a "big" key built
    without one), its K1 byte layout built there once.
    """

    def __init__(self, pke_private_key: CompactPrivateKey, client_key,
                 casting_params, server_key=None, seed: int | None = None,
                 device="cuda"):
        ck = _shortint_key(client_key)
        cp = ck.params
        pp = pke_private_key.params
        if (pp.message_modulus, pp.carry_modulus) != (cp.message_modulus, cp.carry_modulus):
            raise ValueError("mismatched message/carry moduli")
        if seed is None:
            seed = secrets.randbits(128)
        gen = EncryptionRandomGenerator(seed, DeterministicSeeder(seed ^ 0xCA5C))
        if casting_params.destination_key == "big":
            dst, noise = ck.big_lwe_secret_key, cp.glwe_noise
        else:
            dst, noise = ck.lwe_secret_key, cp.lwe_noise
        self._init_from_raw(cp, casting_params, server_key, device)
        ksk = kg.generate_lwe_keyswitch_key(
            pke_private_key.encryption_key, dst,
            DecompParams(casting_params.ks_base_log, casting_params.ks_level), noise, gen)
        self._upload(ksk.data)

    @classmethod
    def from_raw_parts(cls, ksk, dst_params, casting_params, server_key=None,
                       device="cuda") -> "CompactPkeCastingKey":
        """From the casting KSK's words, (k N, l, n_dst + 1) uint64 (e.g.
        another package's key), into the compute set ``dst_params``."""
        obj = cls.__new__(cls)
        obj._init_from_raw(dst_params, casting_params, server_key, device)
        obj._upload(np.asarray(ksk, dtype=np.uint64))
        return obj

    def _init_from_raw(self, dst_params, casting_params, server_key, device) -> None:
        if casting_params.destination_key != "big" and server_key is None:
            raise ValueError("destination 'small' needs the compute ServerKey for "
                             "the PBS refresh to the big key")
        self.params = casting_params
        self.dst_params = dst_params
        self.server_key = None if server_key is None else _shortint_key(server_key)
        self.device = (self.server_key.device if self.server_key is not None
                       else resolve_device(device))

    def _upload(self, ksk: np.ndarray) -> None:
        """The KSK on the device once, with K1's byte layout built there."""
        self.ksk = torus.from_u64(ksk, self.device)
        self.ks_key = kernels.keyswitch_key(self.ksk, self.params.ks_base_log,
                                            self.params.ks_level)

    def cast_batch(self, cts: list) -> list:
        """Cast expanded PKE-domain LWEs into compute-domain ciphertexts: one
        K1 launch (+ one exact blind rotation for dest=small).  The outputs
        stay on the device."""
        cp, kp = self.dst_params, self.params
        rows = upload_batch([c.data for c in cts], self.device)
        degrees = [cp.message_modulus - 1] * len(cts)
        if kp.destination_key == "big":
            return lazy_outputs(kernels.keyswitch(rows, self.ks_key, kp.ks_base_log,
                                                  kp.ks_level), degrees, cts)
        # dest small: KS, the compute key's drift choice where it has drift
        # zeros, the compute set's modulus switch (centered mean on the v1_4
        # sets), as ks_pbs_batch does, then the blind rotation with the
        # identity LUT and the extraction that land the value on the big
        # key, exact, on the unrounded key
        sk = self.server_key
        msed = srv.ks_ms_batch(rows, self.ks_key, cp.polynomial_size.bit_length(),
                               kp.ks_base_log, kp.ks_level,
                               cp.ms_noise_reduction == MsNoiseReduction.CENTERED_MEAN,
                               drift_zeros=sk.drift_zeros, drift_r_sigma=cp.drift_r_sigma,
                               drift_bound=cp.drift_ms_bound,
                               drift_input_variance=cp.drift_input_variance * (2.0 ** 64) ** 2)
        lut = torus.from_u64(sk.generate_lookup_table(lambda x: x).acc, self.device)
        out = srv.pbs_from_switched_batch(
            msed, lut.expand((len(cts),) + tuple(lut.shape)), sk.exact_bsk_ntt(), sk.dp,
            cp.pbs_base_log, cp.pbs_level)
        return lazy_outputs(out, degrees, cts)
