"""Ciphertext re-randomization: XOF-seeded zero encryptions added in place.

Port of tfhe_tpu/shortint/re_randomization.py (shortint/ciphertext/
re_randomization.rs:108-326): before releasing ciphertexts to a
threshold-decryption committee, the server adds a DETERMINISTIC
compact-public-key encryption of zero derived from a public seed and
domain-separation context via an XOF (SHAKE-256 here).  Determinism means
any party can re-derive and verify the re-randomization; freshness comes
from the seed.  The zero GLWE is a host negacyclic product (the same words
as tfhe_tpu); its slots are extracted in one batched call on the device and
added to the ciphertexts there.
"""

from __future__ import annotations

import hashlib

import numpy as np

from ..ops import server as srv
from ..ops import torus
from ..utils.device import resolve_device
from .ciphertext import Ciphertext
from .server_key import lazy_outputs, upload_batch

DOMAIN_SEP = b"TFHE_Rrd"  # re_randomization.rs domain separator analog


def _xof_seed(seed: bytes, context: bytes) -> int:
    h = hashlib.shake_256(DOMAIN_SEP + len(seed).to_bytes(8, "little") + seed
                          + context).digest(16)
    return int.from_bytes(h, "little")


class ReRandomizationKey:
    """Server-side re-randomization material: the compact public key's GLWE
    pair (a, b); zero encryptions are derived from it deterministically."""

    def __init__(self, compact_public_key):
        self.pk = compact_public_key
        self.params = compact_public_key.params

    def zero_lwes(self, count: int, seed128: int, device):
        """``count`` deterministic LWE zero-encryptions under the big key,
        (count, k N + 1) on ``device``: one compact-key GLWE of zero on the
        host, then slots 0 .. count-1 extracted in one batched call."""
        assert count <= self.params.polynomial_size
        glwe = self.pk.encrypt_glwe(np.zeros(self.params.polynomial_size, dtype=np.uint64),
                                    seed128)
        return srv.extract_slots(torus.from_u64(glwe, device), range(count))

    def re_randomize_batch(self, cts: list, seed: bytes, context: bytes = b"",
                           device="cuda") -> list:
        """ct_i + Enc_pk(0; XOF(seed, context, i)): deterministic given
        (seed, context); output noise grows by one fresh-encryption term.
        The sums are taken on ``device`` and stay there."""
        device = resolve_device(device)
        zeros = self.zero_lwes(len(cts), _xof_seed(seed, context), device)
        out = lazy_outputs(upload_batch([c.data for c in cts], device) + zeros,
                           [c.degree for c in cts], cts)
        for o, c in zip(out, cts):
            o.noise_level = c.noise_level + 1
        return out

    def re_randomize(self, ct: Ciphertext, seed: bytes, context: bytes = b"",
                     device="cuda") -> Ciphertext:
        return self.re_randomize_batch([ct], seed, context, device)[0]
