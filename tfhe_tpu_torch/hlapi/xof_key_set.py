"""XofKeySet: the entire key set derived from one master XOF seed.

Port of tfhe_tpu/hlapi/xof_key_set.py.  Mirrors
high_level_api/xof_key_set/mod.rs:104: a client generates every key
(secret keys, server key material, optional compact public key) from a
single 128-bit seed expanded through an XOF (SHAKE-256 here,
domain-separated per key), so a deployment ships one seed-sized secret plus
seeded public material instead of gigabytes of keys.
"""

from __future__ import annotations

import hashlib

from .config import Config
from .keys import ClientKey, CompressedServerKey, ServerKey


def _derive(master_seed: int, tag: bytes) -> int:
    h = hashlib.shake_256(b"TFHE_Xof" + master_seed.to_bytes(16, "little") + tag)
    return int.from_bytes(h.digest(16), "little")


class XofKeySet:
    """Expanded key set: client + server (+ compact public) keys."""

    def __init__(self, client_key: ClientKey, server_key: ServerKey,
                 compact_public_key=None):
        self.client_key = client_key
        self.server_key = server_key
        self.compact_public_key = compact_public_key


class CompressedXofKeySet:
    """One master seed + config; everything re-derives deterministically."""

    def __init__(self, config: Config, master_seed: int):
        self.config = config
        self.master_seed = master_seed

    def expand(self, device="cuda") -> XofKeySet:
        ck = ClientKey(self.config, _derive(self.master_seed, b"client"))
        csk = CompressedServerKey(ck, _derive(self.master_seed, b"server"))
        sk = csk.decompress(device=device)
        if ck.noise_squashing_private_key is not None:
            from ..integer.noise_squashing import NoiseSquashingKey

            sk.noise_squashing_key = NoiseSquashingKey(
                ck.integer_key, ck.noise_squashing_private_key,
                _derive(self.master_seed, b"squash"), device=device)
        cpk = None
        if self.config.enable_compact_public_key:
            from .compact_list import CompactPublicKey

            cpk = CompactPublicKey(ck, _derive(self.master_seed, b"cpk"))
        return XofKeySet(ck, sk, cpk)
