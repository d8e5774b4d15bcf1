"""Integer-level noise squashing (integer/noise_squashing/; port of
tfhe_tpu/integer/noise_squashing.py): squash every block of a radix
ciphertext in one batched PBS128 (K1, then K5 on the card), recompose at
decryption."""

from __future__ import annotations

from dataclasses import dataclass

from ..shortint.noise_squashing import (
    NoiseSquashingKey as ShortintNoiseSquashingKey,
    NoiseSquashingPrivateKey as ShortintNoiseSquashingPrivateKey,
    NoiseSquashingParams,
)
from .ciphertext import RadixCiphertext, SignedRadixCiphertext


@dataclass
class SquashedNoiseRadixCiphertext:
    blocks: list  # list[SquashedNoiseCiphertext]
    is_signed: bool = False


class NoiseSquashingPrivateKey:
    def __init__(self, params: NoiseSquashingParams, seed: int | None = None):
        self.key = ShortintNoiseSquashingPrivateKey(params, seed)

    def decrypt_radix(self, ct: SquashedNoiseRadixCiphertext) -> int:
        msg = ct.blocks[0].message_modulus
        out = 0
        for b in reversed(ct.blocks):
            out = out * msg + self.key.decrypt_squashed_noise_ciphertext(b) % msg
        if ct.is_signed:
            modulus = msg ** len(ct.blocks)
            if out >= modulus // 2:
                out -= modulus
        return out


class NoiseSquashingKey:
    def __init__(self, client_key, private_key: NoiseSquashingPrivateKey,
                 seed: int | None = None, device="cuda"):
        inner_ck = client_key.key if hasattr(client_key, "key") else client_key
        self.key = ShortintNoiseSquashingKey(inner_ck, private_key.key, seed, device=device)

    def squash_radix_ciphertext_noise(self, server_key, ct) -> SquashedNoiseRadixCiphertext:
        """One batched KS->PBS128 across all blocks (cleans carries first)."""
        ct = server_key._cleaned(ct)
        out = self.key.squash_ciphertext_noise_batch(ct.blocks, server_key.key)
        return SquashedNoiseRadixCiphertext(
            out, is_signed=isinstance(ct, SignedRadixCiphertext))
