"""FheString: encrypted ASCII strings as vectors of encrypted chars.

Port of tfhe_tpu/strings/ciphertext.py: the same calls in the same order over
the port's integer layer, so every block gives tfhe_tpu's words.

Mirrors strings/ciphertext.rs:30-32: each char is an FheUint8-like radix
ciphertext; nul-padding semantics (`padded` marks trailing encrypted nuls
whose count is hidden).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class FheString:
    chars: list  # list[RadixCiphertext], one per char (8 bits each)
    padded: bool = False

    @property
    def max_len(self) -> int:
        return len(self.chars)


def encrypt_string(client_key, s: str, padding: int = 0) -> FheString:
    """Encrypt an ASCII string, optionally with hidden-length nul padding."""
    blocks_per_char = 8 // (client_key.params.message_modulus - 1).bit_length()
    chars = [client_key.encrypt_radix(ord(c), blocks_per_char) for c in s]
    for _ in range(padding):
        chars.append(client_key.encrypt_radix(0, blocks_per_char))
    return FheString(chars, padded=padding > 0)


def decrypt_string(client_key, ct: FheString) -> str:
    out = []
    for c in ct.chars:
        v = client_key.decrypt_radix(c)
        if v == 0 and ct.padded:
            break
        out.append(chr(v))
    return "".join(out)
