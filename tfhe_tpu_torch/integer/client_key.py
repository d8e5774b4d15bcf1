"""Integer client key: radix encode/decode over shortint blocks (port of
tfhe_tpu/integer/client_key.py; host numpy, the same ciphertexts from the
same seeds).

Mirrors integer/client_key/mod.rs:182 (encrypt_radix): value decomposed
little-endian in base message_modulus, one shortint encryption per block.
"""

from __future__ import annotations

from ..shortint.client_key import ClientKey as ShortintClientKey
from ..shortint.params import DEFAULT_PARAMS, ShortintParams
from .ciphertext import BooleanBlock, RadixCiphertext, SignedRadixCiphertext
from .crt import CrtClientMixin


class ClientKey(CrtClientMixin):
    def __init__(self, params: ShortintParams = DEFAULT_PARAMS, seed: int | None = None):
        self.key = ShortintClientKey(params, seed)
        self.params = params

    def encrypt_radix(self, value: int, num_blocks: int) -> RadixCiphertext:
        msg = self.params.message_modulus
        v = value % (msg ** num_blocks)
        blocks = []
        for _ in range(num_blocks):
            blocks.append(self.key.encrypt(v % msg))
            v //= msg
        return RadixCiphertext(blocks)

    def decrypt_radix(self, ct: RadixCiphertext) -> int:
        msg = self.params.message_modulus
        out = 0
        for b in reversed(ct.blocks):
            out = out * msg + self.key.decrypt(b)
        return out

    def encrypt_signed_radix(self, value: int, num_blocks: int) -> SignedRadixCiphertext:
        msg = self.params.message_modulus
        modulus = msg ** num_blocks
        return SignedRadixCiphertext(
            self.encrypt_radix(value % modulus, num_blocks).blocks
        )

    def decrypt_signed_radix(self, ct: SignedRadixCiphertext) -> int:
        msg = self.params.message_modulus
        modulus = msg ** ct.num_blocks
        v = self.decrypt_radix(RadixCiphertext(ct.blocks))
        return v - modulus if v >= modulus // 2 else v

    def encrypt_bool(self, value: bool) -> BooleanBlock:
        return BooleanBlock(self.key.encrypt(int(value)))

    def decrypt_bool(self, ct: BooleanBlock) -> bool:
        return bool(self.key.decrypt(ct.block))
