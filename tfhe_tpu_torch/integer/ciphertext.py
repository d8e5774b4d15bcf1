"""Radix integer ciphertexts: little-endian vectors of shortint blocks (port
of tfhe_tpu/integer/ciphertext.py).

Mirrors integer/ciphertext/base.rs:23 (RadixCiphertext / SignedRadixCiphertext
/ BooleanBlock).  Blocks are shortint Ciphertexts (each carrying degree /
noise metadata); ops in server_key.py gather whole rounds of block-PBS into
single batched device calls; a block's words may stay on the device
(shortint LazyLweData).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..shortint.ciphertext import Ciphertext


@dataclass
class RadixCiphertext:
    blocks: list  # list[Ciphertext], little-endian

    @property
    def num_blocks(self) -> int:
        return len(self.blocks)

    def copy(self) -> "RadixCiphertext":
        return RadixCiphertext([b.copy() for b in self.blocks])


@dataclass
class SignedRadixCiphertext:
    """Two's-complement signed radix integer (ciphertext/base.rs:261 family)."""

    blocks: list

    @property
    def num_blocks(self) -> int:
        return len(self.blocks)

    def copy(self) -> "SignedRadixCiphertext":
        return SignedRadixCiphertext([b.copy() for b in self.blocks])


@dataclass
class BooleanBlock:
    """A shortint block constrained to degree <= 1 (encrypted bool)."""

    block: Ciphertext

    def copy(self) -> "BooleanBlock":
        return BooleanBlock(self.block.copy())


@dataclass
class CompressedModulusSwitchedRadixCiphertext:
    """integer/ciphertext compressed_modulus_switched_ciphertext analog:
    per-block shortint CompressedModulusSwitchedCiphertext + signedness."""

    blocks: list
    signed: bool = False
