"""CRT-encoded integers: one shortint block per residue modulus (port of
tfhe_tpu/integer/crt.py).

Mirrors integer/ciphertext/base.rs:261 (BaseCrtCiphertext) and
integer/server_key/{crt,crt_parallel}/: a value m is encrypted as
(m mod b_1, ..., m mod b_k) for pairwise-coprime basis {b_i}, each residue in
its own shortint block (b_i <= message_modulus).  All residue channels are
independent, so every op is a single batched LUT round — the CRT layer is
the best case for a batch-first design (no carry chains at all).

Multiplication is single-round (blockwise bivariate), unlike radix's
schoolbook circuit; the tradeoff is no cheap comparisons/overflow detection.
"""

from __future__ import annotations

from dataclasses import dataclass
from math import gcd, prod


@dataclass
class CrtCiphertext:
    """integer/ciphertext/base.rs:261 BaseCrtCiphertext analog."""

    blocks: list  # list[shortint Ciphertext], one per modulus
    moduli: list  # list[int]

    def copy(self) -> "CrtCiphertext":
        return CrtCiphertext([b.copy() for b in self.blocks], list(self.moduli))


def crt_reconstruct(residues: list, moduli: list) -> int:
    """Garner-style CRT recombination."""
    total = prod(moduli)
    out = 0
    for r, m in zip(residues, moduli):
        n_i = total // m
        out += r * n_i * pow(n_i, -1, m)
    return out % total


class CrtClientMixin:
    """encrypt_crt / decrypt_crt on the integer ClientKey
    (integer/client_key/mod.rs encrypt_crt)."""

    def _check_basis(self, moduli: list) -> None:
        msg = self.params.message_modulus
        for i, m in enumerate(moduli):
            if m > msg:
                raise ValueError(f"CRT modulus {m} exceeds message modulus {msg}")
            for m2 in moduli[i + 1:]:
                if gcd(m, m2) != 1:
                    raise ValueError(f"CRT basis not coprime: {m}, {m2}")

    def encrypt_crt(self, value: int, moduli: list) -> CrtCiphertext:
        self._check_basis(moduli)
        value %= prod(moduli)
        return CrtCiphertext([self.key.encrypt(value % m) for m in moduli],
                             list(moduli))

    def decrypt_crt(self, ct: CrtCiphertext) -> int:
        residues = [self.key.decrypt(b) % m for b, m in zip(ct.blocks, ct.moduli)]
        return crt_reconstruct(residues, ct.moduli)


class CrtOpsMixin:
    """CRT op set on the integer ServerKey (server_key/crt_parallel/)."""

    def create_trivial_crt(self, value: int, moduli: list) -> CrtCiphertext:
        value %= prod(moduli)
        return CrtCiphertext([self.key.create_trivial(value % m) for m in moduli],
                             list(moduli))

    def _crt_reduce_luts(self, moduli: list) -> list:
        return [self._lut(f"crt_mod_{m}", lambda x, m=m: x % m) for m in moduli]

    def _crt_cleaned(self, ct: CrtCiphertext) -> CrtCiphertext:
        """Reduce every block below its modulus when any is dirty."""
        if all(b.degree < m for b, m in zip(ct.blocks, ct.moduli)):
            return ct
        out = self._apply(ct.blocks, self._crt_reduce_luts(ct.moduli))
        for b, m in zip(out, ct.moduli):
            b.degree = min(b.degree, m - 1)
        return CrtCiphertext(out, list(ct.moduli))

    def extract_message_crt(self, ct: CrtCiphertext) -> CrtCiphertext:
        out = self._apply(ct.blocks, self._crt_reduce_luts(ct.moduli))
        for b, m in zip(out, ct.moduli):
            b.degree = min(b.degree, m - 1)
        return CrtCiphertext(out, list(ct.moduli))

    # -- add / sub / neg ------------------------------------------------

    def unchecked_add_crt(self, a: CrtCiphertext, b: CrtCiphertext) -> CrtCiphertext:
        return CrtCiphertext(
            [self.key.unchecked_add(x, y) for x, y in zip(a.blocks, b.blocks)],
            list(a.moduli))

    def add_crt_parallelized(self, a: CrtCiphertext, b: CrtCiphertext) -> CrtCiphertext:
        a, b = self._crt_cleaned(a), self._crt_cleaned(b)
        return self.extract_message_crt(self.unchecked_add_crt(a, b))

    def sub_crt_parallelized(self, a: CrtCiphertext, b: CrtCiphertext) -> CrtCiphertext:
        """Per-block (x - y) mod b_i via one bivariate round."""
        a, b = self._crt_cleaned(a), self._crt_cleaned(b)
        packed = [self._pack(x, y) for x, y in zip(a.blocks, b.blocks)]
        luts = [self._biv_lut(f"crt_sub_{m}", lambda x, y, m=m: (x - y) % m)
                for m in a.moduli]
        out = self._apply(packed, luts)
        for blk, m in zip(out, a.moduli):
            blk.degree = min(blk.degree, m - 1)
        return CrtCiphertext(out, list(a.moduli))

    def neg_crt_parallelized(self, a: CrtCiphertext) -> CrtCiphertext:
        a = self._crt_cleaned(a)
        luts = [self._lut(f"crt_neg_{m}", lambda x, m=m: (-x) % m) for m in a.moduli]
        out = self._apply(a.blocks, luts)
        return CrtCiphertext(out, list(a.moduli))

    # -- mul -------------------------------------------------------------

    def mul_crt_parallelized(self, a: CrtCiphertext, b: CrtCiphertext) -> CrtCiphertext:
        """One bivariate round: (x * y) mod b_i per residue channel."""
        a, b = self._crt_cleaned(a), self._crt_cleaned(b)
        packed = [self._pack(x, y) for x, y in zip(a.blocks, b.blocks)]
        luts = [self._biv_lut(f"crt_mul_{m}", lambda x, y, m=m: (x * y) % m)
                for m in a.moduli]
        out = self._apply(packed, luts)
        for blk, m in zip(out, a.moduli):
            blk.degree = min(blk.degree, m - 1)
        return CrtCiphertext(out, list(a.moduli))

    # -- scalar ops -------------------------------------------------------

    def scalar_add_crt_parallelized(self, a: CrtCiphertext, scalar: int) -> CrtCiphertext:
        a = self._crt_cleaned(a)
        blocks = [self.key.unchecked_scalar_add(x, scalar % m)
                  for x, m in zip(a.blocks, a.moduli)]
        return self.extract_message_crt(CrtCiphertext(blocks, list(a.moduli)))

    def scalar_sub_crt_parallelized(self, a: CrtCiphertext, scalar: int) -> CrtCiphertext:
        total = prod(a.moduli)
        return self.scalar_add_crt_parallelized(a, (-scalar) % total)

    def scalar_mul_crt_parallelized(self, a: CrtCiphertext, scalar: int) -> CrtCiphertext:
        a = self._crt_cleaned(a)
        luts = [self._lut(f"crt_smul_{scalar % m}_{m}",
                          lambda x, m=m, s=scalar: (x * s) % m)
                for m in a.moduli]
        out = self._apply(a.blocks, luts)
        for blk, m in zip(out, a.moduli):
            blk.degree = min(blk.degree, m - 1)
        return CrtCiphertext(out, list(a.moduli))
