"""Signed (two's-complement) radix operations (port of
tfhe_tpu/integer/signed_ops.py).

Mirrors the SignedRadixCiphertext op families of
integer/server_key/radix_parallel/ (tests_signed/, div_mod.rs:699
signed_unchecked_div_rem_parallelized, shift.rs arithmetic shifts,
sub.rs signed overflow detection, cast.rs sign extension).

Linear two's-complement ops (add/sub/neg/mul-low/bitwise) are identical to
the unsigned circuits and flow through ServerKey with type preservation; this
mixin holds everything where signedness changes the math:
  - order comparisons (sign-bit flip on the most significant block),
  - arithmetic right shift (sign fill),
  - signed division/remainder (|.| -> unsigned div -> conditional negate),
  - signed overflow detection for add/sub,
  - casts (sign extension / truncation / reinterpretation).
"""

from __future__ import annotations

from .ciphertext import BooleanBlock, RadixCiphertext, SignedRadixCiphertext


class SignedOpsMixin:
    # ------------------------------------------------------------------
    # Comparison state with sign handling
    # ------------------------------------------------------------------

    def _cmp_state_luts(self, n: int, signed: bool) -> list:
        """Per-block-pair compare-state LUTs, MSB pair last.

        Two's-complement order == unsigned order with the top bit of the most
        significant block flipped (comparator.rs signed handling).
        """
        st = self._biv_lut(
            "cmp_state", lambda x, y: 0 if x < y else (1 if x == y else 2)
        )
        if not signed:
            return [st] * n
        h = self.msg // 2
        st_top = self._biv_lut(
            "cmp_state_signed_top",
            lambda x, y: 0 if (x ^ h) < (y ^ h) else (1 if x == y else 2),
        )
        return [st] * (n - 1) + [st_top]

    # ------------------------------------------------------------------
    # Arithmetic right shift
    # ------------------------------------------------------------------

    def _sign_fill_block(self, a):
        """Block valued (msg-1) when a < 0 else 0 — the fill for sign
        extension (one PBS on the top block)."""
        mb = self._msg_bits()
        lut = self._lut(
            "sign_fill", lambda x: (self.msg - 1) if ((x >> (mb - 1)) & 1) else 0
        )
        return self._apply([a.blocks[-1]], lut)[0]

    def _scalar_right_shift_arithmetic(self, a: SignedRadixCiphertext,
                                       shift: int) -> SignedRadixCiphertext:
        """Shift right filling with the sign bit (shift.rs signed variant)."""
        a = self._cleaned(a)
        mb = self._msg_bits()
        n = a.num_blocks
        block_shift, bit_shift = divmod(shift, mb)
        fill = self._sign_fill_block(a)
        blocks = [b.copy() for b in a.blocks[block_shift:]]
        blocks += [fill.copy() for _ in range(n - len(blocks))]
        if bit_shift == 0:
            return SignedRadixCiphertext(blocks)
        msg = self.msg
        lut = self._biv_lut(
            f"rshift_{bit_shift}",
            lambda nxt, cur: ((cur >> bit_shift) | ((nxt << (mb - bit_shift)) % msg)) % msg,
        )
        packed = []
        for i in range(n):
            nxt = blocks[i + 1] if i + 1 < n else fill
            packed.append(self._pack(nxt, blocks[i]))
        return SignedRadixCiphertext(self._apply(packed, lut))

    # ------------------------------------------------------------------
    # Signed division / remainder (div_mod.rs:699)
    # ------------------------------------------------------------------

    def _signed_div_rem(self, a: SignedRadixCiphertext, b: SignedRadixCiphertext):
        a, b = self._cleaned(a), self._cleaned(b)
        mb = self._msg_bits()
        pos_a = RadixCiphertext(self.abs_parallelized(a).blocks)
        pos_b = RadixCiphertext(self.abs_parallelized(b).blocks)
        q_u, r_u = self.div_rem_parallelized(pos_a, pos_b)
        # quotient sign: numerator/divisor top-bit disagreement
        signs_differ_lut = self._biv_lut(
            "sign_bits_differ",
            lambda x, y: int(((x >> (mb - 1)) & 1) != ((y >> (mb - 1)) & 1)),
        )
        signs_differ = BooleanBlock(self._apply(
            [self._pack(a.blocks[-1], b.blocks[-1])], signs_differ_lut)[0])
        q = self.if_then_else_parallelized(
            signs_differ, self.neg_parallelized(q_u), q_u)
        # remainder takes the numerator's sign
        r = self.if_then_else_parallelized(
            self._sign_bit(a), self.neg_parallelized(r_u), r_u)
        return (SignedRadixCiphertext(q.blocks), SignedRadixCiphertext(r.blocks))

    # ------------------------------------------------------------------
    # Signed overflowing add / sub (tests_signed overflow semantics)
    # ------------------------------------------------------------------

    def signed_overflowing_add_parallelized(self, a, b):
        """(a + b mod 2^T, overflow) — overflow iff operands share a sign the
        result does not."""
        a, b = self._cleaned(a), self._cleaned(b)
        s = [self.key.unchecked_add(x, y) for x, y in zip(a.blocks, b.blocks)]
        out = self._propagate_carries(s)
        res = SignedRadixCiphertext(out)
        return res, self._signed_add_overflow_flag(a, b, res, sub=False)

    def signed_overflowing_sub_parallelized(self, a, b):
        a, b = self._cleaned(a), self._cleaned(b)
        out = self._propagate_carries(self._sub_state_blocks(a, b))
        res = SignedRadixCiphertext(out)
        return res, self._signed_add_overflow_flag(a, b, res, sub=True)

    def _signed_add_overflow_flag(self, a, b, res, sub: bool) -> BooleanBlock:
        """overflow = (sa == sb') && (sr != sa), with sb' = !sb for sub."""
        mb = self._msg_bits()

        def sign(x):
            return (x >> (mb - 1)) & 1

        ab_lut = self._biv_lut(
            "ovf_ab_sub" if sub else "ovf_ab_add",
            lambda x, y: 2 * sign(x) + int(sign(x) == (1 - sign(y) if sub else sign(y))),
        )
        ab = self._apply([self._pack(a.blocks[-1], b.blocks[-1])], ab_lut)[0]
        fin_lut = self._biv_lut(
            "ovf_fin",
            lambda st, r: int((st & 1) == 1 and ((st >> 1) & 1) != sign(r)),
        )
        return BooleanBlock(self._apply([self._pack(ab, res.blocks[-1])], fin_lut)[0])

    # ------------------------------------------------------------------
    # Casts (cast.rs)
    # ------------------------------------------------------------------

    def cast_to_unsigned(self, a, num_blocks: int) -> RadixCiphertext:
        """Reinterpret + resize (sign-extends when growing a signed value)."""
        if isinstance(a, SignedRadixCiphertext) and num_blocks > a.num_blocks:
            a = self.extend_radix_with_sign_msb(a, num_blocks - a.num_blocks)
        blocks = [b.copy() for b in self._cleaned(a).blocks[:num_blocks]]
        blocks += [self.key.create_trivial(0)
                   for _ in range(num_blocks - len(blocks))]
        return RadixCiphertext(blocks)

    def cast_to_signed(self, a, num_blocks: int) -> SignedRadixCiphertext:
        if isinstance(a, SignedRadixCiphertext) and num_blocks > a.num_blocks:
            a = self.extend_radix_with_sign_msb(a, num_blocks - a.num_blocks)
        blocks = [b.copy() for b in self._cleaned(a).blocks[:num_blocks]]
        blocks += [self.key.create_trivial(0)
                   for _ in range(num_blocks - len(blocks))]
        return SignedRadixCiphertext(blocks)

    def extend_radix_with_trivial_zero_blocks_msb(self, a, num: int):
        return self._like(a, [b.copy() for b in a.blocks]
                          + [self.key.create_trivial(0) for _ in range(num)])

    def extend_radix_with_trivial_zero_blocks_lsb(self, a, num: int):
        return self._like(a, [self.key.create_trivial(0) for _ in range(num)]
                          + [b.copy() for b in a.blocks])

    def extend_radix_with_sign_msb(self, a: SignedRadixCiphertext, num: int):
        """Sign extension: append `num` copies of the sign-fill block."""
        a = self._cleaned(a)
        fill = self._sign_fill_block(a)
        return SignedRadixCiphertext(
            [b.copy() for b in a.blocks] + [fill.copy() for _ in range(num)])

    def trim_radix_blocks_msb(self, a, num: int):
        return self._like(a, [b.copy() for b in a.blocks[: a.num_blocks - num]])

    def trim_radix_blocks_lsb(self, a, num: int):
        return self._like(a, [b.copy() for b in a.blocks[num:]])
