"""Extended radix ops: division, encrypted-amount shifts, rotates, bit
counts, ilog2, abs/signed helpers (port of tfhe_tpu/integer/ops_extended.py).

Mirrors integer/server_key/radix_parallel/{div_mod,shift,rotate,ilog2,
count_zeros_ones,abs}.rs algorithm choices, re-expressed as rounds of batched
LUT applications:
  - div/rem: schoolbook binary long division (div_mod.rs:307-317) where each
    iteration folds the compare into the borrow of one overflowing-sub.
  - encrypted shifts/rotates: barrel shifter over the amount's bits
    (shift.rs:363-517), log2(total_bits) cmux stages.
  - count_ones/zeros: per-block popcount LUT + carry-save sum.
  - leading/trailing zeros: prefix-AND zero scan + gated contributions.
"""

from __future__ import annotations

from .ciphertext import BooleanBlock, RadixCiphertext


class ExtendedOpsMixin:
    # ------------------------------------------------------------------
    # Overflowing sub (also yields a >= b)
    # ------------------------------------------------------------------

    def overflowing_sub_parallelized(self, a: RadixCiphertext, b: RadixCiphertext):
        """Returns (a - b mod msg^n, borrow: BooleanBlock true when a < b).

        The borrow-free state adds msg^n, so the top carry bit is exactly
        [a >= b]; borrow = NOT carry comes from the final-carry LUT.
        """
        a, b = self._cleaned(a), self._cleaned(b)
        s = self._sub_state_blocks(a, b)
        out, carry = self._propagate_carries(s, with_overflow=True)
        not_lut = self._lut("not_bit", lambda x: 1 - (x & 1))
        borrow = self._apply([carry.block], not_lut)[0]
        return RadixCiphertext(out), BooleanBlock(borrow)

    def _sub_and_ge(self, a: RadixCiphertext, b: RadixCiphertext):
        """(a - b, ge = [a >= b]) in one propagation."""
        s = self._sub_state_blocks(a, b)
        out, carry = self._propagate_carries(s, with_overflow=True)
        return RadixCiphertext(out), BooleanBlock(carry.block)

    # ------------------------------------------------------------------
    # Bit extraction helpers
    # ------------------------------------------------------------------

    def _msg_bits(self) -> int:
        return (self.msg - 1).bit_length()

    def extract_bits(self, a: RadixCiphertext) -> list:
        """All bits of `a` as blocks with value in {0,1}, LSB first.
        One batched PBS round."""
        a = self._cleaned(a)
        mb = self._msg_bits()
        blocks, luts = [], []
        for blk in a.blocks:
            for j in range(mb):
                blocks.append(blk)
                luts.append(self._lut(f"bit_{j}", lambda x, j=j: (x >> j) & 1))
        return self._apply(blocks, luts)

    def _bits_to_radix(self, bits: list, num_blocks: int) -> RadixCiphertext:
        """Pack bit blocks (LSB first) into radix blocks, linear only."""
        mb = self._msg_bits()
        out = []
        for i in range(num_blocks):
            acc = None
            for j in range(mb):
                idx = i * mb + j
                if idx >= len(bits):
                    break
                term = bits[idx] if j == 0 else self.key.unchecked_scalar_mul(bits[idx], 1 << j)
                acc = term if acc is None else self.key.unchecked_add(acc, term)
            out.append(acc if acc is not None else self.key.create_trivial(0))
        return RadixCiphertext(out)

    # ------------------------------------------------------------------
    # Division (schoolbook binary long division)
    # ------------------------------------------------------------------

    def div_rem_parallelized(self, a: RadixCiphertext, d: RadixCiphertext):
        """(quotient, remainder); signed operands use the |.|-then-fix-signs
        circuit (div_mod.rs:699).  Division by an encrypted zero returns an
        all-ones quotient (reference convention)."""
        if self._is_signed(a) or self._is_signed(d):
            return self._signed_div_rem(a, d)
        a, d = self._cleaned(a), self._cleaned(d)
        n = a.num_blocks
        bits = self.extract_bits(a)  # LSB first
        r = self.create_trivial_radix(0, n)
        q_bits = [None] * len(bits)
        for i in range(len(bits) - 1, -1, -1):
            r = self.scalar_left_shift_parallelized(r, 1)
            # insert numerator bit at the LSB (true value stays < msg)
            blk0 = self.key.unchecked_add(r.blocks[0], bits[i])
            blk0.degree = min(blk0.degree, self.msg - 1)
            r = RadixCiphertext([blk0] + r.blocks[1:])
            diff, ge = self._sub_and_ge(r, d)
            r = self.if_then_else_parallelized(ge, diff, r)
            r = RadixCiphertext(self._propagate_carries(
                [b for b in r.blocks])) if not self._is_clean(r) else r
            q_bits[i] = ge.block
        q = self._bits_to_radix(q_bits, n)
        return q, r

    def div_parallelized(self, a, d):
        return self.div_rem_parallelized(a, d)[0]

    def rem_parallelized(self, a, d):
        return self.div_rem_parallelized(a, d)[1]

    # ------------------------------------------------------------------
    # Encrypted-amount shifts / rotates (barrel shifter)
    # ------------------------------------------------------------------

    def _barrel(self, a: RadixCiphertext, amount: RadixCiphertext, op) -> RadixCiphertext:
        total_bits = a.num_blocks * self._msg_bits()
        stages = (total_bits - 1).bit_length()
        amount_bits = self.extract_bits(amount)[:stages]
        out = self._cleaned(a)
        for j, bit in enumerate(amount_bits):
            shifted = op(out, 1 << j)
            out = self.if_then_else_parallelized(BooleanBlock(bit), shifted, out)
        return out

    def left_shift_parallelized(self, a, amount):
        return self._barrel(a, amount, self.scalar_left_shift_parallelized)

    def right_shift_parallelized(self, a, amount):
        return self._barrel(a, amount, self.scalar_right_shift_parallelized)

    def rotate_left_parallelized(self, a, amount):
        return self._barrel(a, amount, self.scalar_rotate_left_parallelized)

    def rotate_right_parallelized(self, a, amount):
        return self._barrel(a, amount, self.scalar_rotate_right_parallelized)

    def scalar_rotate_left_parallelized(self, a: RadixCiphertext, r: int) -> RadixCiphertext:
        total_bits = a.num_blocks * self._msg_bits()
        r %= total_bits
        if r == 0:
            return self._cleaned(a)
        hi = self.scalar_left_shift_parallelized(a, r)
        lo = self.scalar_right_shift_parallelized(a, total_bits - r)
        return self.bitor_parallelized(hi, lo)

    def scalar_rotate_right_parallelized(self, a: RadixCiphertext, r: int) -> RadixCiphertext:
        total_bits = a.num_blocks * self._msg_bits()
        r %= total_bits
        if r == 0:
            return self._cleaned(a)
        lo = self.scalar_right_shift_parallelized(a, r)
        hi = self.scalar_left_shift_parallelized(a, total_bits - r)
        return self.bitor_parallelized(hi, lo)

    # ------------------------------------------------------------------
    # Bit counts / ilog2
    # ------------------------------------------------------------------

    def count_ones_parallelized(self, a: RadixCiphertext) -> RadixCiphertext:
        a = self._cleaned(a)
        pop = self._lut("popcount", lambda x: bin(x % self.msg).count("1"))
        counts = self._apply(a.blocks, pop)
        rows = [RadixCiphertext([c] + [self.key.create_trivial(0)] * (a.num_blocks - 1))
                for c in counts]
        return self.sum_ciphertexts(rows, a.num_blocks)

    def count_zeros_parallelized(self, a: RadixCiphertext) -> RadixCiphertext:
        a = self._cleaned(a)
        czero = self._lut("popzero",
                          lambda x: self._msg_bits() - bin(x % self.msg).count("1"))
        counts = self._apply(a.blocks, czero)
        rows = [RadixCiphertext([c] + [self.key.create_trivial(0)] * (a.num_blocks - 1))
                for c in counts]
        return self.sum_ciphertexts(rows, a.num_blocks)

    def _zero_scan_contributions(self, blocks: list, per_block_count_lut,
                                 from_top: bool) -> RadixCiphertext:
        """Sum of per-block zero-run contributions gated by a prefix
        all-zero flag (used by leading/trailing_zeros)."""
        n = len(blocks)
        is_zero = self._apply(blocks, self._lut("is_zero", lambda x: int(x % self.msg == 0)))
        counts = self._apply(blocks, per_block_count_lut)
        order = list(range(n - 1, -1, -1)) if from_top else list(range(n))
        # prefix-AND scan of is_zero in scan order (Hillis-Steele)
        flags = [is_zero[i] for i in order]
        and_lut = self._biv_lut("bool_and", lambda x, y: x & y & 1)
        pref = list(flags)
        shift = 1
        while shift < n:
            packed = [self._pack(pref[i], pref[i - shift]) for i in range(shift, n)]
            combined = self._apply(packed, and_lut)
            pref = pref[:shift] + combined
            shift *= 2
        # gate: contribution of scan position t counts iff all earlier
        # positions are zero (prefix up to t-1); position 0 always counts.
        gate = self._biv_lut("gate_count", lambda f, c: c if (f & 1) else 0)
        gated = [counts[order[0]]]
        packed = [self._pack(pref[t - 1], counts[order[t]]) for t in range(1, n)]
        gated += self._apply(packed, gate)
        rows = [RadixCiphertext([g] + [self.key.create_trivial(0)] * (n - 1))
                for g in gated]
        return self.sum_ciphertexts(rows, n)

    def leading_zeros_parallelized(self, a: RadixCiphertext) -> RadixCiphertext:
        a = self._cleaned(a)
        mb = self._msg_bits()
        lut = self._lut("block_lz",
                        lambda x: mb - (x % self.msg).bit_length())
        return self._zero_scan_contributions(a.blocks, lut, from_top=True)

    def trailing_zeros_parallelized(self, a: RadixCiphertext) -> RadixCiphertext:
        a = self._cleaned(a)
        mb = self._msg_bits()

        def tz(x):
            v = x % self.msg
            if v == 0:
                return mb
            return (v & -v).bit_length() - 1

        return self._zero_scan_contributions(a.blocks, self._lut("block_tz", tz),
                                             from_top=False)

    def ilog2_parallelized(self, a: RadixCiphertext) -> RadixCiphertext:
        """floor(log2(a)); result for a = 0 is implementation-defined (as in
        the reference, which pairs it with checked flags)."""
        total_bits = a.num_blocks * self._msg_bits()
        lz = self.leading_zeros_parallelized(a)
        const = self.create_trivial_radix(total_bits - 1, a.num_blocks)
        return self.sub_parallelized(const, lz)

    # ------------------------------------------------------------------
    # Scalar comparisons / bitwise (univariate LUTs — cheaper than packing)
    # ------------------------------------------------------------------

    def _scalar_digits(self, scalar: int, num_blocks: int) -> list:
        msg = self.msg
        scalar %= msg ** num_blocks
        return [(scalar // msg ** i) % msg for i in range(num_blocks)]

    def scalar_eq_parallelized(self, a: RadixCiphertext, scalar: int) -> BooleanBlock:
        a = self._cleaned(a)
        digs = self._scalar_digits(scalar, a.num_blocks)
        luts = [self._lut(f"eq_s{d}", lambda x, d=d: int(x % self.msg == d)) for d in digs]
        eqs = self._apply(a.blocks, luts)
        and_lut = self._biv_lut("bool_and", lambda x, y: x & y & 1)
        return BooleanBlock(self._tree_reduce(eqs, and_lut))

    def scalar_ne_parallelized(self, a: RadixCiphertext, scalar: int) -> BooleanBlock:
        a = self._cleaned(a)
        digs = self._scalar_digits(scalar, a.num_blocks)
        luts = [self._lut(f"ne_s{d}", lambda x, d=d: int(x % self.msg != d)) for d in digs]
        nes = self._apply(a.blocks, luts)
        or_lut = self._biv_lut("bool_or", lambda x, y: (x | y) & 1)
        return BooleanBlock(self._tree_reduce(nes, or_lut))

    def _scalar_cmp_state(self, a: RadixCiphertext, scalar: int):
        signed = self._is_signed(a)
        a = self._cleaned(a)
        digs = self._scalar_digits(scalar, a.num_blocks)
        luts = [
            self._lut(f"cmp_s{d}",
                      lambda x, d=d: 0 if x % self.msg < d else (1 if x % self.msg == d else 2))
            for d in digs
        ]
        if signed:
            h = self.msg // 2
            dt = digs[-1]
            luts[-1] = self._lut(
                f"cmp_s{dt}_signed_top",
                lambda x, d=dt: 0 if ((x % self.msg) ^ h) < (d ^ h)
                else (1 if (x % self.msg) == d else 2))
        states = self._apply(a.blocks, luts)[::-1]  # MSB first
        comb = self._biv_lut("cmp_combine", lambda hi, lo: lo if hi == 1 else hi)
        return self._tree_reduce(states, comb)

    def scalar_lt_parallelized(self, a, scalar) -> BooleanBlock:
        st = self._scalar_cmp_state(a, scalar)
        return BooleanBlock(self._apply([st], self._lut("is_lt", lambda x: int(x == 0)))[0])

    def scalar_le_parallelized(self, a, scalar) -> BooleanBlock:
        st = self._scalar_cmp_state(a, scalar)
        return BooleanBlock(self._apply([st], self._lut("is_le", lambda x: int(x != 2)))[0])

    def scalar_gt_parallelized(self, a, scalar) -> BooleanBlock:
        st = self._scalar_cmp_state(a, scalar)
        return BooleanBlock(self._apply([st], self._lut("is_gt", lambda x: int(x == 2)))[0])

    def scalar_ge_parallelized(self, a, scalar) -> BooleanBlock:
        st = self._scalar_cmp_state(a, scalar)
        return BooleanBlock(self._apply([st], self._lut("is_ge", lambda x: int(x != 0)))[0])

    def scalar_bitand_parallelized(self, a: RadixCiphertext, scalar: int) -> RadixCiphertext:
        a = self._cleaned(a)
        digs = self._scalar_digits(scalar, a.num_blocks)
        luts = [self._lut(f"and_s{d}", lambda x, d=d: (x % self.msg) & d) for d in digs]
        return RadixCiphertext(self._apply(a.blocks, luts))

    def scalar_bitor_parallelized(self, a: RadixCiphertext, scalar: int) -> RadixCiphertext:
        a = self._cleaned(a)
        digs = self._scalar_digits(scalar, a.num_blocks)
        luts = [self._lut(f"or_s{d}", lambda x, d=d: (x % self.msg) | d) for d in digs]
        return RadixCiphertext(self._apply(a.blocks, luts))

    def scalar_bitxor_parallelized(self, a: RadixCiphertext, scalar: int) -> RadixCiphertext:
        a = self._cleaned(a)
        digs = self._scalar_digits(scalar, a.num_blocks)
        luts = [self._lut(f"xor_s{d}", lambda x, d=d: (x % self.msg) ^ d) for d in digs]
        return RadixCiphertext(self._apply(a.blocks, luts))

    # ------------------------------------------------------------------
    # Boolean-block algebra helpers (for circuits above: strings, kv store)
    # ------------------------------------------------------------------

    def boolean_and(self, a: BooleanBlock, b: BooleanBlock) -> BooleanBlock:
        lut = self._biv_lut("bool_and", lambda x, y: x & y & 1)
        return BooleanBlock(self._apply([self._pack(a.block, b.block)], lut)[0])

    def boolean_or(self, a: BooleanBlock, b: BooleanBlock) -> BooleanBlock:
        lut = self._biv_lut("bool_or", lambda x, y: (x | y) & 1)
        return BooleanBlock(self._apply([self._pack(a.block, b.block)], lut)[0])

    def boolean_xor(self, a: BooleanBlock, b: BooleanBlock) -> BooleanBlock:
        lut = self._biv_lut("bool_xor", lambda x, y: (x ^ y) & 1)
        return BooleanBlock(self._apply([self._pack(a.block, b.block)], lut)[0])

    def boolean_not(self, a: BooleanBlock) -> BooleanBlock:
        lut = self._lut("not_bit", lambda x: 1 - (x & 1))
        return BooleanBlock(self._apply([a.block], lut)[0])

    def boolean_and_many(self, bools: list) -> BooleanBlock:
        and_lut = self._biv_lut("bool_and", lambda x, y: x & y & 1)
        return BooleanBlock(self._tree_reduce([b.block for b in bools], and_lut))

    def boolean_or_many(self, bools: list) -> BooleanBlock:
        or_lut = self._biv_lut("bool_or", lambda x, y: (x | y) & 1)
        return BooleanBlock(self._tree_reduce([b.block for b in bools], or_lut))

    # ------------------------------------------------------------------
    # Signed helpers
    # ------------------------------------------------------------------

    def _sign_bit(self, a: RadixCiphertext) -> BooleanBlock:
        a = self._cleaned(a)
        mb = self._msg_bits()
        lut = self._lut("top_bit", lambda x: (x >> (mb - 1)) & 1)
        return BooleanBlock(self._apply([a.blocks[-1]], lut)[0])

    def abs_parallelized(self, a: RadixCiphertext) -> RadixCiphertext:
        """Two's-complement absolute value."""
        neg = self.neg_parallelized(a)
        return self.if_then_else_parallelized(self._sign_bit(a), neg, a)

    def is_even_parallelized(self, a: RadixCiphertext) -> BooleanBlock:
        a = self._cleaned(a)
        lut = self._lut("is_even", lambda x: 1 - (x & 1))
        return BooleanBlock(self._apply([a.blocks[0]], lut)[0])

    def is_odd_parallelized(self, a: RadixCiphertext) -> BooleanBlock:
        a = self._cleaned(a)
        lut = self._lut("is_odd", lambda x: x & 1)
        return BooleanBlock(self._apply([a.blocks[0]], lut)[0])

    # ------------------------------------------------------------------
    # reverse_bits / slice (radix_parallel/{reverse_bits,slice}.rs)
    # ------------------------------------------------------------------

    def reverse_bits_parallelized(self, a: RadixCiphertext) -> RadixCiphertext:
        """Bit-reverse the whole integer: reverse the block order and
        bit-reverse within each block (one batched LUT round)."""
        a = self._cleaned(a)
        mb = self._msg_bits()
        msg = self.msg

        def rev(x):
            v = x % msg
            out = 0
            for j in range(mb):
                out |= ((v >> j) & 1) << (mb - 1 - j)
            return out

        lut = self._lut("bit_reverse", rev)
        blocks = self._apply(list(reversed(a.blocks)), lut)
        return self._like(a, blocks)

    def scalar_bitslice_parallelized(self, a: RadixCiphertext, start: int,
                                     end: int) -> RadixCiphertext:
        """Bits [start, end) of `a`, right-aligned (slice.rs scalar range)."""
        total_bits = a.num_blocks * self._msg_bits()
        end = min(end, total_bits)
        width = max(end - start, 0)
        shifted = self.scalar_right_shift_parallelized(
            RadixCiphertext([b.copy() for b in self._cleaned(a).blocks]), start)
        mask = (1 << width) - 1
        return self._like(a, self.scalar_bitand_parallelized(shifted, mask).blocks)

    # ------------------------------------------------------------------
    # dot product / vector comparisons / vector find
    # (radix_parallel/{dot_prod,vector_comparisons,vector_find}.rs)
    # ------------------------------------------------------------------

    def boolean_dot_prod_parallelized(self, bools: list, clears: list,
                                      num_blocks: int) -> RadixCiphertext:
        """sum_i bool_i * clear_i (boolean-vector x clear-vector dot product):
        one gated-LUT round per element, carry-save summed."""
        assert len(bools) == len(clears)
        msg = self.msg
        rows = []
        for b, c in zip(bools, clears):
            digs = self._scalar_digits(int(c), num_blocks)
            blocks, luts = [], []
            for d in digs:
                blocks.append(b.block)
                luts.append(self._lut(f"gate_mul_{d}",
                                      lambda x, d=d: d if (x & 1) else 0))
            rows.append(RadixCiphertext(self._apply(blocks, luts)))
        if not rows:
            return self.create_trivial_radix(0, num_blocks)
        return self.sum_ciphertexts(rows, num_blocks)

    def all_eq_slices_parallelized(self, lhs: list, rhs: list) -> BooleanBlock:
        """Vector equality: AND over elementwise eq (vector_comparisons.rs)."""
        if len(lhs) != len(rhs):
            return BooleanBlock(self.key.create_trivial(0))
        eqs = [self.eq_parallelized(a, b) for a, b in zip(lhs, rhs)]
        if not eqs:
            return BooleanBlock(self.key.create_trivial(1))
        return self.boolean_and_many(eqs)

    def contains_parallelized(self, haystack: list, needle: RadixCiphertext) -> BooleanBlock:
        """Any element equal to `needle` (vector_find.rs contains)."""
        if not haystack:
            return BooleanBlock(self.key.create_trivial(0))
        eqs = [self.eq_parallelized(h, needle) for h in haystack]
        return self.boolean_or_many(eqs)

    def index_of_parallelized(self, haystack: list, needle: RadixCiphertext):
        """(found, first index) of `needle` in `haystack` (vector_find.rs)."""
        nb = max(2, (max(len(haystack), 1).bit_length() + 1) // 2 + 1)
        if not haystack:
            return (BooleanBlock(self.key.create_trivial(0)),
                    self.create_trivial_radix(0, nb))
        eqs = [self.eq_parallelized(h, needle) for h in haystack]
        found = self.boolean_or_many(eqs)
        index = self.create_trivial_radix(0, nb)
        prefix = None
        for i, m in enumerate(eqs):
            gated = m if prefix is None else self.boolean_and(
                m, self.boolean_not(prefix))
            prefix = m if prefix is None else self.boolean_or(prefix, m)
            contrib = self.boolean_dot_prod_parallelized([gated], [i], nb)
            index = self.add_parallelized(index, contrib)
        return found, index

    def count_consecutive_bits_parallelized(self, a: RadixCiphertext,
                                            bit_value: int,
                                            from_msb: bool = True) -> RadixCiphertext:
        """Length of the run of `bit_value` bits from the MSB (or LSB) —
        count_consecutive_bits.rs; generalizes leading/trailing zeros."""
        work = self.bitnot(a) if bit_value == 1 else a
        return (self.leading_zeros_parallelized(work) if from_msb
                else self.trailing_zeros_parallelized(work))

    # ------------------------------------------------------------------
    # Bitonic network: sort / compare-exchange (radix_parallel/
    # bitonic_shuffle.rs family)
    # ------------------------------------------------------------------

    def _compare_exchange(self, a, b, ascending: bool):
        lt = self.lt_parallelized(a, b)
        lo = self.if_then_else_parallelized(lt, a, b)
        hi = self.if_then_else_parallelized(lt, b, a)
        return (lo, hi) if ascending else (hi, lo)

    def sort_parallelized(self, values: list, ascending: bool = True) -> list:
        """Bitonic sort of encrypted radix values: log^2(n) rounds, each
        round's n/2 oblivious compare-exchanges coalesced into ONE device
        batch through the round scheduler (integer/scheduler.py — the HPU
        batch-pipelining analog, SURVEY §2.13 P8)."""
        from . import scheduler as sched

        n0 = len(values)
        if n0 <= 1:
            return [v.copy() for v in values]
        n = 1 << (n0 - 1).bit_length()
        msg = self.msg
        maxv = msg ** values[0].num_blocks - 1
        pad = self.create_trivial_radix(maxv if ascending else 0,
                                        values[0].num_blocks)
        arr = [self._cleaned(v) for v in values] + [pad] * (n - n0)
        k = 2
        while k <= n:
            j = k // 2
            while j >= 1:
                idx, pairs, dirs = [], [], []
                for i in range(n):
                    partner = i ^ j
                    if partner > i:
                        idx.append((i, partner))
                        pairs.append((arr[i], arr[partner]))
                        dirs.append(((i & k) == 0) == ascending)
                for (i, partner), (lo, hi) in zip(
                        idx, sched.compare_exchange_many(self, pairs, dirs)):
                    arr[i], arr[partner] = lo, hi
                j //= 2
            k *= 2
        return arr[:n0]

    def sort_kv_parallelized(self, keys: list, values: list,
                             ascending: bool = True) -> tuple:
        """Bitonic sort of (key, value) pairs by encrypted key, payloads
        carried through the same coalesced oblivious selects."""
        from . import scheduler as sched

        n0 = len(keys)
        assert len(values) == n0
        if n0 <= 1:
            return [k.copy() for k in keys], [v.copy() for v in values]
        n = 1 << (n0 - 1).bit_length()
        maxk = self.msg ** keys[0].num_blocks - 1
        padk = self.create_trivial_radix(maxk if ascending else 0,
                                         keys[0].num_blocks)
        padv = self.create_trivial_radix(0, values[0].num_blocks)
        arr = list(zip((self._cleaned(k) for k in keys),
                       (self._cleaned(v) for v in values)))
        arr += [(padk, padv)] * (n - n0)
        k = 2
        while k <= n:
            j = k // 2
            while j >= 1:
                idx, pairs, dirs = [], [], []
                for i in range(n):
                    partner = i ^ j
                    if partner > i:
                        idx.append((i, partner))
                        pairs.append((arr[i], arr[partner]))
                        dirs.append(((i & k) == 0) == ascending)
                for (i, partner), (lo, hi) in zip(
                        idx, sched.compare_exchange_kv_many(self, pairs, dirs)):
                    arr[i], arr[partner] = lo, hi
                j //= 2
            k *= 2
        return ([kk for kk, _ in arr[:n0]], [vv for _, vv in arr[:n0]])

    def bitonic_shuffle(self, oprf_sk, values: list, key_bits: int,
                        seed: int) -> list:
        """Uniform random permutation of encrypted values: OPRF-generated
        random sort keys pushed through the bitonic network
        (high_level_api/integers/shuffle.rs:24 bitonic_shuffle; key_bits
        trades key-collision probability against per-comparison cost)."""
        nb = -(-key_bits // (self.msg - 1).bit_length())
        keys = [oprf_sk.generate_oblivious_pseudo_random_unsigned_integer_bounded(
                    (seed << 20) | i, key_bits, nb, self)
                for i in range(len(values))]
        _, out = self.sort_kv_parallelized(keys, list(values))
        return out

    # ------------------------------------------------------------------
    # MatchValues: plaintext (input -> output) mapping applied obliviously
    # (radix_parallel/vector_find.rs:24 MatchValues, :169
    # match_value_parallelized, :258 match_value_or_parallelized)
    # ------------------------------------------------------------------

    def match_value_parallelized(self, a: RadixCiphertext,
                                 matches: list) -> tuple:
        """matches: [(clear_in, clear_out), ...] with DISTINCT inputs.
        Returns (result, matched): result = out_i where a == in_i (0 when
        no match), matched = BooleanBlock.  One eq flag per pair, then one
        boolean dot product — at most one flag is set, so the weighted sum
        is exact."""
        ins = [i for i, _ in matches]
        assert len(set(ins)) == len(ins), "match inputs must be distinct"
        outs = [o for _, o in matches]
        nb_out = max(1, -(-max(max(outs, default=0), 1).bit_length()
                          // (self.msg - 1).bit_length()))
        eqs = [self.scalar_eq_parallelized(a, i) for i in ins]
        result = self.boolean_dot_prod_parallelized(eqs, outs, nb_out)
        ind = self.boolean_dot_prod_parallelized(eqs, [1] * len(eqs), 1)
        matched = self.scalar_ne_parallelized(ind, 0)
        return result, matched

    def match_value_or_parallelized(self, a: RadixCiphertext, matches: list,
                                    default: int) -> RadixCiphertext:
        """match_value with a plaintext fallback for unmatched inputs; the
        result is wide enough for the default as well as every output."""
        result, matched = self.match_value_parallelized(a, matches)
        mb = (self.msg - 1).bit_length()
        nb = max(result.num_blocks,
                 -(-max(default, 1).bit_length() // mb))
        if result.num_blocks < nb:
            result = self.extend_radix_with_trivial_zero_blocks_msb(
                result, nb - result.num_blocks)
        dflt = self.create_trivial_radix(default, nb)
        return self.if_then_else_parallelized(matched, result, dflt)
