"""Integer (radix) server key: batched-PBS block circuits (port of
tfhe_tpu/integer/server_key.py).

Instead of fanning out per-block PBS, every round of block-PBS across the
whole integer (or several integers) is ONE batched device call (shortint
ServerKey.apply_lookup_table_batch: K1, then K2 or K3 on the card), as the
CUDA backend groups PBS (integer.cuh:945 execute_pbs_async).  The rounds,
their tables and their order are tfhe_tpu's, so every block gives its
words.  Round outputs stay on the device (shortint LazyLweData): the linear
algebra between rounds stays symbolic and the next round gathers it there.

Carry propagation uses a Hillis-Steele prefix scan over per-block
generate/propagate states (the parallel algorithm of radix_parallel/add.rs:
828,1046,1248,1452 re-expressed as log2(n) batched bivariate-LUT rounds).

Subtraction is borrow-free: d_0 = a_0 - b_0 + msg*Delta and
d_i = a_i - b_i + (msg-1)*Delta for i>=1 adds exactly msg^n (= 0 mod msg^n)
while keeping every block nonnegative, reducing to the adder's carry
propagation (the radix analog of shortint sub's correcting term,
server_key/sub.rs).
"""

from __future__ import annotations

import numpy as np

from ..shortint.ciphertext import Ciphertext
from ..shortint.server_key import LookupTable, ServerKey as ShortintServerKey
from .ciphertext import BooleanBlock, RadixCiphertext, SignedRadixCiphertext
from .crt import CrtOpsMixin
from .ops_extended import ExtendedOpsMixin
from .signed_ops import SignedOpsMixin


class ServerKey(ExtendedOpsMixin, SignedOpsMixin, CrtOpsMixin):
    def __init__(self, client_key, seed: int | None = None, device="cuda"):
        inner = client_key.key if hasattr(client_key, "key") else client_key
        self.key = ShortintServerKey(inner, seed, device=device)
        self.params = self.key.params
        self.msg = self.params.message_modulus
        # cached LUTs
        self._luts = {}

    @classmethod
    def from_shortint_key(cls, key: ShortintServerKey) -> "ServerKey":
        """Wrap a shortint server key (it keeps its device) with no second
        keygen, as tfhe_tpu/hlapi/keys.py:63-70 wraps a decompressed key."""
        obj = cls.__new__(cls)
        obj.key, obj.params = key, key.params
        obj.msg = key.params.message_modulus
        obj._luts = {}
        return obj

    # ------------------------------------------------------------------
    # Type preservation (RadixCiphertext vs SignedRadixCiphertext)
    # ------------------------------------------------------------------

    @staticmethod
    def _like(ref, blocks):
        return type(ref)(blocks)

    @staticmethod
    def _result_like(a, b, blocks):
        """Signedness wins: result is signed if either operand is signed."""
        cls = SignedRadixCiphertext if (
            isinstance(a, SignedRadixCiphertext) or isinstance(b, SignedRadixCiphertext)
        ) else RadixCiphertext
        return cls(blocks)

    @staticmethod
    def _is_signed(ct) -> bool:
        return isinstance(ct, SignedRadixCiphertext)

    # ------------------------------------------------------------------
    # modulus-switched compression (integer radix wrapper over shortint's)
    # ------------------------------------------------------------------

    def switch_modulus_and_compress(self, ct):
        """CompressedModulusSwitchedRadixCiphertext analog: per-block KS+MS
        packing at log2(2N) bits per coefficient; signedness is preserved."""
        from .ciphertext import CompressedModulusSwitchedRadixCiphertext

        return CompressedModulusSwitchedRadixCiphertext(
            [self.key.switch_modulus_and_compress(b) for b in ct.blocks],
            self._is_signed(ct))

    def decompress(self, compressed):
        """One batched blind rotation (message-extract LUT) over all blocks."""
        lut = self._lut("msg_extract", lambda x: x % self.msg)
        blocks = self.key.decompress_and_apply_lookup_table_batch(
            compressed.blocks, lut)
        cls = SignedRadixCiphertext if compressed.signed else RadixCiphertext
        return cls(blocks)

    # LUT cache by name: a table is built once and stays the same object, so
    # a round uploads each distinct table once (shortint _upload_luts keys
    # on the table's array), however many blocks share it
    def _lut(self, name, f) -> LookupTable:
        if name not in self._luts:
            self._luts[name] = self.key.generate_lookup_table(f)
        return self._luts[name]

    def _biv_lut(self, name, f) -> LookupTable:
        if name not in self._luts:
            self._luts[name] = self.key.generate_lookup_table_bivariate(f)
        return self._luts[name]

    # ------------------------------------------------------------------
    # Batched primitives
    # ------------------------------------------------------------------

    def _apply(self, blocks: list, luts) -> list:
        """One batched PBS round over a list of blocks."""
        if not blocks:
            return []
        return self.key.apply_lookup_table_batch(blocks, luts)

    def _pack(self, hi: Ciphertext, lo: Ciphertext) -> Ciphertext:
        """hi*msg + lo (linear) for bivariate LUT input."""
        return self.key.unchecked_add(self.key.unchecked_scalar_mul(hi, self.msg), lo)

    # ------------------------------------------------------------------
    # Trivial encryption
    # ------------------------------------------------------------------

    def create_trivial_radix(self, value: int, num_blocks: int) -> RadixCiphertext:
        msg = self.msg
        v = value % (msg ** num_blocks)
        blocks = []
        for _ in range(num_blocks):
            blocks.append(self.key.create_trivial(v % msg))
            v //= msg
        return RadixCiphertext(blocks)

    # ------------------------------------------------------------------
    # Carry propagation (parallel prefix)
    # ------------------------------------------------------------------

    def _propagate_carries(self, s_blocks: list, with_overflow: bool = False):
        """Input: blocks with values in [0, 2*msg-1] (degree tracked).

        Returns clean message blocks; optionally the final carry as a
        BooleanBlock.  log2(n)+3 batched PBS rounds.
        """
        n = len(s_blocks)
        msg = self.msg
        if n == 1:
            out = self._apply(s_blocks, self._lut("msg_extract", lambda x: x % msg))
            if with_overflow:
                carry = self._apply(s_blocks, self._lut("carry_bit", lambda x: (x // msg) & 1))
            return (out, BooleanBlock(carry[0])) if with_overflow else out

        # Round 1: per-block state e = 2*(s == msg-1) + (s >= msg)  (in {0,1,2})
        state_lut = self._lut(
            "gp_state", lambda x: (2 if x % (2 * msg) == msg - 1 else 0) + (1 if x % (2 * msg) >= msg else 0)
        )
        e = self._apply(s_blocks, state_lut)

        # Hillis-Steele inclusive scan with (g,p) composition:
        # combine(hi, lo): g = g_hi | (p_hi & g_lo); p = p_hi & p_lo
        def combine(hi, lo):
            g_hi, p_hi = hi & 1, hi >> 1
            g_lo, p_lo = lo & 1, lo >> 1
            return 2 * (p_hi & p_lo) + (g_hi | (p_hi & g_lo))

        comb_lut = self._biv_lut("gp_combine", combine)
        shift = 1
        while shift < n:
            packed = [self._pack(e[i], e[i - shift]) for i in range(shift, n)]
            combined = self._apply(packed, comb_lut)
            e = e[:shift] + combined
            shift *= 2

        # e[i] now holds the prefix state of blocks 0..i; carry into block i+1
        # is its g bit.  Resolve carries (1 round) then final extraction.
        carries = self._apply(e, self._lut("g_bit", lambda x: x & 1))
        out_in = [s_blocks[0]] + [
            self.key.unchecked_add(s_blocks[i], carries[i - 1]) for i in range(1, n)
        ]
        out = self._apply(out_in, self._lut("msg_extract", lambda x: x % msg))
        if with_overflow:
            return out, BooleanBlock(carries[-1])
        return out

    def full_propagate(self, ct: RadixCiphertext) -> RadixCiphertext:
        """Normalize arbitrary dirty blocks (degree <= max_degree) to clean.

        One (msg, carry) extraction round, a linear re-add, then carry
        propagation (radix/mod.rs:753 full_propagate, batch-first).
        """
        msg = self.msg
        blocks = ct.blocks
        n = len(blocks)
        if all(b.degree < msg for b in blocks):
            return ct
        msgs = self._apply(blocks, self._lut("msg_extract", lambda x: x % msg))
        carries = self._apply(blocks, self._lut("carry_extract", lambda x: x // msg))
        s = [msgs[0]] + [
            self.key.unchecked_add(msgs[i], carries[i - 1]) for i in range(1, n)
        ]
        return self._like(ct, self._propagate_carries(s))

    def _is_clean(self, ct: RadixCiphertext) -> bool:
        return all(b.degree < self.msg for b in ct.blocks)

    def _cleaned(self, ct: RadixCiphertext) -> RadixCiphertext:
        return ct if self._is_clean(ct) else self.full_propagate(ct)

    # ------------------------------------------------------------------
    # Add / Sub / Neg
    # ------------------------------------------------------------------

    def unchecked_add(self, a: RadixCiphertext, b: RadixCiphertext) -> RadixCiphertext:
        return self._result_like(
            a, b, [self.key.unchecked_add(x, y) for x, y in zip(a.blocks, b.blocks)]
        )

    def add_parallelized(self, a: RadixCiphertext, b: RadixCiphertext) -> RadixCiphertext:
        a, b = self._cleaned(a), self._cleaned(b)
        s = [self.key.unchecked_add(x, y) for x, y in zip(a.blocks, b.blocks)]
        return self._result_like(a, b, self._propagate_carries(s))

    def overflowing_add_parallelized(self, a, b):
        a, b = self._cleaned(a), self._cleaned(b)
        s = [self.key.unchecked_add(x, y) for x, y in zip(a.blocks, b.blocks)]
        out, carry = self._propagate_carries(s, with_overflow=True)
        return self._result_like(a, b, out), carry

    def _sub_state_blocks(self, a: RadixCiphertext, b: RadixCiphertext) -> list:
        """Borrow-free subtraction pre-state: values in [0, 2*msg-1]."""
        msg = self.msg
        p = self.params
        out = []
        for i, (x, y) in enumerate(zip(a.blocks, b.blocks)):
            corr = msg if i == 0 else msg - 1
            corr_t = np.uint64((corr * p.delta) % (1 << p.bits))
            # the difference stays a linear form over device rows
            data = self.key._add_to_body(x.data - y.data, corr_t)
            deg = (msg - 1) + corr
            out.append(x.with_data(data, degree=deg,
                                   noise_level=x.noise_level + y.noise_level))
        return out

    def sub_parallelized(self, a: RadixCiphertext, b: RadixCiphertext) -> RadixCiphertext:
        a, b = self._cleaned(a), self._cleaned(b)
        return self._result_like(a, b, self._propagate_carries(self._sub_state_blocks(a, b)))

    def neg_parallelized(self, a: RadixCiphertext) -> RadixCiphertext:
        zero = self.create_trivial_radix(0, a.num_blocks)
        return self._like(a, self.sub_parallelized(zero, a).blocks)

    # ------------------------------------------------------------------
    # Scalar ops
    # ------------------------------------------------------------------

    def scalar_add_parallelized(self, a: RadixCiphertext, scalar: int) -> RadixCiphertext:
        a = self._cleaned(a)
        msg = self.msg
        v = scalar % (msg ** a.num_blocks)
        s = []
        for i, blk in enumerate(a.blocks):
            digit = (v // msg ** i) % msg
            s.append(self.key.unchecked_scalar_add(blk, digit) if digit else blk)
        return self._like(a, self._propagate_carries(s))

    def scalar_sub_parallelized(self, a: RadixCiphertext, scalar: int) -> RadixCiphertext:
        msg = self.msg
        return self.scalar_add_parallelized(a, (-scalar) % (msg ** a.num_blocks))

    def scalar_mul_parallelized(self, a: RadixCiphertext, scalar: int) -> RadixCiphertext:
        """Shift-and-add over radix digits of the scalar (block_decomposition
        analog).  Block shifts are free; per-digit scaled copies are summed
        with the multi-operand carry-save adder."""
        msg = self.msg
        n = a.num_blocks
        scalar %= msg ** n
        if scalar == 0:
            return self._like(a, self.create_trivial_radix(0, n).blocks)
        a = self._cleaned(a)
        rows = []
        d = scalar
        shift = 0
        while d > 0 and shift < n:
            digit = d % msg
            if digit:
                shifted = [self.key.create_trivial(0)] * shift + [
                    self.key.unchecked_scalar_mul(blk, digit)
                    for blk in a.blocks[: n - shift]
                ]
                rows.append(RadixCiphertext(shifted))
            d //= msg
            shift += 1
        return self._like(a, self.sum_ciphertexts(rows, n).blocks)

    # ------------------------------------------------------------------
    # Multi-operand sum (carry-save) and multiplication
    # ------------------------------------------------------------------

    def sum_ciphertexts(self, cts: list, num_blocks: int | None = None) -> RadixCiphertext:
        """Sum many radix ciphertexts: column-wise carry-save compression
        (radix_parallel/sum.rs unchecked_sum_ciphertexts_vec_parallelized,
        batch-first)."""
        if num_blocks is None:
            num_blocks = cts[0].num_blocks
        msg = self.msg
        cols = [[] for _ in range(num_blocks)]
        for ct in cts:
            for i, blk in enumerate(ct.blocks[:num_blocks]):
                if blk.degree > 0 or blk.noise_level > 0:
                    cols[i].append(blk)

        def greedy_group(c):
            """Linear-add blocks while staying within degree/noise budget."""
            groups = []
            acc = None
            for blk in c:
                if acc is None:
                    acc = blk
                elif (acc.degree + blk.degree <= self.key.max_degree
                      and acc.noise_level + blk.noise_level <= self.key.max_noise_level):
                    acc = self.key.unchecked_add(acc, blk)
                else:
                    groups.append(acc)
                    acc = blk
            if acc is not None:
                groups.append(acc)
            return groups

        while True:
            max_terms = max((len(c) for c in cols), default=0)
            if max_terms <= 1:
                singles = [
                    c[0] if c else self.key.create_trivial(0) for c in cols
                ]
                if all(b.degree <= 2 * msg - 1 for b in singles):
                    return RadixCiphertext(self._propagate_carries(singles))
                # one more extraction round to shrink degrees
                cols = [[b] if b.degree > 0 else [] for b in singles]
            grouped_cols = [greedy_group(c) for c in cols]
            # decide whether extraction is still needed
            if all(len(c) <= 1 for c in grouped_cols) and all(
                b.degree <= 2 * msg - 1 for c in grouped_cols for b in c
            ):
                singles = [
                    c[0] if c else self.key.create_trivial(0) for c in grouped_cols
                ]
                return RadixCiphertext(self._propagate_carries(singles))
            # batched (msg, carry) extraction
            flat = [(i, b) for i, c in enumerate(grouped_cols) for b in c]
            blocks = [b for _, b in flat]
            msgs = self._apply(blocks, self._lut("msg_extract", lambda x: x % msg))
            carries = self._apply(blocks, self._lut("carry_extract", lambda x: x // msg))
            cols = [[] for _ in range(num_blocks)]
            for (i, _), mblk, cblk in zip(flat, msgs, carries):
                cols[i].append(mblk)
                if i + 1 < num_blocks and cblk.degree > 0:
                    cols[i + 1].append(cblk)

    def mul_parallelized(self, a: RadixCiphertext, b: RadixCiphertext) -> RadixCiphertext:
        """Schoolbook block products (one batched bivariate round for ALL
        lsb+msb partial products) + carry-save sum (radix_parallel/mul.rs)."""
        a, b = self._cleaned(a), self._cleaned(b)
        n = a.num_blocks
        msg = self.msg
        lsb_lut = self._biv_lut("mul_lsb", lambda x, y: (x * y) % msg)
        msb_lut = self._biv_lut("mul_msb", lambda x, y: (x * y) // msg)
        packed, luts, slots = [], [], []
        for i in range(n):
            for j in range(n):
                if i + j < n:
                    packed.append(self._pack(a.blocks[i], b.blocks[j]))
                    luts.append(lsb_lut)
                    slots.append(i + j)
                if i + j + 1 < n:
                    packed.append(self._pack(a.blocks[i], b.blocks[j]))
                    luts.append(msb_lut)
                    slots.append(i + j + 1)
        prods = self._apply(packed, luts)
        rows_by_slot = [[] for _ in range(n)]
        for s, blk in zip(slots, prods):
            rows_by_slot[s].append(blk)
        # wrap as pseudo radix cts for the summer
        cols_ct = []
        max_terms = max(len(r) for r in rows_by_slot)
        for t in range(max_terms):
            blocks = [
                rows_by_slot[i][t] if t < len(rows_by_slot[i]) else self.key.create_trivial(0)
                for i in range(n)
            ]
            cols_ct.append(RadixCiphertext(blocks))
        return self._result_like(a, b, self.sum_ciphertexts(cols_ct, n).blocks)

    # ------------------------------------------------------------------
    # Bitwise ops
    # ------------------------------------------------------------------

    def _bitwise(self, a, b, name, f) -> RadixCiphertext:
        a, b = self._cleaned(a), self._cleaned(b)
        lut = self._biv_lut(name, f)
        packed = [self._pack(x, y) for x, y in zip(a.blocks, b.blocks)]
        return self._result_like(a, b, self._apply(packed, lut))

    def bitand_parallelized(self, a, b):
        return self._bitwise(a, b, "bitand", lambda x, y: x & y)

    def bitor_parallelized(self, a, b):
        return self._bitwise(a, b, "bitor", lambda x, y: x | y)

    def bitxor_parallelized(self, a, b):
        return self._bitwise(a, b, "bitxor", lambda x, y: x ^ y)

    def bitnot(self, a):
        a = self._cleaned(a)
        msg = self.msg
        lut = self._lut("bitnot", lambda x: (msg - 1) - (x % msg))
        return self._like(a, self._apply(a.blocks, lut))

    # ------------------------------------------------------------------
    # Comparisons
    # ------------------------------------------------------------------

    def _tree_reduce(self, blocks: list, comb_lut: LookupTable) -> Ciphertext:
        """log2(n) batched bivariate rounds."""
        while len(blocks) > 1:
            packed, rest = [], []
            for i in range(0, len(blocks) - 1, 2):
                packed.append(self._pack(blocks[i], blocks[i + 1]))
            if len(blocks) % 2 == 1:
                rest = [blocks[-1]]
            blocks = self._apply(packed, comb_lut) + rest
        return blocks[0]

    def eq_parallelized(self, a, b) -> BooleanBlock:
        a, b = self._cleaned(a), self._cleaned(b)
        eq_lut = self._biv_lut("block_eq", lambda x, y: int(x == y))
        packed = [self._pack(x, y) for x, y in zip(a.blocks, b.blocks)]
        eqs = self._apply(packed, eq_lut)
        and_lut = self._biv_lut("bool_and", lambda x, y: x & y & 1)
        return BooleanBlock(self._tree_reduce(eqs, and_lut))

    def ne_parallelized(self, a, b) -> BooleanBlock:
        a, b = self._cleaned(a), self._cleaned(b)
        ne_lut = self._biv_lut("block_ne", lambda x, y: int(x != y))
        packed = [self._pack(x, y) for x, y in zip(a.blocks, b.blocks)]
        nes = self._apply(packed, ne_lut)
        or_lut = self._biv_lut("bool_or", lambda x, y: (x | y) & 1)
        return BooleanBlock(self._tree_reduce(nes, or_lut))

    def _cmp_state(self, a, b) -> Ciphertext:
        """3-state lexicographic compare: 0 = lt, 1 = eq, 2 = gt
        (comparator.rs tree reduction, batch-first; signed operands flip the
        top bit of the most significant block)."""
        signed = self._is_signed(a) or self._is_signed(b)
        a, b = self._cleaned(a), self._cleaned(b)
        luts = self._cmp_state_luts(a.num_blocks, signed)
        packed = [self._pack(x, y) for x, y in zip(a.blocks, b.blocks)]
        states = self._apply(packed, luts)
        # most significant block first; combine(hi, lo) = hi if hi != eq else lo
        states = states[::-1]
        comb = self._biv_lut("cmp_combine", lambda hi, lo: lo if hi == 1 else hi)
        return self._tree_reduce(states, comb)

    def lt_parallelized(self, a, b) -> BooleanBlock:
        st = self._cmp_state(a, b)
        return BooleanBlock(self._apply([st], self._lut("is_lt", lambda x: int(x == 0)))[0])

    def le_parallelized(self, a, b) -> BooleanBlock:
        st = self._cmp_state(a, b)
        return BooleanBlock(self._apply([st], self._lut("is_le", lambda x: int(x != 2)))[0])

    def gt_parallelized(self, a, b) -> BooleanBlock:
        st = self._cmp_state(a, b)
        return BooleanBlock(self._apply([st], self._lut("is_gt", lambda x: int(x == 2)))[0])

    def ge_parallelized(self, a, b) -> BooleanBlock:
        st = self._cmp_state(a, b)
        return BooleanBlock(self._apply([st], self._lut("is_ge", lambda x: int(x != 0)))[0])

    # ------------------------------------------------------------------
    # Select / min / max
    # ------------------------------------------------------------------

    def if_then_else_parallelized(self, cond: BooleanBlock, a: RadixCiphertext,
                                  b: RadixCiphertext) -> RadixCiphertext:
        """cmux: one batched round of condition-gated LUTs + linear add."""
        a, b = self._cleaned(a), self._cleaned(b)
        keep_if_true = self._biv_lut("keep_true", lambda c, x: x if (c & 1) else 0)
        keep_if_false = self._biv_lut("keep_false", lambda c, x: 0 if (c & 1) else x)
        n = a.num_blocks
        packed = [self._pack(cond.block, x) for x in a.blocks] + [
            self._pack(cond.block, x) for x in b.blocks
        ]
        luts = [keep_if_true] * n + [keep_if_false] * n
        outs = self._apply(packed, luts)
        return self._result_like(
            a, b, [self.key.unchecked_add(outs[i], outs[n + i]) for i in range(n)]
        )

    def min_parallelized(self, a, b) -> RadixCiphertext:
        return self.if_then_else_parallelized(self.lt_parallelized(a, b), a, b)

    def max_parallelized(self, a, b) -> RadixCiphertext:
        return self.if_then_else_parallelized(self.ge_parallelized(a, b), a, b)

    # ------------------------------------------------------------------
    # Scalar shifts (encrypted-amount barrel shifter comes with kv/shift work)
    # ------------------------------------------------------------------

    def scalar_left_shift_parallelized(self, a: RadixCiphertext, shift: int) -> RadixCiphertext:
        a = self._cleaned(a)
        msg_bits = (self.msg - 1).bit_length()
        n = a.num_blocks
        block_shift, bit_shift = divmod(shift, msg_bits)
        blocks = [self.key.create_trivial(0)] * min(block_shift, n) + [
            b.copy() for b in a.blocks[: max(n - block_shift, 0)]
        ]
        if bit_shift == 0:
            return self._like(a, blocks)
        msg = self.msg
        lut = self._biv_lut(
            f"lshift_{bit_shift}",
            lambda cur, prev: ((cur << bit_shift) | (prev >> (msg_bits - bit_shift))) % msg,
        )
        packed = []
        for i in range(n):
            prev = blocks[i - 1] if i > 0 else self.key.create_trivial(0)
            packed.append(self._pack(blocks[i], prev))
        return self._like(a, self._apply(packed, lut))

    def scalar_right_shift_parallelized(self, a: RadixCiphertext, shift: int) -> RadixCiphertext:
        if self._is_signed(a):
            return self._scalar_right_shift_arithmetic(a, shift)
        a = self._cleaned(a)
        msg_bits = (self.msg - 1).bit_length()
        n = a.num_blocks
        block_shift, bit_shift = divmod(shift, msg_bits)
        blocks = [b.copy() for b in a.blocks[block_shift:]] + [
            self.key.create_trivial(0)
        ] * min(block_shift, n)
        if bit_shift == 0:
            return self._like(a, blocks)
        msg = self.msg
        lut = self._biv_lut(
            f"rshift_{bit_shift}",
            lambda nxt, cur: ((cur >> bit_shift) | ((nxt << (msg_bits - bit_shift)) % msg)) % msg,
        )
        packed = []
        for i in range(n):
            nxt = blocks[i + 1] if i + 1 < n else self.key.create_trivial(0)
            packed.append(self._pack(nxt, blocks[i]))
        return self._like(a, self._apply(packed, lut))
