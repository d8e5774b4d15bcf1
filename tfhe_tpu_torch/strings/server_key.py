"""Encrypted string operations.

Port of tfhe_tpu/strings/server_key.py: the same calls in the same order over
the port's integer layer, so every block gives tfhe_tpu's words.

Mirrors strings/server_key/ (comp.rs comparisons, no_patterns.rs len/case,
pattern/ contains/starts/ends/find), re-expressed over the batched integer
backend: every per-char round (eq grids, case LUTs) is one fused PBS batch.
"""

from __future__ import annotations

from ..integer.ciphertext import BooleanBlock, RadixCiphertext
from ..integer.server_key import ServerKey as IntegerServerKey
from .ciphertext import FheString
from .split import SplitMixin


class StringServerKey(SplitMixin):
    def __init__(self, integer_key: IntegerServerKey):
        self.sk = integer_key

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    def _char_eq(self, a: RadixCiphertext, b: RadixCiphertext) -> BooleanBlock:
        return self.sk.eq_parallelized(a, b)

    def _char_eq_clear(self, a: RadixCiphertext, c: int) -> BooleanBlock:
        return self.sk.scalar_eq_parallelized(a, c)

    def _false(self) -> BooleanBlock:
        return BooleanBlock(self.sk.key.create_trivial(0))

    def _true(self) -> BooleanBlock:
        return BooleanBlock(self.sk.key.create_trivial(1))

    # ------------------------------------------------------------------
    # comparisons (server_key/comp.rs)
    # ------------------------------------------------------------------

    def eq(self, a: FheString, b: FheString) -> BooleanBlock:
        """Content equality, honoring nul-padding semantics."""
        n = max(a.max_len, b.max_len)
        bools = []
        for i in range(n):
            if i < a.max_len and i < b.max_len:
                bools.append(self._char_eq(a.chars[i], b.chars[i]))
            elif i < a.max_len:
                bools.append(self._char_eq_clear(a.chars[i], 0))
            else:
                bools.append(self._char_eq_clear(b.chars[i], 0))
        if not bools:
            return self._true()
        return self.sk.boolean_and_many(bools)

    def ne(self, a: FheString, b: FheString) -> BooleanBlock:
        return self.sk.boolean_not(self.eq(a, b))

    def eq_clear(self, a: FheString, s: str) -> BooleanBlock:
        if len(s) > a.max_len:
            return self._false()
        bools = []
        for i in range(a.max_len):
            c = ord(s[i]) if i < len(s) else 0
            bools.append(self._char_eq_clear(a.chars[i], c))
        if not bools:
            return self._true()
        return self.sk.boolean_and_many(bools)

    # ------------------------------------------------------------------
    # no-pattern ops (no_patterns.rs)
    # ------------------------------------------------------------------

    def len_(self, a: FheString) -> RadixCiphertext:
        """Encrypted length: count of non-nul chars (nul-padded strings)."""
        nb = max(2, (max(a.max_len, 1).bit_length() + 1) // 2 + 1)
        if not a.chars:
            return self.sk.create_trivial_radix(0, nb)
        nonzero = [self.sk.scalar_ne_parallelized(c, 0) for c in a.chars]
        rows = [
            RadixCiphertext([b.block] + [self.sk.key.create_trivial(0)] * (nb - 1))
            for b in nonzero
        ]
        return self.sk.sum_ciphertexts(rows, nb)

    def is_empty(self, a: FheString) -> BooleanBlock:
        if not a.chars:
            return self._true()
        if not a.padded:
            return self._false()
        return self.sk.boolean_and_many(
            [self.sk.scalar_eq_parallelized(c, 0) for c in a.chars])

    def _case_map(self, a: FheString, lo: int, hi: int, delta: int) -> FheString:
        """Add `delta` to chars in [lo, hi] (to_upper/to_lower core)."""
        out = []
        for c in a.chars:
            ge = self.sk.scalar_ge_parallelized(c, lo)
            le = self.sk.scalar_le_parallelized(c, hi)
            in_range = self.sk.boolean_and(ge, le)
            shifted = (self.sk.scalar_add_parallelized(c, delta) if delta > 0
                       else self.sk.scalar_sub_parallelized(c, -delta))
            out.append(self.sk.if_then_else_parallelized(in_range, shifted, c))
        return FheString(out, a.padded)

    def to_uppercase(self, a: FheString) -> FheString:
        return self._case_map(a, ord("a"), ord("z"), -32)

    def to_lowercase(self, a: FheString) -> FheString:
        return self._case_map(a, ord("A"), ord("Z"), 32)

    def concat(self, a: FheString, b: FheString) -> FheString:
        """Concatenation (strings/server_key concat.rs): for a padded lhs
        the rhs is barrel-shifted right by the hidden length of `a` and the
        two disjoint char sets are merged."""
        if not a.padded:
            return FheString([c.copy() for c in a.chars] +
                             [c.copy() for c in b.chars],
                             a.padded or b.padded)
        if not a.chars:
            return FheString([c.copy() for c in b.chars], b.padded)
        n_out = a.max_len + b.max_len
        nb = a.chars[0].num_blocks
        nbi = self._idx_blocks(n_out + 1)
        la = self.sk.cast_to_unsigned(self.len_(a), nbi)
        zero = self.sk.create_trivial_radix(0, nb)
        b_ext = [c.copy() for c in b.chars] + [zero] * (n_out - b.max_len)
        b_shifted = self._barrel_shift_right_chars(b_ext, la, n_out)
        out = []
        for i in range(n_out):
            if i < a.max_len:
                # disjoint supports: a[i] is nul beyond len(a), b_shifted is
                # nul before it — bitwise OR merges without a carry round
                out.append(self.sk.bitor_parallelized(a.chars[i], b_shifted[i]))
            else:
                out.append(b_shifted[i])
        return FheString(out, padded=True)

    def repeat(self, a: FheString, n: int) -> FheString:
        if not a.padded or n <= 1:
            return FheString([c.copy() for _ in range(n) for c in a.chars],
                             a.padded)
        out = FheString([c.copy() for c in a.chars], padded=True)
        for _ in range(n - 1):
            out = self.concat(out, a)
        return out

    # ------------------------------------------------------------------
    # pattern family (server_key/pattern/)
    # ------------------------------------------------------------------

    def _window_match(self, a: FheString, pat, offset: int) -> BooleanBlock:
        """All pattern chars match a[offset:]; pat is str or FheString.

        A PADDED encrypted pattern has a hidden length: its nul positions
        are past the content and must match anything (per-char flag =
        pat[j] == 0 OR a[offset+j] == pat[j]); past the end of `a` only a
        nul pattern char can match."""
        plen = len(pat) if isinstance(pat, str) else pat.max_len
        enc_padded = not isinstance(pat, str) and pat.padded
        bools = []
        for j in range(plen):
            if offset + j >= a.max_len:
                if not enc_padded:
                    return self._false()
                bools.append(self._char_eq_clear(pat.chars[j], 0))
                continue
            if isinstance(pat, str):
                bools.append(self._char_eq_clear(a.chars[offset + j], ord(pat[j])))
            elif enc_padded:
                eq = self._char_eq(a.chars[offset + j], pat.chars[j])
                past = self._char_eq_clear(pat.chars[j], 0)
                bools.append(self.sk.boolean_or(eq, past))
            else:
                bools.append(self._char_eq(a.chars[offset + j], pat.chars[j]))
        if not bools:
            return self._true()
        return self.sk.boolean_and_many(bools)

    def _pat_offsets(self, a: FheString, pat) -> range:
        """Candidate match offsets: hidden-length (padded encrypted)
        patterns can start anywhere in the text."""
        plen = len(pat) if isinstance(pat, str) else pat.max_len
        if not isinstance(pat, str) and pat.padded:
            return range(max(a.max_len, 1))
        return range(a.max_len - plen + 1)

    def contains(self, a: FheString, pat) -> BooleanBlock:
        plen = len(pat) if isinstance(pat, str) else pat.max_len
        if plen == 0:
            return self._true()
        matches = [self._window_match(a, pat, off)
                   for off in self._pat_offsets(a, pat)]
        if not matches:
            return self._false()
        return self.sk.boolean_or_many(matches)

    def starts_with(self, a: FheString, pat) -> BooleanBlock:
        return self._window_match(a, pat, 0)

    def ends_with(self, a: FheString, pat) -> BooleanBlock:
        plen = len(pat) if isinstance(pat, str) else pat.max_len
        if plen == 0:
            return self._true()
        if not a.padded:
            if plen > a.max_len:
                return self._false()
            return self._window_match(a, pat, a.max_len - plen)
        # hidden length: shift a left by len(a) - len(pat) so the suffix
        # lands at offset 0, then window-match (pattern/ends_with semantics)
        if plen > a.max_len:
            return self._false()
        nbi = self._idx_blocks(a.max_len + 1)
        la = self.sk.cast_to_unsigned(self.len_(a), nbi)
        if isinstance(pat, str):
            lp = self.sk.create_trivial_radix(plen, nbi)
        else:
            lp = (self.sk.cast_to_unsigned(self.len_(pat), nbi) if pat.padded
                  else self.sk.create_trivial_radix(plen, nbi))
        long_enough = self.sk.ge_parallelized(la, lp)
        shift = self.sk.sub_parallelized(la, lp)  # wraps if short; gated below
        shifted = self._barrel_shift_left_chars(
            [c.copy() for c in a.chars], shift, a.max_len)
        tail = FheString(shifted, padded=True)
        if isinstance(pat, str) or not pat.padded:
            match = self._window_match(tail, pat, 0)
            # remaining chars past the pattern must be nul (suffix = whole tail)
            extra = [self._char_eq_clear(shifted[j], 0)
                     for j in range(plen, a.max_len)]
            if extra:
                match = self.sk.boolean_and(match, self.sk.boolean_and_many(extra))
        else:
            match = self.eq(tail, pat)
        return self.sk.boolean_and(match, long_enough)

    def find(self, a: FheString, pat):
        """(found: BooleanBlock, index: RadixCiphertext) of first match."""
        plen = len(pat) if isinstance(pat, str) else pat.max_len
        nb = max(2, (max(a.max_len, 1).bit_length() + 1) // 2 + 1)
        offsets = self._pat_offsets(a, pat)
        matches = [self._window_match(a, pat, off) for off in offsets]
        if not matches:
            return self._false(), self.sk.create_trivial_radix(0, nb)
        found = self.sk.boolean_or_many(matches)
        # first-match gating: m'_i = m_i AND NOT(any m_j, j<i) via prefix OR
        prefix = []
        acc = None
        for m in matches:
            prefix.append(acc)
            acc = m if acc is None else self.sk.boolean_or(acc, m)
        index = self.sk.create_trivial_radix(0, nb)
        for i, (m, pre) in enumerate(zip(matches, prefix)):
            if i == 0 or pre is None:
                gated = m
            else:
                gated = self.sk.boolean_and(m, self.sk.boolean_not(pre))
            contrib = self.sk.if_then_else_parallelized(
                gated, self.sk.create_trivial_radix(i, nb),
                self.sk.create_trivial_radix(0, nb))
            index = self.sk.add_parallelized(index, contrib)
        return found, index

    def rfind(self, a: FheString, pat):
        """(found, index) of the LAST match (pattern/find.rs rfind)."""
        plen = len(pat) if isinstance(pat, str) else pat.max_len
        nb = max(2, (max(a.max_len, 1).bit_length() + 1) // 2 + 1)
        offsets = self._pat_offsets(a, pat)
        matches = [self._window_match(a, pat, off) for off in offsets]
        if not matches:
            return self._false(), self.sk.create_trivial_radix(0, nb)
        found = self.sk.boolean_or_many(matches)
        # last-match gating: suffix OR of later matches
        suffix = [None] * len(matches)
        acc = None
        for i in range(len(matches) - 1, -1, -1):
            suffix[i] = acc
            acc = matches[i] if acc is None else self.sk.boolean_or(acc, matches[i])
        index = self.sk.create_trivial_radix(0, nb)
        for i, (m, suf) in enumerate(zip(matches, suffix)):
            gated = m if suf is None else self.sk.boolean_and(m, self.sk.boolean_not(suf))
            contrib = self.sk.if_then_else_parallelized(
                gated, self.sk.create_trivial_radix(i, nb),
                self.sk.create_trivial_radix(0, nb))
            index = self.sk.add_parallelized(index, contrib)
        return found, index

    # ------------------------------------------------------------------
    # replace (pattern/replace.rs) — clear from/to of equal length
    # ------------------------------------------------------------------

    def replace(self, a: FheString, from_pat, to_pat) -> FheString:
        """Replace ALL non-overlapping matches; from/to may each be a clear
        str or an encrypted FheString (pattern/replace.rs Enc support)."""
        if isinstance(from_pat, str) and isinstance(to_pat, str):
            return self.replace_clear(a, from_pat, to_pat)
        return self.replacen(a, from_pat, to_pat, count=None)

    def replace_clear(self, a: FheString, from_pat: str, to_pat: str) -> FheString:
        """Replace non-overlapping left-to-right matches of `from_pat` with
        `to_pat`.  Equal lengths rewrite in place; the length-changing case
        re-packs through split + join (pattern/replace.rs)."""
        plen = len(from_pat)
        if plen != len(to_pat) or plen == 0:
            return self._replace_repack(a, from_pat, to_pat)
        if plen > a.max_len:
            return FheString([c.copy() for c in a.chars], a.padded)
        matches = [self._window_match(a, from_pat, off)
                   for off in range(a.max_len - plen + 1)]
        # non-overlap gating: active[off] = match[off] AND no active in the
        # previous plen-1 offsets (sequential left-to-right semantics)
        active = []
        for off, m in enumerate(matches):
            blockers = [active[j] for j in range(max(0, off - plen + 1), off)]
            if blockers:
                blocked = self.sk.boolean_or_many(blockers)
                m = self.sk.boolean_and(m, self.sk.boolean_not(blocked))
            active.append(m)
        out = [c.copy() for c in a.chars]
        nb = a.chars[0].num_blocks
        for off, act in enumerate(active):
            for j, ch in enumerate(to_pat):
                i = off + j
                out[i] = self.sk.if_then_else_parallelized(
                    act, self.sk.create_trivial_radix(ord(ch), nb), out[i])
        return FheString(out, a.padded)

    def _replace_repack(self, a: FheString, from_pat: str, to_pat: str) -> FheString:
        """Length-changing replace: split on `from_pat`, join with `to_pat`
        (each insert gated by the field's is_some flag)."""
        if not a.chars:
            return FheString([], padded=True)
        nb = a.chars[0].num_blocks
        pieces = self.split(a, from_pat)
        zero = self.sk.create_trivial_radix(0, nb)
        out = FheString([c.copy() for c in pieces[0][0].chars], padded=True)
        for k in range(1, len(pieces)):
            some = pieces[k][1]
            to_chars = [self.sk.if_then_else_parallelized(
                some, self.sk.create_trivial_radix(ord(ch), nb), zero)
                for ch in to_pat]
            if to_chars:
                out = self.concat(out, FheString(to_chars, padded=True))
            out = self.concat(out, pieces[k][0])
        # provable content bound: n + max_matches * growth
        n, p, q = a.max_len, len(from_pat), len(to_pat)
        cap = n + (n // max(p, 1) + (1 if p == 0 else 0) * (n + 1)) * max(0, q - p)
        if p == 0:
            cap = n + (n + 1) * q
        if out.max_len > cap:
            out = FheString(out.chars[:cap], padded=True)
        return out

    # ------------------------------------------------------------------
    # trim / strip (trim.rs, pattern/strip.rs)
    # ------------------------------------------------------------------

    def _is_whitespace(self, c) -> BooleanBlock:
        """ASCII whitespace: space, \\t, \\n, \\v, \\f, \\r."""
        flags = [self.sk.scalar_eq_parallelized(c, 32)]
        ge = self.sk.scalar_ge_parallelized(c, 9)
        le = self.sk.scalar_le_parallelized(c, 13)
        flags.append(self.sk.boolean_and(ge, le))
        return self.sk.boolean_or_many(flags)

    def trim_end(self, a: FheString) -> FheString:
        """Null out the trailing whitespace run (output is padded)."""
        if a.max_len == 0:
            return FheString([], padded=True)
        n = a.max_len
        ws = [self._is_whitespace(c) for c in a.chars]
        if a.padded:
            nul = [self._char_eq_clear(c, 0) for c in a.chars]
            ws = [self.sk.boolean_or(w, z) for w, z in zip(ws, nul)]
        out = [c.copy() for c in a.chars]
        nb = a.chars[0].num_blocks
        suffix = None
        for i in range(n - 1, -1, -1):
            suffix = ws[i] if suffix is None else self.sk.boolean_and(suffix, ws[i])
            out[i] = self.sk.if_then_else_parallelized(
                suffix, self.sk.create_trivial_radix(0, nb), out[i])
        return FheString(out, padded=True)

    def trim_start(self, a: FheString) -> FheString:
        """Shift out the leading whitespace run (barrel shift by the hidden
        count), output padded."""
        if a.max_len == 0:
            return FheString([], padded=True)
        n = a.max_len
        ws = [self._is_whitespace(c) for c in a.chars]
        prefix = []
        acc = None
        for w in ws:
            acc = w if acc is None else self.sk.boolean_and(acc, w)
            prefix.append(acc)
        # char-level barrel shift: stage 2^j shifts gated by the bit of the
        # leading-ws count; count bits derived by comparing count to ranges.
        nb_idx = max(2, (n.bit_length() + 1) // 2 + 1)
        rows = [self.sk.cast_to_unsigned(RadixCiphertext([pfx.block.copy()]), nb_idx)
                for pfx in prefix]
        count = self.sk.sum_ciphertexts(rows, nb_idx)
        bits = self.sk.extract_bits(count)
        out = [c.copy() for c in a.chars]
        nb = a.chars[0].num_blocks
        stages = (max(n - 1, 1)).bit_length()
        for j in range(min(stages, len(bits))):
            shift = 1 << j
            shifted = [out[i + shift] if i + shift < n
                       else self.sk.create_trivial_radix(0, nb) for i in range(n)]
            gate = BooleanBlock(bits[j])
            out = [self.sk.if_then_else_parallelized(gate, sh, cur)
                   for sh, cur in zip(shifted, out)]
        return FheString(out, padded=True)

    def trim(self, a: FheString) -> FheString:
        return self.trim_start(self.trim_end(a))

    def strip_prefix(self, a: FheString, pat):
        """(stripped, found) — remove `pat` from the start when present.
        `pat` may be a clear str or an encrypted FheString."""
        if isinstance(pat, FheString):
            return self.strip_prefix_enc(a, pat)
        if a.max_len == 0:
            return FheString([], padded=True), self._true() if not pat else self._false()
        found = self.starts_with(a, pat)
        plen = len(pat)
        n = a.max_len
        nb = a.chars[0].num_blocks
        out = []
        for i in range(n):
            shifted = (a.chars[i + plen] if i + plen < n
                       else self.sk.create_trivial_radix(0, nb))
            out.append(self.sk.if_then_else_parallelized(found, shifted, a.chars[i]))
        return FheString(out, padded=True), found

    def strip_suffix(self, a: FheString, pat):
        """(stripped, found) — removes `pat` from the hidden end if present
        (pattern/strip.rs).  `pat` may be a clear str or FheString."""
        if isinstance(pat, FheString):
            return self.strip_suffix_enc(a, pat)
        found = self.ends_with(a, pat)
        plen = len(pat)
        nb = a.chars[0].num_blocks if a.chars else 1
        if not a.padded:
            out = [c.copy() for c in a.chars]
            for i in range(max(0, a.max_len - plen), a.max_len):
                out[i] = self.sk.if_then_else_parallelized(
                    found, self.sk.create_trivial_radix(0, nb), out[i])
            return FheString(out, padded=True), found
        # padded: null out positions i >= len(a) - plen when found
        nbi = self._idx_blocks(a.max_len + 1)
        la = self.sk.cast_to_unsigned(self.len_(a), nbi)
        thresh = self.sk.scalar_sub_parallelized(la, min(plen, a.max_len))
        zero = self.sk.create_trivial_radix(0, nb)
        out = []
        for i in range(a.max_len):
            past = self.sk.scalar_le_parallelized(thresh, i)  # thresh <= i
            kill = self.sk.boolean_and(found, past)
            out.append(self.sk.if_then_else_parallelized(kill, zero, a.chars[i]))
        return FheString(out, padded=True), found

    def eq_ignore_case(self, a: FheString, b: FheString) -> BooleanBlock:
        return self.eq(self.to_lowercase(a), self.to_lowercase(b))
