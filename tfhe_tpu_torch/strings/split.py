"""Split family + hidden-length (padded) string machinery.

Port of tfhe_tpu/strings/split.py: the same calls in the same order over
the port's integer layer, so every block gives tfhe_tpu's words.

Mirrors strings/server_key/pattern/split/ (split, rsplit, splitn, rsplitn,
split_once, rsplit_once, split_terminator, rsplit_terminator,
split_inclusive, split_ascii_whitespace) and the padded-string closures
(concat/ends_with/strip_suffix/repeat with hidden lengths, length-changing
replace via split+join).

Representation: a split result is a list of (FheString, BooleanBlock
is_some) pairs of statically-known maximal length, exactly the information
the reference's FheStringIterator yields per next() call
(strings/server_key/pattern/split/split_iterator.rs) — this version
materializes all fields so every per-field round can batch.

Cost note: field extraction is O(n^2 log n) encrypted cmuxes (n = max_len);
like the reference, split is for short strings, not bulk text.
"""

from __future__ import annotations

from ..integer.ciphertext import BooleanBlock, RadixCiphertext
from .ciphertext import FheString


class SplitMixin:
    """Mixed into StringServerKey; expects self.sk (integer ServerKey) and
    the helpers of server_key.py (_window_match, _char_eq_clear, ...)."""

    # ------------------------------------------------------------------
    # shared machinery
    # ------------------------------------------------------------------

    def _idx_blocks(self, n: int) -> int:
        msg_bits = (self.sk.msg - 1).bit_length()
        return max(2, (max(n, 2).bit_length() + msg_bits - 1) // msg_bits + 1)

    def _bool_radix(self, b: BooleanBlock, nb: int) -> RadixCiphertext:
        return RadixCiphertext([b.block.copy()] +
                               [self.sk.key.create_trivial(0)] * (nb - 1))

    def _barrel_shift_left_chars(self, chars: list, amount: RadixCiphertext,
                                 n: int) -> list:
        """chars shifted left by the encrypted amount, nul-filled on the
        right (the trim_start shifter, factored out)."""
        if n == 0:
            return []
        nb = chars[0].num_blocks
        bits = self.sk.extract_bits(amount)
        out = [c.copy() for c in chars]
        stages = (max(n - 1, 1)).bit_length()
        for j in range(min(stages, len(bits))):
            shift = 1 << j
            shifted = [out[i + shift] if i + shift < n
                       else self.sk.create_trivial_radix(0, nb)
                       for i in range(n)]
            gate = BooleanBlock(bits[j])
            out = [self.sk.if_then_else_parallelized(gate, sh, cur)
                   for sh, cur in zip(shifted, out)]
        return out

    def _barrel_shift_right_chars(self, chars: list, amount: RadixCiphertext,
                                  n: int) -> list:
        """chars shifted right by the encrypted amount, nul-filled left."""
        if n == 0:
            return []
        nb = chars[0].num_blocks
        bits = self.sk.extract_bits(amount)
        out = [c.copy() for c in chars]
        stages = (max(n - 1, 1)).bit_length()
        for j in range(min(stages, len(bits))):
            shift = 1 << j
            shifted = [out[i - shift] if i - shift >= 0
                       else self.sk.create_trivial_radix(0, nb)
                       for i in range(n)]
            gate = BooleanBlock(bits[j])
            out = [self.sk.if_then_else_parallelized(gate, sh, cur)
                   for sh, cur in zip(shifted, out)]
        return out

    def _active_matches(self, a: FheString, pat: str, rightward: bool):
        """Non-overlapping match flags per offset.

        rightward=False scans left-to-right (split family); True scans
        right-to-left (rsplit family) — pattern/split/mod.rs semantics."""
        n, p = a.max_len, len(pat)
        offs = list(range(n - p + 1))
        matches = {off: self._window_match(a, pat, off) for off in offs}
        active = {}
        order = offs if not rightward else list(reversed(offs))
        for off in order:
            if rightward:
                blockers = [active[j] for j in range(off + 1, min(off + p, n - p + 1))]
            else:
                blockers = [active[j] for j in range(max(0, off - p + 1), off)]
            m = matches[off]
            if blockers:
                blocked = self.sk.boolean_or_many(blockers)
                m = self.sk.boolean_and(m, self.sk.boolean_not(blocked))
            active[off] = m
        return [active[off] for off in offs]

    def _limit_matches(self, active: list, limit: int, rightward: bool):
        """Keep only the first (or last, if rightward) limit matches."""
        if limit <= 0:
            return [self._false() for _ in active]
        nb = self._idx_blocks(len(active) + 1)
        out = []
        seq = list(reversed(active)) if rightward else list(active)
        acc = None  # running count of active seen so far (exclusive)
        kept = []
        for m in seq:
            if acc is None:
                ord_ct = self.sk.create_trivial_radix(0, nb)
            else:
                ord_ct = acc
            keep = self.sk.scalar_lt_parallelized(ord_ct, limit)
            kept.append(self.sk.boolean_and(m, keep))
            inc = self._bool_radix(m, nb)
            acc = inc if acc is None else self.sk.add_parallelized(acc, inc)
        if rightward:
            kept.reverse()
        return kept

    def _fields_from_matches(self, a: FheString, active: list, p: int,
                             inclusive: bool):
        """Extract aligned fields given active separator matches of width p.

        Returns (pieces: list[FheString], nonempty: list[BooleanBlock],
        count: RadixCiphertext) with len(pieces) = max_fields; field k is the
        text between the k-th and (k+1)-th active match (inclusive=True keeps
        the trailing separator inside the field)."""
        n = a.max_len
        nb = a.chars[0].num_blocks if a.chars else 1
        nbi = self._idx_blocks(n + p + 1)
        offs = list(range(len(active)))
        max_fields = (n // max(p, 1)) + 1

        # field id per char position: number of active matches ending <= i
        fid = []
        acc = self.sk.create_trivial_radix(0, nbi)
        for i in range(n):
            if i - p >= 0 and i - p < len(active):
                acc = self.sk.add_parallelized(
                    acc, self._bool_radix(active[i - p], nbi))
            fid.append(acc)
        # separator-interior flags (excluded from fields unless inclusive)
        in_sep = []
        for i in range(n):
            cover = [active[off] for off in offs if off <= i < off + p]
            in_sep.append(self.sk.boolean_or_many(cover) if cover
                          else self._false())
        # ordinal of each match among active ones (prefix count, exclusive)
        matchord = []
        acc = self.sk.create_trivial_radix(0, nbi)
        for off in offs:
            matchord.append(acc)
            acc = self.sk.add_parallelized(acc, self._bool_radix(active[off], nbi))
        count = acc if offs else self.sk.create_trivial_radix(0, nbi)

        zero_char = self.sk.create_trivial_radix(0, nb)
        pieces, nonempty = [], []
        for k in range(max_fields):
            # mask: chars belonging to field k
            masked = []
            for i in range(n):
                is_k = self.sk.scalar_eq_parallelized(fid[i], k)
                if not inclusive:
                    is_k = self.sk.boolean_and(
                        is_k, self.sk.boolean_not(in_sep[i]))
                masked.append(self.sk.if_then_else_parallelized(
                    is_k, a.chars[i], zero_char))
            # start position of field k: end of the (k-1)-th active match
            if k == 0:
                start = self.sk.create_trivial_radix(0, nbi)
            else:
                start = self.sk.create_trivial_radix(0, nbi)
                for off in offs:
                    gate = self.sk.boolean_and(
                        active[off],
                        self.sk.scalar_eq_parallelized(matchord[off], k - 1))
                    start = self.sk.add_parallelized(
                        start, self.sk.if_then_else_parallelized(
                            gate,
                            self.sk.create_trivial_radix(off + p, nbi),
                            self.sk.create_trivial_radix(0, nbi)))
            aligned = self._barrel_shift_left_chars(masked, start, n)
            pieces.append(FheString(aligned, padded=True))
            ne_flags = [self.sk.scalar_ne_parallelized(c, 0) for c in aligned]
            nonempty.append(self.sk.boolean_or_many(ne_flags) if ne_flags
                            else self._false())
        return pieces, nonempty, count

    def _is_some_upto_count(self, count: RadixCiphertext, max_fields: int):
        """is_some_k = (k <= count) for k in range(max_fields)."""
        return [self.sk.scalar_ge_parallelized(count, k)
                for k in range(max_fields)]

    def _split_empty_pattern(self, a: FheString):
        """Rust `s.split("")` = ["", c0, ..., c_{len-1}, ""], hidden length.

        Slot k in 1..n holds char k-1 (nul = empty when k-1 == len, matching
        the final empty field); slot n+1 covers the len == max_len case."""
        n = a.max_len
        nb = a.chars[0].num_blocks if a.chars else 1
        nbi = self._idx_blocks(n + 2)
        la = self.sk.cast_to_unsigned(self.len_(a), nbi)
        empty = FheString([self.sk.create_trivial_radix(0, nb)], padded=True)
        out = [(empty, self._true())]
        for k in range(1, n + 1):
            piece = FheString([a.chars[k - 1].copy()], padded=True)
            out.append((piece, self.sk.scalar_ge_parallelized(la, k - 1)))
        out.append((empty, self.sk.scalar_ge_parallelized(la, n)))
        return out

    def _rsplit_empty_pattern(self, a: FheString):
        """Rust `s.rsplit("")` = ["", c_{len-1}, ..., c0, ""]: piece k >= 1
        is the char at hidden position len - k (oblivious selection)."""
        n = a.max_len
        nb = a.chars[0].num_blocks if a.chars else 1
        nbi = self._idx_blocks(n + 2)
        la = self.sk.cast_to_unsigned(self.len_(a), nbi)
        empty = FheString([self.sk.create_trivial_radix(0, nb)], padded=True)
        out = [(empty, self._true())]
        for k in range(1, n + 2):
            sel = self.sk.create_trivial_radix(0, nb)
            for i in range(n):
                if i + k <= n:
                    gate = self.sk.scalar_eq_parallelized(la, i + k)
                    sel = self.sk.if_then_else_parallelized(
                        gate, a.chars[i], sel)
            out.append((FheString([sel], padded=True),
                        self.sk.scalar_ge_parallelized(la, k - 1)))
        return out

    # ------------------------------------------------------------------
    # the split family (pattern/split/)
    # ------------------------------------------------------------------

    def split(self, a: FheString, pat):
        """list of (piece, is_some) — strings/server_key/pattern/split.
        `pat` is a clear str or an encrypted FheString
        (GenericPatternRef::Enc, pattern/split/mod.rs:101)."""
        if isinstance(pat, FheString):
            return self.split_enc(a, pat)
        if not a.chars:
            return [(FheString([], padded=True), self._true())]
        if len(pat) == 0:
            return self._split_empty_pattern(a)
        active = self._active_matches(a, pat, rightward=False)
        pieces, _, count = self._fields_from_matches(a, active, len(pat), False)
        return list(zip(pieces, self._is_some_upto_count(count, len(pieces))))

    def rsplit(self, a: FheString, pat):
        """Fields in reverse order, matches chosen right-to-left."""
        if isinstance(pat, FheString):
            return self.rsplit_enc(a, pat)
        if not a.chars:
            return [(FheString([], padded=True), self._true())]
        if len(pat) == 0:
            return list(reversed(self._split_empty_pattern(a)))
        active = self._active_matches(a, pat, rightward=True)
        pieces, _, count = self._fields_from_matches(a, active, len(pat), False)
        return self._reverse_by_count(pieces, count)

    def _reverse_by_count(self, pieces: list, count: RadixCiphertext):
        """piece'_k = piece_(count - k): oblivious reverse indexing."""
        mf = len(pieces)
        count_eq = [self.sk.scalar_eq_parallelized(count, j) for j in range(mf)]
        nb = pieces[0].chars[0].num_blocks if pieces[0].chars else 1
        n = pieces[0].max_len
        out = []
        for k in range(mf):
            sel = [self.sk.create_trivial_radix(0, nb) for _ in range(n)]
            for j in range(k, mf):
                src = pieces[j - k]
                sel = [self.sk.if_then_else_parallelized(count_eq[j], s, c)
                       for s, c in zip(src.chars, sel)]
            out.append((FheString(sel, padded=True),
                        self.sk.scalar_ge_parallelized(count, k)))
        return out

    def splitn(self, a: FheString, limit: int, pat):
        """At most `limit` pieces; the last keeps the remaining separators."""
        if isinstance(pat, FheString):
            return self.splitn_enc(a, limit, pat)
        if not a.chars or limit <= 0:
            return [(FheString([c.copy() for c in a.chars], padded=True),
                     self._true() if limit > 0 else self._false())]
        if len(pat) == 0:
            full = self._split_empty_pattern(a)
            return full[:limit]
        active = self._active_matches(a, pat, rightward=False)
        active = self._limit_matches(active, limit - 1, rightward=False)
        pieces, _, count = self._fields_from_matches(a, active, len(pat), False)
        flags = self._is_some_upto_count(count, len(pieces))
        return list(zip(pieces, flags))[:limit]

    def rsplitn(self, a: FheString, limit: int, pat: str):
        if not a.chars or limit <= 0:
            return [(FheString([c.copy() for c in a.chars], padded=True),
                     self._true() if limit > 0 else self._false())]
        if len(pat) == 0:
            return self._rsplit_empty_pattern(a)[:limit]
        active = self._active_matches(a, pat, rightward=True)
        active = self._limit_matches(active, limit - 1, rightward=True)
        pieces, _, count = self._fields_from_matches(a, active, len(pat), False)
        return self._reverse_by_count(pieces, count)[:limit]

    def split_once(self, a: FheString, pat):
        """(lhs, rhs, found): text before/after the FIRST match."""
        parts = self.splitn(a, 2, pat)
        found = self.contains(a, pat)
        lhs = parts[0][0]
        rhs = (parts[1][0] if len(parts) > 1
               else FheString([], padded=True))
        return lhs, rhs, found

    def rsplit_once(self, a: FheString, pat):
        """(lhs, rhs, found): around the LAST match (rhs first in Rust's
        return order is (before, after) — we return before, after)."""
        parts = self.rsplitn(a, 2, pat)
        found = self.contains(a, pat)
        rhs = parts[0][0]
        lhs = (parts[1][0] if len(parts) > 1
               else FheString([], padded=True))
        return lhs, rhs, found

    def split_terminator(self, a: FheString, pat: str):
        """Like split but a trailing empty field is dropped."""
        if not a.chars:
            return []
        if len(pat) == 0:
            out = self._split_empty_pattern(a)[:-1]
            # drop the trailing empty: char slots need k-1 < len (strict)
            nbi = self._idx_blocks(a.max_len + 2)
            la = self.sk.cast_to_unsigned(self.len_(a), nbi)
            return [(out[0][0], out[0][1])] + [
                (p, self.sk.scalar_gt_parallelized(la, k - 1))
                for k, (p, _) in enumerate(out[1:], start=1)]
        active = self._active_matches(a, pat, rightward=False)
        pieces, nonempty, count = self._fields_from_matches(
            a, active, len(pat), False)
        flags = []
        for k in range(len(pieces)):
            lt = self.sk.scalar_gt_parallelized(count, k)  # k < count
            last_ok = self.sk.boolean_and(
                self.sk.scalar_eq_parallelized(count, k), nonempty[k])
            flags.append(self.sk.boolean_or(lt, last_ok))
        return list(zip(pieces, flags))

    def rsplit_terminator(self, a: FheString, pat: str):
        if not a.chars:
            return []
        if len(pat) == 0:
            return list(reversed(self.split_terminator(a, pat)))
        active = self._active_matches(a, pat, rightward=True)
        pieces, nonempty, count = self._fields_from_matches(
            a, active, len(pat), False)
        rev = self._reverse_by_count(pieces, count)
        # drop the (now first) trailing-empty field by shifting flags:
        # piece'_0 is the last field — present only if nonempty; later
        # pieces follow split-terminator logic reversed
        out = []
        ne_rev = self._reverse_by_count(
            [FheString([self._bool_radix(nev, 1)], padded=False)
             for nev in nonempty], count)
        for k, (piece, some) in enumerate(rev):
            ne_k = BooleanBlock(ne_rev[k][0].chars[0].blocks[0])
            if k == 0:
                out.append((piece, self.sk.boolean_and(some, ne_k)))
            else:
                out.append((piece, some))
        return out

    def split_inclusive(self, a: FheString, pat):
        """Fields keep their trailing separator; no trailing empty field."""
        if isinstance(pat, FheString):
            return self.split_inclusive_enc(a, pat)
        if not a.chars:
            return []
        assert len(pat) > 0, "split_inclusive needs a non-empty pattern"
        active = self._active_matches(a, pat, rightward=False)
        pieces, nonempty, count = self._fields_from_matches(
            a, active, len(pat), True)
        flags = []
        for k in range(len(pieces)):
            lt = self.sk.scalar_gt_parallelized(count, k)
            last_ok = self.sk.boolean_and(
                self.sk.scalar_eq_parallelized(count, k), nonempty[k])
            flags.append(self.sk.boolean_or(lt, last_ok))
        return list(zip(pieces, flags))

    def split_ascii_whitespace(self, a: FheString):
        """Maximal non-whitespace runs (empty pieces never yielded)."""
        n = a.max_len
        if n == 0:
            return []
        nb = a.chars[0].num_blocks
        nbi = self._idx_blocks(n + 1)
        ws = []
        for c in a.chars:
            w = self._is_whitespace(c)
            z = self._char_eq_clear(c, 0)
            ws.append(self.sk.boolean_or(w, z))
        starts = []
        for i in range(n):
            nw = self.sk.boolean_not(ws[i])
            if i == 0:
                starts.append(nw)
            else:
                starts.append(self.sk.boolean_and(nw, ws[i - 1]))
        runord = []
        acc = self.sk.create_trivial_radix(0, nbi)
        for i in range(n):
            runord.append(acc)
            acc = self.sk.add_parallelized(acc, self._bool_radix(starts[i], nbi))
        total = acc
        zero_char = self.sk.create_trivial_radix(0, nb)
        max_runs = (n + 1) // 2
        out = []
        for k in range(max_runs):
            masked = []
            for i in range(n):
                # char i belongs to run k: not ws and (runord[i+1]... the run
                # index of char i is runord[i] + started(i) - 1 = count of
                # starts at positions <= i, minus one
                fid_i = self.sk.add_parallelized(
                    runord[i], self._bool_radix(starts[i], nbi))
                in_k = self.sk.boolean_and(
                    self.sk.boolean_not(ws[i]),
                    self.sk.scalar_eq_parallelized(fid_i, k + 1))
                masked.append(self.sk.if_then_else_parallelized(
                    in_k, a.chars[i], zero_char))
            start = self.sk.create_trivial_radix(0, nbi)
            for i in range(n):
                gate = self.sk.boolean_and(
                    starts[i], self.sk.scalar_eq_parallelized(runord[i], k))
                start = self.sk.add_parallelized(
                    start, self.sk.if_then_else_parallelized(
                        gate, self.sk.create_trivial_radix(i, nbi),
                        self.sk.create_trivial_radix(0, nbi)))
            aligned = self._barrel_shift_left_chars(masked, start, n)
            out.append((FheString(aligned, padded=True),
                        self.sk.scalar_gt_parallelized(total, k)))
        return out

    # ------------------------------------------------------------------
    # encrypted-pattern (GenericPatternRef::Enc) support
    # (pattern/replace.rs:89-98, pattern/split/mod.rs:101,177)
    # ------------------------------------------------------------------
    # The clear-pattern family above exploits the statically-known pattern
    # width; with a hidden-length FheString pattern every advance becomes an
    # encrypted quantity, so these methods use the reference's ITERATIVE
    # structure instead: each round is one find + barrel-shift splice, with
    # every round's result gated by "were there still matches".

    def _enc_pat_len(self, pat: FheString, nbi: int) -> RadixCiphertext:
        """Hidden length of an encrypted pattern as an nbi-block radix."""
        if not pat.padded:
            return self.sk.create_trivial_radix(pat.max_len, nbi)
        return self.sk.cast_to_unsigned(self.len_(pat), nbi)

    def _mask_prefix(self, chars: list, upto: RadixCiphertext,
                     keep_all: BooleanBlock | None = None) -> list:
        """chars[i] kept where i < upto (or keep_all), else nul."""
        nb = chars[0].num_blocks if chars else 1
        zero = self.sk.create_trivial_radix(0, nb)
        out = []
        for i, c in enumerate(chars):
            keep = self.sk.scalar_gt_parallelized(upto, i)    # upto > i
            if keep_all is not None:
                keep = self.sk.boolean_or(keep, keep_all)
            out.append(self.sk.if_then_else_parallelized(keep, c, zero))
        return out

    def replacen(self, a: FheString, from_pat, to_pat, count=None) -> FheString:
        """Replace up to `count` (clear int, encrypted radix, or None = all)
        non-overlapping left-to-right matches of `from_pat` (str or
        FheString) with `to_pat` (str or FheString).

        Mirrors pattern/replace.rs replace_n_times: per round, find the
        next match past `skip`, splice [lhs, to, rhs] with barrel shifts,
        keep the previous string once matches run out."""
        n = a.max_len
        nb = a.chars[0].num_blocks if a.chars else 1
        if isinstance(to_pat, str):
            to_pat = FheString(
                [self.sk.create_trivial_radix(ord(c), nb) for c in to_pat],
                padded=False)
        t = to_pat.max_len
        from_enc = not isinstance(from_pat, str)
        p_max = from_pat.max_len if from_enc else len(from_pat)
        # max possible matches: empty pattern matches n+1 boundaries
        max_iters = n + 1 if (from_enc or len(from_pat) == 0) \
            else (n // max(len(from_pat), 1) if len(from_pat) else n + 1)
        if isinstance(count, int):
            max_iters = min(max_iters, count)
        if max_iters <= 0 or n == 0:
            return FheString([c.copy() for c in a.chars], a.padded)

        cap = n + max_iters * t            # provable content bound
        nbi = self._idx_blocks(cap + p_max + 2)
        if from_enc:
            lp = self._enc_pat_len(from_pat, nbi)
            from_empty = (self.sk.scalar_eq_parallelized(lp, 0)
                          if from_pat.padded else
                          (self._true() if from_pat.max_len == 0
                           else self._false()))
        else:
            lp = self.sk.create_trivial_radix(len(from_pat), nbi)
            from_empty = self._true() if not from_pat else self._false()
        lt = (self.sk.cast_to_unsigned(self.len_(to_pat), nbi)
              if to_pat.padded else self.sk.create_trivial_radix(t, nbi))

        result = [c.copy() for c in a.chars]
        skip = self.sk.create_trivial_radix(0, nbi)
        for i in range(max_iters):
            cur_n = len(result)
            prev = [c.copy() for c in result]
            shifted = self._barrel_shift_left_chars(result, skip, cur_n)
            found, idx = self.find(FheString(shifted, padded=True), from_pat)
            idx = self.sk.cast_to_unsigned(idx, nbi)
            index = self.sk.add_parallelized(idx, skip)
            # lhs: right-shift by (cur_n - index) then append `to`, shift back
            shift_r = self.sk.sub_parallelized(
                self.sk.create_trivial_radix(cur_n, nbi), index)
            lhs = self._barrel_shift_right_chars(result, shift_r, cur_n)
            spliced = lhs + [c.copy() for c in to_pat.chars]
            spliced = self._barrel_shift_left_chars(
                spliced, shift_r, len(spliced))
            # rhs: left-shift by index + len(from)
            shift_l = self.sk.add_parallelized(index, lp)
            rhs = self._barrel_shift_left_chars(result, shift_l, cur_n)
            # concat spliced (content = index + len(to)) with rhs
            insert_at = self.sk.add_parallelized(index, lt)
            new_n = min(cur_n + t, cap)
            zero = self.sk.create_trivial_radix(0, nb)
            spliced = (spliced + [zero] * (new_n - len(spliced)))[:new_n]
            rhs_ext = (rhs + [zero] * (new_n - len(rhs)))[:new_n]
            rhs_sh = self._barrel_shift_right_chars(rhs_ext, insert_at, new_n)
            merged = [self.sk.bitor_parallelized(x, y)
                      for x, y in zip(spliced, rhs_sh)]
            # no more matches: NOT found, or empty-from exhausted, or count
            stop = self.sk.boolean_not(found)
            if count is not None and not isinstance(count, int):
                exceeded = self.sk.scalar_le_parallelized(
                    self.sk.cast_to_unsigned(count, nbi), i)
                stop = self.sk.boolean_or(stop, exceeded)
            prev_ext = (prev + [zero] * (new_n - len(prev)))[:new_n]
            result = [self.sk.if_then_else_parallelized(stop, pc, mc)
                      for pc, mc in zip(prev_ext, merged)]
            # skip past the replacement; +1 when `from` is empty so the next
            # round advances to the next boundary (replace.rs:144-153)
            new_skip = self.sk.add_parallelized(index, lt)
            new_skip = self.sk.add_parallelized(
                new_skip, self._bool_radix(from_empty, nbi))
            skip = self.sk.if_then_else_parallelized(stop, skip, new_skip)
        return FheString(result, padded=True)

    def _split_iter_enc(self, a: FheString, pat: FheString, max_fields: int,
                        inclusive: bool = False, limit: int | None = None):
        """Iterative split with an encrypted pattern: successive find +
        mask + shift rounds.  Returns list of (piece, is_some)."""
        n = a.max_len
        nbi = self._idx_blocks(n + pat.max_len + 2)
        lp = self._enc_pat_len(pat, nbi)
        lp1 = self.sk.if_then_else_parallelized(      # empty pat advances 1
            self.sk.scalar_eq_parallelized(lp, 0),
            self.sk.create_trivial_radix(1, nbi), lp)
        remaining = [c.copy() for c in a.chars]
        alive = self._true()
        out = []
        for k in range(max_fields):
            is_last = (k == max_fields - 1) or (
                limit is not None and k == limit - 1)
            rem_s = FheString([c.copy() for c in remaining], padded=True)
            found, idx = self.find(rem_s, pat)
            idx = self.sk.cast_to_unsigned(idx, nbi)
            if is_last:
                piece = rem_s            # last field keeps the whole rest
            else:
                upto = (self.sk.add_parallelized(idx, lp) if inclusive
                        else idx)
                piece = FheString(
                    self._mask_prefix(remaining, upto,
                                      keep_all=self.sk.boolean_not(found)),
                    padded=True)
            out.append((piece, alive))
            if is_last:
                break
            advance = self.sk.add_parallelized(idx, lp1)
            remaining = self._barrel_shift_left_chars(remaining, advance, n)
            # once no match remains, later fields are None
            alive = self.sk.boolean_and(alive, found)
        return out

    def split_enc(self, a: FheString, pat: FheString):
        """split with an encrypted pattern.  An encrypted-empty pattern is
        handled by selecting between the boundary form and the iterative
        form per field (Rust `split("")` semantics, hidden obliviously)."""
        if not a.chars:
            return [(FheString([], padded=True), self._true())]
        n = a.max_len
        max_fields = n + 2                  # "" split yields n+2 fields max
        it = self._split_iter_enc(a, pat, max_fields)
        if not pat.padded and pat.max_len > 0:
            return it[:n + 1]
        emp = self._split_empty_pattern(a)
        nbi = self._idx_blocks(n + pat.max_len + 2)
        is_empty = (self._true() if pat.max_len == 0 else
                    self.sk.scalar_eq_parallelized(
                        self._enc_pat_len(pat, nbi), 0))
        out = []
        nb = a.chars[0].num_blocks
        for k in range(max_fields):
            pe, se = emp[k] if k < len(emp) else (
                FheString([], padded=True), self._false())
            pi, si = it[k] if k < len(it) else (
                FheString([], padded=True), self._false())
            w = max(pe.max_len, pi.max_len)
            zero = self.sk.create_trivial_radix(0, nb)
            ce = pe.chars + [zero] * (w - pe.max_len)
            ci = pi.chars + [zero] * (w - pi.max_len)
            chars = [self.sk.if_then_else_parallelized(is_empty, x, y)
                     for x, y in zip(ce, ci)]
            some = BooleanBlock(self.sk.if_then_else_parallelized(
                is_empty, self._bool_radix(se, 1),
                self._bool_radix(si, 1)).blocks[0])
            out.append((FheString(chars, padded=True), some))
        return out

    def splitn_enc(self, a: FheString, limit: int, pat: FheString):
        if not a.chars or limit <= 0:
            return [(FheString([c.copy() for c in a.chars], padded=True),
                     self._true() if limit > 0 else self._false())]
        return self._split_iter_enc(a, pat, min(a.max_len + 2, limit),
                                    limit=limit)

    def split_inclusive_enc(self, a: FheString, pat: FheString):
        if not a.chars:
            return []
        out = self._split_iter_enc(a, pat, a.max_len + 1, inclusive=True)
        # no trailing empty field: last piece present only when nonempty
        trimmed = []
        for k, (piece, some) in enumerate(out):
            ne = self.sk.boolean_or_many(
                [self.sk.scalar_ne_parallelized(c, 0) for c in piece.chars]
            ) if piece.chars else self._false()
            trimmed.append((piece, self.sk.boolean_and(some, ne)))
        return trimmed

    def rsplit_enc(self, a: FheString, pat: FheString):
        """rsplit with an encrypted pattern: iterate from the right with
        rfind; no barrel shifts needed (truncate-by-mask instead)."""
        if not a.chars:
            return [(FheString([], padded=True), self._true())]
        n = a.max_len
        max_fields = n + 2
        nbi = self._idx_blocks(n + pat.max_len + 2)
        lp = self._enc_pat_len(pat, nbi)
        remaining = [c.copy() for c in a.chars]
        alive = self._true()
        out = []
        for k in range(max_fields):
            rem_s = FheString([c.copy() for c in remaining], padded=True)
            found, idx = self.rfind(rem_s, pat)
            idx = self.sk.cast_to_unsigned(idx, nbi)
            if k == max_fields - 1:
                out.append((rem_s, alive))
                break
            # piece = chars after the match: shift left by idx + lp
            start = self.sk.add_parallelized(idx, lp)
            tail = self._barrel_shift_left_chars(
                [c.copy() for c in remaining], start, n)
            nb = a.chars[0].num_blocks
            zero = self.sk.create_trivial_radix(0, nb)
            piece = [self.sk.if_then_else_parallelized(found, c, r)
                     for c, r in zip(tail, remaining)]
            out.append((FheString(piece, padded=True), alive))
            # truncate remaining to [0, idx)
            remaining = self._mask_prefix(remaining, idx)
            alive = self.sk.boolean_and(alive, found)
        return out

    def strip_prefix_enc(self, a: FheString, pat: FheString):
        """(stripped, found) with an encrypted pattern: barrel-shift left by
        the hidden pattern length when it matches (pattern/strip.rs Enc)."""
        found = self.starts_with(a, pat)
        n = a.max_len
        if n == 0:
            return FheString([], padded=True), found
        nbi = self._idx_blocks(n + pat.max_len + 2)
        lp = self._enc_pat_len(pat, nbi)
        shifted = self._barrel_shift_left_chars(
            [c.copy() for c in a.chars], lp, n)
        out = [self.sk.if_then_else_parallelized(found, s, c)
               for s, c in zip(shifted, a.chars)]
        return FheString(out, padded=True), found

    def strip_suffix_enc(self, a: FheString, pat: FheString):
        """(stripped, found) — removes the hidden-length suffix."""
        found = self.ends_with(a, pat)
        n = a.max_len
        if n == 0:
            return FheString([], padded=True), found
        nb = a.chars[0].num_blocks
        nbi = self._idx_blocks(n + pat.max_len + 2)
        la = self.sk.cast_to_unsigned(self.len_(a), nbi)
        lp = self._enc_pat_len(pat, nbi)
        thresh = self.sk.sub_parallelized(la, lp)   # gated by `found` below
        zero = self.sk.create_trivial_radix(0, nb)
        out = []
        for i in range(n):
            past = self.sk.scalar_le_parallelized(thresh, i)
            kill = self.sk.boolean_and(found, past)
            out.append(self.sk.if_then_else_parallelized(kill, zero,
                                                         a.chars[i]))
        return FheString(out, padded=True), found
