"""Cross-op round-coalescing scheduler (port of
tfhe_tpu/integer/scheduler.py).

The single-op integer layer already batches every PBS round of ONE op, but
a lone op's rounds are small batches that leave most of the card idle.
This module runs the SAME op over MANY independent ciphertext tuples with
every internal PBS round coalesced across the whole set (the analog of the
HPU's batch-of-12 pipelining, and what FheUintArray / sort / KVStore sit
on).  The grouping of independent tables into one batch is tfhe_tpu's,
round for round, so the blocks are its words.

All *_many functions take the integer ServerKey as first argument and lists
of equal-width operands; every `_apply` call inside spans all items.
"""

from __future__ import annotations

from .ciphertext import BooleanBlock, RadixCiphertext


def _propagate_carries_many(sk, items: list) -> list:
    """Carry-propagate many block-lists at once (each value in [0, 2*msg-1]).

    items: list of lists of blocks, all the same length n.  The Hillis-
    Steele scan runs its log2(n)+3 rounds ONCE with every item's blocks in
    the same batch.  Returns the list of clean block-lists.
    """
    if not items:
        return []
    n = len(items[0])
    assert all(len(s) == n for s in items), "coalesced items must share width"
    msg = sk.msg
    m = len(items)
    if n == 1:
        flat = [s[0] for s in items]
        out = sk._apply(flat, sk._lut("msg_extract", lambda x: x % msg))
        return [[o] for o in out]

    state_lut = sk._lut(
        "gp_state", lambda x: (2 if x % (2 * msg) == msg - 1 else 0)
        + (1 if x % (2 * msg) >= msg else 0))
    flat = [b for s in items for b in s]
    e_flat = sk._apply(flat, state_lut)
    e = [e_flat[i * n:(i + 1) * n] for i in range(m)]

    def combine(hi, lo):
        g_hi, p_hi = hi & 1, hi >> 1
        g_lo, p_lo = lo & 1, lo >> 1
        return 2 * (p_hi & p_lo) + (g_hi | (p_hi & g_lo))

    comb_lut = sk._biv_lut("gp_combine", combine)
    shift = 1
    while shift < n:
        packed = [sk._pack(e[it][i], e[it][i - shift])
                  for it in range(m) for i in range(shift, n)]
        combined = sk._apply(packed, comb_lut)
        w = n - shift
        e = [e[it][:shift] + combined[it * w:(it + 1) * w] for it in range(m)]
        shift *= 2

    carries_flat = sk._apply([b for s in e for b in s],
                             sk._lut("g_bit", lambda x: x & 1))
    carries = [carries_flat[i * n:(i + 1) * n] for i in range(m)]
    out_in = []
    for it in range(m):
        out_in.append(items[it][0])
        out_in.extend(sk.key.unchecked_add(items[it][i], carries[it][i - 1])
                      for i in range(1, n))
    out_flat = sk._apply(out_in, sk._lut("msg_extract", lambda x: x % msg))
    return [out_flat[i * n:(i + 1) * n] for i in range(m)]


def add_many_parallelized(sk, pairs: list) -> list:
    """[(a, b), ...] -> [a+b, ...] with all carry rounds coalesced."""
    if not pairs:
        return []
    pairs = [(sk._cleaned(a), sk._cleaned(b)) for a, b in pairs]
    sums = [[sk.key.unchecked_add(x, y) for x, y in zip(a.blocks, b.blocks)]
            for a, b in pairs]
    outs = _propagate_carries_many(sk, sums)
    return [sk._result_like(a, b, o) for (a, b), o in zip(pairs, outs)]


def sub_many_parallelized(sk, pairs: list) -> list:
    if not pairs:
        return []
    pairs = [(sk._cleaned(a), sk._cleaned(b)) for a, b in pairs]
    states = [sk._sub_state_blocks(a, b) for a, b in pairs]
    outs = _propagate_carries_many(sk, states)
    return [sk._result_like(a, b, o) for (a, b), o in zip(pairs, outs)]


def _tree_reduce_many(sk, lists: list, comb_lut) -> list:
    """Batched tree reduction over many block lists -> one block each."""
    lists = [list(blocks) for blocks in lists]
    while any(len(b) > 1 for b in lists):
        packed, meta = [], []
        for it, blocks in enumerate(lists):
            for i in range(0, len(blocks) - 1, 2):
                packed.append(sk._pack(blocks[i], blocks[i + 1]))
                meta.append(it)
        combined = sk._apply(packed, comb_lut)
        pos = 0
        new_lists = []
        for it, blocks in enumerate(lists):
            cnt = len(blocks) // 2
            nb = combined[pos:pos + cnt]
            pos += cnt
            if len(blocks) % 2 == 1:
                nb = nb + [blocks[-1]]
            new_lists.append(nb)
        lists = new_lists
    return [b[0] for b in lists]


def cmp_state_many(sk, pairs: list) -> list:
    """3-state compares for many pairs, all rounds coalesced."""
    if not pairs:
        return []
    pairs = [(sk._cleaned(a), sk._cleaned(b)) for a, b in pairs]
    packed, counts = [], []
    for a, b in pairs:
        pk = [sk._pack(x, y) for x, y in zip(a.blocks, b.blocks)]
        packed.extend(pk)
        counts.append(len(pk))
    luts = []
    for (a, b), cnt in zip(pairs, counts):
        signed = sk._is_signed(a) or sk._is_signed(b)
        luts.extend(sk._cmp_state_luts(cnt, signed))
    states_flat = sk._apply(packed, luts)
    comb = sk._biv_lut("cmp_combine", lambda hi, lo: lo if hi == 1 else hi)
    lists, pos = [], 0
    for cnt in counts:
        lists.append(states_flat[pos:pos + cnt][::-1])
        pos += cnt
    return _tree_reduce_many(sk, lists, comb)


def _cmp_bool_many(sk, pairs, name, f):
    states = cmp_state_many(sk, pairs)
    outs = sk._apply(states, sk._lut(name, f))
    return [BooleanBlock(o) for o in outs]


def lt_many_parallelized(sk, pairs):
    return _cmp_bool_many(sk, pairs, "is_lt", lambda x: int(x == 0))


def le_many_parallelized(sk, pairs):
    return _cmp_bool_many(sk, pairs, "is_le", lambda x: int(x != 2))


def gt_many_parallelized(sk, pairs):
    return _cmp_bool_many(sk, pairs, "is_gt", lambda x: int(x == 2))


def ge_many_parallelized(sk, pairs):
    return _cmp_bool_many(sk, pairs, "is_ge", lambda x: int(x != 0))


def eq_many_parallelized(sk, pairs):
    """Block equality grid + AND-tree, coalesced across pairs."""
    if not pairs:
        return []
    pairs = [(sk._cleaned(a), sk._cleaned(b)) for a, b in pairs]
    eq_lut = sk._biv_lut("block_eq", lambda x, y: int(x == y))
    packed, counts = [], []
    for a, b in pairs:
        pk = [sk._pack(x, y) for x, y in zip(a.blocks, b.blocks)]
        packed.extend(pk)
        counts.append(len(pk))
    eqs_flat = sk._apply(packed, eq_lut)
    and_lut = sk._biv_lut("bool_and", lambda x, y: x & y & 1)
    lists, pos = [], 0
    for cnt in counts:
        lists.append(eqs_flat[pos:pos + cnt])
        pos += cnt
    return [BooleanBlock(b) for b in _tree_reduce_many(sk, lists, and_lut)]


def if_then_else_many_parallelized(sk, triples: list) -> list:
    """[(cond, a, b), ...] -> [cmux(...)...] in ONE gated-LUT round."""
    if not triples:
        return []
    triples = [(c, sk._cleaned(a), sk._cleaned(b)) for c, a, b in triples]
    keep_t = sk._biv_lut("keep_true", lambda c, x: x if (c & 1) else 0)
    keep_f = sk._biv_lut("keep_false", lambda c, x: 0 if (c & 1) else x)
    packed, luts, counts = [], [], []
    for c, a, b in triples:
        n = a.num_blocks
        packed.extend(sk._pack(c.block, x) for x in a.blocks)
        packed.extend(sk._pack(c.block, x) for x in b.blocks)
        luts.extend([keep_t] * n + [keep_f] * n)
        counts.append(n)
    outs = sk._apply(packed, luts)
    res, pos = [], 0
    for (c, a, b), n in zip(triples, counts):
        t_part = outs[pos:pos + n]
        f_part = outs[pos + n:pos + 2 * n]
        pos += 2 * n
        res.append(sk._result_like(
            a, b, [sk.key.unchecked_add(t_part[i], f_part[i])
                   for i in range(n)]))
    return res


def compare_exchange_many(sk, pairs: list, directions: list) -> list:
    """Oblivious (min,max)/(max,min) for many pairs — the bitonic-sort
    round primitive: ONE coalesced compare round + ONE coalesced cmux round
    for all n/2 exchanges of a sort stage."""
    lts = lt_many_parallelized(sk, pairs)
    triples = []
    for (a, b), lt in zip(pairs, lts):
        triples.append((lt, a, b))   # lo
        triples.append((lt, b, a))   # hi
    sel = if_then_else_many_parallelized(sk, triples)
    out = []
    for i, up in enumerate(directions):
        lo, hi = sel[2 * i], sel[2 * i + 1]
        out.append((lo, hi) if up else (hi, lo))
    return out


def compare_exchange_kv_many(sk, pairs: list, directions: list) -> list:
    """Key-value compare-exchange for many pairs: sort by KEY, carry the
    VALUE payload through the same oblivious selects — the bitonic-shuffle
    round primitive (one coalesced compare round + one coalesced cmux round
    covering keys and payloads of every exchange).

    pairs: [((ka, va), (kb, vb)), ...]; returns [((klo, vlo), (khi, vhi))]
    ordered per `directions` (True = ascending)."""
    lts = lt_many_parallelized(sk, [(ka, kb) for (ka, _), (kb, _) in pairs])
    triples = []
    for ((ka, va), (kb, vb)), lt in zip(pairs, lts):
        triples.extend([(lt, ka, kb), (lt, kb, ka),
                        (lt, va, vb), (lt, vb, va)])
    sel = if_then_else_many_parallelized(sk, triples)
    out = []
    for i, up in enumerate(directions):
        klo, khi, vlo, vhi = sel[4 * i:4 * i + 4]
        out.append((((klo, vlo), (khi, vhi))) if up
                   else (((khi, vhi), (klo, vlo))))
    return out


def sum_ciphertexts_many(sk, lists: list, num_blocks: int) -> list:
    """Carry-save multi-operand sums for MANY independent operand lists at
    once: every (msg, carry) extraction round spans all items (the
    mul-coalescing core, VERDICT r2 task 9)."""
    if not lists:
        return []
    msg = sk.msg
    m = len(lists)
    cols = [[[] for _ in range(num_blocks)] for _ in range(m)]
    for it, cts in enumerate(lists):
        for ct in cts:
            for i, blk in enumerate(ct.blocks[:num_blocks]):
                if blk.degree > 0 or blk.noise_level > 0:
                    cols[it][i].append(blk)

    def greedy_group(c):
        groups, acc = [], None
        for blk in c:
            if acc is None:
                acc = blk
            elif (acc.degree + blk.degree <= sk.key.max_degree
                  and acc.noise_level + blk.noise_level
                  <= sk.key.max_noise_level):
                acc = sk.key.unchecked_add(acc, blk)
            else:
                groups.append(acc)
                acc = blk
        if acc is not None:
            groups.append(acc)
        return groups

    done = [None] * m
    while True:
        live = [it for it in range(m) if done[it] is None]
        # finalize items whose columns are single small blocks
        for it in live:
            if (max((len(c) for c in cols[it]), default=0) <= 1
                    and all(b.degree <= 2 * msg - 1
                            for c in cols[it] for b in c)):
                done[it] = [c[0] if c else sk.key.create_trivial(0)
                            for c in cols[it]]
        live = [it for it in range(m) if done[it] is None]
        if not live:
            break
        flat, meta = [], []
        for it in live:
            grouped = [greedy_group(c) for c in cols[it]]
            if (all(len(c) <= 1 for c in grouped)
                    and all(b.degree <= 2 * msg - 1
                            for c in grouped for b in c)):
                done[it] = [c[0] if c else sk.key.create_trivial(0)
                            for c in grouped]
                continue
            for i, c in enumerate(grouped):
                for b in c:
                    flat.append(b)
                    meta.append((it, i))
        if not flat:
            continue
        msgs = sk._apply(flat, sk._lut("msg_extract", lambda x: x % msg))
        carries = sk._apply(flat, sk._lut("carry_extract", lambda x: x // msg))
        for it in live:
            if done[it] is None:
                cols[it] = [[] for _ in range(num_blocks)]
        for (it, i), mblk, cblk in zip(meta, msgs, carries):
            cols[it][i].append(mblk)
            if i + 1 < num_blocks and cblk.degree > 0:
                cols[it][i + 1].append(cblk)
    return _propagate_carries_many(sk, done)


def mul_many_parallelized(sk, pairs: list) -> list:
    """[(a, b), ...] -> [a*b, ...]: ONE bivariate block-product round for
    every partial product of every pair, then the coalesced carry-save sum
    (the per-item structure of ServerKey.mul_parallelized,
    radix_parallel/mul.rs, with the item axis folded into every batch)."""
    if not pairs:
        return []
    pairs = [(sk._cleaned(a), sk._cleaned(b)) for a, b in pairs]
    msg = sk.msg
    lsb_lut = sk._biv_lut("mul_lsb", lambda x, y: (x * y) % msg)
    msb_lut = sk._biv_lut("mul_msb", lambda x, y: (x * y) // msg)
    packed, luts, meta = [], [], []
    for it, (a, b) in enumerate(pairs):
        n = a.num_blocks
        for i in range(n):
            for j in range(n):
                if i + j < n:
                    packed.append(sk._pack(a.blocks[i], b.blocks[j]))
                    luts.append(lsb_lut)
                    meta.append((it, i + j))
                if i + j + 1 < n:
                    packed.append(sk._pack(a.blocks[i], b.blocks[j]))
                    luts.append(msb_lut)
                    meta.append((it, i + j + 1))
    prods = sk._apply(packed, luts)
    lists = []
    for it, (a, b) in enumerate(pairs):
        n = a.num_blocks
        rows_by_slot = [[] for _ in range(n)]
        for (pit, s), blk in zip(meta, prods):
            if pit == it:
                rows_by_slot[s].append(blk)
        max_terms = max(len(r) for r in rows_by_slot)
        cts = []
        for t in range(max_terms):
            blocks = [rows_by_slot[i][t] if t < len(rows_by_slot[i])
                      else sk.key.create_trivial(0) for i in range(n)]
            cts.append(RadixCiphertext(blocks))
        lists.append(cts)
    n0 = pairs[0][0].num_blocks
    assert all(a.num_blocks == n0 for a, _ in pairs), \
        "coalesced items must share width"
    outs = sum_ciphertexts_many(sk, lists, n0)
    return [sk._result_like(a, b, o) for (a, b), o in zip(pairs, outs)]


def _bitwise_many(sk, pairs: list, name: str, f) -> list:
    if not pairs:
        return []
    pairs = [(sk._cleaned(a), sk._cleaned(b)) for a, b in pairs]
    lut = sk._biv_lut(name, f)
    packed = [sk._pack(x, y) for a, b in pairs
              for x, y in zip(a.blocks, b.blocks)]
    out = sk._apply(packed, lut)
    res, pos = [], 0
    for a, b in pairs:
        n = a.num_blocks
        res.append(sk._result_like(a, b, out[pos:pos + n]))
        pos += n
    return res


def bitand_many_parallelized(sk, pairs):
    return _bitwise_many(sk, pairs, "bitand", lambda x, y: x & y)


def bitor_many_parallelized(sk, pairs):
    return _bitwise_many(sk, pairs, "bitor", lambda x, y: x | y)


def bitxor_many_parallelized(sk, pairs):
    return _bitwise_many(sk, pairs, "bitxor", lambda x, y: x ^ y)
