"""The integer (radix) layer of the port against tfhe_tpu on the CPU, word
for word (tolerance 0; all arithmetic is integer): every op runs on both
from the same seeds and inputs, and every output block must hold the same
u64 words, degree and noise level, and decrypt to the clear model.  Also
the host-materialisation counter: a chained op on lazy round outputs
downloads nothing before decrypt."""

import numpy as np
import pytest
import torch

from tfhe_tpu import integer as ref_integer
from tfhe_tpu import shortint as ref_shortint
from tfhe_tpu.integer import scheduler as ref_sched
from tfhe_tpu_torch import integer, shortint
from tfhe_tpu_torch.integer import scheduler
from tfhe_tpu_torch.shortint.ciphertext import DeviceLweBatch, LazyLweData

torch.set_num_threads(1)  # the suite runs in parallel processes: one thread each

SEED = 0x1A7E
NB = 4                   # 4 blocks x 2 bits = 8-bit integers
MOD = 4 ** NB


class Pair:
    """The same value on tfhe_tpu (``r``) and on the port (``p``)."""

    def __init__(self, r, p):
        self.r, self.p = r, p


def _blocks(ct) -> list:
    if hasattr(ct, "blocks"):
        return ct.blocks
    return [ct.block] if hasattr(ct, "block") else [ct]


def same(r, p) -> None:
    """tfhe_tpu's and the port's outputs hold the same blocks: type, u64
    words, degrees and noise levels."""
    if isinstance(r, (list, tuple)):
        assert len(r) == len(p)
        for x, y in zip(r, p):
            same(x, y)
        return
    assert type(r).__name__ == type(p).__name__
    br, bp = _blocks(r), _blocks(p)
    assert len(br) == len(bp)
    want = np.stack([np.asarray(b.data) for b in br])
    got = np.stack([np.asarray(b.data) for b in bp])
    assert got.dtype == np.uint64 and (got == want).all()
    assert [b.degree for b in bp] == [b.degree for b in br]
    assert [b.noise_level for b in bp] == [b.noise_level for b in br]


class Keys:
    def __init__(self, rck, rsk, pck, psk):
        self.rck, self.rsk, self.pck, self.psk = rck, rsk, pck, psk

    def enc(self, v: int, nb: int = NB) -> Pair:
        return Pair(self.rck.encrypt_radix(v, nb), self.pck.encrypt_radix(v, nb))

    def enc_signed(self, v: int, nb: int = NB) -> Pair:
        return Pair(self.rck.encrypt_signed_radix(v, nb), self.pck.encrypt_signed_radix(v, nb))

    def enc_bool(self, v: bool) -> Pair:
        return Pair(self.rck.encrypt_bool(v), self.pck.encrypt_bool(v))

    def run(self, name: str, *args):
        """The op on both keys; the outputs checked block for block."""
        r = getattr(self.rsk, name)(*[a.r if isinstance(a, Pair) else a for a in args])
        p = getattr(self.psk, name)(*[a.p if isinstance(a, Pair) else a for a in args])
        same(r, p)
        return Pair(r, p)

    def dec(self, out: Pair):
        """The port's decryption (the reference's must agree)."""
        ct = out.p
        if isinstance(ct, integer.BooleanBlock):
            got, want = self.pck.decrypt_bool(ct), self.rck.decrypt_bool(out.r)
        elif isinstance(ct, integer.SignedRadixCiphertext):
            got, want = self.pck.decrypt_signed_radix(ct), self.rck.decrypt_signed_radix(out.r)
        else:
            got, want = self.pck.decrypt_radix(ct), self.rck.decrypt_radix(out.r)
        assert got == want
        return got


@pytest.fixture(scope="module")
def keys():
    rck, rsk = ref_integer.gen_keys(ref_shortint.TEST_PARAM_MESSAGE_2_CARRY_2, seed=SEED)
    pck, psk = integer.gen_keys(shortint.TEST_PARAM_MESSAGE_2_CARRY_2, seed=SEED,
                                device="cpu")
    return Keys(rck, rsk, pck, psk)


def test_encrypt_radix_matches(keys):
    a = keys.enc(201)
    same(a.r, a.p)
    assert keys.dec(a) == 201
    s = keys.enc_signed(-77)
    same(s.r, s.p)
    assert keys.dec(s) == -77


A, B = 201, 183          # every block pair carries on add and borrows on sub

BINARY = {
    "add_parallelized": lambda x, y: (x + y) % MOD,
    "sub_parallelized": lambda x, y: (x - y) % MOD,
    "mul_parallelized": lambda x, y: (x * y) % MOD,
    "bitand_parallelized": lambda x, y: x & y,
    "bitor_parallelized": lambda x, y: x | y,
    "bitxor_parallelized": lambda x, y: x ^ y,
    "eq_parallelized": lambda x, y: x == y,
    "lt_parallelized": lambda x, y: x < y,
    "gt_parallelized": lambda x, y: x > y,
    "min_parallelized": min,
    "max_parallelized": max,
}


@pytest.mark.parametrize("op", sorted(BINARY))
def test_binary_op_matches(keys, op):
    out = keys.run(op, keys.enc(A), keys.enc(B))
    assert keys.dec(out) == BINARY[op](A, B)


def test_eq_of_equal_values(keys):
    out = keys.run("eq_parallelized", keys.enc(77), keys.enc(77))
    assert keys.dec(out) is True


def test_overflowing_add_matches(keys):
    out = keys.run("overflowing_add_parallelized", keys.enc(A), keys.enc(B))
    s, carry = Pair(out.r[0], out.p[0]), Pair(out.r[1], out.p[1])
    assert (keys.dec(s), keys.dec(carry)) == ((A + B) % MOD, A + B >= MOD)


SCALAR = {
    "scalar_add_parallelized": (200, lambda x, s: (x + s) % MOD),
    "scalar_sub_parallelized": (200, lambda x, s: (x - s) % MOD),
    "scalar_mul_parallelized": (5, lambda x, s: (x * s) % MOD),
    "scalar_left_shift_parallelized": (3, lambda x, s: (x << s) % MOD),
    "scalar_right_shift_parallelized": (3, lambda x, s: x >> s),
}


@pytest.mark.parametrize("op", sorted(SCALAR))
def test_scalar_op_matches(keys, op):
    scalar, f = SCALAR[op]
    out = keys.run(op, keys.enc(123), scalar)
    assert keys.dec(out) == f(123, scalar)


def test_neg_and_bitnot_match(keys):
    assert keys.dec(keys.run("neg_parallelized", keys.enc(100))) == (-100) % MOD
    assert keys.dec(keys.run("bitnot", keys.enc(100))) == (~100) % MOD


def test_if_then_else_matches(keys):
    for cond in (True, False):
        out = keys.run("if_then_else_parallelized", keys.enc_bool(cond), keys.enc(A),
                       keys.enc(B))
        assert keys.dec(out) == (A if cond else B)


def test_full_propagate_matches(keys):
    """Dirty blocks (an unchecked add) through full_propagate."""
    a, b = keys.enc(A), keys.enc(B)
    dirty = Pair(keys.rsk.unchecked_add(a.r, b.r), keys.psk.unchecked_add(a.p, b.p))
    same(dirty.r, dirty.p)
    assert keys.dec(keys.run("full_propagate", dirty)) == (A + B) % MOD


SIGNED = {
    "add_parallelized": lambda x, y: x + y,
    "mul_parallelized": lambda x, y: x * y,
    "lt_parallelized": lambda x, y: x < y,
}


def _wrap_signed(v: int) -> int:
    v %= MOD
    return v - MOD if v >= MOD // 2 else v


@pytest.mark.parametrize("op", sorted(SIGNED))
def test_signed_op_matches(keys, op):
    x, y = -77, 45
    out = keys.run(op, keys.enc_signed(x), keys.enc_signed(y))
    want = SIGNED[op](x, y)
    assert keys.dec(out) == (want if isinstance(want, bool) else _wrap_signed(want))


def test_signed_abs_matches(keys):
    assert keys.dec(keys.run("abs_parallelized", keys.enc_signed(-77))) == 77


def test_casts_match(keys):
    """Signed cast growing (sign extension), unsigned cast shrinking, and the
    trivial-zero extension of the FheUint8 cast path."""
    s = keys.enc_signed(-77, 2 * 2)
    assert keys.dec(keys.run("cast_to_signed", s, 6)) == -77
    assert keys.dec(keys.run("cast_to_unsigned", s, 2)) == (-77) % 16
    u = keys.run("cast_to_signed", keys.enc(45), NB)
    ext = keys.run("extend_radix_with_trivial_zero_blocks_msb", u, 2)
    assert keys.dec(ext) == 45 and len(ext.p.blocks) == NB + 2


def test_div_rem_matches(keys):
    q, r = keys.run("div_rem_parallelized", keys.enc(13, 2), keys.enc(4, 2)).p
    assert (keys.pck.decrypt_radix(q), keys.pck.decrypt_radix(r)) == (3, 1)


def test_encrypted_shift_matches(keys):
    out = keys.run("left_shift_parallelized", keys.enc(0b10110101), keys.enc(3))
    assert keys.dec(out) == (0b10110101 << 3) % MOD


@pytest.mark.parametrize("op,f", [("count_ones_parallelized", lambda x: bin(x).count("1")),
                                  ("leading_zeros_parallelized", lambda x: 8 - x.bit_length())])
def test_bit_counts_match(keys, op, f):
    assert keys.dec(keys.run(op, keys.enc(0b00101101))) == f(0b00101101)


def test_scalar_eq_matches(keys):
    assert keys.dec(keys.run("scalar_eq_parallelized", keys.enc(77), 77)) is True
    assert keys.dec(keys.run("scalar_eq_parallelized", keys.enc(77), 76)) is False


def test_sort_matches(keys):
    vals = [9, 2, 14]
    cts = [keys.enc(v, 2) for v in vals]
    r = keys.rsk.sort_parallelized([c.r for c in cts])
    p = keys.psk.sort_parallelized([c.p for c in cts])
    same(r, p)
    assert [keys.pck.decrypt_radix(c) for c in p] == sorted(vals)


SCHEDULED = {
    "add_many_parallelized": lambda x, y: (x + y) % MOD,
    "mul_many_parallelized": lambda x, y: (x * y) % MOD,
    "eq_many_parallelized": lambda x, y: x == y,
}


def _pbs_counts(keys):
    return keys.rsk.key.pbs_count, keys.psk.key.pbs_count


@pytest.mark.parametrize("op", sorted(SCHEDULED) + ["if_then_else_many_parallelized"])
def test_scheduler_matches_with_pbs_count(keys, op):
    """Three items coalesced into every round; the same PBS count a call."""
    vals = [(A, B), (7, 7), (255, 3)]
    pairs = [(keys.enc(x), keys.enc(y)) for x, y in vals]
    if op == "if_then_else_many_parallelized":
        conds = [keys.enc_bool(c) for c in (True, False, True)]
        r_args = [(c.r, a.r, b.r) for c, (a, b) in zip(conds, pairs)]
        p_args = [(c.p, a.p, b.p) for c, (a, b) in zip(conds, pairs)]
        want = [x if c else y for c, (x, y) in zip((True, False, True), vals)]
    else:
        r_args = [(a.r, b.r) for a, b in pairs]
        p_args = [(a.p, b.p) for a, b in pairs]
        want = [SCHEDULED[op](x, y) for x, y in vals]
    before = _pbs_counts(keys)
    r = getattr(ref_sched, op)(keys.rsk, r_args)
    p = getattr(scheduler, op)(keys.psk, p_args)
    after = _pbs_counts(keys)
    same(r, p)
    assert after[0] - before[0] == after[1] - before[1] > 0
    assert [keys.dec(Pair(x, y)) for x, y in zip(r, p)] == want


def test_crt_add_mul_match(keys):
    moduli = [2, 3]
    r = [keys.rck.encrypt_crt(v, moduli) for v in (5, 4)]
    p = [keys.pck.encrypt_crt(v, moduli) for v in (5, 4)]
    for op, f in (("add_crt_parallelized", lambda x, y: x + y),
                  ("mul_crt_parallelized", lambda x, y: x * y)):
        ro, po = getattr(keys.rsk, op)(*r), getattr(keys.psk, op)(*p)
        same(ro, po)
        assert keys.pck.decrypt_crt(po) == keys.rck.decrypt_crt(ro) == f(5, 4) % 6


def test_modulus_switched_radix_matches(keys):
    """switch_modulus_and_compress stores the same bytes; decompress gives
    the same words and the value."""
    a = keys.run("mul_parallelized", keys.enc(A), keys.enc(3))
    rc = keys.rsk.switch_modulus_and_compress(a.r)
    pc = keys.psk.switch_modulus_and_compress(a.p)
    assert [(c.packed == d.packed).all() for c, d in zip(rc.blocks, pc.blocks)] == [True] * NB
    assert keys.dec(keys.run("decompress", Pair(rc, pc))) == (A * 3) % MOD


def test_chained_ops_download_nothing_before_decrypt(keys):
    """A chain of adds and a sub on lazy round outputs: every round gathers
    its inputs on the device, no batch is downloaded until decrypt."""
    a, b = keys.enc(A), keys.enc(B)
    before = DeviceLweBatch.downloads
    s = keys.psk.add_parallelized(a.p, b.p)
    s = keys.psk.add_parallelized(s, keys.psk.mul_parallelized(s, b.p))
    s = keys.psk.sub_parallelized(s, a.p)
    assert all(isinstance(blk.data, LazyLweData) for blk in s.blocks)
    assert DeviceLweBatch.downloads == before
    assert keys.pck.decrypt_radix(s) == ((A + B) * (1 + B) - A) % MOD
    assert DeviceLweBatch.downloads > before
