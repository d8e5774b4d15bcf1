"""The port's encrypted strings against tfhe_tpu's on the CPU, word for
word (tolerance 0): every StringServerKey method runs on both from the same
keys and inputs, and every output block must hold the same u64 words,
degree and noise level, and decrypt to Python's str result.

The string layer is host orchestration over the integer layer (tested
block for block at the TEST set in test_torch_integer.py): its parity is
that of its calls and their order.  A 2-3 character op is 30 to 700
rounds, so the keys here are the TEST set cut to n = 2, N = 64, where a
round costs a few milliseconds on both packages (the same message and
carry moduli, decomposition and noise; the modulus switch's error stays
below 3 x 2^56 < Delta / 2, so every output decrypts)."""

import dataclasses

import numpy as np
import pytest
import torch

from tfhe_tpu import integer as ref_integer
from tfhe_tpu import shortint as ref_shortint
from tfhe_tpu.strings import ciphertext as ref_sc
from tfhe_tpu.strings import server_key as ref_ssk
from tfhe_tpu_torch import integer, shortint, strings
from tfhe_tpu_torch.strings import ciphertext as sc

torch.set_num_threads(1)  # the suite runs in parallel processes: one thread each

SEED = 0x57C


def _params(mod):
    return dataclasses.replace(mod.TEST_PARAM_MESSAGE_2_CARRY_2, lwe_dimension=2,
                               polynomial_size=64)


def _blocks(x) -> list:
    if hasattr(x, "blocks"):
        return x.blocks
    return [x.block] if hasattr(x, "block") else [x]


def same(r, p) -> None:
    """The same blocks: strings char by char (and their padded flag),
    booleans, radix integers, and tuples or lists of them."""
    if isinstance(r, (list, tuple)):
        assert type(r) is type(p) and len(r) == len(p)
        for x, y in zip(r, p):
            same(x, y)
        return
    assert type(r).__name__ == type(p).__name__
    if hasattr(r, "chars"):
        assert r.padded == p.padded
        same(list(r.chars), list(p.chars))
        return
    br, bp = _blocks(r), _blocks(p)
    assert len(br) == len(bp)
    got = np.stack([np.asarray(b.data) for b in bp])
    assert got.dtype == np.uint64 and (got == np.stack([np.asarray(b.data) for b in br])).all()
    assert [b.degree for b in bp] == [b.degree for b in br]
    assert [b.noise_level for b in bp] == [b.noise_level for b in br]


class Keys:
    def __init__(self):
        self.rck, rsk = ref_integer.gen_keys(_params(ref_shortint), seed=SEED)
        self.pck, psk = integer.gen_keys(_params(shortint), seed=SEED, device="cpu")
        self.r, self.p = ref_ssk.StringServerKey(rsk), strings.StringServerKey(psk)

    def run(self, fn):
        """fn(string key, encrypt) on tfhe_tpu's keys, then on the port's
        (encrypt(s, padding=0) encrypts a str); the outputs checked block
        for block; returns the port's output decrypted."""
        r = fn(self.r, lambda s, pad=0: ref_sc.encrypt_string(self.rck, s, pad))
        p = fn(self.p, lambda s, pad=0: sc.encrypt_string(self.pck, s, pad))
        same(r, p)
        got, want = self.dec(p, self.pck, sc), self.dec(r, self.rck, ref_sc)
        assert got == want
        return got

    @classmethod
    def dec(cls, x, ck, mod):
        """Strings to str, booleans to bool, integers to int; a split's
        (field, is_some) list to the fields that are there."""
        if hasattr(x, "chars"):
            return mod.decrypt_string(ck, x)
        if isinstance(x, list):
            return [cls.dec(f, ck, mod) for f, some in x if ck.decrypt_bool(some)]
        if isinstance(x, tuple):
            return tuple(cls.dec(v, ck, mod) for v in x)
        return ck.decrypt_bool(x) if hasattr(x, "block") else ck.decrypt_radix(x)


@pytest.fixture(scope="module")
def keys():
    return Keys()


# (name, call on (key, encrypt), Python's result); inputs of 1-3 characters,
# unpadded and with hidden-length nul padding, clear and encrypted patterns
CASES = [
    ("eq", lambda k, e: k.eq(e("ab"), e("ab")), True),
    ("eq_padded", lambda k, e: k.eq(e("ab", 1), e("ab")), True),
    ("ne", lambda k, e: k.ne(e("ab"), e("ac")), True),
    ("eq_clear", lambda k, e: k.eq_clear(e("ab"), "ab"), True),
    ("len_padded", lambda k, e: k.len_(e("ab", 1)), 2),
    ("is_empty_padded", lambda k, e: k.is_empty(e("", 1)), True),
    ("to_uppercase", lambda k, e: k.to_uppercase(e("aB")), "AB"),
    ("to_lowercase", lambda k, e: k.to_lowercase(e("aB")), "ab"),
    ("eq_ignore_case", lambda k, e: k.eq_ignore_case(e("aB"), e("Ab")), True),
    ("concat", lambda k, e: k.concat(e("a"), e("b")), "ab"),
    ("concat_padded", lambda k, e: k.concat(e("a", 1), e("b")), "ab"),
    ("repeat", lambda k, e: k.repeat(e("a"), 2), "aa"),
    ("repeat_padded", lambda k, e: k.repeat(e("a", 1), 2), "aa"),
    ("contains_clear", lambda k, e: k.contains(e("ab"), "b"), True),
    ("contains_enc", lambda k, e: k.contains(e("ab"), e("c")), False),
    ("contains_enc_padded", lambda k, e: k.contains(e("ab"), e("b", 1)), True),
    ("starts_with", lambda k, e: k.starts_with(e("ab"), "a"), True),
    ("ends_with", lambda k, e: k.ends_with(e("ab"), "b"), True),
    ("ends_with_padded", lambda k, e: k.ends_with(e("ab", 1), "b"), True),
    ("find", lambda k, e: k.find(e("ab"), "b"), (True, 1)),
    ("find_enc", lambda k, e: k.find(e("ab"), e("a")), (True, 0)),
    ("rfind", lambda k, e: k.rfind(e("ab"), "b"), (True, 1)),
    ("replace_same_length", lambda k, e: k.replace(e("ab"), "b", "c"), "ac"),
    ("replace_length_changing", lambda k, e: k.replace(e("b"), "b", ""), ""),
    ("replace_enc", lambda k, e: k.replace(e("b"), e("b", 1), e("c")), "c"),
    ("trim_end", lambda k, e: k.trim_end(e("a ")), "a"),
    ("trim_start", lambda k, e: k.trim_start(e(" a")), "a"),
    ("trim", lambda k, e: k.trim(e(" a")), "a"),
    ("strip_prefix", lambda k, e: k.strip_prefix(e("ab"), "a"), ("b", True)),
    ("strip_prefix_padded", lambda k, e: k.strip_prefix(e("ab", 1), "a"), ("b", True)),
    ("strip_prefix_enc", lambda k, e: k.strip_prefix(e("ab"), e("a")), ("b", True)),
    ("strip_suffix", lambda k, e: k.strip_suffix(e("ab"), "b"), ("a", True)),
    ("strip_suffix_padded", lambda k, e: k.strip_suffix(e("ab", 1), "b"), ("a", True)),
    ("strip_suffix_enc", lambda k, e: k.strip_suffix(e("ab"), e("b")), ("a", True)),
    ("split", lambda k, e: k.split(e("a."), "."), ["a", ""]),
    ("split_enc", lambda k, e: k.split(e("."), e(".")), ["", ""]),
    ("rsplit", lambda k, e: k.rsplit(e("."), "."), ["", ""]),
    ("rsplit_enc", lambda k, e: k.rsplit(e("."), e(".")), ["", ""]),
    ("splitn", lambda k, e: k.splitn(e("."), 2, "."), ["", ""]),
    ("splitn_enc", lambda k, e: k.splitn_enc(e("."), 2, e(".")), ["", ""]),
    ("rsplitn", lambda k, e: k.rsplitn(e("."), 2, "."), ["", ""]),
    ("split_once", lambda k, e: k.split_once(e("."), "."), ("", "", True)),
    ("rsplit_once", lambda k, e: k.rsplit_once(e("."), "."), ("", "", True)),
    ("split_terminator", lambda k, e: k.split_terminator(e("."), "."), [""]),
    ("rsplit_terminator", lambda k, e: k.rsplit_terminator(e("."), "."), [""]),
    ("split_inclusive", lambda k, e: k.split_inclusive(e("."), "."), ["."]),
    ("split_inclusive_enc", lambda k, e: k.split_inclusive(e("."), e(".")), ["."]),
    ("split_ascii_whitespace", lambda k, e: k.split_ascii_whitespace(e("a ")), ["a"]),
]


@pytest.mark.parametrize("name,fn,want", CASES, ids=[c[0] for c in CASES])
def test_string_op_matches(keys, name, fn, want):
    assert keys.run(fn) == want


def test_encrypt_decrypt_roundtrip(keys):
    """Encryption is the same words, the padded flag rides along, and a
    padded string decrypts up to its first nul."""
    r = ref_sc.encrypt_string(keys.rck, "Hi", 2)
    p = sc.encrypt_string(keys.pck, "Hi", 2)
    same(r, p)
    assert p.padded and p.max_len == 4 and sc.decrypt_string(keys.pck, p) == "Hi"
