"""Squashed-noise compression of the port against tfhe_tpu on the CPU, word
for word (tolerance 0; all arithmetic is integer): the key's words from the
same seeds (keygen at the TEST compression set over a squashing key cut to
N = 64, so tfhe_tpu's row-by-row keygen stays short), from_raw_keys of
tfhe_tpu's 8-prime NTT-domain key, compress at count 1, 5 and 16 through
K6's wrapper on CPU tensors (its plain version) against tfhe_tpu's compress
on the same key, decrypt_list, the batched compress, and K6's wrapper's
shape refusals.  tfhe_tpu's compress runs with its NTT helpers compiled by
jax.jit (the same functions; eager dispatch compiles each of their
operations on its own, about 15 s more)."""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfhe_tpu.ops import ntt as ref_ntt
from tfhe_tpu.ops import server128 as ref_s128
from tfhe_tpu.shortint import noise_squashing as ref_ns
from tfhe_tpu_torch.core import torus128
from tfhe_tpu_torch.ops import kernels, ntt, server128
from tfhe_tpu_torch.shortint import noise_squashing as ns

torch.set_num_threads(1)  # the suite runs in parallel processes: one thread each

SEED = 0xC0DE
M128 = 1 << 128
# the squashing set cut to N = 64 (n = 64 input key bits) for the keygen
CUT_SQ = dataclasses.replace(ns.TEST_NOISE_SQUASHING_PARAM, polynomial_size=64)
REF_CUT_SQ = dataclasses.replace(ref_ns.TEST_NOISE_SQUASHING_PARAM, polynomial_size=64)


@contextlib.contextmanager
def compiled_reference_helpers():
    """tfhe_tpu's NTT and u128 helpers of compress, jit-compiled where they
    run on jnp (their numpy calls, the keygen's and decrypt_list's, pass
    through), restored after."""
    saved = []

    def on_jnp(fn, static):
        compiled = jax.jit(fn, static_argnums=static)
        return lambda *a: compiled(*a) if a[-1] is jnp else fn(*a)

    for mod, name, static, always in (
            (ref_s128, "signed_decompose128", (2, 3), True),
            (ref_s128, "_digit_residues128", (2,), True),
            (ref_ntt, "ntt_forward_stacked", (1, 2), False),
            (ref_ntt, "ntt_inverse_stacked", (1, 2), False),
            (ref_ntt, "pointwise_mul_mont_stacked", (2, 3), False),
            (ref_ntt, "lazy_reduce_stacked", (1, 2), False),
            (ref_ntt, "garner_to_u128", (1, 2), False)):
        fn = getattr(mod, name)
        saved.append((mod, name, fn))
        setattr(mod, name, jax.jit(fn, static_argnums=static) if always else on_jnp(fn, static))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _encrypt128(rng, key_bits, m: int, delta: int) -> tuple:
    """A u128 LWE of m under the binary key (a squashed ciphertext's form),
    as (lo, hi) uint64 with noise in [-8, 8)."""
    n = len(key_bits)
    lo = rng.integers(0, 1 << 64, n + 1, dtype=np.uint64)
    hi = rng.integers(0, 1 << 64, n + 1, dtype=np.uint64)
    dot = sum(int(lo[i]) | (int(hi[i]) << 64) for i in range(n) if key_bits[i])
    body = (dot + m * delta + int(rng.integers(-8, 8))) % M128
    lo[n], hi[n] = body & (2**64 - 1), body >> 64
    return lo, hi


@pytest.fixture(scope="module")
def cut_keys():
    """Both packages' compression keys over the cut squashing key, from the
    same seeds."""
    ref_priv = ref_ns.NoiseSquashingPrivateKey(REF_CUT_SQ, seed=SEED)
    ref_cpriv = ref_ns.NoiseSquashingCompressionPrivateKey(
        ref_ns.TEST_NOISE_SQUASHING_COMP_PARAM, seed=SEED + 1)
    ref_key = ref_ns.NoiseSquashingCompressionKey(ref_priv, ref_cpriv, seed=SEED + 2)
    priv = ns.NoiseSquashingPrivateKey(CUT_SQ, seed=SEED)
    cpriv = ns.NoiseSquashingCompressionPrivateKey(ns.TEST_NOISE_SQUASHING_COMP_PARAM,
                                                   seed=SEED + 1)
    key = ns.NoiseSquashingCompressionKey(priv, cpriv, seed=SEED + 2, device="cpu")
    return ref_key, ref_cpriv, key, cpriv, priv


@pytest.fixture(scope="module")
def test_set():
    """The TEST sets: the port's keys, tfhe_tpu's compression key on the same
    words (its NTT-domain form built from them), and 16 squashed inputs."""
    priv = ns.NoiseSquashingPrivateKey(ns.TEST_NOISE_SQUASHING_PARAM, seed=SEED + 3)
    cpriv = ns.NoiseSquashingCompressionPrivateKey(ns.TEST_NOISE_SQUASHING_COMP_PARAM,
                                                   seed=SEED + 4)
    key = ns.NoiseSquashingCompressionKey(priv, cpriv, seed=SEED + 5, device="cpu")
    ref_key = ref_ns.NoiseSquashingCompressionKey.__new__(ref_ns.NoiseSquashingCompressionKey)
    ref_key.params = ref_ns.TEST_NOISE_SQUASHING_COMP_PARAM
    ref_key.plan = ref_ntt.make_plan(ref_key.params.packing_ks_polynomial_size, 8)
    lo, hi = key.standard_key()
    ref_key.pksk_mont = jnp.asarray(torus128.bootstrap_key128_to_ntt(lo, hi, key.plan))
    ref_cpriv = ref_ns.NoiseSquashingCompressionPrivateKey(
        ref_ns.TEST_NOISE_SQUASHING_COMP_PARAM, seed=SEED + 4)
    rng = np.random.default_rng(SEED)
    delta = ns.TEST_NOISE_SQUASHING_PARAM.delta128
    bits = priv.glwe_secret_key.to_lwe_key_bits()
    msgs = [int(x) for x in rng.integers(0, 16, 16)]
    pairs = [_encrypt128(rng, bits, m, delta) for m in msgs]
    ref_cts = [ref_ns.SquashedNoiseCiphertext(lo, hi, 3, 4, 4) for lo, hi in pairs]
    cts = [ns.SquashedNoiseCiphertext(torch.from_numpy(lo.view(np.int64)),
                                      torch.from_numpy(hi.view(np.int64)), 3, 4, 4)
           for lo, hi in pairs]
    return key, cpriv, ref_key, ref_cpriv, cts, ref_cts, msgs


def test_key_words_equal_tfhe_tpu(cut_keys):
    ref_key, _, key, _, _ = cut_keys
    lo, hi = key.standard_key()
    assert key.pksk.shape == (64, 1, 3, 256, 2)
    assert key.device_bytes == 64 * 3 * 256 * 16
    np.testing.assert_array_equal(torus128.bootstrap_key128_to_ntt(lo, hi, key.plan),
                                  np.asarray(ref_key.pksk_mont))


def test_from_raw_keys_equals_the_port_keygen(cut_keys):
    ref_key, _, key, _, _ = cut_keys
    raw = ns.NoiseSquashingCompressionKey.from_raw_keys(
        np.asarray(ref_key.pksk_mont), ns.TEST_NOISE_SQUASHING_COMP_PARAM, device="cpu")
    assert torch.equal(raw.pksk, key.pksk)


def test_private_key_equals_tfhe_tpu(cut_keys):
    ref_key, ref_cpriv, key, cpriv, _ = cut_keys
    np.testing.assert_array_equal(cpriv.glwe_secret_key.data, ref_cpriv.glwe_secret_key.data)


@pytest.mark.parametrize("count", [1, 5, 16])
def test_compress_matches_tfhe_tpu(test_set, count):
    key, cpriv, ref_key, ref_cpriv, cts, ref_cts, msgs = test_set
    with compiled_reference_helpers():
        want = ref_key.compress(ref_cts[:count])
    got = key.compress(cts[:count])
    np.testing.assert_array_equal(got.glwe_lo, np.asarray(want.glwe_lo))
    np.testing.assert_array_equal(got.glwe_hi, np.asarray(want.glwe_hi))
    assert (got.count, got.message_modulus, got.carry_modulus) == (count, 4, 4)
    assert cpriv.decrypt_list(got) == ref_cpriv.decrypt_list(want) == msgs[:count]


def test_compress_batch_equals_one_list_at_a_time(test_set):
    key, cpriv, _, _, cts, _, msgs = test_set
    lists = [cts[:3], cts[3:16], cts[7:8]]
    batch = key.compress_batch(lists)
    for packed, cts_g in zip(batch, lists):
        one = key.compress(cts_g)
        np.testing.assert_array_equal(packed.glwe_lo, one.glwe_lo)
        np.testing.assert_array_equal(packed.glwe_hi, one.glwe_hi)
    assert cpriv.decrypt_list(batch[1]) == msgs[3:16]


# mask words whose base-2^61 digit is +2^60 and -2^60 (the tie rounds down
# to -2^60 where the rounding bit is set)
DIGIT_PLUS = 1 << 127
DIGIT_MINUS = (1 << 127) - (1 << 66)


def test_plain_k6_extreme_digits_match_the_direct_product(test_set):
    """The plain version (8-prime CRT-NTT) on masks whose digits are +-2^60,
    the extremes of base 2^61, against the product taken directly in Python
    integers mod 2^128 at a few output coefficients."""
    key = test_set[0]
    lo, hi = key.standard_key()
    n_in, _, k1, n_poly = lo.shape
    count = 3
    rows = [[DIGIT_PLUS if (i + j) % 3 else DIGIT_MINUS for i in range(n_in)] + [j + 1]
            for j in range(count)]
    t = lambda a: torch.from_numpy(np.asarray(a, dtype=np.uint64).view(np.int64))  # noqa: E731
    w_lo = t([[x & (2**64 - 1) for x in row] for row in rows])
    w_hi = t([[x >> 64 for x in row] for row in rows])
    d_lo, d_hi = server128.signed_decompose128(w_lo[:, :-1], w_hi[:, :-1], 61, 1)[0]
    assert torch.equal(d_hi, torch.where(d_lo < 0, -1, 0))
    digits = d_lo.tolist()            # |d| < 2^63: the low word is the digit
    assert set(digits[0]) | set(digits[1]) == {1 << 60, -(1 << 60)}
    got_lo, got_hi = server128.packing_keyswitch128(w_lo[None], w_hi[None], t(lo), t(hi),
                                                    key.dp, 61, 1)
    for c, m in ((0, 0), (0, n_poly - 1), (k1 - 1, 1), (k1 - 1, 7)):
        acc = 0
        for j in range(count):
            for i in range(n_in):
                idx = m - j
                kv = int(lo[i, 0, c, idx]) | (int(hi[i, 0, c, idx]) << 64)
                acc += digits[j][i] * (kv if idx >= 0 else -kv)
        body = m + 1 if c == k1 - 1 and m < count else 0
        got = (int(got_lo[0, c, m]) % 2**64) | ((int(got_hi[0, c, m]) % 2**64) << 64)
        assert got == (body - acc) % M128, (c, m)


def test_k6_wrapper_refuses_bad_inputs(test_set):
    key, *_ = test_set
    n_in = key.pksk.shape[0]
    lwes = torch.zeros((1, 2, n_in + 1, 2), dtype=torch.int64)
    with pytest.raises(ValueError, match="counts"):
        kernels.packing_keyswitch128(lwes, key.pksk, [3], 61, 1, key.dp)
    with pytest.raises(ValueError, match="8-prime"):
        kernels.packing_keyswitch128(lwes, key.pksk, [2], 61, 1,
                                     ntt.device_plan(ntt.make_plan(256, 4), "cpu"))
    with pytest.raises(ValueError, match="disagree"):
        kernels.packing_keyswitch128(lwes[:, :, 1:], key.pksk, [2], 61, 1, key.dp)
    with pytest.raises(ValueError, match="fit a GLWE"):
        key.compress_batch([[]])
