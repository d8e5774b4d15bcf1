"""The noise-squashing slice of the port against tfhe_tpu on the CPU, word
for word (tolerance 0; all arithmetic is integer): the parameter sets, the
u128 helpers and signed decomposition (random values and the rounding
edges), the u128 CRT-NTT's host and torch halves, the u128 bootstrapping
key in both forms, the plain u128 blind rotation and the K5 wrapper on CPU
tensors against tfhe_tpu's XLA twin of the v2q Pallas kernel (which
tests/test_pallas_kernel.py ties to v2q), squash_ciphertext_noise_batch end
to end through from_raw_keys and through the port's own keygen, and K2's
single-step entry (blind_rotate_stepwise) against the exact rotation."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tfhe_tpu import shortint as ref
from tfhe_tpu.core import torus128 as ref_t128
from tfhe_tpu.core.entities import LweSecretKey as RefLweSecretKey
from tfhe_tpu.core.params import DecompParams as RefDecomp
from tfhe_tpu.ops import ntt as ref_ntt
from tfhe_tpu.ops import server as ref_srv
from tfhe_tpu.ops import server128 as ref_s128
from tfhe_tpu.shortint import noise_squashing as ref_ns
from tfhe_tpu.utils.csprng import DeterministicSeeder as RefSeeder
from tfhe_tpu.utils.csprng import EncryptionRandomGenerator as RefGen
from tfhe_tpu.utils.csprng import TUniform as RefTUniform
from tfhe_tpu_torch import shortint
from tfhe_tpu_torch.core import torus128
from tfhe_tpu_torch.core.entities import LweSecretKey
from tfhe_tpu_torch.core.params import DecompParams
from tfhe_tpu_torch.ops import kernels, ntt, server, server128, torus
from tfhe_tpu_torch.shortint import noise_squashing as ns
from tfhe_tpu_torch.utils.csprng import (DeterministicSeeder, EncryptionRandomGenerator,
                                         TUniform)

torch.set_num_threads(1)  # the suite runs in parallel processes: one thread each

SEED = 0x5A5A
N = 512                         # TEST_NOISE_SQUASHING_PARAM's polynomial size
BASE_LOG, LEVELS = 24, 3        # its decomposition
M128 = 1 << 128


def _t(a) -> torch.Tensor:
    return torus.from_u64(np.asarray(a, dtype=np.uint64), "cpu")


def _u(t) -> np.ndarray:
    return torus.to_u64(t)


def _pairs(values) -> tuple:
    """Python ints mod 2^128 -> (lo, hi) uint64 arrays."""
    v = [x % M128 for x in values]
    return (np.array([x & (2**64 - 1) for x in v], dtype=np.uint64),
            np.array([x >> 64 for x in v], dtype=np.uint64))


def _rand_pairs(rng, shape) -> tuple:
    return (rng.integers(0, 2**64, shape, dtype=np.uint64),
            rng.integers(0, 2**64, shape, dtype=np.uint64))


def _same(got_pair, want_pair) -> bool:
    return all(np.array_equal(_u(g) if isinstance(g, torch.Tensor) else g, np.asarray(w))
               for g, w in zip(got_pair, want_pair))


def _random_key128(rng, n_in, k1, plan) -> np.ndarray:
    """A random 6-prime NTT-domain key (n_in, l, k+1, k+1, 6, N) uint32."""
    key = np.zeros((n_in, LEVELS, k1, k1, 6, plan.n), dtype=np.uint32)
    for pi, p in enumerate(plan.primes):
        key[..., pi, :] = rng.integers(0, p, (n_in, LEVELS, k1, k1, plan.n),
                                       dtype=np.uint64).astype(np.uint32)
    return key


@pytest.fixture(scope="module")
def keys():
    """tfhe_tpu's client, server, squashing private and squashing keys at
    the TEST sets, and the port's from the same seeds (device "cpu")."""
    rck = ref.ClientKey(ref.TEST_PARAM_MESSAGE_2_CARRY_2, seed=SEED)
    rsk = ref.ServerKey(rck, seed=SEED + 1)
    rpriv = ref_ns.NoiseSquashingPrivateKey(ref_ns.TEST_NOISE_SQUASHING_PARAM, seed=SEED + 2)
    rnsk = ref_ns.NoiseSquashingKey(rck, rpriv, seed=SEED + 3)
    pck = shortint.ClientKey(shortint.TEST_PARAM_MESSAGE_2_CARRY_2, seed=SEED)
    psk = shortint.ServerKey(pck, seed=SEED + 1, device="cpu")
    ppriv = shortint.NoiseSquashingPrivateKey(shortint.TEST_NOISE_SQUASHING_PARAM,
                                              seed=SEED + 2)
    pnsk = shortint.NoiseSquashingKey(pck, ppriv, seed=SEED + 3, device="cpu")
    return rck, rsk, rpriv, rnsk, pck, psk, ppriv, pnsk


# ---------------------------------------------------------------------------
# Parameters, u128 helpers, decomposition
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", [
    "TEST_NOISE_SQUASHING_PARAM",
    "V1_4_NOISE_SQUASHING_PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128"])
def test_params_match(name):
    mine, theirs = getattr(ns, name), getattr(ref_ns, name)
    assert getattr(shortint, name) is mine
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert (mine.total_modulus, mine.delta128) == (theirs.total_modulus, theirs.delta128)


def test_u128_arithmetic_matches():
    """add, sub, neg and the u32-by-constant product, host and torch halves,
    against tfhe_tpu's on random pairs and on the carry edges."""
    rng = np.random.default_rng(1)
    a = _rand_pairs(rng, 64)
    b = _rand_pairs(rng, 64)
    edge = _pairs([2**64 - 1, 2**128 - 1, 0, 2**64, 2**127])
    a = tuple(np.concatenate([x, e]) for x, e in zip(a, edge))
    b = tuple(np.concatenate([x, e[::-1]]) for x, e in zip(b, edge))
    small = rng.integers(0, 2**32, a[0].shape, dtype=np.uint64)
    const = (0xFEDCBA9876543210F0E1D2C3B4A59687, (1 << 128) - 1, 1 << 64)
    with np.errstate(over="ignore"):
        want = {"add": ref_ntt.add128(*a, *b, np), "sub": ref_ntt.sub128(*a, *b, np),
                "neg": ref_ntt.neg128(*a, np)}
        for c in const:
            want[c] = ref_ntt.mul_u32_by_u128(small, c & (2**64 - 1), c >> 64, np)
        host = {"add": ntt.add128_np(*a, *b), "sub": ntt.sub128_np(*a, *b),
                "neg": ntt.neg128_np(*a)}
        for c in const:
            host[c] = ntt.mul_u32_by_u128_np(small, c & (2**64 - 1), c >> 64)
    ta, tb = tuple(map(_t, a)), tuple(map(_t, b))
    dev = {"add": ntt.add128(*ta, *tb), "sub": ntt.sub128(*ta, *tb), "neg": ntt.neg128(*ta)}
    for c in const:
        dev[c] = ntt.mul_u32_by_u128(_t(small), c & (2**64 - 1), c >> 64)
    for key, w in want.items():
        assert _same(host[key], w), key
        assert _same(dev[key], w), key


@pytest.mark.parametrize("s", [0, 1, 23, 63, 64, 65, 100, 127])
def test_pair_shifts_match(s):
    rng = np.random.default_rng(2 + s)
    lo, hi = _rand_pairs(rng, 32)
    jl, jh, tl, th = jnp.asarray(lo), jnp.asarray(hi), _t(lo), _t(hi)
    assert _same(server128._shr128(tl, th, s), ref_s128._shr128(jl, jh, s))
    assert _same(server128._shl128(tl, th, s), ref_s128._shl128(jl, jh, s))
    assert _same(server128._mask128(tl, th, s), ref_s128._mask128(jl, jh, s))
    assert np.array_equal(_u(server128._bit128(tl, th, s)), np.asarray(ref_s128._bit128(jl, jh, s)))
    if s < 64:
        assert _same(server128._sar128(tl, th, s), ref_s128._sar128(jl, jh, s))


def _edge_values(base_log: int, levels: int) -> list:
    """Values at the decomposer's rounding boundary: each kept top part
    (zero, all ones, digits of exactly B/2 or B/2 - 1, the need-balance
    bit) with the rounding bit set or clear and the bits below it all zero
    or all one."""
    rep = base_log * levels
    half = 1 << (base_log - 1)
    tops = [0, (1 << rep) - 1, 1 << (rep - 1), (1 << (rep - 1)) - 1,
            sum(half << (base_log * i) for i in range(levels)),
            sum((half - 1) << (base_log * i) for i in range(levels)),
            half << (base_log * (levels - 1)), half]
    out = []
    for top in tops:
        for rounding in (0, 1):
            for low in (0, (1 << (127 - rep)) - 1):
                out.append((top << (128 - rep)) | (rounding << (127 - rep)) | low)
    return out


@pytest.mark.parametrize("base_log,levels", [(24, 3), (31, 3), (12, 4), (8, 1), (20, 6)])
def test_signed_decompose128_matches(base_log, levels):
    rng = np.random.default_rng(base_log * 10 + levels)
    rand = [int(x) | (int(y) << 64) for x, y in zip(*_rand_pairs(rng, 96))]
    lo, hi = _pairs(rand + _edge_values(base_log, levels))
    want = ref_s128.signed_decompose128(jnp.asarray(lo), jnp.asarray(hi), base_log, levels)
    got = server128.signed_decompose128(_t(lo), _t(hi), base_log, levels)
    assert len(got) == levels
    for g, w in zip(got, want):
        assert _same(g, w)
    # the digits' residues, as the rotation takes them
    plan = ntt.make_plan(N, 6)
    dp = ntt.device_plan(plan, "cpu")
    for g, w in zip(got, want):
        r_want = np.asarray(ref_s128._digit_residues128(*w, ref_ntt.make_plan(N, 6)))
        assert np.array_equal(server128._digit_residues128(*g, dp).numpy(),
                              r_want.astype(np.int64))


# ---------------------------------------------------------------------------
# The u128 CRT-NTT, host and torch halves
# ---------------------------------------------------------------------------


def test_garner_to_u128_matches():
    plan, rplan = ntt.make_plan(N, 6), ref_ntt.make_plan(N, 6)
    rng = np.random.default_rng(5)
    res = np.stack([rng.integers(0, p, (3, N), dtype=np.uint64) for p in plan.primes], axis=-2)
    with np.errstate(over="ignore"):
        want = ref_ntt.garner_to_u128(res, rplan, np)
    assert _same(ntt.garner_to_u128_np(res, plan), want)
    got = ntt.garner_to_u128(torch.from_numpy(res.astype(np.int64)), ntt.device_plan(plan, "cpu"))
    assert _same(got, want)


@pytest.mark.parametrize("binary", [True, False])
def test_negacyclic_polymul_u128_matches(binary):
    """The host product of a u128 polynomial with a binary key (the keygen
    product) and with small signed digits (the external product's range)."""
    plan, rplan = ntt.make_plan(N, 6), ref_ntt.make_plan(N, 6)
    rng = np.random.default_rng(6 + binary)
    a = _rand_pairs(rng, (2, N))
    if binary:
        b = (rng.integers(0, 2, (2, N), dtype=np.uint64), np.zeros((2, N), np.uint64))
    else:
        b = _pairs([int(v) for v in rng.integers(-2**23, 2**23, 2 * N)])
        b = tuple(x.reshape(2, N) for x in b)
    with np.errstate(over="ignore"):
        want = ref_ntt.negacyclic_polymul_u128(*a, *b, rplan, np)
    assert _same(ntt.negacyclic_polymul_u128(*a, *b, plan), want)


@pytest.mark.parametrize("k", [1, 2])
def test_mask_times_binary_key_u128_matches(k):
    """The torch half's keygen product, sum_i m_i * s_i, against the sum of
    tfhe_tpu's u128 products."""
    rplan = ref_ntt.make_plan(N, 6)
    rng = np.random.default_rng(20 + k)
    m = _rand_pairs(rng, (3, k, N))
    key = rng.integers(0, 2, (k, N), dtype=np.uint64)
    z = np.zeros(N, np.uint64)
    with np.errstate(over="ignore"):
        want = (np.zeros((3, N), np.uint64), np.zeros((3, N), np.uint64))
        for i in range(k):
            prod = ref_ntt.negacyclic_polymul_u128(m[0][:, i], m[1][:, i], key[i], z, rplan, np)
            want = ref_ntt.add128(*want, *prod, np)
    got = ntt.mask_times_binary_key_u128(_t(m[0]), _t(m[1]), torch.from_numpy(key.astype(np.int64)),
                                         ntt.device_plan(ntt.make_plan(N, 6), "cpu"))
    assert _same(got, want)


def test_encrypt_glwe_assign128_matches():
    rng = np.random.default_rng(15)
    key = rng.integers(0, 2, (2, N)).astype(np.uint64)
    body = _rand_pairs(rng, N)
    want = ref_t128.encrypt_glwe_assign128(
        ref_t128.GlweSecretKey128(key), *body, RefTUniform(3), RefGen(SEED, RefSeeder(SEED + 1)),
        ref_ntt.make_plan(N, 6))
    got = torus128.encrypt_glwe_assign128(
        torus128.GlweSecretKey128(key), *body, TUniform(3),
        EncryptionRandomGenerator(SEED, DeterministicSeeder(SEED + 1)),
        ntt.device_plan(ntt.make_plan(N, 6), "cpu"))
    assert _same(got, want)


def test_forward_u128_mont_matches_host():
    plan = ntt.make_plan(N, 6)
    rng = np.random.default_rng(7)
    lo, hi = _rand_pairs(rng, (3, N))
    with np.errstate(over="ignore"):
        want = ntt.to_mont_all(ntt.forward_all_u128(lo, hi, plan), plan)
        rwant = ref_ntt.to_mont_all(ref_ntt.forward_all_u128(lo, hi, ref_ntt.make_plan(N, 6),
                                                             np), ref_ntt.make_plan(N, 6), np)
    assert np.array_equal(want, rwant)
    got = ntt.forward_u128_mont(_t(lo), _t(hi), ntt.device_plan(plan, "cpu"))
    assert np.array_equal(got.numpy(), want.astype(np.int64))


def test_kernel128_constant_table_layout():
    """The packed table csrc/blind_rotate128.cu reads, at its slots."""
    plan = ntt.make_plan(2048, 6)
    dp = ntt.device_plan(plan, "cpu")
    c = dp.kernel_consts128.numpy()
    g = ntt.garner_consts(plan.primes)
    assert dp.kernel_consts is None and c.shape == (ntt.KERNEL128_CONSTS_LEN,)
    assert list(c[:6]) == list(plan.primes)
    assert list(c[6:12]) == [int(v) for v in plan.pinvs[:, 0]]
    assert list(c[12:18]) == [int(v) for v in plan.n_invs[:, 0]]
    for j, v in g["inv_mont"].items():
        assert c[18 + j] == v
    for (i, j), v in g["pm_mont"].items():
        assert c[24 + 6 * i + j] == v
    words = c[60:74].view(np.uint64)
    for i, (lo, hi) in enumerate(g["prods128"] + [g["P_mod128"]]):
        assert (int(words[2 * i]), int(words[2 * i + 1])) == (lo, hi)
    assert list(c[74:80]) == g["half_digits"]


# ---------------------------------------------------------------------------
# The u128 bootstrapping key
# ---------------------------------------------------------------------------


def test_bootstrap_key128_matches_in_both_forms():
    """A GGSW list at the TEST squashing set from the same seeds, in the
    standard domain and in the NTT domain on the host and with the torch
    half, byte-identical to tfhe_tpu's."""
    n_in = 6
    rng = np.random.default_rng(8)
    lwe = rng.integers(0, 2, n_in).astype(np.uint64)
    glwe = rng.integers(0, 2, (1, N)).astype(np.uint64)
    rplan, plan = ref_ntt.make_plan(N, 6), ntt.make_plan(N, 6)
    dp = ntt.device_plan(plan, "cpu")
    want = ref_t128.generate_bootstrap_key128(
        RefLweSecretKey(lwe), ref_t128.GlweSecretKey128(glwe), RefDecomp(BASE_LOG, LEVELS),
        RefTUniform(3), RefGen(SEED, RefSeeder(SEED + 1)), rplan)
    got = torus128.generate_bootstrap_key128(
        LweSecretKey(lwe), torus128.GlweSecretKey128(glwe), DecompParams(BASE_LOG, LEVELS),
        TUniform(3), EncryptionRandomGenerator(SEED, DeterministicSeeder(SEED + 1)), dp)
    assert _same(got, want)
    ntt_want = ref_t128.bootstrap_key128_to_ntt(*want, rplan)
    assert np.array_equal(torus128.bootstrap_key128_to_ntt(*got, plan), ntt_want)
    on = torus128.bootstrap_key128_to_ntt_on(*got, dp)
    assert np.array_equal(on.numpy().view(np.uint32), ntt_want)


def test_fork_budget_is_16_bytes_a_u128_element():
    gen = EncryptionRandomGenerator(1, DeterministicSeeder(2))
    kids = gen.fork(3, 10, 4, TUniform(3), 128)
    assert [k.mask.end - k.mask.pos for k in kids] == [160] * 3
    assert gen.mask.pos == 480 and gen.noise.pos == 12
    kid = gen.fork(1, 10, 4, TUniform(3))[0]        # u64 elements by default
    assert kid.mask.end - kid.mask.pos == 80


def test_squashing_keys_match(keys):
    rck, rsk, rpriv, rnsk, pck, psk, ppriv, pnsk = keys
    assert np.array_equal(ppriv.glwe_secret_key.data, rpriv.glwe_secret_key.data)
    assert np.array_equal(pnsk.bsk128_ntt.numpy().view(np.uint32), np.asarray(rnsk.bsk128_mont))
    assert pnsk.plan128.primes == rnsk.plan128.primes


# ---------------------------------------------------------------------------
# Blind rotation and the squashing path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k1", [2, 3])
def test_blind_rotate128_matches(k1):
    """The plain rotation and the K5 wrapper on CPU tensors against
    tfhe_tpu's XLA twin of the v2q kernel, on a random 6-prime key."""
    rng = np.random.default_rng(9 + k1)
    n_in, b = 3, 3
    plan = ntt.make_plan(N, 6)
    key = _random_key128(rng, n_in, k1, plan)
    lut = _rand_pairs(rng, (b, k1, N))
    mask = rng.integers(0, 2 * N, (b, n_in))
    body = rng.integers(0, 2 * N, (b,))
    want = ref_s128.blind_rotate128(jnp.asarray(mask), jnp.asarray(body), jnp.asarray(lut[0]),
                                    jnp.asarray(lut[1]), jnp.asarray(key),
                                    ref_ntt.make_plan(N, 6), BASE_LOG, LEVELS)
    args = (torch.from_numpy(mask), torch.from_numpy(body), _t(lut[0]), _t(lut[1]),
            torch.from_numpy(key.view(np.int32)), ntt.device_plan(plan, "cpu"),
            BASE_LOG, LEVELS)
    assert _same(server128.blind_rotate128(*args), want)
    before = kernels.blind_rotate128.launches
    assert _same(kernels.blind_rotate128(*args), want)
    assert kernels.blind_rotate128.launches == before


@pytest.mark.parametrize("op", ["mul", "div"])
def test_monomials128_and_sample_extract_match(op):
    rng = np.random.default_rng(12)
    lo, hi = _rand_pairs(rng, (4, 2, 16))
    deg = rng.integers(0, 32, (4,))
    ref_fn = ref_s128.monomial_mul128 if op == "mul" else ref_s128.monomial_div128
    fn = server128.monomial_mul128 if op == "mul" else server128.monomial_div128
    want = ref_fn(jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(deg)[:, None, None])
    got = fn(_t(lo), _t(hi), torch.from_numpy(deg)[:, None, None])
    assert _same(got, want)
    assert _same(server128.sample_extract128(*got),
                 ref_s128.sample_extract128(*map(jnp.asarray, want)))


def test_generate_lut128_matches():
    sp = ns.TEST_NOISE_SQUASHING_PARAM
    args = (sp.polynomial_size, sp.glwe_dimension + 1, sp.total_modulus, sp.delta128)
    assert _same(server128.generate_lut128(*args, lambda x: (3 * x + 1) % 16),
                 ref_s128.generate_lut128(*args, lambda x: (3 * x + 1) % 16))


def _squashed_words(sq) -> tuple:
    return (np.stack([_u(s.lo) if isinstance(s.lo, torch.Tensor) else np.asarray(s.lo)
                      for s in sq]),
            np.stack([_u(s.hi) if isinstance(s.hi, torch.Tensor) else np.asarray(s.hi)
                      for s in sq]))


@pytest.mark.parametrize("route", ["own_keygen", "from_raw_keys"])
def test_squash_batch_matches(keys, route):
    """squash_ciphertext_noise_batch end to end, lo and hi words, degrees
    and decryptions, on fresh and carry-space ciphertexts; through the
    port's own seeded keys, or through tfhe_tpu's keys carried in."""
    rck, rsk, rpriv, rnsk, pck, psk, ppriv, pnsk = keys
    if route == "from_raw_keys":
        p = shortint.TEST_PARAM_MESSAGE_2_CARRY_2
        psk = shortint.ServerKey.from_raw_keys(p, np.asarray(rsk.ksk), rsk._bsk_coeff.data,
                                               rsk._bsk_floored, device="cpu")
        ppriv = shortint.NoiseSquashingPrivateKey.from_raw_keys(
            ns.TEST_NOISE_SQUASHING_PARAM, rpriv.glwe_secret_key.data)
        pnsk = shortint.NoiseSquashingKey.from_raw_keys(
            np.asarray(rnsk.bsk128_mont), ns.TEST_NOISE_SQUASHING_PARAM, device="cpu")
    msgs = [0, 1, 2, 3, 1, 2]
    rcts = [rck.encrypt(m) for m in msgs]
    pcts = [pck.encrypt(m) for m in msgs]
    rcts.append(rsk.unchecked_add(rcts[3], rcts[2]))         # 5: the carry space
    pcts.append(psk.unchecked_add(pcts[3], pcts[2]))
    want = rnsk.squash_ciphertext_noise_batch(rcts, rsk)
    got = pnsk.squash_ciphertext_noise_batch(pcts, psk)
    assert _same(_squashed_words(got), _squashed_words(want))
    assert [s.degree for s in got] == [s.degree for s in want]
    dec = [ppriv.decrypt_squashed_noise_ciphertext(s) for s in got]
    assert dec == [rpriv.decrypt_squashed_noise_ciphertext(s) for s in want] == msgs + [5]
    assert ppriv.decrypt_squashed_noise_ciphertext(pnsk.squash_ciphertext_noise(pcts[1], psk)) == 1


def test_squash_message_modulus_mismatch_raises(keys):
    *_, pck, psk, ppriv, pnsk = keys
    ct = pck.encrypt(1)
    ct.message_modulus = 2
    with pytest.raises(ValueError, match="MessageModulus"):
        pnsk.squash_ciphertext_noise_batch([ct], psk)


def test_squash_default_device_raises(keys, monkeypatch):
    *_, pck, _, ppriv, _ = keys
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        shortint.NoiseSquashingKey(pck, ppriv, seed=1)


def test_decrypt_lwe128_matches_python_ints():
    rng = np.random.default_rng(13)
    bits = rng.integers(0, 2, 40).astype(np.uint64)
    lo, hi = _rand_pairs(rng, 41)
    assert torus128.decrypt_lwe128(bits, lo, hi) == ref_t128.decrypt_lwe128(bits, lo, hi)


# ---------------------------------------------------------------------------
# K2's single-step entry (row 6, build_cmux_step)
# ---------------------------------------------------------------------------


def test_blind_rotate_stepwise_matches():
    """One cmux_step a mask element (plain on CPU tensors) equals tfhe_tpu's
    exact rotation, the rotation of the row-6 kernel's wrapper
    (tfhe_tpu/ops/server.py:488), on a random 4-prime key at l = 2."""
    rng = np.random.default_rng(14)
    n_in, b, k1, levels, base_log, n = 4, 3, 2, 2, 8, 256
    plan = ntt.make_plan(n, 4)
    key = np.stack([rng.integers(0, p, (n_in, levels, k1, k1, n), dtype=np.uint64)
                    for p in plan.primes], axis=-2).astype(np.uint32)
    lut = rng.integers(0, 2**64, (b, k1, n), dtype=np.uint64)
    mask = rng.integers(0, 2 * n, (b, n_in))
    body = rng.integers(0, 2 * n, (b,))
    want = ref_srv.blind_rotate(jnp.asarray(mask), jnp.asarray(body), jnp.asarray(lut),
                                jnp.asarray(key), ref_ntt.make_plan(n, 4), base_log, levels)
    dp = ntt.device_plan(plan, "cpu")
    args = (torch.from_numpy(mask), torch.from_numpy(body), _t(lut),
            torch.from_numpy(key.view(np.int32)), dp, base_log, levels)
    before = kernels.cmux_step.launches
    got = server.blind_rotate_stepwise(*args)
    assert kernels.cmux_step.launches == before
    assert np.array_equal(_u(got), np.asarray(want))
    assert torch.equal(got, server.blind_rotate(*args))
    acc = server.initial_accumulator(_t(lut), torch.from_numpy(body), False)
    step = (acc, torch.from_numpy(mask[:, 0]), torch.from_numpy(key[0].view(np.int32)), dp,
            base_log, levels)
    assert torch.equal(kernels.cmux_step(*step), server.cmux_step(*step))


def test_new_wrappers_refuse_other_devices():
    meta = torch.empty((2, 5), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="no u128 blind-rotation kernel"):
        kernels.blind_rotate128(meta, meta[:, 0], meta, meta, meta, None, BASE_LOG, LEVELS)
    with pytest.raises(ValueError, match="no blind-rotation kernel"):
        kernels.cmux_step(meta, meta[:, 0], meta, None, 8, 1)
