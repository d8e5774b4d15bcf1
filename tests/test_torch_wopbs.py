"""WoPBS of the port against tfhe_tpu on the CPU, word for word (tolerance 0;
all arithmetic is integer): the PFPKS key from the same seed (keygen at the
TEST set cut to N = 64, so tfhe_tpu's row-by-row keygen stays short) and
from_raw_keys of tfhe_tpu's 4-prime NTT-domain key; at the TEST set, on
one key's words in both packages, the PFPKS rows (K1's plain version at the
PFPKS shape), extract_bits, the circuit-bootstrapped GGSWs, vertical
packing (K2's CMux and step entries' plain versions) with and without the
CMux tree, and apply_wopbs with the identity and a non-monotone LUT.
tfhe_tpu's _pfpks and _cmux run compiled by jax.jit (the same functions;
eager dispatch compiles each of their operations on its own, about 30 s
more)."""

import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfhe_tpu import shortint as ref
from tfhe_tpu.ops import ntt as ref_ntt
from tfhe_tpu.shortint import wopbs as ref_wopbs
from tfhe_tpu_torch import shortint
from tfhe_tpu_torch.ops import kernels, ntt, server, torus
from tfhe_tpu_torch.shortint import wopbs

SEED = 0x30B
P = shortint.TEST_PARAM_MESSAGE_2_CARRY_2
REF_P = ref.TEST_PARAM_MESSAGE_2_CARRY_2


def _u(t) -> np.ndarray:
    return torus.to_u64(t) if isinstance(t, torch.Tensor) else np.asarray(t)


def _ref_rows(wk: wopbs.WopbsKey) -> list:
    """The port key's rows in tfhe_tpu's layout: k+1 arrays (n+1, l, k+1,
    4, N) uint32, 4-prime Montgomery NTT domain."""
    words = torus.to_u64(wk.pfpksk).copy()
    with np.errstate(over="ignore"):
        words[-1] = np.uint64(0) - words[-1]
    k1, n_poly = wk.k + 1, wk.n_poly
    rows = words.reshape(words.shape[:2] + (k1, k1, n_poly))
    plan = ntt.make_plan(n_poly, 4)
    with np.errstate(over="ignore"):
        return [ntt.to_mont_all(ntt.forward_all(rows[:, :, r], plan), plan).astype(np.uint32)
                for r in range(k1)]


@pytest.fixture(scope="module")
def cut_keys():
    cut = dataclasses.replace(P, polynomial_size=64)
    ref_cut = dataclasses.replace(REF_P, polynomial_size=64)
    ref_ck = ref.ClientKey(ref_cut, seed=SEED)
    ref_wk = ref_wopbs.WopbsKey(ref_ck, None, ref_wopbs.TEST_WOPBS_PARAM, seed=SEED + 2)
    ck = shortint.ClientKey(cut, seed=SEED)
    sk = shortint.ServerKey(ck, seed=SEED + 1, device="cpu")
    wk = wopbs.WopbsKey(ck, sk, wopbs.TEST_WOPBS_PARAM, seed=SEED + 2)
    return ref_wk, sk, wk


@pytest.fixture(scope="module")
def keys():
    """The TEST set: the port's keys and tfhe_tpu's on the same words, with
    tfhe_tpu's _pfpks and _cmux compiled."""
    ck = shortint.ClientKey(P, seed=SEED)
    sk = shortint.ServerKey(ck, seed=SEED + 1, device="cpu")
    wk = wopbs.WopbsKey(ck, sk, wopbs.TEST_WOPBS_PARAM, seed=SEED + 2)
    ref_ck = ref.ClientKey(REF_P, seed=SEED)
    ref_sk = ref.ServerKey(ref_ck, seed=SEED + 1)
    ref_wk = ref_wopbs.WopbsKey.__new__(ref_wopbs.WopbsKey)
    ref_wk.params = ref_wopbs.TEST_WOPBS_PARAM
    ref_wk.shortint_params = REF_P
    ref_wk.server_key = ref_sk
    ref_wk.k, ref_wk.n_poly = P.glwe_dimension, P.polynomial_size
    ref_wk.plan = ref_ntt.make_plan(P.polynomial_size, 4)
    ref_wk.pfpksk = [jnp.asarray(r) for r in _ref_rows(wk)]

    def pfpks(keys_, lwe, r):
        obj = copy.copy(ref_wk)
        obj.pfpksk = list(keys_)
        return ref_wopbs.WopbsKey._pfpks(obj, lwe, r)

    compiled_pfpks = jax.jit(pfpks, static_argnums=2)
    ref_wk._pfpks = lambda lwe, r: compiled_pfpks(tuple(ref_wk.pfpksk), lwe, r)
    ref_wk._cmux = jax.jit(functools.partial(ref_wopbs.WopbsKey._cmux, ref_wk))
    return ck, sk, wk, ref_ck, ref_wk


def test_pfpks_key_equals_tfhe_tpu(cut_keys):
    ref_wk, _, wk = cut_keys
    for got, want in zip(_ref_rows(wk), ref_wk.pfpksk):
        np.testing.assert_array_equal(got, np.asarray(want))
    assert wk.pfpksk.shape == (65, 2, 4 * 64)


def test_from_raw_keys_equals_the_port_keygen(cut_keys):
    ref_wk, sk, wk = cut_keys
    raw = wopbs.WopbsKey.from_raw_keys(sk, [np.asarray(k) for k in ref_wk.pfpksk])
    assert torch.equal(raw.pfpksk, wk.pfpksk)


def test_pfpks_rows_match(keys):
    ck, _, wk, ref_ck, ref_wk = keys
    lwe = np.asarray(ref_ck.encrypt_without_padding_value(11).data)
    for r in range(wk.k + 1):
        np.testing.assert_array_equal(_u(wk._pfpks(lwe, r)), np.asarray(ref_wk._pfpks(lwe, r)))


@pytest.fixture(scope="module")
def bits(keys):
    ck, _, wk, ref_ck, ref_wk = keys
    ct = ref_ck.encrypt_without_padding_value(0b1011)
    port_ct = shortint.Ciphertext(np.asarray(ct.data).copy(), ct.degree, ct.noise_level, 4, 4)
    return ref_wk.extract_bits(ct, 4), wk.extract_bits(port_ct, 4)


def test_extract_bits_match(keys, bits):
    ck = keys[0]
    ref_bits, port_bits = bits
    for a, b in zip(ref_bits, port_bits):
        np.testing.assert_array_equal(np.asarray(b.data), np.asarray(a.data))
    assert [ck.decrypt_raw(b) & 1 for b in port_bits] == [1, 0, 1, 1]


@pytest.fixture(scope="module")
def ggsws(keys, bits):
    _, _, wk, _, ref_wk = keys
    ref_bits, port_bits = bits
    return ([ref_wk.circuit_bootstrap_bit(b) for b in ref_bits],
            wk.circuit_bootstrap_bits(port_bits))


def test_circuit_bootstrap_ggsws_match(keys, bits, ggsws):
    ref_g, port_g = ggsws
    assert port_g[0].shape == (4, 2, 2, 4, 512) and port_g[0].dtype == torch.int32
    for a, b in zip(ref_g, port_g):
        np.testing.assert_array_equal(b.numpy().view(np.uint32), np.asarray(a))
    assert torch.equal(keys[2].circuit_bootstrap_bit(bits[1][2]), port_g[2])


def test_vertical_packing_matches(keys, ggsws):
    ck, _, wk, _, ref_wk = keys
    ref_g, port_g = ggsws
    f = lambda x: (x * x + 3) % 16  # noqa: E731
    vals = [f(x) for x in range(16)]
    want = ref_wk.vertical_packing(ref_g, vals, REF_P.delta)
    got = wk.vertical_packing(port_g, vals, P.delta)
    np.testing.assert_array_equal(np.asarray(got.data), np.asarray(want.data))
    assert (got.degree, got.noise_level) == (want.degree, want.noise_level)
    assert ck.decrypt_raw(got) == f(0b1011)


@pytest.mark.parametrize("lut,value", [("identity", 5), ("nonmonotone", 12)])
def test_apply_wopbs_matches(keys, lut, value):
    ck, _, wk, ref_ck, ref_wk = keys
    f = (lambda x: x) if lut == "identity" else (lambda x: (x * x + 3) % 16)
    ct = ref_ck.encrypt_without_padding_value(value)
    port_ct = shortint.Ciphertext(np.asarray(ct.data).copy(), ct.degree, ct.noise_level, 4, 4)
    want = ref_wk.apply_wopbs(ct, f, 4)
    got = wk.apply_wopbs(port_ct, f, 4)
    np.testing.assert_array_equal(np.asarray(got.data), np.asarray(want.data))
    assert ck.decrypt_raw(got) == f(value)


def test_large_lut_tree_matches(keys):
    """kappa = 10 > log2 N = 9: one level of the CMux tree (K2's CMux entry),
    then nine low-bit rotations (K2's step entry)."""
    ck, _, wk, ref_ck, ref_wk = keys
    f = lambda x: (x ^ (x >> 3)) % 16  # noqa: E731
    v = 0b1100101011
    ref_cts = [ref_ck.encrypt_without_padding_value((v >> j) & 1) for j in range(9, -1, -1)]
    cts = [shortint.Ciphertext(np.asarray(c.data).copy(), c.degree, c.noise_level, 4, 4)
           for c in ref_cts]
    vals = [f(x) for x in range(1 << 10)]
    want = ref_wk.vertical_packing([ref_wk.circuit_bootstrap_bit(c) for c in ref_cts], vals,
                                   REF_P.delta)
    cmux_calls = []
    real = kernels.cmux

    def counting(*args):
        cmux_calls.append(args[0].shape[0])
        return real(*args)

    kernels.cmux = counting
    try:
        got = wk.vertical_packing(wk.circuit_bootstrap_bits(cts), vals, P.delta)
    finally:
        kernels.cmux = real
    assert cmux_calls == [1]
    np.testing.assert_array_equal(np.asarray(got.data), np.asarray(want.data))
    assert ck.decrypt_raw(got) == f(v)


def test_cmux_plain_is_ct0_plus_the_external_product(keys):
    _, sk, _, _, _ = keys
    rng = np.random.default_rng(SEED)
    ct0, ct1 = (torus.from_u64(rng.integers(0, 1 << 64, (3, 2, 512), dtype=np.uint64), "cpu")
                for _ in range(2))
    ggsw = torch.from_numpy(rng.integers(0, 1 << 29, (4, 2, 2, 4, 512)).astype(np.int32))
    want = ct0 + server.external_product(ct1 - ct0, ggsw, sk.dp, 6, 4)
    assert torch.equal(kernels.cmux(ct0, ct1, ggsw, sk.dp, 6, 4), want)
